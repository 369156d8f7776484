"""PyTorch port vs the JAX package: the CART trainer, the GemmForest forms,
the tree plan, and forest labels (the plain ``forest_labels`` against
``forest_labels_pallas(interpret=True)`` and ``gemm_labels_cm``), on the
four forest fixtures of tests/test_pallas.py. Labels are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.ops.pallas_kernels import forest_labels_pallas
from rs_image_segmentation_tpu.pipeline.turbo import gemm_labels_cm
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import kernels


def _numpy_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


# (name, data seed, samples, estimators, fit seed, duplicated samples,
#  pixels, Pallas block_n): the fixtures of tests/test_pallas.py:97-222
FIXTURES = {
    "20_trees": (7, 64, 20, 0, False, 7000, 256),
    "2_trees_ties": (11, 32, 2, 1, False, 4096, 128),
    "fractional_leaves": (3, 24, 10, 2, True, 4096, 128),
    "40_trees_grouped": (23, 120, 40, 0, False, 7000, 256),
}


def _fixture(name):
    seed, n, trees, fit_seed, dup, pixels, block_n = FIXTURES[name]
    rng = np.random.default_rng(seed)
    x = rng.random((n, 19)).astype(np.float32)
    if dup:
        x = np.concatenate([x, x])          # duplicates with clashing labels
    y = rng.integers(1, 4, x.shape[0])
    forest, _ = jforest.fit_random_forest(x, y, n_estimators=trees,
                                          seed=fit_seed)
    gf = jforest._gemm_for(forest, 19)
    xc = rng.random((19, pixels)).astype(np.float32)
    return x, y, trees, fit_seed, gf, xc, block_n


@pytest.mark.parametrize("name", list(FIXTURES))
def test_forest_labels_plain_matches_pallas_and_gemm(name):
    _, _, _, _, gf, xc, block_n = _fixture(name)
    if name == "fractional_leaves":
        assert not np.isin(np.asarray(gf.leaf_dist), (0.0, 1.0)).all()
    tgf = tforest.gemm_forest_from_numpy(_numpy_fields(gf))
    got = kernels.forest_labels(tgf, torch.from_numpy(xc)).numpy()
    ref_gemm = np.asarray(gemm_labels_cm(gf, jnp.asarray(xc), 1024))
    ref_dense = np.asarray(forest_labels_pallas(gf, jnp.asarray(xc),
                                                block_n=block_n,
                                                interpret=True))
    np.testing.assert_array_equal(got, ref_gemm)
    np.testing.assert_array_equal(got, ref_dense)
    plan = jforest.forest_tree_plan(gf)
    if plan is not None:
        ref_plan = np.asarray(forest_labels_pallas(
            gf, jnp.asarray(xc), block_n=block_n, interpret=True, plan=plan))
        np.testing.assert_array_equal(got, ref_plan)
    if name == "40_trees_grouped":
        assert plan is not None and len(plan) > 1


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fit_random_forest_identical_to_jax(name):
    x, y, trees, fit_seed, gf, _, _ = _fixture(name)
    ref, ref_depth = jforest.fit_random_forest(x, y, n_estimators=trees,
                                               seed=fit_seed)
    got, depth = tforest.fit_random_forest(x, y, n_estimators=trees,
                                           seed=fit_seed)
    assert depth == ref_depth
    for k, r in _numpy_fields(ref).items():
        assert np.array_equal(getattr(got, k).numpy(), r), k
    tgf = tforest._gemm_for(got, 19)
    for k, r in _numpy_fields(gf).items():
        assert np.array_equal(getattr(tgf, k).numpy(),
                              r.astype(np.float32 if k != "classes"
                                       else np.int32)), k
    assert tforest.forest_tree_plan(tgf) == jforest.forest_tree_plan(gf)


def test_flat_forest_carried_across_compiles_identically():
    _, _, _, _, gf, _, _ = _fixture("20_trees")
    rng = np.random.default_rng(7)
    x = rng.random((64, 19)).astype(np.float32)
    y = rng.integers(1, 4, 64)
    jflat, _ = jforest.fit_random_forest(x, y, n_estimators=20, seed=0)
    flat = tforest.flat_forest_from_numpy(_numpy_fields(jflat))
    tgf = tforest.forest_to_gemm(flat, 19)
    for k, r in _numpy_fields(gf).items():
        assert np.array_equal(getattr(tgf, k).numpy(), r.astype(np.float32)
                              if k != "classes" else r), k


def _tree_slots(packed, n_trees):
    """(first slot, steps) of each tree of the packed form, the real trees
    first, then the filler trees that pad the last group."""
    group = kernels.FOREST_GROUP
    slots = [(int(root), int(packed["depths"][t // group]))
             for t, root in enumerate(packed["roots"])]
    return slots[:n_trees], slots[n_trees:]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_pack_forest_trees_round_trip_to_path(name):
    """Walking every record of the packed form back to its leaves rebuilds
    the GemmForest's path matrix: real records give the decisions, padding
    records have two equal children and decide nothing."""
    _, _, trees, _, gf, _, _ = _fixture(name)
    tgf = tforest.gemm_forest_from_numpy(_numpy_fields(gf))
    packed = kernels.pack_forest(tgf)
    words = packed["records"].view(np.uint32)
    node_of = packed["record_node"]
    path = np.asarray(gf.path.astype(jnp.float32))
    rebuilt = np.zeros_like(path)
    reached = np.zeros(path.shape[1], int)

    def down(slot, left, trail):
        if left == 0:
            leaf = packed["row_leaf"][slot]
            reached[leaf] += 1
            for nd, sign in trail:
                rebuilt[nd, leaf] = sign
            return
        kids = int(words[slot, 0] >> 10)
        if node_of[slot] < 0:                # padding: both sides alike
            if left > 1:
                assert np.array_equal(words[kids], words[kids + 1])
            else:
                assert packed["row_leaf"][kids] == packed["row_leaf"][kids + 1]
            down(kids, left - 1, trail)
            return
        nd = node_of[slot]
        assert words[slot, 0] & 1023 == np.asarray(
            gf.selector.astype(jnp.float32))[:, nd].argmax()
        assert words[slot, 1].view(np.float32) == np.asarray(
            gf.thresholds)[nd]
        down(kids, left - 1, trail + [(nd, 1.0)])
        down(kids + 1, left - 1, trail + [(nd, -1.0)])

    real, fillers = _tree_slots(packed, trees)
    assert len(fillers) == -trees % kernels.FOREST_GROUP
    for root, steps in real:
        down(root, steps, [])
    assert (reached == 1).all()
    np.testing.assert_array_equal(rebuilt, path)
    n_leaves = path.shape[1]               # the fillers reach the zero row
    for root, steps in fillers:
        reached = np.zeros(n_leaves + 1, int)
        rebuilt = np.zeros((path.shape[0], n_leaves + 1))
        down(root, steps, [])
        assert reached[n_leaves] == 1 and reached.sum() == 1
    zero_rows = packed["row_leaf"] == n_leaves
    assert not packed["leaf_table"][:, zero_rows].any()


def _walk(packed, inv_trees, n_classes, xc):
    """The kernel's walk rendered in numpy, (F, N) -> (N,): groups of
    FOREST_GROUP trees stepping together for the group's depth, each step
    a record (feature, threshold, kids) and a compare, then the leaf table
    added in f64 in tree order, rounded once to f32, times inv_trees, the
    first maximal class over the real (unpadded) classes in chunks of 16."""
    words = packed["records"].view(np.uint32)
    table = packed["leaf_table"]               # (C', rows) f64
    group = kernels.FOREST_GROUP
    pixels = np.arange(xc.shape[1])
    total = np.zeros((table.shape[0], xc.shape[1]))
    for g, depth in enumerate(packed["depths"]):
        node = np.repeat(packed["roots"][g * group:(g + 1) * group, None],
                         xc.shape[1], axis=1)
        for _ in range(depth):
            rec = words[node]
            le = xc[rec[..., 0] & 1023, pixels] <= rec[..., 1].view(np.float32)
            node = (rec[..., 0] >> 10).astype(np.int64) + np.where(le, 0, 1)
        for k in range(group):                 # tree order
            total += table[:, node[k]]
    total = total[:n_classes].astype(np.float32) * np.float32(inv_trees)
    best = np.zeros(xc.shape[1], np.int64)
    best_v = np.full(xc.shape[1], -np.inf, np.float32)
    for c0 in range(0, n_classes, 16):         # chunks: a later one wins
        chunk = total[c0:c0 + 16]              # only when strictly larger
        top = chunk.max(axis=0)
        take = (top > best_v) | (c0 == 0)
        best = np.where(take, c0 + chunk.argmax(axis=0), best)
        best_v = np.where(take, top, best_v)
    return packed["classes"][best]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_pack_forest_walk_gives_the_plain_labels(name):
    _, _, _, _, gf, xc, _ = _fixture(name)
    tgf = tforest.gemm_forest_from_numpy(_numpy_fields(gf))
    want = kernels.forest_labels(tgf, torch.from_numpy(xc)).numpy()
    got = _walk(kernels.pack_forest(tgf), float(tgf.inv_trees),
                tgf.leaf_dist.shape[1], xc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_classes", [1, 4, 20])
def test_forest_walk_rendering_matches_gemm_at_class_counts(n_classes):
    """The kernel's walk at one class (every total one column), four (the
    main path's 4-wide chunk) and twenty (two 16-wide chunks, padded with
    zero classes), against gemm_labels_cm on seeded pixels."""
    rng = np.random.default_rng(40 + n_classes)
    x = rng.random((90, 19)).astype(np.float32)
    y = np.concatenate([np.arange(n_classes),
                        rng.integers(0, n_classes, 90 - n_classes)])
    flat, _ = tforest.fit_random_forest(x, y, n_estimators=7, seed=3)
    gf = tforest._gemm_for(flat, 19)
    assert gf.leaf_dist.shape[1] == n_classes
    packed = kernels.pack_forest(gf)
    width = packed["leaf_table"].shape[0]
    assert width == {1: 4, 4: 4, 20: 32}[n_classes]
    assert not packed["leaf_table"][n_classes:].any()
    xc = rng.random((19, 3000)).astype(np.float32)
    want = kernels.gemm_labels_cm(gf, torch.from_numpy(xc)).numpy()
    got = _walk(packed, float(gf.inv_trees), n_classes, xc)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > (n_classes > 1)    # not one class alone


def test_pack_forest_refuses_forests_outside_the_kernel_contract():
    _, _, _, _, gf, _, _ = _fixture("2_trees_ties")
    fields = _numpy_fields(gf)
    bad_len = dict(fields, path_len=fields["path_len"] + 1)
    with pytest.raises(ValueError, match="path_len"):
        kernels.pack_forest(tforest.gemm_forest_from_numpy(bad_len))
    bad_sel = dict(fields, selector=np.asarray(fields["selector"],
                                               np.float32) * 2)
    with pytest.raises(ValueError, match="one-hot"):
        kernels.pack_forest(tforest.gemm_forest_from_numpy(bad_sel))
    path = np.asarray(fields["path"], np.float32).copy()
    path[:, 1] = path[:, 0]             # two leaves on one path
    plen = np.asarray(fields["path_len"]).copy()
    plen[1] = plen[0]
    not_trees = dict(fields, path=path, path_len=plen)
    with pytest.raises(ValueError, match="binary trees"):
        kernels.pack_forest(tforest.gemm_forest_from_numpy(not_trees))


def test_forest_labels_batched_equals_per_scene():
    _, _, _, _, gf, xc, _ = _fixture("40_trees_grouped")
    tgf = tforest.gemm_forest_from_numpy(_numpy_fields(gf))
    x = torch.from_numpy(xc.reshape(19, 2, -1).transpose(1, 0, 2).copy())
    got = kernels.forest_labels(tgf, x)
    assert got.shape == (2, x.shape[2]) and got.dtype == torch.int32
    for b in range(2):
        assert torch.equal(got[b], kernels.forest_labels(tgf, x[b]))
