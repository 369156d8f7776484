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


@pytest.mark.parametrize("name", list(FIXTURES))
def test_pack_forest_trees_round_trip_to_path(name):
    _, _, trees, _, gf, _, _ = _fixture(name)
    tgf = tforest.gemm_forest_from_numpy(_numpy_fields(gf))
    packed = kernels.pack_forest(tgf)
    nodes = packed["nodes"]
    path = np.asarray(gf.path.astype(jnp.float32))
    rebuilt = np.zeros_like(path)
    reached = np.zeros(path.shape[1], int)

    def down(at, trail):
        if at < 0:
            reached[~at] += 1
            for nd, sign in trail:
                rebuilt[nd, ~at] = sign
            return
        down(nodes[at, 2], trail + [(at, 1.0)])
        down(nodes[at, 3], trail + [(at, -1.0)])

    assert len(packed["roots"]) == trees
    for root in packed["roots"]:
        down(root, [])
    assert (reached == 1).all()
    np.testing.assert_array_equal(rebuilt, path)
    sel = np.asarray(gf.selector.astype(jnp.float32))
    used = np.flatnonzero(path.any(axis=1))
    assert np.array_equal(nodes[used, 0], sel.argmax(axis=0)[used])
    assert np.array_equal(nodes[:, 1].view(np.float32),
                          np.asarray(gf.thresholds))


def _walk(packed, inv_trees, xc):
    """The kernel's per-pixel tree walk rendered in numpy: (F, N) -> (N,)."""
    nodes, dist = packed["nodes"], packed["leaf_dist"].astype(np.float64)
    thr = nodes[:, 1].view(np.float32)
    pixels = np.arange(xc.shape[1])
    total = np.zeros((xc.shape[1], dist.shape[1]))
    for root in packed["roots"]:
        at = np.full(xc.shape[1], root)
        while (at >= 0).any():
            live = at >= 0
            nd = at[live]
            le = xc[nodes[nd, 0], pixels[live]] <= thr[nd]
            at[live] = np.where(le, nodes[nd, 2], nodes[nd, 3])
        total += dist[~at]
    total = total.astype(np.float32) * np.float32(inv_trees)
    return packed["classes"][np.argmax(total, axis=1)]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_pack_forest_walk_gives_the_plain_labels(name):
    _, _, _, _, gf, xc, _ = _fixture(name)
    tgf = tforest.gemm_forest_from_numpy(_numpy_fields(gf))
    want = kernels.forest_labels(tgf, torch.from_numpy(xc)).numpy()
    got = _walk(kernels.pack_forest(tgf), float(tgf.inv_trees), xc)
    np.testing.assert_array_equal(got, want)


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
