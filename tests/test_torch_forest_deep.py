"""Forests of any size on the port's main path, on the CPU: the kernel's
packing read from child links (the GemmForest's sparse path past
``GEMM_MAX_LEAVES``) byte-equal within the cap to the dense-path packing of
the port before sparse paths (a frozen copy below), and past the cap the
plain version, ``forest_predict``, the numpy rendering of the kernel's
walk and the routes that launch ``forest_labels`` against the plain walk
of ``tests/forest_walk_ref.py``."""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig,
                                                         GLCMConfig)
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.parallel import forest_tp
from rs_image_segmentation_tpu_torch.parallel.pipeline_pp import (
    pp_classify_scenes)
from rs_image_segmentation_tpu_torch.pipeline import large_scene, turbo
from rs_image_segmentation_tpu_torch.pipeline.features import (
    hierarchical_stack_fused)
from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
    build_stretch_lut)
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    deep_forest_fields, synthetic_scenes)
from rs_image_segmentation_tpu_torch.utils.timing import span, spans
from tests.forest_walk_ref import fields_of, walk_labels
from tests.test_torch_forest import _walk

CPU = "cpu"
CFG = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                         levels=8))
CAL = CalibrationConfig()
GAINS, BIASES = np.asarray(CAL.gains), np.asarray(CAL.biases)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Small tensors gain nothing from many intra-op threads; other test
    workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------- the dense-path packing, frozen copy

def _dense_gemm(forest, n_features):
    """``models.forest.forest_to_gemm`` as it was before sparse paths:
    a recursive preorder walk into a dense (M, L) path."""
    feature = forest.feature.numpy()
    threshold = forest.threshold.numpy()
    left, right = forest.left.numpy(), forest.right.numpy()
    proba = forest.leaf_proba.numpy()
    sel_rows, thr_vals, paths, leaf_dists = [], [], [], []
    for t in range(feature.shape[0]):
        node_col = {}

        def walk(node, trail):
            if left[t, node] == node:
                paths.append(list(trail))
                leaf_dists.append(proba[t, node])
                return
            if node not in node_col:
                node_col[node] = len(sel_rows)
                sel_rows.append(feature[t, node])
                thr_vals.append(threshold[t, node])
            col = node_col[node]
            walk(left[t, node], trail + [(col, 1.0)])
            walk(right[t, node], trail + [(col, -1.0)])

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(100000)
        try:
            walk(0, [])
        finally:
            sys.setrecursionlimit(old)
    m, n_leaves = len(sel_rows), len(paths)
    selector = np.zeros((n_features, max(m, 1)), np.float32)
    for col, f in enumerate(sel_rows):
        selector[f, col] = 1.0
    thresholds = (np.asarray(thr_vals, np.float32) if m
                  else np.zeros(1, np.float32))
    path = np.zeros((max(m, 1), n_leaves), np.float32)
    path_len = np.zeros(n_leaves, np.float32)
    for li, trail in enumerate(paths):
        path_len[li] = len(trail)
        for col, sign in trail:
            path[col, li] = sign
    return tforest.gemm_forest_from_numpy(
        {"selector": selector, "thresholds": thresholds, "path": path,
         "path_len": path_len, "leaf_dist": np.stack(leaf_dists),
         "inv_trees": np.float32(1.0 / feature.shape[0]),
         "classes": forest.classes.numpy()})


def _dense_links(gf):
    """``ops.kernels._tree_links`` before sparse paths: a loop over the
    dense path's leaves."""
    path = gf.path.numpy()
    leaf, node = np.nonzero(path.T)
    m, n_leaves = path.shape
    counts = np.bincount(leaf, minlength=n_leaves)
    child = np.full((m, 2), np.iinfo(np.int32).max, np.int64)
    roots = {}
    starts = np.concatenate([[0], np.cumsum(counts)])
    for lf in range(n_leaves):
        trail = node[starts[lf]:starts[lf + 1]]
        roots[int(trail[0]) if trail.size else ~lf] = None
        sides = (path[trail, lf] < 0).astype(np.int64)
        for nd, side, to in zip(trail, sides, [*trail[1:], ~lf]):
            child[nd, side] = to
    return child, list(roots)


def _dense_packing(gf):
    """``ops.kernels.pack_forest`` before sparse paths (its checks left
    out): the same slots, from the dense path's links."""
    child, roots = _dense_links(gf)
    feature = gf.selector.numpy().argmax(axis=0)
    thr_bits = gf.thresholds.numpy().astype(np.float32).view(np.int32)
    n_leaves = gf.path.shape[1]
    depth_of = {}

    def depth(ref):
        if ref < 0:
            return 0
        if ref not in depth_of:
            depth_of[ref] = 1 + max(depth(int(child[ref, 0])),
                                    depth(int(child[ref, 1])))
        return depth_of[ref]

    group_n = kernels.FOREST_GROUP
    trees = roots + [~n_leaves] * (-len(roots) % group_n)
    records, rows, slot_roots, depths = [], [], [], []
    for g in range(0, len(trees), group_n):
        group = trees[g:g + group_n]
        d = max(depth(r) for r in group)
        depths.append(d)
        queue = []
        for ref in group:
            space = records if d > 0 else rows
            slot_roots.append(len(space))
            space.append(None)
            queue.append(((slot_roots[-1],), ref, d))
        for slots, ref, left in queue:
            if left == 0:
                for s in slots:
                    rows[s] = ~ref
                continue
            space = records if left > 1 else rows
            kids = len(space)
            space.extend([None, None])
            if ref >= 0:
                rec = [int(feature[ref]) | kids << 10, int(thr_bits[ref]),
                       ref]
                queue.append(((kids,), int(child[ref, 0]), left - 1))
                queue.append(((kids + 1,), int(child[ref, 1]), left - 1))
            else:
                rec = [kids << 10, 0, -1]
                queue.append(((kids, kids + 1), ref, left - 1))
            for s in slots:
                records[s] = rec
    rec = np.asarray(records, np.int64).reshape(-1, 3)
    n_classes = gf.leaf_dist.shape[1]
    width = (4 if n_classes <= 4 else 8 if n_classes <= 8
             else -(-n_classes // 16) * 16)
    dist = np.zeros((n_leaves + 1, width))
    dist[:n_leaves, :n_classes] = gf.leaf_dist.numpy()
    row_leaf = np.asarray(rows, np.int64)
    return {
        "records": np.ascontiguousarray(
            rec[:, :2].astype(np.uint32).view(np.int32)),
        "leaf_table": np.ascontiguousarray(dist[row_leaf].T),
        "roots": np.asarray(slot_roots, np.int32),
        "depths": np.asarray(depths, np.int32),
        "classes": gf.classes.numpy().astype(np.int32),
        "record_node": rec[:, 2].astype(np.int32),
        "row_leaf": row_leaf.astype(np.int32),
    }


# ------------------------------------------------------------- forests

@pytest.fixture(scope="module")
def stack():
    """The port's turbo stack of a 7 x 64 x 80 synthetic scene, (19, H, W)
    host numpy."""
    raw = synthetic_scenes(1, 64, 80, seed=21)[0]
    lut = build_stretch_lut(raw, GAINS, BIASES).astype(np.uint8)
    return turbo.hierarchical_stack_turbo_cm(raw, lut, CFG,
                                             device=CPU).numpy()


def _class_labels(stack, pick, n_classes):
    """Classes 1..n_classes of the pixels ``pick``: NDVI (channel 2)
    quantile bins, NDWI (channel 0) splitting each bin in two for even
    counts."""
    flat = stack.reshape(stack.shape[0], -1)
    ndvi, ndwi = flat[2, pick], flat[0, pick]
    if n_classes % 2 == 0:
        bins = n_classes // 2
        edges = np.quantile(ndvi, np.linspace(0, 1, bins + 1)[1:-1])
        return (1 + 2 * np.digitize(ndvi, edges)
                + (ndwi > np.median(ndwi)))
    edges = np.quantile(ndvi, np.linspace(0, 1, n_classes + 1)[1:-1])
    return 1 + np.digitize(ndvi, edges)


def _cart(stack, samples, n_classes=4, trees=100):
    flat = stack.reshape(stack.shape[0], -1)
    pick = np.random.default_rng(samples).choice(flat.shape[1], samples,
                                                 replace=False)
    forest, _ = tforest.fit_random_forest(
        flat[:, pick].T, _class_labels(stack, pick, n_classes),
        n_estimators=trees, seed=42)
    return forest


def _one_leaf_trees(stack):
    """A forest whose every third tree is one leaf (no decision)."""
    fields = fields_of(_cart(stack, 33, trees=9))
    for t in range(0, 9, 3):
        fields["left"][t] = np.arange(fields["left"].shape[1])
        fields["right"][t] = fields["left"][t]
        fields["threshold"][t] = np.inf
    return tforest.flat_forest_from_numpy(fields)


WITHIN_CAP = {
    "cart_33": lambda s: _cart(s, 33),
    "cart_2000": lambda s: _cart(s, 2000),
    "complete_depth_10": lambda s: tforest.flat_forest_from_numpy(
        deep_forest_fields(s, depth=10)),
    "one_leaf_trees": _one_leaf_trees,
    "classes_2": lambda s: _cart(s, 300, n_classes=2, trees=20),
    "classes_7": lambda s: _cart(s, 300, n_classes=7, trees=20),
}


@pytest.mark.parametrize("name", list(WITHIN_CAP))
def test_child_link_packing_equals_the_dense_path_packing(stack, name):
    """Within the cap the GemmForest equals the dense one field for field,
    and the kernel's packing, read from its links (dense path or the same
    path made sparse), is byte-equal to the dense-path packing."""
    flat = WITHIN_CAP[name](stack)
    gf = tforest.forest_to_gemm(flat, 19)
    dense = _dense_gemm(flat, 19)
    assert not gf.path.is_sparse
    for k in tforest.GemmForest._fields:
        a, b = getattr(gf, k), getattr(dense, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    want = _dense_packing(dense)
    if name == "classes_7":
        assert want["leaf_table"].shape[0] == 8
    for got in (kernels.pack_forest(gf),
                kernels.pack_forest(gf._replace(path=gf.path.to_sparse()))):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def deep(stack):
    """``deep_forest_fields`` over the stack: five complete depth-12
    trees, 20 480 leaves: ``(fields, FlatForest, GemmForest)``."""
    fields = deep_forest_fields(stack)
    flat = tforest.flat_forest_from_numpy(fields)
    return fields, flat, tforest._gemm_for(flat, 19)


def test_gemm_for_past_the_cap_holds_no_m_by_l_array(deep):
    _, flat, gf = deep
    m, n_leaves = gf.path.shape
    assert n_leaves == tforest.n_leaves(flat) == 20480 > \
        tforest.GEMM_MAX_LEAVES
    assert isinstance(gf, tforest.GemmForest)
    assert all(isinstance(t, torch.Tensor) for t in gf)
    assert gf.path.is_sparse and gf.path.is_coalesced()
    # one entry a level of each leaf's path
    assert gf.path._nnz() == int(gf.path_len.sum()) == 12 * n_leaves
    sizes = [t._nnz() * 3 if t.is_sparse else t.numel() for t in gf]
    assert max(sizes) < m * n_leaves // 100
    # moved field by field, as a caller moves it to its device
    moved = tforest.GemmForest(*(t.to(CPU) for t in gf))
    assert moved.path.is_sparse
    with pytest.raises(ValueError, match="past GEMM_MAX_LEAVES"):
        tforest.dense_path(gf)


def test_past_the_cap_plain_version_and_predict_equal_the_walk(deep, stack):
    fields, flat, gf = deep
    x = torch.from_numpy(stack.reshape(19, -1))
    want = walk_labels(fields, x.T)
    kernels.forest_labels.launches = 0
    got = kernels.forest_labels(gf, x)
    assert kernels.forest_labels.launches == 0     # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        tforest.forest_predict(flat, x.T.contiguous(), 12).numpy(),
        want.numpy())
    assert len(np.unique(want.numpy())) > 1
    # the kernel's walk, rendered in numpy, on the packing of the sparse path
    packed = kernels.pack_forest(gf)
    assert kernels.forest_instance(gf) == "global"
    np.testing.assert_array_equal(
        _walk(packed, float(gf.inv_trees), 4, x.numpy()), want.numpy())


def test_cart_forest_past_a_patched_cap_equals_the_walk(stack, monkeypatch):
    monkeypatch.setattr(tforest, "GEMM_MAX_LEAVES", 64)
    flat = _cart(stack, 300, trees=20)
    gf = tforest.forest_to_gemm(flat, 19)
    assert gf.path.is_sparse and gf.path.shape[1] > 64
    x = torch.from_numpy(stack.reshape(19, -1))
    want = walk_labels(fields_of(flat), x.T).numpy()
    np.testing.assert_array_equal(kernels.forest_labels(gf, x).numpy(), want)
    np.testing.assert_array_equal(
        _walk(kernels.pack_forest(gf), float(gf.inv_trees), 4, x.numpy()),
        want)
    # the packing does not depend on the path's form
    dense = _dense_packing(_dense_gemm(flat, 19))
    for k, v in kernels.pack_forest(gf).items():
        assert v.tobytes() == dense[k].tobytes(), k


def test_pack_forest_checks_the_child_index_width(stack, monkeypatch):
    """A record keeps a child index in 32 - 10 bits; a forest with more
    slots is refused (here with the index narrowed to 6 bits)."""
    gf = tforest.forest_to_gemm(_cart(stack, 33, trees=9), 19)
    monkeypatch.setattr(kernels, "_FEATURE_BITS", 26)
    with pytest.raises(ValueError, match="too many slots"):
        kernels.pack_forest(gf)


def test_deep_chain_packs_without_a_depth_limit():
    """One tree of 1 500 levels (a chain: each node's left child a leaf)
    packs past Python's recursion limit, its group padded to its depth."""
    n = 1500
    nodes = 2 * n + 1
    idx = np.arange(nodes, dtype=np.int32)
    inner = idx % 2 == 0
    inner[-1] = False
    fields = {"feature": np.where(inner, idx % 19, 0)[None].astype(np.int32),
              "threshold": np.where(inner, idx / nodes, np.inf)[None]
              .astype(np.float32),
              "left": np.where(inner, idx + 1, idx)[None].astype(np.int32),
              "right": np.where(inner, idx + 2, idx)[None].astype(np.int32),
              "leaf_proba": np.random.default_rng(0).dirichlet(
                  np.ones(3), (1, nodes)).astype(np.float32),
              "classes": np.arange(1, 4, dtype=np.int32)}
    gf = tforest.forest_to_gemm(tforest.flat_forest_from_numpy(fields), 19)
    packed = kernels.pack_forest(gf)
    assert packed["depths"].tolist() == [n]
    x = np.random.default_rng(1).random((19, 500)).astype(np.float32)
    np.testing.assert_array_equal(
        _walk(packed, float(gf.inv_trees), 3, x),
        walk_labels(fields, torch.from_numpy(x).T).numpy())


def test_parallel_dense_consumers_refuse_a_sparse_path(deep):
    _, _, gf = deep
    with pytest.raises(ValueError, match="past GEMM_MAX_LEAVES"):
        forest_tp.pad_gemm_leaves(gf, 2)
    with pytest.raises(ValueError, match="past GEMM_MAX_LEAVES"):
        tforest.forest_tree_plan(gf)


# --------------------------------------------------------------- routes

def _recording(monkeypatch, module):
    """Wrap ``module.forest_labels``: every call's (features, labels)."""
    calls = []
    inner = module.forest_labels

    def wrapped(gf, x_cm):
        out = inner(gf, x_cm)
        calls.append((x_cm.clone(), out.clone()))
        return out

    monkeypatch.setattr(module, "forest_labels", wrapped)
    return calls


def _walked(fields, x_cm):
    x3 = x_cm if x_cm.dim() == 3 else x_cm[None]
    return torch.stack([walk_labels(fields, xb.T) for xb in x3]).reshape(
        x_cm.shape[:-2] + x_cm.shape[-1:])


def test_turbo_batch_past_the_cap_equals_the_walk(deep, monkeypatch):
    fields, _, gf = deep
    scenes = synthetic_scenes(2, 48, 56, seed=22)
    luts = np.stack([build_stretch_lut(s, GAINS, BIASES)
                     for s in scenes]).astype(np.uint8)
    calls = _recording(monkeypatch, turbo)
    maps = turbo.classify_scenes_turbo(scenes, luts, gf, CFG, device=CPU)
    (x_cm, labels), = calls                       # one call a batch
    assert x_cm.shape == (2, 19, 48 * 56)
    walked = _walked(fields, x_cm)
    np.testing.assert_array_equal(labels.numpy(), walked.numpy())
    np.testing.assert_array_equal(
        maps.numpy(), walked.reshape(2, 48, 56).numpy().astype(np.uint8))
    assert len(np.unique(maps.numpy())) > 1


def test_streamed_large_scene_past_the_cap_equals_the_walk(deep,
                                                          monkeypatch):
    fields, _, gf = deep
    raw = synthetic_scenes(1, 100, 72, seed=23)[0]
    calls = _recording(monkeypatch, large_scene)
    labels = large_scene.classify_large_scene_streamed(
        raw, gf, CAL, CFG, tile_rows=40, device=CPU)
    assert len(calls) == 3                        # one call a tile
    rows = []
    for x_cm, out in calls:
        walked = walk_labels(fields, x_cm.T)
        np.testing.assert_array_equal(out.numpy(), walked.numpy())
        rows.append(walked.reshape(-1, 72))
    np.testing.assert_array_equal(labels, torch.cat(rows).numpy())
    assert len(np.unique(labels)) > 1


def test_stage_pipeline_past_the_cap_equals_the_walk(deep):
    """``parallel.pipeline_pp`` moves the forest field by field to its
    stage-3 device (a sparse path stays sparse) and labels with
    ``forest_labels``: equal to the plain walk over the stage-2 stack."""
    fields, _, gf = deep
    raw = synthetic_scenes(2, 40, 48, seed=24)
    scenes = [np.stack([build_stretch_lut(r, GAINS, BIASES)[c][r[c]]
                        for c in range(7)]).astype(np.float32) for r in raw]
    got = pp_classify_scenes(scenes, gf, CFG, devices=[CPU, CPU])
    for s, g in zip(scenes, got):
        stack = hierarchical_stack_fused(s, CFG, device=CPU)
        want = walk_labels(fields, stack.reshape(-1, 19))
        np.testing.assert_array_equal(g, want.reshape(40, 48).numpy())


def test_forest_spans_count_the_walk(deep):
    """Under a profiler ``forest_labels`` is marked ``forest.labels`` with
    its pixels, the pixel-steps of the fixed-depth walk, the tables'
    bytes and the instance; the first call's packing ``forest.pack`` with
    the leaves and records."""
    _, flat, _ = deep
    gf = tforest.forest_to_gemm(flat, 19)         # a fresh packing
    x = torch.rand((2, 19, 300))
    with span("unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        kernels.forest_labels(gf, x)
        kernels.forest_labels(gf, x[0])
    recs = spans()
    labels = [r for r in recs if r.name == "forest.labels"]
    pack, = [r for r in recs if r.name == "forest.pack"]
    packed = kernels.pack_forest(gf)
    walk = kernels.FOREST_GROUP * int(packed["depths"].sum())
    assert walk == 4 * 2 * 12                     # 5 trees + 3 fillers
    table = packed["records"].nbytes + packed["leaf_table"].nbytes
    assert [r.counts for r in labels] == [
        {"pixels": px, "walk_steps": px * walk, "table_bytes": table,
         "global_instance": 1} for px in (600, 300)]
    assert pack.parent == labels[0].id
    assert pack.counts == {"leaves": 20480,
                           "records": packed["records"].shape[0]}
