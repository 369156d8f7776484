"""Random forest: host-side NumPy training, tensor forms for inference.

Counterpart of ``rs_image_segmentation_tpu.models.forest``. The CART
trainer is the same NumPy code (gini, bootstrap, sqrt feature
subsampling), so one seed gives the same trees in both packages. A trained
``FlatForest`` compiles to a ``GemmForest``: a (F, M) one-hot feature
selector, (M,) thresholds, a (M, L) signed path matrix, (L,) path lengths
and a (L, C) leaf distribution table. Inference over channel-major
features is ``ops.kernels.forest_labels``, for a forest of any size;
``forest_predict`` takes it for (N, F) rows (on a CUDA tensor the kernel,
on a CPU one its plain version). Past ``GEMM_MAX_LEAVES`` the path matrix
is kept as a sparse tensor of its leaf paths, which the kernel's packing
and the plain version read; the JAX package walks such forests level by
level instead.

The JAX package stores ``selector`` and ``path`` as bf16; their values are
exactly 0/+-1, so here they are f32 with the same values.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.kernels import forest_labels, gemm_totals_cm


class FlatForest(NamedTuple):
    """Padded tensor form of a forest (T trees, up to N nodes, C classes).

    Leaves are self-looping: left == right == own index and threshold =
    +inf, so a fixed-depth traversal parks at the leaf."""
    feature: torch.Tensor     # (T, N) int32
    threshold: torch.Tensor   # (T, N) float32
    left: torch.Tensor        # (T, N) int32
    right: torch.Tensor       # (T, N) int32
    leaf_proba: torch.Tensor  # (T, N, C) float32 (class distribution at node)
    classes: torch.Tensor     # (C,) original class labels


class GemmForest(NamedTuple):
    """All-matmul forest form. For a pixel's features x: node m decides
    s = +1 if x @ selector[:, m] <= thresholds[m] else -1; leaf l fires iff
    (s @ path)[:, l] == path_len[l]; the class totals are the fired leaves'
    leaf_dist rows summed, times inv_trees."""
    selector: torch.Tensor    # (F, M) one-hot feature picker, f32
    thresholds: torch.Tensor  # (M,) f32
    path: torch.Tensor        # (M, L) in {-1, 0, +1}, f32
    path_len: torch.Tensor    # (L,) f32
    leaf_dist: torch.Tensor   # (L, C) f32 per-tree distributions (raw)
    inv_trees: torch.Tensor   # () f32, 1 / n_trees
    classes: torch.Tensor     # (C,) int32


def _tensors(cls, fields: dict, dtypes: dict, device):
    """``cls`` of ``fields`` cast to ``dtypes`` on ``device``; a field that
    is already a tensor (a sparse path) is moved and cast as it is."""
    def one(v, dt):
        if isinstance(v, torch.Tensor):
            return v.to(device=device,
                        dtype=torch.from_numpy(np.zeros(0, dt)).dtype)
        return torch.as_tensor(np.asarray(v).astype(dt), device=device)

    return cls(**{k: one(fields[k], dt) for k, dt in dtypes.items()})


_GEMM_DTYPES = {"selector": np.float32, "thresholds": np.float32,
                "path": np.float32, "path_len": np.float32,
                "leaf_dist": np.float32, "inv_trees": np.float32,
                "classes": np.int32}


def gemm_forest_from_numpy(fields: dict, device="cpu") -> GemmForest:
    """A GemmForest from numpy arrays keyed by field name (for example the
    JAX package's GemmForest fields, converted with ``np.asarray``). The
    0/+-1 selector and path take f32, exactly."""
    return _tensors(GemmForest, fields, _GEMM_DTYPES, device)


def flat_forest_from_numpy(fields: dict, device="cpu") -> FlatForest:
    """A FlatForest from numpy arrays keyed by field name."""
    dtypes = {"feature": np.int32, "threshold": np.float32,
              "left": np.int32, "right": np.int32,
              "leaf_proba": np.float32,
              "classes": np.asarray(fields["classes"]).dtype}
    return _tensors(FlatForest, fields, dtypes, device)


def forest_to_gemm(forest: FlatForest, n_features: int) -> GemmForest:
    """Compile a FlatForest into its GEMM form (host-side), on the CPU.
    Trees are walked in order and each tree depth first, left before
    right, so internal-node columns are numbered in preorder and leaves
    are grouped by tree.

    The walk follows the child links, one visit a node; a leaf's path is
    its ancestors' columns, about depth entries a leaf. Within
    ``GEMM_MAX_LEAVES`` the path is a dense (M, L) matrix; past it, a
    sparse COO tensor of those entries, so no (M, L) array is built."""
    feature = forest.feature.cpu().numpy()
    threshold = forest.threshold.cpu().numpy()
    left = forest.left.cpu().numpy()
    right = forest.right.cpu().numpy()
    proba = forest.leaf_proba.cpu().numpy()
    t_count = feature.shape[0]

    sel_rows = []      # feature index per internal node
    thr_vals = []
    leaf_nodes = []    # (tree, node) per leaf
    ent_col, ent_leaf, ent_sign = [], [], []    # the path's nonzeros
    path_len = []
    for t in range(t_count):
        stack = [(0, ())]          # (node, ((column, sign), ...) above it)
        while stack:
            node, trail = stack.pop()
            if left[t, node] == node:  # leaf (self-loop)
                leaf = len(leaf_nodes)
                leaf_nodes.append((t, node))
                path_len.append(len(trail))
                for col, sign in trail:
                    ent_col.append(col)
                    ent_leaf.append(leaf)
                    ent_sign.append(sign)
                continue
            col = len(sel_rows)
            sel_rows.append(feature[t, node])
            thr_vals.append(threshold[t, node])
            # popped left first: the left subtree is numbered before the
            # right, as a recursive preorder walk numbers it
            stack.append((right[t, node], trail + ((col, -1.0),)))
            stack.append((left[t, node], trail + ((col, 1.0),)))

    m = max(len(sel_rows), 1)
    n_leaves = len(leaf_nodes)
    selector = np.zeros((n_features, m), np.float32)
    selector[np.asarray(sel_rows, np.int64), np.arange(len(sel_rows))] = 1.0
    thresholds = (np.asarray(thr_vals, np.float32) if sel_rows
                  else np.zeros(1, np.float32))
    ent_col = np.asarray(ent_col, np.int64)
    ent_leaf = np.asarray(ent_leaf, np.int64)
    ent_sign = np.asarray(ent_sign, np.float32)
    lt, ln = np.asarray(leaf_nodes, np.int64).reshape(-1, 2).T
    if n_leaves <= GEMM_MAX_LEAVES:
        path = np.zeros((m, n_leaves), np.float32)
        path[ent_col, ent_leaf] = ent_sign
    else:
        order = np.lexsort((ent_leaf, ent_col))     # coalesced: row major
        with torch.sparse.check_sparse_tensor_invariants():
            path = torch.sparse_coo_tensor(
                torch.from_numpy(np.stack([ent_col[order], ent_leaf[order]])),
                torch.from_numpy(ent_sign[order]), (m, n_leaves),
                is_coalesced=True)
    return gemm_forest_from_numpy(
        {"selector": selector, "thresholds": thresholds, "path": path,
         "path_len": np.asarray(path_len, np.float32),
         "leaf_dist": proba[lt, ln], "inv_trees": np.float32(1.0 / t_count),
         "classes": forest.classes.cpu().numpy()})


def _pack_trees(trees: Sequence[dict], classes: np.ndarray,
                max_depth: int) -> "tuple[FlatForest, int]":
    t = len(trees)
    max_nodes = max(tr["feature"].shape[0] for tr in trees)
    c = len(classes)
    feature = np.zeros((t, max_nodes), np.int32)
    threshold = np.full((t, max_nodes), np.inf, np.float32)
    left = np.tile(np.arange(max_nodes, dtype=np.int32), (t, 1))
    right = left.copy()
    proba = np.zeros((t, max_nodes, c), np.float32)
    for i, tr in enumerate(trees):
        n = tr["feature"].shape[0]
        is_leaf = tr["left"] < 0
        feature[i, :n] = np.where(is_leaf, 0, tr["feature"])
        threshold[i, :n] = np.where(is_leaf, np.inf, tr["threshold"])
        left[i, :n] = np.where(is_leaf, np.arange(n), tr["left"])
        right[i, :n] = np.where(is_leaf, np.arange(n), tr["right"])
        proba[i, :n] = tr["value"]
    forest = flat_forest_from_numpy(
        {"feature": feature, "threshold": threshold, "left": left,
         "right": right, "leaf_proba": proba, "classes": classes})
    return forest, max_depth


def forest_from_sklearn(clf) -> "tuple[FlatForest, int]":
    """A fitted sklearn ``RandomForestClassifier`` as a FlatForest, read
    through its attributes (``estimators_[i].tree_``, ``classes_``), so
    sklearn need not be importable: each leaf's value becomes its class
    distribution, as ``predict_proba`` reads it. Returns (forest on the
    CPU, max_depth)."""
    trees = []
    max_depth = 1
    for est in clf.estimators_:
        tr = est.tree_
        value = np.asarray(tr.value)[:, 0, :].astype(np.float64)
        norm = value.sum(axis=1, keepdims=True)
        norm[norm == 0] = 1
        trees.append({
            "feature": np.asarray(tr.feature).astype(np.int32),
            "threshold": np.asarray(tr.threshold).astype(np.float32),
            "left": np.asarray(tr.children_left).astype(np.int32),
            "right": np.asarray(tr.children_right).astype(np.int32),
            "value": (value / norm).astype(np.float32),
        })
        max_depth = max(max_depth, int(tr.max_depth))
    return _pack_trees(trees, np.asarray(clf.classes_).copy(), max_depth)


def gemm_forest_proba(gf: GemmForest, x: torch.Tensor,
                      chunk: int = 8192) -> torch.Tensor:
    """Mean forest proba of (N, F) rows: ``ops.kernels.gemm_totals_cm``
    over ``chunk``-row blocks, the sums that ``forest_labels`` takes its
    labels from."""
    return gemm_totals_cm(gf, x.to(torch.float32).T, chunk).T.contiguous()


def gemm_forest_predict(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """Labels of (N, F) rows: ``ops.kernels.forest_labels`` over the rows
    as channel-major features (the kernel on a CUDA tensor), equal to the
    argmax of :func:`gemm_forest_proba` with ties to the lowest class."""
    return forest_labels(gf, x.to(torch.float32).T.contiguous())


# host-side cache: FlatForest buffers -> compiled GemmForest
_GEMM_CACHE: dict = {}
GEMM_MAX_LEAVES = 16384


def n_leaves(forest: FlatForest) -> int:
    """Leaves reachable from the trees' roots, counted level by level
    (leaves loop on themselves; padding nodes are never reached)."""
    left = forest.left.cpu().numpy()
    right = forest.right.cpu().numpy()
    trees = np.arange(left.shape[0])
    nodes = np.zeros_like(trees)
    count = 0
    while trees.size:
        lft, rgt = left[trees, nodes], right[trees, nodes]
        leaf = lft == nodes
        count += int(leaf.sum())
        trees = np.repeat(trees[~leaf], 2)
        nodes = np.stack([lft[~leaf], rgt[~leaf]], axis=1).reshape(-1)
    return count


def _gemm_for(forest: FlatForest, n_features: int) -> GemmForest:
    """The cached GemmForest of ``forest``, of any size: its path is dense
    within GEMM_MAX_LEAVES and sparse past it (:func:`forest_to_gemm`)."""
    key = (id(forest.feature), n_features)
    if key not in _GEMM_CACHE:
        # keep a strong reference to the keyed buffer: id() of a collected
        # tensor can be recycled, which would silently serve the wrong
        # forest
        _GEMM_CACHE[key] = (forest.feature,
                            forest_to_gemm(forest, n_features))
    return _GEMM_CACHE[key][1]


def _gemm_chunk(n_leaves: int) -> int:
    """Row block keeping the (chunk, leaves) intermediates near 64 MB."""
    return max(512, min(65536, (64 << 20) // max(4 * n_leaves, 1)))


def path_entries(gf: GemmForest
                 ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """The nonzeros of ``gf.path`` (dense within GEMM_MAX_LEAVES, sparse
    past it) as ``(leaf, node, sign)`` host arrays ordered by leaf, then
    node: each leaf's path root first, since node columns are numbered in
    preorder."""
    path = gf.path.cpu()
    path = (path if path.is_sparse else path.to_sparse()).coalesce()
    node, leaf = path.indices().numpy()
    sign = path.values().numpy()
    keep = sign != 0
    node, leaf, sign = node[keep], leaf[keep], sign[keep]
    order = np.lexsort((node, leaf))
    return leaf[order], node[order], sign[order]


def dense_path(gf: GemmForest) -> torch.Tensor:
    """``gf.path`` as the dense (M, L) matrix, for the consumers that
    multiply or slice it whole; raises ValueError for a forest past
    GEMM_MAX_LEAVES, whose path is kept sparse."""
    if gf.path.is_sparse:
        raise ValueError(
            f"a forest of {gf.path.shape[1]} leaves is past GEMM_MAX_LEAVES "
            f"({GEMM_MAX_LEAVES}): its path is sparse, and the dense (M, L) "
            "form would take "
            f"{4 * gf.path.shape[0] * gf.path.shape[1] / 1e9:.1f} GB")
    return gf.path


def forest_predict_proba(forest: FlatForest, x: torch.Tensor,
                         max_depth: int, chunk: int = 65536) -> torch.Tensor:
    """Mean forest proba of (N, F) rows on their device, from the GEMM
    form (its path sparse past ``GEMM_MAX_LEAVES``). ``max_depth`` and
    ``chunk`` are unused: they keep the JAX package's signature, which
    the cross-package tests call both packages with."""
    gf = _gemm_for(forest, x.shape[1])
    return gemm_forest_proba(gf, x, _gemm_chunk(gf.path.shape[1]))


def forest_predict(forest: FlatForest, x: torch.Tensor, max_depth: int,
                   chunk: int = 65536) -> torch.Tensor:
    """sklearn's ``predict`` of (N, F) rows on their device: the class of
    the largest mean proba, ties to the lowest index, from
    ``ops.kernels.forest_labels`` (:func:`gemm_forest_predict`) for a
    forest of any size. ``max_depth`` and ``chunk`` are unused: they keep
    the JAX package's signature, with which ``pipeline.classify``,
    ``parallel.sharded``, ``tools.batch``, ``tools.supervised`` and the
    cross-package tests still call it."""
    classes = forest.classes.to(x.device)
    gf = _gemm_for(forest, x.shape[1])
    return gemm_forest_predict(gf, x).to(classes.dtype)


_PLAN_CACHE: dict = {}
_PLAN_MIN_BLOCK = 128
_PLAN_MAX_GROUPS = 32


def forest_tree_plan(gf: GemmForest):
    """Tree-grouping plan of ``gf``: a tuple of ``(m_off, m_cnt, l_off,
    l_cnt)`` per group, trees packed contiguously so each group's
    internal-node columns and leaf rows cover whole trees, each group
    within 128 columns and leaves where trees allow, at most 32 groups.

    None when any tree is a bare leaf, or the forest is too small to split
    (fewer than 256 internal nodes). The JAX package sizes its
    TPU forest kernel by this plan; here it describes the forest's scale.
    Cached by buffer identity like ``_gemm_for``."""
    path = dense_path(gf)
    min_block, max_groups = _PLAN_MIN_BLOCK, _PLAN_MAX_GROUPS
    key = id(gf.path)
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key][1]
    path = path.cpu().numpy()
    m, l = path.shape
    plan = None
    if m >= 2 * min_block and float(gf.path_len.min()) >= 1:
        nz = path != 0
        # every leaf's path includes its tree's root (walk starts there),
        # so the first nonzero row per leaf column is the tree root
        root = nz.argmax(axis=0)
        starts_l = np.concatenate(
            [[0], np.flatnonzero(np.diff(root) != 0) + 1])
        roots = root[starts_l]
        if roots[0] == 0:
            tree_m = np.diff(np.concatenate([roots, [m]]))
            tree_l = np.diff(np.concatenate([starts_l, [l]]))
            bound = max(min_block, int(max(tree_m.max(), tree_l.max())))
            bound = ((bound + min_block - 1) // min_block) * min_block
            groups = []
            t0 = 0
            m_acc = l_acc = 0
            for t in range(len(roots)):
                if (m_acc and (m_acc + int(tree_m[t]) > bound
                               or l_acc + int(tree_l[t]) > bound)
                        and len(groups) < max_groups - 1):
                    m_off = int(roots[t0])
                    l_off = int(starts_l[t0])
                    groups.append((m_off, int(roots[t]) - m_off,
                                   l_off, int(starts_l[t]) - l_off))
                    t0 = t
                    m_acc = l_acc = 0
                m_acc += int(tree_m[t])
                l_acc += int(tree_l[t])
            m_off = int(roots[t0])
            l_off = int(starts_l[t0])
            groups.append((m_off, m - m_off, l_off, l - l_off))
            if len(groups) > 1:
                plan = tuple(groups)
    _PLAN_CACHE[key] = (gf.path, plan)
    return plan


# ----------------------------------------------------------------- training

@dataclasses.dataclass
class _TreeBuilder:
    x: np.ndarray
    y: np.ndarray          # class indices 0..C-1
    n_classes: int
    max_features: int
    max_depth: Optional[int]
    rng: np.random.Generator
    min_samples_split: int = 2
    min_samples_leaf: int = 1

    def __post_init__(self):
        self.feature = []
        self.threshold = []
        self.left = []
        self.right = []
        self.value = []

    def _add_node(self):
        self.feature.append(0)
        self.threshold.append(0.0)
        self.left.append(-1)
        self.right.append(-1)
        self.value.append(None)
        return len(self.feature) - 1

    def build(self, idx: np.ndarray, depth: int = 0) -> int:
        node = self._add_node()
        y = self.y[idx]
        counts = np.bincount(y, minlength=self.n_classes).astype(np.float64)
        self.value[node] = counts
        n = idx.size
        if (n < self.min_samples_split
                or (self.max_depth is not None and depth >= self.max_depth)
                or counts.max() == n):
            return node
        best = self._best_split(idx)
        if best is None:
            return node
        f, thr = best
        go_left = self.x[idx, f] <= thr
        if go_left.all() or not go_left.any():
            return node
        self.feature[node] = f
        self.threshold[node] = thr
        self.left[node] = self.build(idx[go_left], depth + 1)
        self.right[node] = self.build(idx[~go_left], depth + 1)
        return node

    def _best_split(self, idx: np.ndarray):
        n = idx.size
        feats = self.rng.permutation(self.x.shape[1])
        best_gain = -np.inf
        best = None
        y = self.y[idx]
        total = np.bincount(y, minlength=self.n_classes).astype(np.float64)
        gini_parent = 1.0 - ((total / n) ** 2).sum()
        tried = 0
        for f in feats:
            v = self.x[idx, f]
            order = np.argsort(v, kind="stable")
            vs = v[order]
            ys = y[order]
            # candidate splits between distinct values
            distinct = vs[1:] != vs[:-1]
            if not distinct.any():
                continue
            tried += 1
            onehot = np.zeros((n, self.n_classes), np.float64)
            onehot[np.arange(n), ys] = 1
            cum = onehot.cumsum(axis=0)
            nl = np.arange(1, n, dtype=np.float64)
            cl = cum[:-1]
            cr = total[None, :] - cl
            nr = n - nl
            gini_l = 1.0 - ((cl / nl[:, None]) ** 2).sum(axis=1)
            gini_r = 1.0 - ((cr / nr[:, None]) ** 2).sum(axis=1)
            w = (nl * gini_l + nr * gini_r) / n
            w[~distinct] = np.inf
            k = int(np.argmin(w))
            gain = gini_parent - w[k]
            if gain > best_gain:
                best_gain = gain
                thr = (vs[k] + vs[k + 1]) / 2.0
                best = (int(f), float(thr))
            if tried >= self.max_features and best_gain > 0:
                break
        return best


def fit_random_forest(x: np.ndarray, y: np.ndarray, n_estimators: int = 100,
                      max_depth: Optional[int] = None, seed: int = 42,
                      bootstrap: bool = True) -> "tuple[FlatForest, int]":
    """Self-contained RF trainer (NumPy CART, gini, bootstrap, sqrt feature
    subsampling). Returns (FlatForest on the CPU, max_depth)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    classes, y_idx = np.unique(y, return_inverse=True)
    c = len(classes)
    n, f = x.shape
    max_features = max(1, int(np.sqrt(f)))
    rng = np.random.default_rng(seed)
    trees = []
    depth_seen = 1
    for _ in range(n_estimators):
        idx = (rng.integers(0, n, n) if bootstrap
               else np.arange(n))
        tb = _TreeBuilder(x, y_idx, c, max_features, max_depth,
                          np.random.default_rng(rng.integers(0, 2 ** 31)))
        tb.build(idx)
        val = np.stack(tb.value)
        norm = val.sum(axis=1, keepdims=True)
        norm[norm == 0] = 1
        trees.append({
            "feature": np.asarray(tb.feature, np.int32),
            "threshold": np.asarray(tb.threshold, np.float32),
            "left": np.asarray(tb.left, np.int32),
            "right": np.asarray(tb.right, np.int32),
            "value": (val / norm).astype(np.float32),
        })
        depth_seen = max(depth_seen, _tree_depth(trees[-1]))
    return _pack_trees(trees, classes, depth_seen)


def _tree_depth(tr: dict) -> int:
    left, right = tr["left"], tr["right"]

    def depth(i):
        if left[i] < 0:
            return 1
        return 1 + max(depth(left[i]), depth(right[i]))

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        return depth(0)
    finally:
        sys.setrecursionlimit(old)
