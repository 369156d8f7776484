"""The benchmark's random forest: a CART trainer and the rule labels it is
fitted on.

Frozen copy of ``rs_image_segmentation_tpu_torch/models/forest.py``
(``_TreeBuilder``, ``fit_random_forest``, ``_pack_trees``,
``_tree_depth``) and of ``tools/fixtures.py::rule_labels`` /
``rule_forest``'s first sample count, at commit
3b8722c442acffa7c4dd38665a58daa3434fcab6. NumPy CART: gini, bootstrap,
sqrt feature subsampling. The result is a dict of padded numpy arrays
(the port's ``FlatForest`` fields), which the benchmark hands to both the
program and the reference.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np


@dataclasses.dataclass
class _TreeBuilder:
    x: np.ndarray
    y: np.ndarray          # class indices 0..C-1
    n_classes: int
    max_features: int
    max_depth: Optional[int]
    rng: np.random.Generator
    min_samples_split: int = 2

    def __post_init__(self):
        self.feature, self.threshold = [], []
        self.left, self.right, self.value = [], [], []

    def _add_node(self) -> int:
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
        best_gain, best = -np.inf, None
        y = self.y[idx]
        total = np.bincount(y, minlength=self.n_classes).astype(np.float64)
        gini_parent = 1.0 - ((total / n) ** 2).sum()
        tried = 0
        for f in feats:
            v = self.x[idx, f]
            order = np.argsort(v, kind="stable")
            vs, ys = v[order], y[order]
            distinct = vs[1:] != vs[:-1]
            if not distinct.any():
                continue
            tried += 1
            onehot = np.zeros((n, self.n_classes), np.float64)
            onehot[np.arange(n), ys] = 1
            cl = onehot.cumsum(axis=0)[:-1]
            nl = np.arange(1, n, dtype=np.float64)
            cr = total[None, :] - cl
            nr = n - nl
            gini_l = 1.0 - ((cl / nl[:, None]) ** 2).sum(axis=1)
            gini_r = 1.0 - ((cr / nr[:, None]) ** 2).sum(axis=1)
            wgt = (nl * gini_l + nr * gini_r) / n
            wgt[~distinct] = np.inf
            k = int(np.argmin(wgt))
            gain = gini_parent - wgt[k]
            if gain > best_gain:
                best_gain = gain
                best = (int(f), float((vs[k] + vs[k + 1]) / 2.0))
            if tried >= self.max_features and best_gain > 0:
                break
        return best


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    def depth(i):
        return 1 if left[i] < 0 else 1 + max(depth(left[i]), depth(right[i]))

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        return depth(0)
    finally:
        sys.setrecursionlimit(old)


def fit_random_forest(x: np.ndarray, y: np.ndarray, n_estimators: int = 100,
                      seed: int = 42):
    """``(fields, max_depth)``: a forest of ``n_estimators`` CART trees on
    (N, F) ``x`` and labels ``y``, as padded numpy arrays ``feature``,
    ``threshold``, ``left``, ``right`` (leaves loop on themselves with an
    infinite threshold), ``leaf_proba`` (T, nodes, C) and ``classes``."""
    x = np.asarray(x, np.float32)
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    n, f = x.shape
    rng = np.random.default_rng(seed)
    trees, depth_seen = [], 1
    for _ in range(n_estimators):
        idx = rng.integers(0, n, n)
        tree_rng = np.random.default_rng(rng.integers(0, 2 ** 31))
        tb = _TreeBuilder(x, y_idx, len(classes), max(1, int(np.sqrt(f))),
                          None, tree_rng)
        tb.build(idx)
        val = np.stack(tb.value)
        norm = val.sum(axis=1, keepdims=True)
        norm[norm == 0] = 1
        trees.append((np.asarray(tb.feature, np.int32),
                      np.asarray(tb.threshold, np.float32),
                      np.asarray(tb.left, np.int32),
                      np.asarray(tb.right, np.int32),
                      (val / norm).astype(np.float32)))
        depth_seen = max(depth_seen, _tree_depth(trees[-1][2], trees[-1][3]))
    t, m = len(trees), max(tr[0].shape[0] for tr in trees)
    fields = {"feature": np.zeros((t, m), np.int32),
              "threshold": np.full((t, m), np.inf, np.float32),
              "left": np.tile(np.arange(m, dtype=np.int32), (t, 1)),
              "right": np.tile(np.arange(m, dtype=np.int32), (t, 1)),
              "leaf_proba": np.zeros((t, m, len(classes)), np.float32),
              "classes": classes.astype(np.int32)}
    for i, (feat, thr, lft, rgt, val) in enumerate(trees):
        k = feat.shape[0]
        leaf = lft < 0
        fields["feature"][i, :k] = np.where(leaf, 0, feat)
        fields["threshold"][i, :k] = np.where(leaf, np.inf, thr)
        fields["left"][i, :k] = np.where(leaf, np.arange(k), lft)
        fields["right"][i, :k] = np.where(leaf, np.arange(k), rgt)
        fields["leaf_proba"][i, :k] = val
    return fields, depth_seen


def rule_labels(stack: np.ndarray, pick: np.ndarray) -> np.ndarray:
    """Classes 1..4 of the pixels ``pick`` of a (19, H, W) stack: above or
    below the samples' median NDVI (channel 2) and NDWI (channel 0)."""
    flat = stack.reshape(stack.shape[0], -1)
    ndvi, ndwi = flat[2, pick], flat[0, pick]
    return 1 + (ndvi > np.median(ndvi)) + 2 * (ndwi > np.median(ndwi))


def rule_forest(stack: np.ndarray, samples: int, n_estimators: int,
                seed: int):
    """``(fields, max_depth)``: the forest fitted on :func:`rule_labels` of
    ``samples`` pixels of ``stack`` drawn with ``seed``."""
    flat = stack.reshape(stack.shape[0], -1)
    pick = np.random.default_rng(seed).choice(flat.shape[1], samples,
                                              replace=False)
    return fit_random_forest(flat[:, pick].T, rule_labels(stack, pick),
                             n_estimators, seed)
