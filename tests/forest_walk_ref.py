"""Plain reference for the port's forest labels: every tree of a forest's
fields walked from its root in plain torch, one decision ``x[f] <= t`` a
level until the node loops on itself (a leaf), the leaves' class
distributions summed in f64 (exact for these f32 values in any order),
the mean taken as the port's float32 proba is (the sum rounded once to
f32, times 1 / trees in f32), the label the class of the largest mean
with ties to the lowest. It imports neither JAX nor the port, so it holds
the port's packing, kernel and plain versions to an independent walk."""

from __future__ import annotations

import numpy as np
import torch


def walk_labels(fields: dict, x: torch.Tensor, chunk: int = 1 << 15
                ) -> torch.Tensor:
    """Labels of (N, F) rows ``x`` under the forest ``fields`` (numpy
    ``feature``, ``threshold``, ``left``, ``right``, ``leaf_proba``,
    ``classes``; leaves loop on themselves) -> (N,) int64 class labels, on
    ``x``'s device."""
    dev = x.device

    def table(name, dtype):
        return torch.from_numpy(np.asarray(fields[name]).astype(dtype)).to(dev)

    feat, thr = table("feature", np.int64), table("threshold", np.float32)
    left, right = table("left", np.int64), table("right", np.int64)
    proba, classes = table("leaf_proba", np.float64), table("classes",
                                                            np.int64)
    x = x.to(torch.float32)
    trees = torch.arange(feat.shape[0], device=dev)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=dev)
    for s in range(0, x.shape[0], chunk):
        xb = x[s:s + chunk]
        node = torch.zeros((xb.shape[0], trees.numel()), dtype=torch.int64,
                           device=dev)
        while True:
            inner = left[trees, node] != node
            if not bool(inner.any()):
                break
            xv = torch.gather(xb, 1, feat[trees, node])
            step = torch.where(xv <= thr[trees, node], left[trees, node],
                               right[trees, node])
            node = torch.where(inner, step, node)
        totals = proba[trees, node].sum(dim=1)          # (n, C) f64
        mean = totals.to(torch.float32) * torch.tensor(
            1.0 / trees.numel(), dtype=torch.float32, device=dev)
        # torch.argmax returns the first maximal index: ties to the lowest
        out[s:s + chunk] = classes[torch.argmax(mean, dim=1)]
    return out


def fields_of(forest) -> dict:
    """Numpy fields of a port ``FlatForest`` (or any named tuple of
    tensors with its field names)."""
    return {k: np.asarray(v.cpu()) for k, v in forest._asdict().items()}
