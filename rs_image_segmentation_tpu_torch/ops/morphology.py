"""Grayscale morphology with rectangular or OpenCV-ellipse elements
(min/max stencils).

Counterpart of ``rs_image_segmentation_tpu.ops.morphology``: separable
1-D min/max windows over the trailing two dims for a rect; for an ellipse,
one horizontal window per distinct row span of the element, then a
vertical window over each run of rows that share it. Out-of-image pixels
never win the min/max (OpenCV's morphology default): the border pads with
+/-inf.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def ellipse_element(ksize: int) -> Tuple[Tuple[int, int], ...]:
    """Offsets ``(dy, dx)`` of OpenCV's MORPH_ELLIPSE structuring element
    of size ``ksize`` (cv2.getStructuringElement parity), relative to the
    anchor."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    offs = []
    for i in range(ksize):
        dy = i - r
        dx = c * np.sqrt(max((r * r - dy * dy) * inv_r2, 0.0))
        j1 = max(int(round(c - dx)), 0)
        j2 = min(int(round(c + dx + 1)), ksize)
        offs.extend((dy, j - c) for j in range(j1, j2))
    return tuple(offs)


@functools.lru_cache(maxsize=None)
def _ellipse_spans(ksize: int) -> Tuple[Tuple[int, int, int], ...]:
    """Per-row contiguous spans (dy, dx0, dx1) of the ellipse element."""
    rows: Dict[int, List[int]] = {}
    for dy, dx in ellipse_element(ksize):
        rows.setdefault(dy, []).append(dx)
    return tuple((dy, min(dxs), max(dxs)) for dy, dxs in sorted(rows.items()))


def _reduce_window_1d(x: torch.Tensor, window: int, lo: int, dim: int,
                      reduce_fn, init: float) -> torch.Tensor:
    """Same-size 1-D reduce over ``dim``: ``out[i] = reduce(x[i+lo :
    i+lo+window])`` with out-of-range reading ``init``."""
    if window == 1 and lo == 0:
        return x
    n = x.shape[dim]
    before, after = -lo, window - 1 + lo
    pads = [0, 0] * (x.ndim - 1 - dim) + [before, after]
    xp = F.pad(x, pads, mode="constant", value=init)
    out = xp.narrow(dim, 0, n)
    for i in range(1, window):
        out = reduce_fn(out, xp.narrow(dim, i, n))
    return out


def _runs(values: List[int]) -> List[Tuple[int, int]]:
    """Sorted integers grouped into runs of consecutive values (lo, hi)."""
    values = sorted(values)
    runs = [[values[0], values[0]]]
    for v in values[1:]:
        if v == runs[-1][1] + 1:
            runs[-1][1] = v
        else:
            runs.append([v, v])
    return [(lo, hi) for lo, hi in runs]


def _morph(x: torch.Tensor, ksize: int, shape: str, reduce_fn,
           init: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    h_dim, w_dim = x.ndim - 2, x.ndim - 1
    half = ksize // 2
    if shape == "rect":
        out = _reduce_window_1d(xf, ksize, -half, w_dim, reduce_fn, init)
        out = _reduce_window_1d(out, ksize, -half, h_dim, reduce_fn, init)
        return out.to(x.dtype)
    if shape != "ellipse":
        raise ValueError(f"shape must be 'rect' or 'ellipse', not {shape!r}")
    widths: Dict[Tuple[int, int], List[int]] = {}
    for dy, dx0, dx1 in _ellipse_spans(ksize):
        widths.setdefault((dx0, dx1), []).append(dy)
    out = None
    for (dx0, dx1), dys in widths.items():
        row = _reduce_window_1d(xf, dx1 - dx0 + 1, dx0, w_dim, reduce_fn, init)
        for lo, hi in _runs(dys):
            v = _reduce_window_1d(row, hi - lo + 1, lo, h_dim, reduce_fn, init)
            out = v if out is None else reduce_fn(out, v)
    return out.to(x.dtype)


def erode(x: torch.Tensor, ksize: int, shape: str = "rect") -> torch.Tensor:
    """Min filter over a ksize x ksize ``shape`` ('rect' or 'ellipse')."""
    return _morph(x, ksize, shape, torch.minimum, float("inf"))


def dilate(x: torch.Tensor, ksize: int, shape: str = "rect") -> torch.Tensor:
    """Max filter over a ksize x ksize ``shape``. OpenCV reflects the
    element about the anchor; both elements are symmetric."""
    return _morph(x, ksize, shape, torch.maximum, float("-inf"))


def opening(x: torch.Tensor, ksize: int, shape: str = "rect") -> torch.Tensor:
    """Erode, then dilate."""
    return dilate(erode(x, ksize, shape), ksize, shape)


def closing(x: torch.Tensor, ksize: int, shape: str = "rect") -> torch.Tensor:
    """Dilate, then erode."""
    return erode(dilate(x, ksize, shape), ksize, shape)


def gradient(x: torch.Tensor, ksize: int, shape: str = "rect"
             ) -> torch.Tensor:
    """Morphological gradient: dilate - erode, subtracted in f32 and cast
    back to ``x``'s dtype (no uint8 wraparound)."""
    d = dilate(x, ksize, shape).to(torch.float32)
    e = erode(x, ksize, shape).to(torch.float32)
    return (d - e).to(x.dtype)
