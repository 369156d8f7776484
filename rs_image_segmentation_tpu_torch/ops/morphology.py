"""Grayscale morphology with rectangular elements (min/max stencils).

Counterpart of the rect-element part of
``rs_image_segmentation_tpu.ops.morphology``: separable 1-D min/max
windows over the trailing two dims. Out-of-image pixels never win the
min/max (OpenCV's morphology default): the border pads with +/-inf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _morph(x: torch.Tensor, ksize: int, reduce_fn, init: float
           ) -> torch.Tensor:
    xf = x.to(torch.float32)
    half = ksize // 2
    out = _reduce_window_1d(xf, ksize, -half, x.ndim - 1, reduce_fn, init)
    out = _reduce_window_1d(out, ksize, -half, x.ndim - 2, reduce_fn, init)
    return out.to(x.dtype)


def erode(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Min filter over a ksize x ksize rect."""
    return _morph(x, ksize, torch.minimum, float("inf"))


def dilate(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Max filter over a ksize x ksize rect (symmetric about the anchor)."""
    return _morph(x, ksize, torch.maximum, float("-inf"))


def gradient(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Morphological gradient with a rect element: dilate - erode,
    subtracted in f32 and cast back to ``x``'s dtype (no uint8 wraparound)."""
    d = dilate(x, ksize).to(torch.float32)
    e = erode(x, ksize).to(torch.float32)
    return (d - e).to(x.dtype)
