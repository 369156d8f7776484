"""Fixed-stencil filters as shift-and-add over explicitly padded inputs.

Counterpart of ``rs_image_segmentation_tpu.ops.stencil`` (``box_filter``,
``sobel_magnitude`` and the helpers they need). Every tap is a slice of
the padded input and weighted taps are summed as a pairwise tree in the
JAX package's order, so results match it to a rounding step in f32 (XLA
may fuse a tap's multiply into the add). No convolution library runs, so
TF32 never applies.

Border conventions (OpenCV):
  * ``reflect101`` (cv2.BORDER_DEFAULT, "gfedcb|abcdefgh"): np.pad 'reflect'.
  * ``reflect``    (cv2.BORDER_REFLECT, "fedcba|abcdefgh"): np.pad 'symmetric'.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_PAD_MODE = {"reflect101": "reflect", "reflect": "symmetric"}


def _pad_axis(x: torch.Tensor, pads: Tuple[int, int], dim: int,
              mode: str) -> torch.Tensor:
    if pads == (0, 0):
        return x
    # np.pad of an index ramp is numpy's own border rule for every mode
    idx = np.pad(np.arange(x.shape[dim]), pads, mode=mode)
    return x.index_select(dim, torch.from_numpy(idx).to(x.device))


def pad2d(x: torch.Tensor, pad_h: Tuple[int, int], pad_w: Tuple[int, int],
          border: str = "reflect101") -> torch.Tensor:
    """Pad the trailing two dims of ``x`` with a reflecting border."""
    mode = _PAD_MODE[border]
    x = _pad_axis(x, tuple(pad_h), x.ndim - 2, mode)
    return _pad_axis(x, tuple(pad_w), x.ndim - 1, mode)


def _tree_sum(terms: List[torch.Tensor]) -> torch.Tensor:
    # pairwise, in the JAX package's order (sequential accumulation of
    # many taps drifts further from cv2's fixed-point result)
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def conv2d_same(x: torch.Tensor, kernel: np.ndarray,
                border: str = "reflect101") -> torch.Tensor:
    """'Same' 2-D correlation of (..., H, W) with a small static kernel
    (cv2.filter2D semantics, anchor at (kh//2, kw//2)) as shift-and-add
    over its nonzero taps."""
    kf = np.asarray(kernel, np.float32)
    kh, kw = kf.shape
    ah, aw = kh // 2, kw // 2
    xp = pad2d(x, (ah, kh - 1 - ah), (aw, kw - 1 - aw), border).to(
        torch.float32)
    h, w = x.shape[-2], x.shape[-1]
    terms = []
    for i in range(kh):
        for j in range(kw):
            wgt = float(kf[i, j])
            if wgt == 0.0:
                continue
            tap = xp[..., i:i + h, j:j + w]
            terms.append(tap if wgt == 1.0 else tap * wgt)
    return _tree_sum(terms)


def _axis_shift_add(x: torch.Tensor, k: np.ndarray, axis: int,
                    border: str, out_len: int) -> torch.Tensor:
    """1-D 'same' correlation along ``axis`` as a sum of shifted slices."""
    n = k.shape[0]
    a = n // 2
    pads = (a, n - 1 - a)
    if axis == x.ndim - 2:
        xp = pad2d(x, pads, (0, 0), border)
    else:
        xp = pad2d(x, (0, 0), pads, border)
    xp = xp.to(torch.float32)
    kf = np.asarray(k, np.float32)
    terms = []
    for i in range(n):
        wgt = float(kf[i])
        if wgt == 0.0:
            continue
        tap = xp.narrow(axis, i, out_len)
        terms.append(tap if wgt == 1.0 else tap * wgt)
    return _tree_sum(terms)


def _sep_conv(x: torch.Tensor, kv: np.ndarray, kh: np.ndarray,
              border: str) -> torch.Tensor:
    """Separable 'same' conv: column kernel ``kv`` then row kernel ``kh``."""
    out = _axis_shift_add(x, kv, x.ndim - 2, border, x.shape[-2])
    return _axis_shift_add(out, kh, x.ndim - 1, border, x.shape[-1])


def box_filter(x: torch.Tensor, ksize: int, border: str = "reflect101"
               ) -> torch.Tensor:
    """Mean filter. cv2.blur uses reflect101; the spatial-context
    boxFilter uses BORDER_REFLECT (``border='reflect'``)."""
    k = np.full(ksize, 1.0 / ksize)     # separable: (1/k)(1/k) == 1/k^2
    return _sep_conv(x, k, k, border)


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
_SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32)


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) of cv2.Sobel(dx=1) and (dy=1), ksize 3,
    reflect101 border."""
    gx = conv2d_same(x, _SOBEL_X)
    gy = conv2d_same(x, _SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy)
