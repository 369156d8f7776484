"""Fixed-stencil filters as shift-and-add over explicitly padded inputs.

Counterpart of ``rs_image_segmentation_tpu.ops.stencil``: box, Gaussian
(OpenCV's small tables), Laplacian, Sobel and the Gabor bank. Every tap is a slice of
the padded input and weighted taps are summed as a pairwise tree in the
JAX package's order, so results match it to a rounding step in f32 (XLA
may fuse a tap's multiply into the add). The JAX package takes a
convolution for kernels of more than 32 taps (the 15 x 15 Gabor
kernels); here they are shift-and-add too, summed in another order. No
convolution library runs, so TF32 never applies.

Border conventions (OpenCV):
  * ``reflect101`` (cv2.BORDER_DEFAULT, "gfedcb|abcdefgh"): np.pad 'reflect'.
  * ``reflect``    (cv2.BORDER_REFLECT, "fedcba|abcdefgh"): np.pad 'symmetric'.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import math

import numpy as np
import torch

_PAD_MODE = {"reflect101": "reflect", "reflect": "symmetric"}

# (length, pads, np.pad mode, device) -> the padded index ramp on the device
_PAD_INDEX: Dict[tuple, torch.Tensor] = {}


def pad_index(n: int, pads: Tuple[int, int], mode: str,
              device: torch.device) -> torch.Tensor:
    """``np.pad(np.arange(n), pads, mode)`` as an int64 tensor on
    ``device``, copied there once per key: later calls copy nothing from
    the host, so a stencil on a CUDA tensor neither waits for a pageable
    copy nor blocks a CUDA graph capture. np.pad of an index ramp is
    numpy's own border rule for every mode."""
    key = (n, pads, mode, device)
    idx = _PAD_INDEX.get(key)
    if idx is None:
        idx = _PAD_INDEX[key] = torch.from_numpy(
            np.pad(np.arange(n), pads, mode=mode)).to(device)
    return idx


def _pad_axis(x: torch.Tensor, pads: Tuple[int, int], dim: int,
              mode: str) -> torch.Tensor:
    if pads == (0, 0):
        return x
    return x.index_select(dim, pad_index(x.shape[dim], pads, mode, x.device))


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


_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]),
}


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel: OpenCV's fixed tables for ksize <= 7 with
    sigma <= 0; otherwise sigma <= 0 means 0.3 * ((ksize - 1) * 0.5 - 1) +
    0.8."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize].copy()
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0,
                  border: str = "reflect101") -> torch.Tensor:
    """cv2.GaussianBlur in f32, separable."""
    k = gaussian_kernel1d(ksize, sigma)
    return _sep_conv(x, k, k, border)


def gaussian_blur_u8(x_u8: torch.Tensor, ksize: int, sigma: float = 0.0
                     ) -> torch.Tensor:
    """GaussianBlur of a uint8 image, rounded half to even and saturated
    to uint8 (within 1 LSB of cv2's fixed-point path)."""
    out = gaussian_blur(x_u8.to(torch.float32), ksize, sigma)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


_LAPLACIAN_K = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=np.float32)
_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
_SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32)


def laplacian(x: torch.Tensor, border: str = "reflect101") -> torch.Tensor:
    """cv2.Laplacian(ksize=1)."""
    return conv2d_same(x, _LAPLACIAN_K, border)


def sobel_xy(x: torch.Tensor, border: str = "reflect101"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.Sobel(dx=1) and (dy=1) with ksize 3."""
    return conv2d_same(x, _SOBEL_X, border), conv2d_same(x, _SOBEL_Y, border)


def sobel_magnitude(x: torch.Tensor, border: str = "reflect101"
                    ) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) of :func:`sobel_xy`."""
    gx, gy = sobel_xy(x, border)
    return torch.sqrt(gx * gx + gy * gy)


def gabor_kernel(ksize: int, sigma: float, theta: float, lambd: float,
                 gamma: float, psi: float = 0.0) -> np.ndarray:
    """cv2.getGaborKernel (CV_32F)."""
    half = ksize // 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    x_t = x * math.cos(theta) + y * math.sin(theta)
    y_t = -x * math.sin(theta) + y * math.cos(theta)
    k = np.exp(-(x_t ** 2 + (gamma ** 2) * (y_t ** 2)) / (2.0 * sigma ** 2))
    k *= np.cos(2.0 * math.pi * x_t / lambd + psi)
    return k.astype(np.float32)


def gabor_bank_params(num_scales: int = 4, num_orientations: int = 6
                      ) -> List[Tuple[int, float, float, float, float]]:
    """The reference's Gabor bank: scales logspace(-1, 0.5, 4), thetas
    arange(0, pi, pi/6), ksize max(5, odd(int(5 * scale))), sigma = scale,
    lambd = 10 * scale, gamma 0.5."""
    params = []
    for s in np.logspace(-1, 0.5, num=num_scales):
        ks = int(5 * s)
        if ks % 2 == 0:
            ks += 1
        ks = max(ks, 5)
        for t in np.arange(0, np.pi, np.pi / num_orientations):
            params.append((ks, float(s), float(t), float(10 * s), 0.5))
    return params


def gabor_responses(band_u8: torch.Tensor, num_scales: int = 4,
                    num_orientations: int = 6) -> List[torch.Tensor]:
    """The 24 Gabor responses of a uint8 band, each min-max normalised to
    [0, 1]."""
    x = band_u8.to(torch.float32)
    out = []
    for ks, sigma, theta, lambd, gamma in gabor_bank_params(
            num_scales, num_orientations):
        r = conv2d_same(x, gabor_kernel(ks, sigma, theta, lambd, gamma))
        out.append((r - torch.min(r)) / (torch.max(r) - torch.min(r) + 1e-10))
    return out
