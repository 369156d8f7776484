"""Thresholding: the comparison mask of the rule programs, Otsu's threshold
and the median fallback.

Counterpart of ``rs_image_segmentation_tpu.ops.threshold``. Otsu runs in
f32 over a 256-bin histogram with the JAX package's formulas, and returns
the first bin of a plateau of the between-class variance.
"""

from __future__ import annotations

import torch

from . import kernels
from .normalize import percentile


def histogram256(x_u8: torch.Tensor) -> torch.Tensor:
    """(256,) f32 counts of a uint8 image (exact below 2^24 pixels)."""
    return kernels.histogram256(x_u8.reshape(1, -1)).to(torch.float32)


def otsu_threshold_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold of a uint8 image as an f32 scalar: the first bin
    that maximises the between-class variance. Foreground is ``> t``."""
    hist = histogram256(x_u8)
    total = torch.sum(hist)
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    w0 = torch.cumsum(hist, dim=0)              # count <= t
    sum0 = torch.cumsum(hist * bins, dim=0)
    w1 = total - w0
    mu0 = torch.where(w0 > 0, sum0 / torch.where(w0 > 0, w0, 1.0), 0.0)
    mu1 = torch.where(w1 > 0, (sum0[-1] - sum0)
                      / torch.where(w1 > 0, w1, 1.0), 0.0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    between = torch.where((w0 > 0) & (w1 > 0), between, -1.0)
    return torch.argmax(between).to(torch.float32)


def threshold_binary(x: torch.Tensor, threshold: float,
                     above: bool = True) -> torch.Tensor:
    """uint8 mask of ``x > threshold`` (``x < threshold`` with
    ``above=False``), NaNs read as 0 first. A Python ``threshold`` is
    compared in ``x``'s dtype, as the JAX package compares a weak-typed
    scalar."""
    x = torch.nan_to_num(x, nan=0.0)
    mask = (x > threshold) if above else (x < threshold)
    return mask.to(torch.uint8)


def threshold_otsu(x: torch.Tensor, above: bool = True) -> torch.Tensor:
    """{0, 1} uint8 Otsu mask of a float image through the reference's
    min-max rescale to uint8. A constant image gives all 0 (``above``) or
    all 1."""
    x = torch.nan_to_num(x.to(torch.float32), nan=0.0)
    mn, mx = torch.min(x), torch.max(x)
    degenerate = mx == mn
    scale = torch.where(degenerate, 1.0, mx - mn + 1e-10)
    norm = torch.clamp((x - mn) / scale * 255.0, 0, 255).to(torch.uint8)
    mask = (norm.to(torch.float32) > otsu_threshold_u8(norm)).to(torch.uint8)
    mask = torch.where(degenerate, 0, mask).to(torch.uint8)
    return mask if above else (1 - mask).to(torch.uint8)


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of the flattened input (the reference's fallback when Otsu
    fails)."""
    return percentile(x, 50.0)
