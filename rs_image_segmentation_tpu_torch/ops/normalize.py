"""Percentile and stretch normalisation.

Counterpart of ``rs_image_segmentation_tpu.ops.normalize``. The percentile
is a sort with ``np.percentile``'s linear interpolation, its position and
weights in f32 as in the JAX package. ``robust_normalize`` and
``minmax_stretch_u8`` reduce over the trailing two dims, so a ``(C, H,
W)`` stack is normalised band by band (the JAX package's ``vmap``).
"""

from __future__ import annotations

import torch


def _interp(srt: torch.Tensor, q) -> torch.Tensor:
    """Linear-interpolation quantiles of rows sorted ascending along the
    last dim: ``(..., n)`` -> ``(len(q), ...)``."""
    n = srt.shape[-1]
    qt = torch.as_tensor(q, dtype=torch.float32).reshape(-1)
    pos = qt / 100.0 * (n - 1)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = (pos - lo.to(torch.float32)).to(srt.device)
    lo, hi = lo.to(srt.device), hi.to(srt.device)
    v_lo = srt.index_select(-1, lo).movedim(-1, 0)
    v_hi = srt.index_select(-1, hi).movedim(-1, 0)
    shape = (-1,) + (1,) * (srt.dim() - 1)
    return (v_lo * (1.0 - frac.reshape(shape))
            + v_hi * frac.reshape(shape))


def percentile(x: torch.Tensor, q) -> torch.Tensor:
    """``np.percentile(method='linear')`` over the flattened input; ``q``
    a scalar or a sequence of percentiles in [0, 100]."""
    srt = torch.sort(x.reshape(-1).to(torch.float32)).values
    out = _interp(srt, q)
    return out[0] if torch.as_tensor(q).dim() == 0 else out


def robust_normalize(band: torch.Tensor, lower_percentile: float = 2.0,
                     upper_percentile: float = 98.0,
                     epsilon: float = 1e-10) -> torch.Tensor:
    """Clip each trailing ``(H, W)`` plane to its [p_lo, p_hi] percentiles,
    then scale to [0, 1]."""
    band = band.to(torch.float32)
    h, w = band.shape[-2:]
    srt = torch.sort(band.reshape(*band.shape[:-2], h * w), dim=-1).values
    p = _interp(srt, [lower_percentile, upper_percentile])
    lo, hi = p[0][..., None, None], p[1][..., None, None]
    return (torch.clamp(band, lo, hi) - lo) / (hi - lo + epsilon)


def minmax01(x: torch.Tensor, epsilon: float = 1e-10) -> torch.Tensor:
    """Min-max scale to [0, 1] over the whole input."""
    x = x.to(torch.float32)
    mn, mx = torch.min(x), torch.max(x)
    return (x - mn) / (mx - mn + epsilon)


def minmax_stretch_f32(band: torch.Tensor) -> torch.Tensor:
    """Per trailing ``(H, W)`` plane ``(x - min) * 255 / (max - min)`` in
    f32, before the truncation of :func:`minmax_stretch_u8`."""
    band = band.to(torch.float32)
    mn = torch.amin(band, dim=(-2, -1), keepdim=True)
    mx = torch.amax(band, dim=(-2, -1), keepdim=True)
    return (band - mn) * 255.0 / (mx - mn)


def minmax_stretch_u8(band: torch.Tensor) -> torch.Tensor:
    """Linear stretch of each trailing ``(H, W)`` plane to [0, 255],
    truncated to uint8 (the reference's ``astype(np.uint8)``, no
    rounding)."""
    return minmax_stretch_f32(band).to(torch.uint8)


def quantize_levels(band01: torch.Tensor, levels: int) -> torch.Tensor:
    """A [0, 1] band to ``levels`` gray levels by truncation:
    ``(band * (levels - 1)).astype(np.uint8)``."""
    return (band01 * (levels - 1)).to(torch.uint8)
