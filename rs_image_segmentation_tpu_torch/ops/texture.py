"""Texture: GLCM co-occurrence properties, uniform LBP, windowed entropy.

Counterpart of ``rs_image_segmentation_tpu.ops.texture``.

* GLCM, ``backend="xla"`` (the default, the JAX package's XLA route):
  integer ``scatter_add`` counts where the JAX package uses bf16 one-hot
  einsums (both exact), then the properties in f32. ``backend="kernel"``
  is the counterpart of the JAX ``"pallas"`` backend: the CUDA kernel
  ``ops.kernels.glcm_grid`` (on a CPU tensor its plain version).
* LBP: skimage's ``local_binary_pattern(method='uniform')`` from static
  bilinear taps.
* Entropy: skimage's rank entropy over a disk, from per-level counts of
  one-hot planes, chunked over the levels.

Every GLCM function takes any leading batch shape; LBP and entropy take
``(..., H, W)`` as well.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import glcm_grid
from .resize import resize_bilinear

GLCM_PROPS = ("contrast", "dissimilarity", "homogeneity", "energy",
              "correlation")


def _offset_for_angle(distance: int, angle: float) -> Tuple[int, int]:
    """skimage.graycomatrix convention: (row, col) offset =
    (round(sin(a)*d), round(cos(a)*d))."""
    return (int(round(math.sin(angle) * distance)),
            int(round(math.cos(angle) * distance)))


def _extract_windows(q: torch.Tensor, window: int, step: int
                     ) -> torch.Tensor:
    """(..., H, W) -> (..., N, window, window) windows at stride ``step``,
    row-major over the window grid."""
    win = q.unfold(-2, window, step).unfold(-2, window, step)
    n_i, n_j = win.shape[-4], win.shape[-3]
    return win.reshape(*q.shape[:-2], n_i * n_j, window, window)


def glcm_matrices(windows: torch.Tensor, levels: int,
                  distances: Sequence[int], angles: Sequence[float]
                  ) -> torch.Tensor:
    """Symmetric, normalised co-occurrence matrices for a batch of
    quantized windows.

    windows: (..., N, ws, ws) int in [0, levels). Returns (..., N, D, A,
    levels, levels) float32, matching skimage.graycomatrix(symmetric=True,
    normed=True) per window."""
    *lead, ws, _ = windows.shape
    flat_w = windows.reshape(-1, ws, ws).long()
    n = flat_w.shape[0]
    out = []
    for d in distances:
        per_angle = []
        for a in angles:
            dr, dc = _offset_for_angle(d, a)
            r0, r1 = max(0, -dr), min(ws, ws - dr)
            c0, c1 = max(0, -dc), min(ws, ws - dc)
            src = flat_w[:, r0:r1, c0:c1].reshape(n, -1)
            dst = flat_w[:, r0 + dr:r1 + dr, c0 + dc:c1 + dc].reshape(n, -1)
            counts = torch.zeros(n, levels * levels, dtype=torch.int32,
                                 device=windows.device)
            counts.scatter_add_(1, src * levels + dst,
                                torch.ones_like(src, dtype=torch.int32))
            per_angle.append(counts.reshape(n, levels, levels))
        out.append(torch.stack(per_angle, dim=1))
    glcm = torch.stack(out, dim=1).to(torch.float32)     # (N, D, A, L, L)
    glcm = glcm + glcm.transpose(-1, -2)
    s = torch.sum(glcm, dim=(-1, -2), keepdim=True)
    glcm = glcm / torch.where(s > 0, s, 1.0)
    return glcm.reshape(*lead, *glcm.shape[1:])


def glcm_properties(glcm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The five props over (..., L, L) normalized GLCMs — skimage.graycoprops
    formulas, vectorized over all leading axes."""
    levels = glcm.shape[-1]
    ar = torch.arange(levels, dtype=torch.float32, device=glcm.device)
    i = ar[:, None]
    j = ar[None, :]
    diff = i - j
    dims = (-1, -2)
    contrast = torch.sum(glcm * diff ** 2, dim=dims)
    dissimilarity = torch.sum(glcm * torch.abs(diff), dim=dims)
    homogeneity = torch.sum(glcm / (1.0 + diff ** 2), dim=dims)
    asm = torch.sum(glcm * glcm, dim=dims)
    energy = torch.sqrt(asm)
    mean_i = torch.sum(glcm * i, dim=dims)
    mean_j = torch.sum(glcm * j, dim=dims)
    var_i = torch.sum(glcm * (i - mean_i[..., None, None]) ** 2, dim=dims)
    var_j = torch.sum(glcm * (j - mean_j[..., None, None]) ** 2, dim=dims)
    std = torch.sqrt(var_i * var_j)
    cov = torch.sum(glcm * (i - mean_i[..., None, None])
                    * (j - mean_j[..., None, None]), dim=dims)
    flat = std < 1e-15
    correlation = torch.where(flat, 1.0, cov / torch.where(flat, 1.0, std))
    return {"contrast": contrast, "dissimilarity": dissimilarity,
            "homogeneity": homogeneity, "energy": energy,
            "correlation": correlation}


def glcm_feature_maps(band01: torch.Tensor, levels: int = 32,
                      window_size: int = 21, step_size: int = 21,
                      distances: Sequence[int] = (1,),
                      angles: Sequence[float] = (0.0, math.pi / 4,
                                                 math.pi / 2, 3 * math.pi / 4),
                      backend: str = "xla",
                      ) -> Dict[str, torch.Tensor]:
    """GLCM stage on a [0,1]-normalized (..., H, W) band: quantize ->
    windowed co-occurrence -> props -> mean over distances and angles ->
    bilinear resize back to (H, W).

    ``backend="xla"`` (default): the JAX package's XLA route, f32 props of
    the normalised matrices. ``backend="kernel"``: the counterpart of the
    JAX ``"pallas"`` backend, ``ops.kernels.glcm_grid`` (the CUDA kernel,
    or its plain version on a CPU tensor); distance 1 only, and
    ``step_size == window_size``."""
    h, w = band01.shape[-2:]
    q = (band01 * (levels - 1)).to(torch.uint8).to(torch.int64)
    n_i = (h - window_size) // step_size + 1
    n_j = (w - window_size) // step_size + 1
    lead = band01.shape[:-2]
    if backend == "kernel":
        if tuple(distances) != (1,):
            raise ValueError("the GLCM kernel supports distance 1 only")
        offsets = tuple(_offset_for_angle(1, a) for a in angles)
        grids = glcm_grid(q.reshape(-1, h, w).to(torch.int32), levels,
                          window_size, step_size, offsets).reshape(
                              *lead, n_i, n_j, 5)
        return {name: resize_bilinear(grids[..., k], (h, w))
                for k, name in enumerate(GLCM_PROPS)}
    if backend != "xla":
        raise ValueError(f"backend must be 'xla' or 'kernel', not "
                         f"{backend!r}")
    windows = _extract_windows(q, window_size, step_size)
    props = glcm_properties(glcm_matrices(windows, levels, distances, angles))
    return {name: resize_bilinear(
                torch.mean(v, dim=(-2, -1)).reshape(*lead, n_i, n_j), (h, w))
            for name, v in props.items()}


# ---------------------------------------------------------------------- LBP

@functools.lru_cache(maxsize=None)
def _lbp_sample_weights(n_points: int, radius: float):
    """Static bilinear taps of each circular sample point (skimage: rp =
    -R sin(2 pi i/P), cp = R cos(2 pi i/P), rounded to 5 decimals)."""
    taps = []
    for k in range(n_points):
        rp = round(-radius * math.sin(2 * math.pi * k / n_points), 5)
        cp = round(radius * math.cos(2 * math.pi * k / n_points), 5)
        r0, c0 = math.floor(rp), math.floor(cp)
        fr, fc = rp - r0, cp - c0
        taps.append(tuple(((dy, dx), wgt) for dy, dx, wgt in (
            (r0, c0, (1 - fr) * (1 - fc)), (r0, c0 + 1, (1 - fr) * fc),
            (r0 + 1, c0, fr * (1 - fc)), (r0 + 1, c0 + 1, fr * fc))
            if wgt > 0.0))
    return tuple(taps)


def lbp_uniform(band_u8: torch.Tensor, n_points: int = 24,
                radius: float = 3.0) -> torch.Tensor:
    """skimage.local_binary_pattern(method='uniform'): f32 codes in [0,
    n_points + 1], the popcount of the circular sign pattern where it has
    at most 2 transitions (counted over the linear sequence), else
    n_points + 1. Samples outside the image read 0."""
    x = band_u8.to(torch.float32)
    h, w = x.shape[-2:]
    pad = int(math.ceil(radius)) + 1
    xp = F.pad(x, (pad, pad, pad, pad))
    signs: List[torch.Tensor] = []
    for taps in _lbp_sample_weights(n_points, radius):
        gp = None
        for (dy, dx), wgt in taps:
            term = xp[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w] * \
                float(np.float32(wgt))
            gp = term if gp is None else gp + term
        signs.append((gp - x) >= 0.0)
    s = torch.stack(signs, dim=0).to(torch.int32)        # (P, ..., H, W)
    changes = torch.sum((s[1:] != s[:-1]).to(torch.int32), dim=0)
    code = torch.where(changes <= 2, torch.sum(s, dim=0), n_points + 1)
    return code.to(torch.float32)


def lbp_feature(band01: torch.Tensor, n_points: int = 24,
                radius: float = 3.0) -> torch.Tensor:
    """The reference's LBP feature: scale to uint8, uniform LBP, divide by
    the largest code present (per trailing plane)."""
    code = lbp_uniform((band01 * 255.0).to(torch.uint8), n_points, radius)
    return code / torch.amax(code, dim=(-2, -1), keepdim=True)


# ------------------------------------------------------------------- entropy

@functools.lru_cache(maxsize=None)
def disk_footprint(radius: int) -> np.ndarray:
    """skimage.morphology.disk."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


def _disk_spans(radius: int):
    """Per-row contiguous spans (dy, dx0, dx1) of the disk footprint."""
    fp = disk_footprint(radius)
    spans = []
    for i in range(2 * radius + 1):
        row = np.nonzero(fp[i])[0]
        spans.append((i - radius, int(row.min()) - radius,
                      int(row.max()) - radius))
    return tuple(spans)


def _window_sum(x: torch.Tensor, lo: int, hi: int, dim: int) -> torch.Tensor:
    """``out[i] = sum(x[i + lo : i + hi + 1])`` along ``dim``, zero outside,
    as a difference of a running sum: exact for integer-valued f32 sums
    below 2**24."""
    n = x.shape[dim]
    pads = [0, 0] * (x.dim() - 1 - dim) + [max(0, -lo) + 1, max(0, hi)]
    cs = torch.cumsum(F.pad(x, pads), dim=dim)
    base = max(0, -lo) + 1
    return (cs.narrow(dim, base + hi, n) - cs.narrow(dim, base + lo - 1, n))


def _span_count(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum of integer-valued ``(..., H, W)`` over the disk footprint, zero
    outside the image: one horizontal window sum per distinct span width,
    then a vertical window sum per run of rows that share it (exact below
    2**24)."""
    widths: Dict[Tuple[int, int], List[int]] = {}
    for dy, dx0, dx1 in _disk_spans(radius):
        widths.setdefault((dx0, dx1), []).append(dy)
    h_dim, w_dim = x.dim() - 2, x.dim() - 1
    out = None
    for (dx0, dx1), dys in widths.items():
        row = _window_sum(x, dx0, dx1, w_dim)
        dys = sorted(dys)
        runs = [[dys[0], dys[0]]]
        for d in dys[1:]:
            if d == runs[-1][1] + 1:
                runs[-1][1] = d
            else:
                runs.append([d, d])
        for lo, hi in runs:
            v = _window_sum(row, lo, hi, h_dim)
            out = v if out is None else out + v
    return out


def windowed_entropy_u8(band_u8: torch.Tensor, radius: int,
                        levels: int = 256, chunk: int = 32) -> torch.Tensor:
    """Local Shannon entropy (bits) of a uint8 ``(..., H, W)`` band over a
    disk footprint, normalised by the footprint pixels inside the image
    (skimage.filters.rank.entropy). Per-level counts are exact, ``chunk``
    one-hot levels at a time: 32 levels of a 600 x 600 band hold 46 MB
    where all 256 would hold 369 MB (the JAX package's default chunk is
    256; the sum over levels then runs in another order)."""
    total = _span_count(torch.ones(band_u8.shape[-2:], dtype=torch.float32,
                                   device=band_u8.device), radius)
    vals = band_u8.to(torch.int32)
    ent = torch.zeros(band_u8.shape, dtype=torch.float32,
                      device=band_u8.device)
    for lo in range(0, levels, chunk):
        lv = torch.arange(lo, min(lo + chunk, levels), dtype=torch.int32,
                          device=band_u8.device)
        onehot = (vals[None] == lv.reshape(-1, *([1] * vals.dim()))).to(
            torch.float32)
        p = _span_count(onehot, radius) / total
        ent = ent - torch.sum(torch.where(
            p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0), dim=0)
    return ent


def entropy_feature(band01: torch.Tensor, radius: int) -> torch.Tensor:
    """The reference's multi-scale entropy feature: uint8 quantize, rank
    entropy over disk(radius), divided by its maximum (per trailing
    plane)."""
    ent = windowed_entropy_u8((band01 * 255.0).to(torch.uint8), radius)
    return ent / torch.amax(ent, dim=(-2, -1), keepdim=True)
