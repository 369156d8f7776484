"""GLCM texture: windowed co-occurrence matrices and their properties.

Counterpart of the GLCM part of ``rs_image_segmentation_tpu.ops.texture``
(its default XLA route). The JAX package counts co-occurrences with bf16
one-hot einsums; here they are integer ``scatter_add`` counts. Both are
exact, so the normalised matrices are equal. Every function takes any
leading batch shape.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from .resize import resize_bilinear


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
                      ) -> Dict[str, torch.Tensor]:
    """GLCM stage on a [0,1]-normalized (..., H, W) band: quantize ->
    windowed co-occurrence -> props -> mean over distances and angles ->
    bilinear resize back to (H, W)."""
    h, w = band01.shape[-2:]
    q = (band01 * (levels - 1)).to(torch.uint8).to(torch.int64)
    n_i = (h - window_size) // step_size + 1
    n_j = (w - window_size) // step_size + 1
    windows = _extract_windows(q, window_size, step_size)
    props = glcm_properties(glcm_matrices(windows, levels, distances, angles))
    lead = band01.shape[:-2]
    return {name: resize_bilinear(
                torch.mean(v, dim=(-2, -1)).reshape(*lead, n_i, n_j), (h, w))
            for name, v in props.items()}
