"""PCA with robust (median/IQR) or min-max scaling.

Counterpart of ``rs_image_segmentation_tpu.models.pca``: per-column
percentiles by sort, the covariance as one f32 matmul (TF32 off on CUDA,
``backend.resolve_device``), and ``torch.linalg.eigh`` of the small F x F
matrix, which is the SVD of the centred data. Each component's sign
follows sklearn's ``svd_flip(u_based_decision=False)``: its entry of
largest magnitude is made positive, so the sign does not depend on the
eigensolver.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.normalize import percentile


class PCAResult(NamedTuple):
    components: torch.Tensor                # (k, F) principal axes (rows)
    explained_variance: torch.Tensor        # (k,)
    explained_variance_ratio: torch.Tensor  # (k,)
    transformed: torch.Tensor               # (N, k) projected data
    mean: torch.Tensor                      # (F,) centre used by PCA


def robust_scale(x: torch.Tensor) -> torch.Tensor:
    """sklearn.RobustScaler on (N, F): median centre, IQR scale (a zero IQR
    scales by 1)."""
    cols = []
    for f in range(x.shape[1]):
        q = percentile(x[:, f], [25.0, 50.0, 75.0])
        iqr = q[2] - q[0]
        scale = torch.where(iqr > 0, iqr, 1.0)
        cols.append((x[:, f] - q[1]) / scale)
    return torch.stack(cols, dim=1)


def minmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-column min-max scale of (N, F) to [0, 1] (a flat column by 1)."""
    mn = torch.amin(x, dim=0, keepdim=True)
    mx = torch.amax(x, dim=0, keepdim=True)
    return (x - mn) / torch.where(mx - mn > 0, mx - mn, 1.0)


def pca_fit_transform(x: torch.Tensor, n_components: Optional[int] = None,
                      use_robust_scaling: bool = True) -> PCAResult:
    """PCA of (N, F) data after robust or min-max scaling, centred by the
    mean (sklearn-equivalent up to f32 rounding)."""
    x = x.to(torch.float32)
    n, f = x.shape
    k = n_components or f
    xs = robust_scale(x) if use_robust_scaling else minmax_scale(x)
    mean = torch.mean(xs, dim=0)
    xc = xs - mean
    cov = (xc.T @ xc) / (n - 1)
    eigvals, eigvecs = torch.linalg.eigh(cov)           # ascending
    order = torch.argsort(-eigvals)
    eigvals = torch.clamp_min(eigvals[order], 0.0)
    total_var = torch.sum(eigvals)
    comps = eigvecs[:, order].T                         # rows = components
    peak = torch.argmax(torch.abs(comps), dim=1)
    signs = torch.sign(comps[torch.arange(f, device=x.device), peak])
    comps = comps * torch.where(signs == 0, 1.0, signs)[:, None]
    comps, eigvals = comps[:k], eigvals[:k]
    transformed = xc @ comps.T
    return PCAResult(comps, eigvals, eigvals / total_var, transformed, mean)


def pca_bands(bands: torch.Tensor, n_components: Optional[int] = None,
              use_robust_scaling: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PCA over a (C, H, W) band stack -> ((k, H, W) component images, (k,)
    explained variance ratio)."""
    c, h, w = bands.shape
    res = pca_fit_transform(bands.reshape(c, h * w).T, n_components,
                            use_robust_scaling)
    k = res.transformed.shape[1]
    return res.transformed.T.reshape(k, h, w), res.explained_variance_ratio
