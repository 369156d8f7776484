"""Spectral indices: guarded ratio + clip to [-1, 1].

Counterpart of ``rs_image_segmentation_tpu.ops.indices``. Where the
denominator is <= 1e-3 the output is 0. Band order (TM bands 1-7):
0 blue, 1 green, 2 red, 3 NIR, 4 SWIR1, 5 thermal, 6 SWIR2. Each function
works on any leading batch shape; ``spectral_indices`` takes the bands
from dimension -3.
"""

from __future__ import annotations

from typing import Dict

import torch


def _guarded_ratio(num: torch.Tensor, den: torch.Tensor,
                   threshold: float = 1e-3) -> torch.Tensor:
    mask = den > threshold
    safe_den = torch.where(mask, den, 1.0)
    out = torch.where(mask, num / safe_den, 0.0)
    return torch.clamp(out, -1.0, 1.0).to(torch.float32)


def ndvi(nir: torch.Tensor, red: torch.Tensor) -> torch.Tensor:
    """(NIR-R)/(NIR+R)."""
    return _guarded_ratio(nir - red, nir + red)


def evi(nir: torch.Tensor, red: torch.Tensor, blue: torch.Tensor,
        L: float = 1.0, C1: float = 6.0, C2: float = 7.5,
        G: float = 2.5) -> torch.Tensor:
    """G*(NIR-R)/(NIR + C1*R - C2*B + L)."""
    return _guarded_ratio(G * (nir - red), nir + C1 * red - C2 * blue + L)


def msavi(nir: torch.Tensor, red: torch.Tensor) -> torch.Tensor:
    """MSAVI2 closed form, clipped, no divide guard."""
    t = 2.0 * nir + 1.0
    out = (t - torch.sqrt(t * t - 8.0 * (nir - red))) / 2.0
    return torch.clamp(out, -1.0, 1.0).to(torch.float32)


def ndwi(green: torch.Tensor, nir: torch.Tensor) -> torch.Tensor:
    """(G-NIR)/(G+NIR)."""
    return _guarded_ratio(green - nir, green + nir)


def mndwi(green: torch.Tensor, swir1: torch.Tensor) -> torch.Tensor:
    """(G-SWIR1)/(G+SWIR1)."""
    return _guarded_ratio(green - swir1, green + swir1)


def ndbi(swir1: torch.Tensor, nir: torch.Tensor) -> torch.Tensor:
    """(SWIR1-NIR)/(SWIR1+NIR)."""
    return _guarded_ratio(swir1 - nir, swir1 + nir)


def bsi(blue: torch.Tensor, red: torch.Tensor, nir: torch.Tensor,
        swir1: torch.Tensor) -> torch.Tensor:
    """((S+R)-(N+B))/((S+R)+(N+B))."""
    sr = swir1 + red
    nb = nir + blue
    return _guarded_ratio(sr - nb, sr + nb)


def spectral_indices(bands: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All seven indices from a ``(..., C>=5, H, W)`` normalized band stack,
    in the JAX package's order."""
    blue, green, red, nir, swir1 = bands.unbind(-3)[:5]
    return {
        "ndvi": ndvi(nir, red),
        "evi": evi(nir, red, blue),
        "msavi": msavi(nir, red),
        "ndwi": ndwi(green, nir),
        "mndwi": mndwi(green, swir1),
        "ndbi": ndbi(swir1, nir),
        "bsi": bsi(blue, red, nir, swir1),
    }
