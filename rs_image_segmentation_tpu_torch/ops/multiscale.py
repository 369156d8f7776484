"""Multi-scale windowed statistics.

Counterpart of ``rs_image_segmentation_tpu.ops.multiscale``: per scale s a
box mean, the variance E[x^2] - E[x]^2 clamped at 0, its square root, and
for s up to ``entropy_max_scale`` the disk-entropy feature.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .stencil import box_filter
from .texture import entropy_feature


def multi_scale_features(band01: torch.Tensor,
                         scales: Sequence[int] = (1, 3, 5, 7),
                         entropy_max_scale: int = 5,
                         include_entropy: bool = True
                         ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for s in scales:
        mean = box_filter(band01, s)
        mean_sq = box_filter(band01 * band01, s)
        variance = torch.clamp_min(mean_sq - mean * mean, 0.0)
        out[f"mean_scale_{s}"] = mean
        out[f"variance_scale_{s}"] = variance
        out[f"std_dev_scale_{s}"] = torch.sqrt(variance)
        if include_entropy and s <= entropy_max_scale:
            out[f"entropy_scale_{s}"] = entropy_feature(band01, s)
    return out
