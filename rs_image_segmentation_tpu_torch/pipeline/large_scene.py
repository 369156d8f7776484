"""Rule-based classification of a large preprocessed scene with global
semantics: the uncapped rule route.

Counterpart of the rule route of
``rs_image_segmentation_tpu.pipeline.large_scene``. It consumes the
stage-1 output, a (7, H, W) scene of stretched uint8 levels, so the
robust-normalisation percentiles are exact functions of per-band 256-bin
histograms. The four index planes are pointwise, and the post-processing
(ellipse morphology and min-area removal, relative to the whole image's
area) runs over the whole scene on the device: the connected-components
kernel (``ops.kernels.cc_labels``) labels a whole mask, so no tile loop and
no component-id cap are needed. Scenes that the batched rule program flags
for its 32768-id cap come here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backend import DeviceLike, resolve_device
from ..core.config import FeatureStageConfig, RuleBasedConfig
from .classify import rule_based_classify
from .turbo import rule_indices


def band_histograms_u8(arr: np.ndarray) -> np.ndarray:
    """(C, H, W) uint8-valued array -> (C, 256) int64 counts (host)."""
    return np.stack([np.bincount(band.reshape(-1).astype(np.uint8),
                                 minlength=256) for band in arr])


def _rule_indices(stretched_u8: torch.Tensor, hist: torch.Tensor,
                  cfg: FeatureStageConfig):
    """A (7, H, W) stretched scene and its (7, 256) histograms -> the four
    rule index planes (ndvi, ndwi, mndwi, ndbi), each (H, W) f32, with
    exact global percentile normalisation: the turbo rule front's math
    after its preamble."""
    return tuple(p[0] for p in rule_indices(stretched_u8[None], hist[None],
                                            cfg))


def _rule_from_stretched(stretched_u8: torch.Tensor, hist: torch.Tensor,
                         cfg: FeatureStageConfig, rule_cfg: RuleBasedConfig,
                         cc_impl: str) -> torch.Tensor:
    """The single-scene rule program from its preamble's outputs onward:
    the stretched scene and its histograms in place of raw DNs and a
    LUT."""
    return rule_based_classify(*_rule_indices(stretched_u8, hist, cfg),
                               rule_cfg, cc_impl=cc_impl)


def rule_based_large_scene(arr: np.ndarray,
                           cfg: FeatureStageConfig = FeatureStageConfig(),
                           rule_cfg: Optional[RuleBasedConfig] = None,
                           hists: Optional[np.ndarray] = None,
                           cc_impl: str = "auto",
                           device: DeviceLike = None) -> np.ndarray:
    """Rule-based classification of a PREPROCESSED (7, H, W) scene of
    stretched uint8 levels, of any size the device holds -> (H, W) uint8
    numpy labels, as the JAX function returns them (its callers write rows
    of a host map). Runs on ``device`` (CUDA unless named).

    ``hists``: optional (7, 256) stretched-value histograms (int64, as the
    serving engine passes them); computed on the host when absent.
    Bit-equal to ``pipeline.turbo.rule_based_scenes_turbo`` on the raw
    scene whose stretch gave ``arr``."""
    dev = resolve_device(device)
    if hists is None:
        hists = band_histograms_u8(arr)
    stretched = torch.from_numpy(np.ascontiguousarray(arr, np.uint8)).to(dev)
    hist = torch.from_numpy(np.asarray(hists).astype(np.int32)).to(dev)
    out = _rule_from_stretched(stretched, hist, cfg,
                               rule_cfg if rule_cfg is not None
                               else RuleBasedConfig(), cc_impl)
    return out.cpu().numpy()
