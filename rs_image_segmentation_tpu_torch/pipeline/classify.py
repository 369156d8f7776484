"""Stage 3, the rule-based part: index thresholds -> post-processing
(ellipse morphology and 8-connected min-area removal) -> priority paint
built-up (3) -> vegetation (1) -> water (2) -> bare land (4) into the
remaining unclassified pixels.

Counterpart of the rule functions of
``rs_image_segmentation_tpu.pipeline.classify``. Connected components run
through ``ops.components.connected_components_best``, whose ``"auto"``
route is the CUDA kernel ``ops.kernels.cc_labels`` on a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import RuleBasedConfig
from ..ops.components import post_process_mask
from ..ops.threshold import threshold_binary


def rule_mask(kind: str, ndvi: torch.Tensor, ndwi: Optional[torch.Tensor],
              mndwi: Optional[torch.Tensor], ndbi: torch.Tensor,
              cfg: RuleBasedConfig = RuleBasedConfig(),
              cc_impl: str = "auto") -> torch.Tensor:
    """One post-processed (H, W) uint8 rule mask, ``kind`` in
    vegetation / water / builtup."""
    h, w = ndvi.shape
    area = h * w
    if kind == "vegetation":
        veg = threshold_binary(ndvi, cfg.ndvi_threshold)
        return post_process_mask(veg, int(area * cfg.veg_min_area_frac), 3,
                                 cc_impl=cc_impl)
    if kind == "water":
        if cfg.use_mndwi_if_available and mndwi is not None:
            water = threshold_binary(mndwi, cfg.mndwi_threshold)
        else:
            water = threshold_binary(ndwi, cfg.ndwi_threshold)
        return post_process_mask(water, int(area * cfg.water_min_area_frac),
                                 3, cc_impl=cc_impl)
    if kind == "builtup":
        built = threshold_binary(ndbi, cfg.ndbi_threshold)
        non_veg = threshold_binary(ndvi, cfg.ndvi_threshold_for_builtup,
                                   above=False)
        built = ((built != 0) & (non_veg != 0)).to(torch.uint8)
        return post_process_mask(built,
                                 int(area * cfg.builtup_min_area_frac), 5,
                                 cc_impl=cc_impl)
    raise ValueError(f"unknown rule mask kind {kind!r}")


def paint_rule_masks(veg: torch.Tensor, water: torch.Tensor,
                     built: torch.Tensor) -> torch.Tensor:
    """Priority paint: built-up (3), then vegetation (1), and water (2)
    wins."""
    out = torch.zeros(veg.shape, dtype=torch.uint8, device=veg.device)
    out = torch.where(built == 1, 3, out)
    out = torch.where(veg == 1, 1, out)
    return torch.where(water == 1, 2, out).to(torch.uint8)


def bare_rule_mask(painted: torch.Tensor, ndvi: torch.Tensor,
                   ndbi: torch.Tensor,
                   cfg: RuleBasedConfig = RuleBasedConfig(),
                   cc_impl: str = "auto") -> torch.Tensor:
    """Bare-land mask from the unclassified remainder of the painted
    map."""
    h, w = ndvi.shape
    nd_v = torch.nan_to_num(ndvi)
    nd_b = torch.nan_to_num(ndbi)
    bare = ((painted == 0)
            & (nd_v > cfg.bareland_ndvi_low) & (nd_v < cfg.bareland_ndvi_high)
            & (nd_b > cfg.bareland_ndbi_low) & (nd_b < cfg.bareland_ndbi_high)
            ).to(torch.uint8)
    return post_process_mask(bare, int(h * w * cfg.bareland_min_area_frac),
                             3, cc_impl=cc_impl)


def rule_based_classify(ndvi: torch.Tensor, ndwi: torch.Tensor,
                        mndwi: Optional[torch.Tensor], ndbi: torch.Tensor,
                        cfg: RuleBasedConfig = RuleBasedConfig(),
                        cc_impl: str = "auto") -> torch.Tensor:
    """(H, W) index planes -> (H, W) uint8 labels {0, 1 = vegetation,
    2 = water, 3 = built-up, 4 = bare land} on the planes' device.
    ``cc_impl`` picks the connected-components route
    (``ops.components.connected_components_best``)."""
    veg = rule_mask("vegetation", ndvi, ndwi, mndwi, ndbi, cfg, cc_impl)
    water = rule_mask("water", ndvi, ndwi, mndwi, ndbi, cfg, cc_impl)
    built = rule_mask("builtup", ndvi, ndwi, mndwi, ndbi, cfg, cc_impl)
    out = paint_rule_masks(veg, water, built)
    bare = bare_rule_mask(out, ndvi, ndbi, cfg, cc_impl)
    return torch.where((bare == 1) & (out == 0), 4, out).to(torch.uint8)
