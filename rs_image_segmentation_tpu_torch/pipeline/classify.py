"""Stage 3, classification: rule-based, KMeans and random forest, and the
three-class map.

Counterpart of ``rs_image_segmentation_tpu.pipeline.classify`` without its
file I/O (``load_roi_raster``, ``train_or_load_forest``, the map writers
and the stage drivers).

* rule_based: index thresholds -> post-processing (ellipse morphology and
  8-connected min-area removal) -> priority paint built-up (3) ->
  vegetation (1) -> water (2) -> bare land (4) into the remaining
  unclassified pixels. Connected components run through
  ``ops.components.connected_components_best``, whose ``"auto"`` route is
  the CUDA kernel ``ops.kernels.cc_labels`` on a CUDA tensor.
* kmeans: the selected feature planes, MinMax-scaled, clustered by
  ``models.kmeans``, labels + 1.
* random_forest: ``models.forest.forest_predict`` over every pixel, whose
  labels come from the CUDA kernel ``ops.kernels.forest_labels`` on a CUDA
  tensor within the leaf cap.

Entry points taking arrays run on CUDA unless the caller names a device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, resolve_device
from ..core.config import RuleBasedConfig
from ..models.forest import FlatForest, forest_predict
from ..models.kmeans import kmeans_fit_predict, minmax_scale_features
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


# ------------------------------------------------------------------ kmeans

_ARRAYS = (np.ndarray, torch.Tensor)


def kmeans_classify(features: Dict[str, object], keys, n_clusters: int,
                    seed: int = 42, device: DeviceLike = None
                    ) -> torch.Tensor:
    """Cluster the pixels of the feature planes named by ``keys`` (arrays
    or tensors; a 3-D (H, W, C) stack gives C columns, NaN reads as 0),
    MinMax-scaled, into ``n_clusters``: (H, W) uint8 labels from 1 on
    ``device`` (CUDA unless named). ``features["height"]`` and
    ``["width"]`` give the image shape; keys of another shape are
    skipped."""
    dev = resolve_device(device)
    h, w = features["height"], features["width"]
    cols = [as_tensor(v, dev, torch.float32).reshape(h * w, -1)
            for v in (features.get(k) for k in keys)
            if isinstance(v, _ARRAYS) and tuple(v.shape[:2]) == (h, w)
            and v.ndim in (2, 3)]
    if not cols:
        raise ValueError("no usable features for KMeans")
    x = torch.nan_to_num(torch.cat(cols, dim=1))
    labels, _ = kmeans_fit_predict(minmax_scale_features(x), n_clusters,
                                   seed=seed)
    return (labels.reshape(h, w) + 1).to(torch.uint8)


def auto_kmeans_keys(features: Dict[str, object]) -> list:
    """The reference's automatic key selection: every 2-D plane of the
    image's shape that is not metadata, else the default candidates (2-D,
    or 3-D stacks of the image's shape)."""
    h, w = features["height"], features["width"]
    meta = {"transform", "crs", "width", "height", "dimensions",
            "geo_transform"}
    keys = [k for k, v in features.items()
            if isinstance(v, _ARRAYS) and v.ndim == 2
            and tuple(v.shape) == (h, w) and k not in meta]
    if not keys:
        for k in ["ndvi", "ndwi", "ndbi", "texture_mean", "evi", "savi",
                  "hierarchical_level_1", "hierarchical_level_2",
                  "hierarchical_all"]:
            v = features.get(k)
            if isinstance(v, _ARRAYS) and (
                    (v.ndim == 2 and tuple(v.shape) == (h, w))
                    or (v.ndim == 3 and tuple(v.shape[:2]) == (h, w))):
                keys.append(k)
    return keys


# ------------------------------------------------------------ random forest

def prepare_training_samples(feature_array: np.ndarray, roi: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Training rows of an (H, W, F) feature array: the pixels where ``roi``
    is neither 0 nor NaN, features NaN -> 0 (host numpy)."""
    h, w, f = feature_array.shape
    flat = feature_array.reshape(-1, f)
    lab = roi.reshape(-1)
    sel = (lab != 0) & ~np.isnan(lab.astype(np.float64))
    x = np.nan_to_num(flat[sel])
    y = lab[sel].astype(np.int64)
    if x.size == 0:
        raise ValueError("no training samples found in ROI")
    return x, y


def forest_classify(feature_array, forest: FlatForest, depth: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """(H, W, F) features (an array or a tensor, NaN read as 0) -> (H, W)
    forest class labels on ``device`` (CUDA unless named)."""
    h, w, f = feature_array.shape
    x = torch.nan_to_num(as_tensor(feature_array, resolve_device(device),
                                   torch.float32).reshape(-1, f))
    return forest_predict(forest, x, depth).reshape(h, w)


# ------------------------------------------------------------ three-class map

def create_three_class_map(result, method: str = "rule_based",
                           kmeans_mapping: Optional[Dict[str, list]] = None,
                           device: DeviceLike = None) -> torch.Tensor:
    """Method-specific labels (an array or a tensor) -> 1 = water /
    2 = vegetation / 3 = built-up, 0 elsewhere, uint8 on ``device`` (CUDA
    unless named). KMeans maps clusters through ``kmeans_mapping`` (by
    default 1-2 water, 3-5 vegetation, 6-7 built-up)."""
    result = as_tensor(result, resolve_device(device))
    out = torch.zeros(result.shape, dtype=torch.uint8, device=result.device)
    if method in ("rule_based", "random_forest"):
        mapping = {"water": [2], "vegetation": [1], "builtup": [3]}
    elif method == "kmeans":
        mapping = kmeans_mapping or {"water": [1, 2],
                                     "vegetation": [3, 4, 5],
                                     "builtup": [6, 7]}
    else:
        return out
    for value, name in ((1, "water"), (2, "vegetation"), (3, "builtup")):
        for c in mapping.get(name, []):
            out[result == c] = value
    return out
