"""Stage 3, classification: rule-based, KMeans and random forest, and the
three-class map.

Counterpart of ``rs_image_segmentation_tpu.pipeline.classify``.

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
  tensor, for a forest of any size.

The stage-3 file driver, ``run_classification_stage``, reads the stage-2
pickle (``io.artifacts``), runs one method on the device, and writes the
class-map GeoTIFF, the three-class GeoTIFF and two PNGs. Its compute and
GeoTIFF part, ``classify_and_write``, needs no plotting library; the
random forest's model cache (``train_or_load_forest``) uses joblib and
sklearn where they import, else the port's NumPy CART trainer.

Entry points taking arrays run on CUDA unless the caller names a device.
Everything written to disk is host numpy.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, host_numpy, resolve_device
from ..core.config import (ClassTables, ForestConfig, KMeansConfig,
                           RuleBasedConfig)
from ..core.types import GeoMeta
from ..io.artifacts import (alias_feature_keys, load_features,
                            normalize_features_structure)
from ..io.tiff import read_tiff, write_tiff
from ..models.forest import (FlatForest, fit_random_forest,
                             forest_from_sklearn, forest_predict)
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


def load_roi_raster(path: str, expected_shape=None) -> np.ndarray:
    """The labelled ROI of a ``.npy`` or the first band of a GeoTIFF
    (host); raises if its shape is not ``expected_shape``."""
    if path.endswith(".npy"):
        roi = np.load(path)
    else:
        arr, _ = read_tiff(path)
        roi = arr[0]
    if expected_shape is not None and roi.shape != tuple(expected_shape):
        raise ValueError(f"ROI shape {roi.shape} != features {expected_shape}")
    return roi


def train_or_load_forest(x: np.ndarray, y: np.ndarray, model_path: str,
                         cfg: ForestConfig = ForestConfig(),
                         use_sklearn: bool = True
                         ) -> Tuple[FlatForest, int]:
    """The reference's model cache: reload the joblib model at
    ``model_path`` when its feature count matches ``x``; else train with
    sklearn where it imports (and cache the model with joblib), else with
    the port's NumPy CART trainer (no cache). Returns (forest on the CPU,
    max depth)."""
    if os.path.exists(model_path):
        try:
            import joblib
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                clf = joblib.load(model_path)
            if getattr(clf, "n_features_in_", -1) == x.shape[1]:
                return forest_from_sklearn(clf)
        except Exception:  # an unreadable cache is retrained
            pass
    if use_sklearn:
        try:
            from sklearn.ensemble import RandomForestClassifier
            import joblib
            clf = RandomForestClassifier(n_estimators=cfg.n_estimators,
                                         max_depth=cfg.max_depth,
                                         random_state=cfg.seed, n_jobs=-1)
            clf.fit(x, y)
            os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
            joblib.dump(clf, model_path)
            return forest_from_sklearn(clf)
        except ImportError:
            pass
    return fit_random_forest(x, y, cfg.n_estimators, cfg.max_depth, cfg.seed)


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


THREE_CLASS_COLORMAP = np.array(
    [[0, 0, 0], [0, 0, 255], [0, 128, 0], [255, 0, 0]], dtype=np.uint8)


def save_three_class_evaluation_tif(result, meta: GeoMeta, output_path: str,
                                    method: str = "rule_based",
                                    device: DeviceLike = None) -> np.ndarray:
    """The three-class map of ``result`` (on ``device``, CUDA unless
    named) as a uint8 GeoTIFF with a colour map and a band description;
    returns the map (host)."""
    three = create_three_class_map(result, method,
                                   device=device).cpu().numpy()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    write_tiff(output_path, three[None], meta, compression="lzw", tiled=True,
               tile_size=256, colormap=THREE_CLASS_COLORMAP,
               band_names=["Land Cover Classification "
                           "(1=Water, 2=Vegetation, 3=Built-up)"])
    return three


def create_classification_map(result, class_names: Dict[int, str],
                              class_colors: Dict[int, list], save_path: str,
                              title: str = "Classification") -> None:
    """Coloured label map PNG with a legend (host, matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch

    result = np.asarray(host_numpy(result))
    h, w = result.shape
    rgb = np.zeros((h, w, 3), np.uint8)
    present = np.unique(result)
    for cid in present:
        rgb[result == cid] = class_colors.get(int(cid), [128, 128, 128])
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(rgb)
    ax.set_title(title)
    ax.axis("off")
    patches = [Patch(facecolor=np.array(class_colors.get(int(c), [128] * 3))
                     / 255.0, label=class_names.get(int(c), str(c)))
               for c in present]
    ax.legend(handles=patches, loc="center left", bbox_to_anchor=(1.0, 0.5))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def save_classification_as_geotiff(result, meta: GeoMeta,
                                   output_path: str) -> None:
    """The label map as a GeoTIFF of the narrowest of uint8 / uint16 /
    int32 that holds it, nodata 0, LZW, 256 x 256 tiles."""
    result = np.asarray(host_numpy(result))
    mx = result.max()
    if mx < 256:
        arr = result.astype(np.uint8)
    elif mx < 65536:
        arr = result.astype(np.uint16)
    else:
        arr = result.astype(np.int32)
    meta = GeoMeta(meta.transform, meta.crs, nodata=0.0)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    write_tiff(output_path, arr[None], meta, compression="lzw", tiled=True,
               tile_size=256)


def run_three_class_evaluation_output(features_meta: Optional[Dict] = None,
                                      output_dir: str = "output",
                                      method: str = "rule_based",
                                      classification_map=None,
                                      shape=(256, 256),
                                      device: DeviceLike = None
                                      ) -> np.ndarray:
    """Write ``<method>_three_class_evaluation.tif`` of a given (or a
    random placeholder) class map, georeferenced by ``features_meta`` or
    synthetically."""
    from ..tools.fixtures import (make_random_classification_map,
                                  synthetic_geometa)
    dev = resolve_device(device)
    if classification_map is None:
        classification_map = make_random_classification_map(shape)
    if features_meta is not None:
        meta = GeoMeta(transform=features_meta.get("transform"),
                       crs=features_meta.get("crs"))
    else:
        meta = synthetic_geometa(tuple(classification_map.shape))
    out = os.path.join(output_dir, f"{method}_three_class_evaluation.tif")
    return save_three_class_evaluation_tif(classification_map, meta, out,
                                           method, device=dev)


def classify_and_write(feature_file_path: str, method: str = "rule_based",
                       output_dir: str = "segmentation_outputs",
                       use_hierarchical_all: bool = True,
                       labeled_roi_file: str = "labeled_roi.tif",
                       rule_cfg: RuleBasedConfig = RuleBasedConfig(),
                       kmeans_cfg: KMeansConfig = KMeansConfig(),
                       forest_cfg: ForestConfig = ForestConfig(),
                       device: DeviceLike = None
                       ) -> Tuple[np.ndarray, Dict, str]:
    """The compute and GeoTIFF part of :func:`run_classification_stage`:
    load and flatten the features, classify on ``device`` (CUDA unless
    named), write ``<method>_classification_map.tif`` and
    ``<method>_three_class_evaluation.tif``. Returns (the host label map,
    the flattened host features, the map's title)."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    features = alias_feature_keys(normalize_features_structure(
        load_features(feature_file_path)))
    h, w = features["height"], features["width"]
    meta = GeoMeta(transform=features.get("transform"),
                   crs=features.get("crs"))

    if method == "rule_based":
        ndvi = features.get("ndvi")
        ndwi = features.get("ndwi")
        mndwi = features.get("mndwi")
        ndbi = features.get("ndbi")
        if ndvi is None or ndbi is None or (ndwi is None and mndwi is None):
            raise ValueError("rule_based requires ndvi/ndbi and ndwi or mndwi")
        planes = [None if v is None else as_tensor(v, dev)
                  for v in (ndvi, ndwi if ndwi is not None else ndvi,
                            mndwi, ndbi)]
        result = rule_based_classify(*planes, rule_cfg)
        title = "Rule-based classification"
    elif method == "kmeans":
        wanted = ["ndvi", "ndwi", "ndbi", "texture_mean", "hierarchical_all"]
        keys = [k for k in wanted
                if isinstance(features.get(k), np.ndarray)
                and features[k].ndim in (2, 3)]
        if not keys:
            keys = auto_kmeans_keys(features)
        result = kmeans_classify(features, keys, kmeans_cfg.n_clusters,
                                 kmeans_cfg.seed, device=dev)
        title = f"K-Means ({kmeans_cfg.n_clusters} clusters)"
    elif method == "random_forest":
        if use_hierarchical_all and isinstance(
                features.get("hierarchical_all"), np.ndarray):
            fa = features["hierarchical_all"]
        else:
            keys = [k for k, v in features.items()
                    if isinstance(v, np.ndarray) and v.ndim == 2
                    and v.shape == (h, w)]
            if not keys:
                raise ValueError("no 2-D features available for random forest")
            fa = np.stack([features[k] for k in keys], axis=-1)
        roi = load_roi_raster(labeled_roi_file, (h, w))
        x, y = prepare_training_samples(fa, roi)
        model_path = os.path.join(output_dir, "random_forest_model.joblib")
        forest, depth = train_or_load_forest(x, y, model_path, forest_cfg)
        result = forest_classify(fa, forest, depth, device=dev)
        title = "Random-forest classification"
    else:
        raise ValueError(f"unsupported method {method!r}")

    tif_path = os.path.join(output_dir, f"{method}_classification_map.tif")
    save_classification_as_geotiff(result, meta, tif_path)
    eval_tif = os.path.join(output_dir, f"{method}_three_class_evaluation.tif")
    save_three_class_evaluation_tif(result, meta, eval_tif, method, device=dev)
    return result.cpu().numpy(), features, title


def run_classification_stage(feature_file_path: str,
                             method: str = "rule_based",
                             output_dir: str = "segmentation_outputs",
                             use_hierarchical_all: bool = True,
                             labeled_roi_file: str = "labeled_roi.tif",
                             rule_cfg: RuleBasedConfig = RuleBasedConfig(),
                             kmeans_cfg: KMeansConfig = KMeansConfig(),
                             forest_cfg: ForestConfig = ForestConfig(),
                             tables: ClassTables = ClassTables(),
                             device: DeviceLike = None) -> np.ndarray:
    """Stage 3 on files: :func:`classify_and_write` on ``device`` (CUDA
    unless named), then the combined-index PNG and the class-map PNG.
    Returns the host label map."""
    from .visualize import visualize_combined_indices
    result, features, title = classify_and_write(
        feature_file_path, method, output_dir, use_hierarchical_all,
        labeled_roi_file, rule_cfg, kmeans_cfg, forest_cfg, device)
    visualize_combined_indices(
        features, os.path.join(output_dir, "combined_indices.png"))
    create_classification_map(
        result, tables.names_dict(), tables.colors_dict(),
        os.path.join(output_dir, f"{method}_classification_map.png"), title)
    return result
