"""Stage artifact contract: .npy / .pkl / GeoTIFF feature containers.

Counterpart of ``rs_image_segmentation_tpu.io.artifacts``, host numpy over
the port's ``io.tiff``, writing and reading the same files:

  * ``save_feature_artifacts`` writes ``level1_features.npy`` /
    ``level2_features.npy`` / ``all_hierarchical_features.npy`` (H, W, F)
    float32, the full ``all_features_and_metadata.pkl`` dict, and the
    19-band LZW tiled GeoTIFF. It takes tensors or arrays and moves every
    leaf to host numpy first, so the pickle holds no ``torch.Tensor`` and
    loads without torch or a card (the JAX package's ``load_features``
    reads it).
  * ``load_features`` autodetects .npy / .pkl / .tif.
  * ``normalize_features_structure`` recursively flattens nested dict/list
    arrays into prefixed top-level keys and canonicalizes metadata (which
    is why keys like ``all_extracted_features_dict_ndvi`` and
    ``hierarchical_all`` exist).
  * ``alias_feature_keys`` copies prefixed keys to bare names.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

from ..backend import host_numpy
from ..core.types import GeoMeta
from .tiff import read_tiff, write_tiff


def load_features(path: str) -> Dict[str, Any]:
    """Load a feature container from .npy (dict or array), .pkl, or .tif."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        obj = np.load(path, allow_pickle=True)
        if obj.dtype == object:
            obj = obj.item()
            if not isinstance(obj, dict):
                raise ValueError(f"object .npy does not hold a dict: {path}")
            return dict(obj)
        arr = np.asarray(obj)
        if arr.ndim == 3:
            # band-stacked (bands, H, W), as the reference loader reads it
            return {f"band_{i + 1}": arr[i] for i in range(arr.shape[0])}
        return {"array": arr}
    if ext in (".pkl", ".pickle"):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, dict):
            raise ValueError(f"pickle does not hold a dict: {path}")
        return dict(obj)
    if ext in (".tif", ".tiff"):
        arr, info = read_tiff(path)
        out: Dict[str, Any] = {}
        for i in range(arr.shape[0]):
            name = None
            if info.band_names and info.band_names[i]:
                name = info.band_names[i]
            out[name or f"band_{i + 1}"] = arr[i]
        out["transform"] = info.meta.transform
        out["crs"] = info.meta.crs
        out["width"] = info.width
        out["height"] = info.height
        return out
    raise ValueError(f"unsupported feature file type: {path}")


_METADATA_KEYS = ("transform", "crs", "width", "height", "dimensions",
                  "geo_transform", "variance_ratio")


def normalize_features_structure(loaded: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten nested feature dicts/lists into prefixed top-level keys and
    canonicalize metadata:

      {'hierarchical_features': {'all': A}}   -> {'hierarchical_all': A}
      {'all_extracted_features_dict': {'ndvi': N}}
          -> {'all_extracted_features_dict_ndvi': N}
      {'x': [A, B]}                           -> {'x_0': A, 'x_1': B}
      geo_transform (gdal 6-tuple)            -> 'transform' affine 6-tuple
      dimensions (H, W)                       -> height/width ints
    """
    flat: Dict[str, Any] = {}

    def extract_arrays(obj: Any, prefix: str) -> None:
        if isinstance(obj, np.ndarray) and obj.ndim >= 2:
            flat[prefix] = obj
        elif isinstance(obj, dict):
            for k, v in obj.items():
                extract_arrays(v, f"{prefix}_{k}" if prefix else str(k))
        elif isinstance(obj, (list, tuple)) and obj and all(
                isinstance(x, np.ndarray) for x in obj):
            for i, v in enumerate(obj):
                extract_arrays(v, f"{prefix}_{i}" if prefix else str(i))

    for key, value in loaded.items():
        if key in _METADATA_KEYS:
            continue
        if key == "hierarchical_features" and isinstance(value, dict):
            for sub, arr in value.items():
                if isinstance(arr, np.ndarray):
                    flat[f"hierarchical_{sub}"] = arr
            continue
        extract_arrays(value, key)

    # ---- metadata canonicalization ----
    out: Dict[str, Any] = dict(flat)
    transform = loaded.get("transform")
    if transform is None and loaded.get("geo_transform") is not None:
        gt = loaded["geo_transform"]
        try:
            c, a, b, f, d, e = gt
            transform = (a, b, c, d, e, f)
        except (TypeError, ValueError):
            transform = None
    out["transform"] = tuple(transform) if transform is not None else None
    out["crs"] = loaded.get("crs")

    height = width = None
    dims = loaded.get("dimensions")
    if isinstance(dims, (tuple, list)) and len(dims) == 2:
        height, width = int(dims[0]), int(dims[1])
    if height is None:
        if isinstance(loaded.get("height"), (int, np.integer)):
            height, width = int(loaded["height"]), int(loaded["width"])
    if height is None:
        for arr in flat.values():
            if isinstance(arr, np.ndarray) and arr.ndim >= 2:
                height, width = int(arr.shape[0]), int(arr.shape[1])
                break
    out["height"] = height
    out["width"] = width
    return out


def alias_feature_keys(features: Dict[str, Any],
                       prefix: str = "all_extracted_features_dict_"
                       ) -> Dict[str, Any]:
    """Copy ``<prefix><name>`` keys to bare ``<name>`` keys (an existing
    bare key wins)."""
    out = dict(features)
    for key in list(features.keys()):
        if key.startswith(prefix):
            out.setdefault(key[len(prefix):], features[key])
    return out


def save_feature_artifacts(
    output_dir: str,
    features_dict: Dict[str, Any],
    hierarchical: Dict[str, Any],
    meta: Optional[GeoMeta] = None,
) -> Dict[str, str]:
    """Persist stage-2 outputs: the three ``.npy`` stacks, the pickle and
    the 19-band GeoTIFF. Leaves may be tensors on any device or arrays;
    every file holds host numpy. Returns the written paths."""
    os.makedirs(output_dir, exist_ok=True)
    features_dict = host_numpy(features_dict)
    hierarchical = {k: np.ascontiguousarray(host_numpy(v), dtype=np.float32)
                    for k, v in hierarchical.items()}
    paths: Dict[str, str] = {}

    for name, key in (("level1_features.npy", "level_1"),
                      ("level2_features.npy", "level_2"),
                      ("all_hierarchical_features.npy", "all")):
        p = os.path.join(output_dir, name)
        np.save(p, hierarchical[key])
        paths[key] = p

    h, w = hierarchical["all"].shape[:2]
    payload = {
        "hierarchical_features": dict(hierarchical),
        "all_extracted_features_dict": dict(features_dict),
        "dimensions": (h, w),
        "geo_transform": meta.to_gdal() if meta is not None else None,
        "crs": meta.crs if meta is not None else None,
    }
    pkl_path = os.path.join(output_dir, "all_features_and_metadata.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(payload, f)
    paths["pkl"] = pkl_path

    stack = hierarchical["all"]
    tif_path = os.path.join(output_dir, "all_hierarchical_features.tif")
    write_tiff(
        tif_path,
        np.moveaxis(stack, 2, 0),
        meta or GeoMeta(),
        compression="lzw",
        tiled=True,
        tile_size=256,
        band_names=[f"feature_{i + 1}" for i in range(stack.shape[2])],
    )
    paths["tif"] = tif_path
    return paths
