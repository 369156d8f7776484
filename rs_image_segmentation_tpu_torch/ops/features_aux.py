"""Auxiliary feature utilities of the reference's public API: variance-based
selection, fusion helpers, segmentation prep, water-class merging, and
forest feature importances.

Counterpart of ``rs_image_segmentation_tpu.ops.features_aux``. The
functions that take arrays compute on ``device``: a tensor stays on its
own device unless ``device`` is named, an array goes to ``device`` (CUDA
unless named; no device and no CUDA raises, ``backend.resolve_device``).
``evaluate_feature_importance_for_classes`` is host numpy (sklearn where
it imports, else the port's CART trainer).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, host_numpy, resolve_device
from .normalize import robust_normalize

_ARRAYS = (np.ndarray, torch.Tensor)


def _on(x, device: DeviceLike, dtype: Optional[torch.dtype] = None
        ) -> torch.Tensor:
    """``x`` as a tensor: a tensor on its own device when ``device`` is
    None, else on ``resolve_device(device)``; cast to ``dtype`` if given."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    return as_tensor(x, resolve_device(device), dtype)


def _f32(x, device: DeviceLike) -> torch.Tensor:
    return _on(x, device, torch.float32)


def feature_selection_by_variance(features: Dict, threshold: float = 0.01,
                                  device: DeviceLike = None) -> Dict:
    """Drop features whose f32 variance (on ``device``) is below
    ``threshold``, recursing one level into lists and dicts. The kept
    features are the inputs themselves."""
    def kept(x) -> bool:
        return float(torch.var(_f32(x, device), correction=0)) >= threshold

    out: Dict = {}
    for name, feat in features.items():
        if isinstance(feat, _ARRAYS) and feat.ndim == 2:
            if kept(feat):
                out[name] = feat
        elif isinstance(feat, list) and all(isinstance(f, _ARRAYS)
                                            for f in feat):
            lst = [f for f in feat if kept(f)]
            if lst:
                out[name] = lst
        elif isinstance(feat, dict):
            sub = {k: v for k, v in feat.items()
                   if isinstance(v, _ARRAYS) and kept(v)}
            if sub:
                out[name] = sub
    return out


def feature_fusion_for_segmentation(features: Sequence,
                                    weights: Optional[Sequence[float]] = None,
                                    method: str = "weighted_sum",
                                    device: DeviceLike = None
                                    ) -> torch.Tensor:
    """Weighted-sum (equal weights by default) or channel-concat fusion of
    same-shape planes, on ``device``."""
    stack = [_f32(f, device) for f in features]
    if method == "weighted_sum":
        if weights is None:
            weights = [1.0 / len(stack)] * len(stack)
        return sum(w * f for w, f in zip(weights, stack))
    if method == "concat":
        return torch.stack(stack, dim=-1)
    raise ValueError(f"unknown fusion method {method!r}")


def prepare_features_for_segmentation(features: Dict, keys: Sequence[str],
                                      device: DeviceLike = None
                                      ) -> torch.Tensor:
    """Select the named features that are present, robust-normalize each
    and stack them to (H, W, F) on ``device``."""
    cols = [robust_normalize(_f32(features[k], device)) for k in keys
            if features.get(k) is not None]
    if not cols:
        raise ValueError("none of the requested feature keys are present")
    return torch.stack(cols, dim=-1)


def hierarchical_feature_fusion(features: Dict, device: DeviceLike = None
                                ) -> torch.Tensor:
    """Stack [ndwi, mndwi, ndvi, evi, ndbi, bsi] to (H, W, 6) on
    ``device``."""
    keys = ["ndwi", "mndwi", "ndvi", "evi", "ndbi", "bsi"]
    return torch.stack([_f32(features[k], device) for k in keys], dim=-1)


def semantic_merge_water_classes(segmentation, source_labels=(1, 2),
                                 target_label: int = 1,
                                 device: DeviceLike = None) -> torch.Tensor:
    """Merge the river and lake labels into one water class, on
    ``device``."""
    out = _on(segmentation, device)
    for lab in source_labels:
        out = torch.where(out == lab, target_label, out)
    return out


def evaluate_feature_importance_for_classes(feature_stack, labels,
                                            n_estimators: int = 50,
                                            seed: int = 42) -> np.ndarray:
    """Feature importances of a throwaway forest on the labelled pixels
    (``labels > 0``): sklearn's mean impurity decrease where it imports,
    else the share of splits on each feature in the port's trainer."""
    from ..models.forest import fit_random_forest
    feature_stack = np.asarray(host_numpy(feature_stack))
    labels = np.asarray(host_numpy(labels))
    x = feature_stack.reshape(-1, feature_stack.shape[-1])
    y = labels.reshape(-1)
    sel = y > 0
    try:
        from sklearn.ensemble import RandomForestClassifier
        clf = RandomForestClassifier(n_estimators=n_estimators,
                                     random_state=seed)
        clf.fit(np.nan_to_num(x[sel]), y[sel])
        return clf.feature_importances_
    except ImportError:
        forest, _ = fit_random_forest(np.nan_to_num(x[sel]), y[sel],
                                      n_estimators, seed=seed)
        feats = forest.feature.numpy()
        internal = forest.left.numpy() != np.arange(feats.shape[1])[None]
        counts = np.bincount(feats[internal].ravel(),
                             minlength=x.shape[1]).astype(np.float64)
        total = counts.sum()
        return counts / total if total else counts
