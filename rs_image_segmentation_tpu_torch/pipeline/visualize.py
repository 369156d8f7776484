"""Index-composite visualization (host, matplotlib).

Counterpart of ``rs_image_segmentation_tpu.pipeline.visualize``.
``visualize_combined_indices`` builds an RGB composite with candidate-key
lookup — R from BSI/NDBI (bare/built-up), G from EVI/MSAVI/NDVI
(vegetation), B from MNDWI/NDWI (water) — accepting both bare and
``all_extracted_features_dict_``-prefixed keys, per-channel min-max
normalized, with a grayscale fallback when fewer than 3 channels resolve.
Feature maps may be arrays or tensors; they are drawn from host copies.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..backend import host_numpy


def _plane(v) -> Optional[np.ndarray]:
    """``v`` as a host 2-D array, or None if it is not a 2-D map."""
    v = host_numpy(v)
    return v if isinstance(v, np.ndarray) and v.ndim == 2 else None


def visualize_selected_features(features: Dict, keys, save_path: str,
                                cols: int = 4) -> Optional[str]:
    """Grid plot of the named 2-D feature maps; None if none is 2-D."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    maps = [(k, m) for k, m in ((k, _plane(features.get(k))) for k in keys)
            if m is not None]
    if not maps:
        return None
    rows = -(-len(maps) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for ax in axes:
        ax.axis("off")
    for ax, (name, img) in zip(axes, maps):
        im = ax.imshow(img, cmap="viridis")
        ax.set_title(name, fontsize=9)
        fig.colorbar(im, ax=ax, fraction=0.046)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


_CHANNEL_CANDIDATES = {
    "R": ("bsi", "ndbi"),
    "G": ("evi", "msavi", "ndvi"),
    "B": ("mndwi", "ndwi"),
}
_PREFIXES = ("", "all_extracted_features_dict_")


def _resolve(features: Dict, names) -> Optional[np.ndarray]:
    for name in names:
        for prefix in _PREFIXES:
            v = _plane(features.get(prefix + name))
            if v is not None:
                return v
    return None


def _minmax(x: np.ndarray) -> np.ndarray:
    mn, mx = np.nanmin(x), np.nanmax(x)
    return np.nan_to_num((x - mn) / (mx - mn + 1e-10))


def visualize_combined_indices(features: Dict, save_path: str,
                               title: str = "Combined spectral indices"
                               ) -> Optional[str]:
    """The R/G/B index composite as a PNG, or a grayscale image of the one
    channel found; None (and no file) if no channel resolves."""
    channels = {k: _resolve(features, names)
                for k, names in _CHANNEL_CANDIDATES.items()}
    found = {k: v for k, v in channels.items() if v is not None}
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    if not found:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch

    fig, ax = plt.subplots(figsize=(10, 10))
    if len(found) == 3:
        rgb = np.stack([_minmax(channels["R"]), _minmax(channels["G"]),
                        _minmax(channels["B"])], axis=-1)
        ax.imshow(rgb)
        legend = [Patch(facecolor="red",
                        label="R: bare / built-up (BSI/NDBI)"),
                  Patch(facecolor="green",
                        label="G: vegetation (EVI/MSAVI/NDVI)"),
                  Patch(facecolor="blue", label="B: water (MNDWI/NDWI)")]
        ax.legend(handles=legend, loc="lower right")
    else:
        k, v = next(iter(found.items()))
        ax.imshow(_minmax(v), cmap="gray")
        ax.set_xlabel(f"grayscale fallback: channel {k}")
    ax.set_title(title)
    ax.axis("off")
    fig.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return save_path
