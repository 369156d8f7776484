"""Labeling tools: sample collection + ROI-mask rasterization.

Counterpart of ``rs_image_segmentation_tpu.tools.sampling``, host numpy
only (no tensor is touched, so nothing here takes a device). Recording
(x, y) coords, class labels and feature vectors, and burning them into an
int16 ROI mask, is non-interactive; the matplotlib click UI
(``collect_samples``) is an optional wrapper around it, importing
matplotlib and tkinter only when called.

Artifact contract, the JAX package's: samples.pkl holds
``(coords Nx2 int64 [x, y], labels N int64)``, labels {1: water,
2: vegetation, 3: built-up}; roi_mask.npy is H x W int16 with
0 = unlabeled. An ``(x, y)`` coordinate indexes a raster as ``[y, x]``.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

DEFAULT_CLASS_LABELS = {1: "water", 2: "vegetation", 3: "built-up"}


class SampleSet:
    """Accumulates labeled point samples over an image."""

    def __init__(self, feature_map: Optional[np.ndarray] = None):
        self.coords: list = []   # (x, y) pixel coords
        self.labels: list = []
        self.features: list = []
        self.feature_map = feature_map

    def add(self, x: int, y: int, label: int) -> None:
        self.coords.append((int(x), int(y)))
        self.labels.append(int(label))
        if self.feature_map is not None:
            # NOTE: the reference indexes feature_map[y, x] (row, col) for an
            # (x, y) coordinate — supervised_classifiers.py:135
            self.features.append(self.feature_map[int(y), int(x), :])

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        coords = np.asarray(self.coords, dtype=np.int64)
        labels = np.asarray(self.labels, dtype=np.int64)
        with open(path, "wb") as f:
            pickle.dump((coords, labels), f)

    @staticmethod
    def load(path: str) -> Tuple[np.ndarray, np.ndarray]:
        with open(path, "rb") as f:
            coords, labels = pickle.load(f)
        return np.asarray(coords), np.asarray(labels)

    def training_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(X, y) like the bundled supervised workflow
        (supervised_classifiers.py:126-135)."""
        if self.feature_map is None:
            raise ValueError("no feature map attached")
        coords = np.asarray(self.coords)
        x = self.feature_map[coords[:, 1], coords[:, 0], :]
        return x, np.asarray(self.labels)


def training_matrix_from_samples(samples_path: str, feature_map: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    coords, labels = SampleSet.load(samples_path)
    x = feature_map[coords[:, 1], coords[:, 0], :]
    return np.nan_to_num(x), labels


def generate_roi_mask_from_samples(samples_path: str,
                                   shape: Tuple[int, int],
                                   out_npy: Optional[str] = None) -> np.ndarray:
    """Burn point samples into an int16 mask (reference
    generate_roi_mask.py:24-58), with bounds checking."""
    coords, labels = SampleSet.load(samples_path)
    h, w = shape
    mask = np.zeros((h, w), dtype=np.int16)
    for (x, y), lab in zip(coords, labels):
        if 0 <= y < h and 0 <= x < w:
            mask[y, x] = lab
    if out_npy:
        os.makedirs(os.path.dirname(out_npy) or ".", exist_ok=True)
        np.save(out_npy, mask)
    return mask


def normalize_for_display(rgb: np.ndarray, lower: float = 2.0,
                          upper: float = 98.0) -> np.ndarray:
    """Percentile display stretch (reference collect_samples.py:32-49)."""
    out = np.zeros_like(rgb, dtype=np.float64)
    for c in range(rgb.shape[-1]):
        band = rgb[..., c].astype(np.float64)
        lo, hi = np.percentile(band, [lower, upper])
        out[..., c] = np.clip((band - lo) / (hi - lo + 1e-10), 0, 1)
    return out


def collect_samples(image_rgb: np.ndarray, feature_map: np.ndarray,
                    output_path: str,
                    class_labels: Dict[int, str] = None) -> SampleSet:
    """Interactive click-to-label collection (reference
    collect_samples.py:51-110). Requires a GUI matplotlib backend; in
    headless environments build a SampleSet programmatically instead."""
    import matplotlib.pyplot as plt

    class_labels = class_labels or DEFAULT_CLASS_LABELS
    samples = SampleSet(feature_map)
    disp = normalize_for_display(image_rgb)
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(disp)
    ax.set_title("Left-click to label a pixel; close window to save")

    def onclick(event):
        if event.xdata is None or event.ydata is None:
            return
        x, y = int(round(event.xdata)), int(round(event.ydata))
        try:
            from tkinter.simpledialog import askinteger
            label = askinteger("Class", f"Class id for ({x}, {y})?\n"
                               + "\n".join(f"{k}: {v}"
                                           for k, v in class_labels.items()))
        except Exception:
            label = None
        if label is None:
            return
        samples.add(x, y, label)
        ax.plot(x, y, "r.", markersize=6)
        fig.canvas.draw_idle()

    def onclose(_event):
        if samples.coords:
            samples.save(output_path)

    fig.canvas.mpl_connect("button_press_event", onclick)
    fig.canvas.mpl_connect("close_event", onclose)
    plt.show()
    return samples
