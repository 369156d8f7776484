"""Stage 4, evaluation: cluster -> class mapping, the confusion matrix,
overall accuracy, Cohen's kappa and per-class scores, the plots and the
text report.

Counterpart of ``rs_image_segmentation_tpu.pipeline.evaluate``. The counts
run on the evaluator's device (``ops.stats``, exact integers); the scores
are float64 host math that equals ``sklearn.metrics``. Rasters are read
and plots and the report written on the host. The file driver
``ClassificationEvaluator.evaluate_classification`` is
:meth:`~ClassificationEvaluator.evaluate_and_report` (metrics and report,
no plotting library needed) followed by the three plots.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, host_numpy, resolve_device
from ..core.config import EVAL_CLASS_COLORS, EVAL_CLASS_NAMES
from ..io.tiff import read_tiff
from ..ops.resize import resize_nearest
from ..ops.stats import (cohen_kappa, confusion_matrix,
                         map_clusters_to_classes, overall_accuracy,
                         per_class_metrics)


def _load_label_raster(path: str) -> np.ndarray:
    """A label map from a ``.npy`` or the first band of a GeoTIFF."""
    if path.endswith(".npy"):
        return np.load(path)
    arr, _ = read_tiff(path)
    return arr[0]


def _labels(x, device: torch.device) -> torch.Tensor:
    """Labels (an array or a tensor) as a tensor on ``device``; an array of
    unsigned integers wider than a byte (a uint16 GeoTIFF) as int64, which
    torch compares on every device."""
    if (isinstance(x, np.ndarray) and x.dtype.kind == "u"
            and x.dtype.itemsize > 1):
        x = x.astype(np.int64)
    return as_tensor(x, device)


class ClassificationEvaluator:
    """The reference's evaluator, counting on ``device`` (CUDA unless
    named). Inputs are arrays or tensors."""

    def __init__(self, class_names: Optional[Dict[int, str]] = None,
                 class_colors: Optional[Dict[int, tuple]] = None,
                 device: DeviceLike = None):
        self.class_names = class_names or dict(EVAL_CLASS_NAMES)
        self.class_colors = class_colors or dict(EVAL_CLASS_COLORS)
        self.device = resolve_device(device)

    # -- loading -----------------------------------------------------------
    def load_classification_result(self, path: str) -> np.ndarray:
        return _load_label_raster(path)

    def load_roi_mask(self, path: str) -> np.ndarray:
        return _load_label_raster(path)

    def extract_valid_samples(self, classification, roi
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(predicted, true) int64 labels of the pixels where ``roi > 0``;
        ``roi`` is nearest-resized to the classification's shape first
        when they differ."""
        pred = _labels(classification, self.device)
        roi = _labels(roi, self.device)
        if roi.shape != pred.shape:
            roi = resize_nearest(roi, tuple(pred.shape))
        valid = roi > 0
        return pred[valid].to(torch.int64), roi[valid].to(torch.int64)

    # -- mapping + metrics ---------------------------------------------------
    def map_clusters_to_classes(self, pred, truth) -> torch.Tensor:
        """Each cluster of ``pred`` -> its majority true class
        (``ops.stats.map_clusters_to_classes``)."""
        pred = _labels(pred, self.device)
        truth = _labels(truth, self.device)
        return map_clusters_to_classes(pred, truth, int(pred.max()) + 1,
                                       int(truth.max()) + 1)

    def calculate_metrics(self, y_true, y_pred) -> Dict:
        """Confusion matrix (host int64), OA, kappa and per-class scores
        over the labels present in either input, sorted."""
        y_true = _labels(y_true, self.device)
        y_pred = _labels(y_pred, self.device)
        labels = sorted(set(torch.unique(y_true).tolist())
                        | set(torch.unique(y_pred).tolist()))
        cm = confusion_matrix(y_true, y_pred, labels).cpu().numpy()
        per = per_class_metrics(cm)
        return {
            "labels": labels,
            "confusion_matrix": cm,
            "overall_accuracy": overall_accuracy(cm),
            "kappa": cohen_kappa(cm),
            "per_class": {
                int(lab): {
                    "precision": float(per["precision"][i]),
                    "recall": float(per["recall"][i]),
                    "f1": float(per["f1"][i]),
                    "support": int(per["support"][i]),
                }
                for i, lab in enumerate(labels)
            },
        }

    # -- plots (host, matplotlib) ----------------------------------------------
    def plot_confusion_matrix(self, metrics: Dict, path: str) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        cm = np.asarray(metrics["confusion_matrix"])
        labels = metrics["labels"]
        names = [self.class_names.get(int(lab), str(lab)) for lab in labels]
        row_sum = cm.sum(axis=1, keepdims=True).astype(np.float64)
        pct = np.divide(cm, row_sum, out=np.zeros_like(cm, np.float64),
                        where=row_sum > 0) * 100
        fig, ax = plt.subplots(figsize=(7, 6))
        im = ax.imshow(cm, cmap="Blues")
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, f"{cm[i, j]}\n{pct[i, j]:.1f}%",
                        ha="center", va="center", fontsize=9,
                        color="white" if cm[i, j] > cm.max() / 2 else "black")
        ax.set_xticks(range(len(names)), names, rotation=45, ha="right")
        ax.set_yticks(range(len(names)), names)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title("Confusion matrix")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)

    def plot_accuracy_comparison(self, metrics: Dict, path: str) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        labels = metrics["labels"]
        names = [self.class_names.get(int(lab), str(lab)) for lab in labels]
        per = metrics["per_class"]
        fig, axes = plt.subplots(1, 2, figsize=(13, 5))
        axes[0].bar(["OA", "Kappa"],
                    [metrics["overall_accuracy"], metrics["kappa"]],
                    color=["tab:blue", "tab:orange"])
        axes[0].set_ylim(0, 1.05)
        axes[0].set_title("Overall accuracy / Kappa")
        for i, (m, c) in enumerate((("precision", "tab:blue"),
                                    ("recall", "tab:orange"),
                                    ("f1", "tab:green"))):
            axes[1].bar(np.arange(len(labels)) + (i - 1) * 0.25,
                        [per[int(lab)][m] for lab in labels], width=0.25,
                        label=m, color=c)
        axes[1].set_xticks(range(len(names)), names, rotation=30, ha="right")
        axes[1].set_ylim(0, 1.05)
        axes[1].legend()
        axes[1].set_title("Per-class metrics")
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)

    def plot_classification_comparison(self, classification, mapped, roi,
                                       path: str) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.colors import ListedColormap

        classification, mapped, roi = (
            np.asarray(host_numpy(x)) for x in (classification, mapped, roi))
        max_lab = int(max(classification.max(), mapped.max(), roi.max()))
        colors = [self.class_colors.get(i, (0.5, 0.5, 0.5))
                  for i in range(max_lab + 1)]
        cmap = ListedColormap(colors)
        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        for ax, (img, title) in zip(axes, [
                (classification, "Raw classification"),
                (mapped, "Mapped to classes"),
                (roi, "Reference ROI")]):
            ax.imshow(img, cmap=cmap, vmin=0, vmax=max_lab,
                      interpolation="nearest")
            ax.set_title(title)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)

    # -- report ------------------------------------------------------------------
    def generate_evaluation_report(self, metrics: Dict, path: str) -> str:
        """The OA / kappa / per-class / confusion-matrix text report,
        written to ``path`` and returned."""
        lines = ["=" * 60,
                 "Classification accuracy evaluation report",
                 "=" * 60, "",
                 f"Overall Accuracy (OA): {metrics['overall_accuracy']:.4f}",
                 f"Cohen's Kappa:         {metrics['kappa']:.4f}", "",
                 "Per-class metrics:",
                 f"{'class':<16}{'precision':>10}{'recall':>10}"
                 f"{'f1':>10}{'support':>10}"]
        for lab in metrics["labels"]:
            p = metrics["per_class"][int(lab)]
            name = self.class_names.get(int(lab), str(lab))
            lines.append(f"{name:<16}{p['precision']:>10.3f}"
                         f"{p['recall']:>10.3f}{p['f1']:>10.3f}"
                         f"{p['support']:>10d}")
        lines += ["", "Confusion matrix (rows=true, cols=predicted):"]
        for row in metrics["confusion_matrix"]:
            lines.append("  " + " ".join(f"{v:>8d}" for v in row))
        report = "\n".join(lines) + "\n"
        with open(path, "w") as f:
            f.write(report)
        return report

    # -- orchestration -------------------------------------------------------------
    def evaluate_and_report(self, classification_file: str, roi_file: str,
                            output_dir: str, map_clusters: bool = True
                            ) -> Tuple[Dict, np.ndarray, np.ndarray,
                                       np.ndarray]:
        """The metrics and report part of :meth:`evaluate_classification`:
        read both rasters, resize the ROI to the map when they differ,
        map clusters to their majority class (``map_clusters``), count on
        the device and write ``evaluation_report.txt``. Returns (metrics,
        the map, the mapped map, the ROI), host arrays."""
        os.makedirs(output_dir, exist_ok=True)
        classification = _labels(
            self.load_classification_result(classification_file),
            self.device)
        roi = _labels(self.load_roi_mask(roi_file), self.device)
        if roi.shape != classification.shape:
            roi = resize_nearest(roi, tuple(classification.shape))
        y_pred_raw, y_true = self.extract_valid_samples(classification, roi)
        if map_clusters:
            mapped_full = self.map_clusters_to_classes(
                classification.to(torch.int64), roi.to(torch.int64))
            y_pred = mapped_full[roi > 0]
        else:
            mapped_full = classification
            y_pred = y_pred_raw
        metrics = self.calculate_metrics(y_true, y_pred)
        self.generate_evaluation_report(
            metrics, os.path.join(output_dir, "evaluation_report.txt"))
        return (metrics, classification.cpu().numpy(),
                mapped_full.cpu().numpy(), roi.cpu().numpy())

    def evaluate_classification(self, classification_file: str,
                                roi_file: str, output_dir: str,
                                map_clusters: bool = True) -> Dict:
        """Stage 4 on files: :meth:`evaluate_and_report`, then the
        confusion-matrix, accuracy and map-comparison PNGs."""
        metrics, classification, mapped_full, roi = self.evaluate_and_report(
            classification_file, roi_file, output_dir, map_clusters)
        self.plot_confusion_matrix(
            metrics, os.path.join(output_dir, "confusion_matrix.png"))
        self.plot_accuracy_comparison(
            metrics, os.path.join(output_dir, "accuracy_comparison.png"))
        self.plot_classification_comparison(
            classification, mapped_full, roi,
            os.path.join(output_dir, "classification_comparison.png"))
        return metrics


def evaluate_classification(pred, gt, class_names=None,
                            save_dir: Optional[str] = None,
                            device: DeviceLike = None) -> Dict:
    """The pixels where ``gt > 0``, labels 1..max: confusion matrix (host
    int64), OA and kappa, counted on ``device`` (CUDA unless named); with
    ``save_dir``, also the confusion-matrix PNG there."""
    dev = resolve_device(device)
    pred, gt = _labels(pred, dev), _labels(gt, dev)
    mask = gt > 0
    y_true = gt[mask].to(torch.int64)
    y_pred = pred[mask].to(torch.int64)
    n = int(max(y_true.max(), y_pred.max()))
    labels = list(range(1, n + 1))
    cm = confusion_matrix(y_true, y_pred, labels).cpu().numpy()
    out = {"confusion_matrix": cm,
           "overall_accuracy": overall_accuracy(cm),
           "kappa": cohen_kappa(cm)}
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        ev = ClassificationEvaluator(class_names=class_names, device=dev)
        ev.plot_confusion_matrix({"confusion_matrix": cm, "labels": labels},
                                 os.path.join(save_dir,
                                              "confusion_matrix.png"))
    return out
