"""Stage 4, evaluation: cluster -> class mapping, the confusion matrix,
overall accuracy, Cohen's kappa and per-class scores.

Counterpart of ``rs_image_segmentation_tpu.pipeline.evaluate`` without
its file I/O (the raster loaders, the plots and the report file). The
counts run on the evaluator's device (``ops.stats``, exact integers);
the scores are float64 host math that equals ``sklearn.metrics``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..backend import DeviceLike, as_tensor, resolve_device
from ..ops.resize import resize_nearest
from ..ops.stats import (cohen_kappa, confusion_matrix,
                         map_clusters_to_classes, overall_accuracy,
                         per_class_metrics)


class ClassificationEvaluator:
    """The reference's evaluator, on ``device`` (CUDA unless named).
    Inputs are arrays or tensors."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def extract_valid_samples(self, classification, roi
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(predicted, true) int64 labels of the pixels where ``roi > 0``;
        ``roi`` is nearest-resized to the classification's shape first
        when they differ."""
        pred = as_tensor(classification, self.device)
        roi = as_tensor(roi, self.device)
        if roi.shape != pred.shape:
            roi = resize_nearest(roi, tuple(pred.shape))
        valid = roi > 0
        return pred[valid].to(torch.int64), roi[valid].to(torch.int64)

    def map_clusters_to_classes(self, pred, truth) -> torch.Tensor:
        """Each cluster of ``pred`` -> its majority true class
        (``ops.stats.map_clusters_to_classes``)."""
        pred = as_tensor(pred, self.device)
        truth = as_tensor(truth, self.device)
        return map_clusters_to_classes(pred, truth, int(pred.max()) + 1,
                                       int(truth.max()) + 1)

    def calculate_metrics(self, y_true, y_pred) -> Dict:
        """Confusion matrix (host int64), OA, kappa and per-class scores
        over the labels present in either input, sorted."""
        y_true = as_tensor(y_true, self.device)
        y_pred = as_tensor(y_pred, self.device)
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


def evaluate_classification(pred, gt, device: DeviceLike = None) -> Dict:
    """The pixels where ``gt > 0``, labels 1..max: confusion matrix (host
    int64), OA and kappa, counted on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    pred, gt = as_tensor(pred, dev), as_tensor(gt, dev)
    mask = gt > 0
    y_true = gt[mask].to(torch.int64)
    y_pred = pred[mask].to(torch.int64)
    n = int(max(y_true.max(), y_pred.max()))
    cm = confusion_matrix(y_true, y_pred, list(range(1, n + 1))
                          ).cpu().numpy()
    return {"confusion_matrix": cm,
            "overall_accuracy": overall_accuracy(cm),
            "kappa": cohen_kappa(cm)}
