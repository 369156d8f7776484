"""Evaluation metrics: the confusion matrix, overall accuracy, Cohen's
kappa, per-class precision / recall / F1, and the cluster -> class
majority mapping.

Counterpart of ``rs_image_segmentation_tpu.ops.stats``. The counts run on
the labels' device as integer ``torch.bincount`` calls, exact at any N (the
JAX package counts with an f32 one-hot matmul, exact below 2^24). The
scores are the JAX package's float64 host formulas over the integer
matrix, which equal ``sklearn.metrics``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _label_index(y: torch.Tensor, labels: torch.Tensor):
    """Each value of ``y`` as its position in ``labels``, and whether it is
    one of them."""
    srt, order = torch.sort(labels)
    y = y.reshape(-1).to(torch.int64)
    pos = torch.clamp_max(torch.searchsorted(srt, y), labels.numel() - 1)
    return order[pos], srt[pos] == y


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     labels: Sequence[int]) -> torch.Tensor:
    """(L, L) int64 counts ``C[i, j] = #{y_true == labels[i] and y_pred ==
    labels[j]}`` on the labels' device; pairs with a value outside
    ``labels`` are not counted."""
    n_lab = len(labels)
    lab = torch.as_tensor(list(labels), dtype=torch.int64,
                          device=y_true.device)
    ti, t_in = _label_index(y_true, lab)
    pi, p_in = _label_index(y_pred, lab)
    code = torch.where(t_in & p_in, ti * n_lab + pi, n_lab * n_lab)
    counts = torch.bincount(code, minlength=n_lab * n_lab + 1)
    return counts[:n_lab * n_lab].reshape(n_lab, n_lab)


def overall_accuracy(cm) -> float:
    """Exact float64 OA from an integer confusion matrix."""
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    return float(np.trace(cm) / total) if total > 0 else 0.0


def cohen_kappa(cm) -> float:
    """Unweighted Cohen's kappa, ``sklearn.metrics.cohen_kappa_score``'s
    formula (the normalised expected matrix)."""
    cm = np.asarray(cm, dtype=np.float64)
    n = cm.sum()
    sum0 = cm.sum(axis=0)
    sum1 = cm.sum(axis=1)
    expected = np.outer(sum1, sum0) / n
    w_mat = np.ones_like(cm)
    np.fill_diagonal(w_mat, 0)
    k = np.sum(w_mat * cm) / np.sum(w_mat * expected)
    return float(1.0 - k)


def per_class_metrics(cm) -> Dict[str, np.ndarray]:
    """Precision, recall, F1 and support per class, with sklearn's
    ``zero_division=0`` (float64 host math over the integer matrix)."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diagonal(cm)
    pred_tot = cm.sum(axis=0)
    true_tot = cm.sum(axis=1)
    precision = np.divide(tp, pred_tot, out=np.zeros_like(tp),
                          where=pred_tot > 0)
    recall = np.divide(tp, true_tot, out=np.zeros_like(tp),
                       where=true_tot > 0)
    denom = precision + recall
    f1 = np.divide(2.0 * precision * recall, denom,
                   out=np.zeros_like(tp), where=denom > 0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "support": true_tot.astype(np.int64)}


def evaluate_predictions(
    y_true: torch.Tensor, y_pred: torch.Tensor, labels: Sequence[int]
) -> Tuple[np.ndarray, float, float, Dict[str, np.ndarray]]:
    """The metric bundle on host types: (cm, OA, kappa, per-class)."""
    cm = confusion_matrix(y_true, y_pred, labels).cpu().numpy()
    return cm, overall_accuracy(cm), cohen_kappa(cm), per_class_metrics(cm)


def map_clusters_to_classes(pred: torch.Tensor, truth: torch.Tensor,
                            n_pred_labels: int, n_true_labels: int
                            ) -> torch.Tensor:
    """Each predicted label -> the most frequent true class among its
    pixels with ``truth > 0``, applied to ``pred``. Ties go to the lowest
    true label; a cluster with no labelled pixel maps to 0. Labels are
    assumed in [0, n)."""
    p = pred.reshape(-1).to(torch.int64)
    t = truth.reshape(-1).to(torch.int64)
    cells = n_pred_labels * n_true_labels
    ok = ((t > 0) & (t < n_true_labels) & (p >= 0) & (p < n_pred_labels))
    code = torch.where(ok, p * n_true_labels + t, cells)
    counts = torch.bincount(code, minlength=cells + 1)[:cells].reshape(
        n_pred_labels, n_true_labels)
    mapping = torch.argmax(counts, dim=1)          # first index on ties
    mapping = torch.where(counts.sum(dim=1) > 0, mapping, 0).to(pred.dtype)
    return mapping[pred.to(torch.int64)]
