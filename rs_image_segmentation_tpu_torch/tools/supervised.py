"""The bundled supervised workflow: samples.pkl -> train RF -> full-scene
predict -> class_map.npy + PNG.

Counterpart of ``rs_image_segmentation_tpu.tools.supervised``. Training is
host-side (sklearn's ``RandomForestClassifier`` where it imports, read
through ``models.forest.forest_from_sklearn``, else the port's NumPy CART
trainer, which gives the JAX package's trees for a seed). Every predict
goes through ``models.forest.forest_predict`` on the device, whose labels
come from the CUDA kernel ``ops.kernels.forest_labels`` on a CUDA tensor,
for a forest of any size. The grid search's fold loop and the validation
report's metrics (``ops.stats.evaluate_predictions``) run there too.

``run_supervised_workflow`` is split as ``pipeline.classify`` splits stage
3: ``train_predict_and_write`` trains, predicts and writes
``class_map.npy`` (and the joblib model where sklearn is present) without
a plotting library; the PNG is drawn after it.

Entry points that touch tensors run on CUDA unless the caller names a
device.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, resolve_device
from ..models.forest import (FlatForest, fit_random_forest,
                             forest_from_sklearn, forest_predict)
from ..ops.stats import evaluate_predictions
from .sampling import training_matrix_from_samples


def train_random_forest_from_samples(x: np.ndarray, y: np.ndarray,
                                     n_estimators: int = 100,
                                     max_depth: Optional[int] = None,
                                     seed: int = 42,
                                     use_sklearn: bool = True,
                                     model_path: Optional[str] = None
                                     ) -> Tuple[FlatForest, int]:
    """Plain RF(100, None, rs=42) like the reference's supervised
    workflow, persisting a joblib model when sklearn is available. Returns
    (forest on the CPU, max depth)."""
    if use_sklearn:
        try:
            from sklearn.ensemble import RandomForestClassifier
            clf = RandomForestClassifier(n_estimators=n_estimators,
                                         max_depth=max_depth,
                                         random_state=seed)
            clf.fit(x, y)
            if model_path:
                import joblib
                os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
                joblib.dump(clf, model_path)
            return forest_from_sklearn(clf)
        except ImportError:
            pass
    return fit_random_forest(x, y, n_estimators, max_depth, seed)


def _predict_rows(forest: FlatForest, depth: int, x: np.ndarray,
                  dev) -> np.ndarray:
    """Forest labels of (N, F) host rows, predicted on ``dev``."""
    return forest_predict(forest, as_tensor(x, dev, torch.float32), depth,
                          chunk=max(64, len(x))).cpu().numpy()


def train_random_forest_grid(x: np.ndarray, y: np.ndarray,
                             max_depth_grid=(10, 20, None),
                             n_estimators: int = 100, seed: int = 42,
                             cv: int = 3, device: DeviceLike = None
                             ) -> Tuple[FlatForest, int, dict]:
    """GridSearchCV(RandomForestClassifier, {'max_depth': [10, 20, None]},
    cv=3) equivalent: k-fold accuracy per grid point, each fold predicted
    on ``device`` (CUDA unless named), refit on the winner."""
    dev = resolve_device(device)
    n = len(y)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    folds = np.array_split(order, cv)
    scores = {}
    for depth in max_depth_grid:
        accs = []
        for i in range(cv):
            val = folds[i]
            trn = np.concatenate([folds[j] for j in range(cv) if j != i])
            if len(np.unique(y[trn])) < 2:
                continue
            forest, d = fit_random_forest(x[trn], y[trn], n_estimators,
                                          depth, seed)
            pred = _predict_rows(forest, d, x[val], dev)
            accs.append(float((pred == y[val]).mean()))
        scores[depth] = float(np.mean(accs)) if accs else 0.0
    best = max(scores, key=lambda k: scores[k])
    forest, d = fit_random_forest(x, y, n_estimators, best, seed)
    return forest, d, {"best_max_depth": best, "cv_scores": scores}


def train_with_validation_report(x: np.ndarray, y: np.ndarray,
                                 feature_names=None, n_estimators: int = 100,
                                 test_size: float = 0.3, seed: int = 42,
                                 device: DeviceLike = None
                                 ) -> Tuple[FlatForest, int, dict]:
    """The reference's train_random_forest_classifier behavior: stratified
    70/30 split, fit, validation accuracy / Kappa / per-class report
    (predicted and counted on ``device``, CUDA unless named) / sorted
    feature importances (where sklearn imports). Returns
    (forest, depth, report_dict)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    classes, counts = np.unique(y, return_counts=True)
    # stratified split when every class has >= 2 samples
    if len(classes) > 1 and counts.min() >= 2:
        tr_idx, va_idx = [], []
        for c in classes:
            idx = rng.permutation(np.where(y == c)[0])
            n_val = max(1, int(round(len(idx) * test_size)))
            va_idx.append(idx[:n_val])
            tr_idx.append(idx[n_val:])
        tr = np.concatenate(tr_idx)
        va = np.concatenate(va_idx)
    else:
        perm = rng.permutation(len(y))
        n_val = int(len(y) * test_size)
        va, tr = perm[:n_val], perm[n_val:]

    forest, depth = train_random_forest_from_samples(
        x[tr], y[tr], n_estimators=n_estimators, seed=seed)
    report: dict = {"n_train": int(len(tr)), "n_val": int(len(va))}
    if len(va):
        pred = _predict_rows(forest, depth, x[va], dev)
        labels = sorted(set(np.unique(y[va])) | set(np.unique(pred)))
        cm, oa, kappa, per = evaluate_predictions(
            as_tensor(y[va], dev, torch.int64),
            as_tensor(pred, dev, torch.int64), labels)
        report.update(accuracy=oa, kappa=kappa, confusion_matrix=cm,
                      labels=labels,
                      per_class={int(l): {k: float(v[i]) for k, v in
                                          per.items()}
                                 for i, l in enumerate(labels)})
    # impurity-based importances from the full-data sklearn fit when present
    try:
        from sklearn.ensemble import RandomForestClassifier
        clf = RandomForestClassifier(n_estimators=n_estimators,
                                     random_state=seed).fit(x[tr], y[tr])
        imp = clf.feature_importances_
        names = feature_names or [f"feature_{i}" for i in range(x.shape[1])]
        order = np.argsort(imp)[::-1]
        report["feature_importances"] = [(names[i], float(imp[i]))
                                         for i in order]
    except ImportError:
        pass
    return forest, depth, report


def predict_image(forest: FlatForest, depth: int, feature_map: np.ndarray,
                  device: DeviceLike = None) -> np.ndarray:
    """Full-scene predict of an (H, W, F) feature map (NaN read as 0) on
    ``device`` (CUDA unless named) -> (H, W) int32 host labels, the dtype
    of the JAX package's class_map.npy."""
    h, w, f = feature_map.shape
    x = np.nan_to_num(feature_map.reshape(-1, f), nan=0.0).astype(np.float32)
    pred = forest_predict(forest, as_tensor(x, resolve_device(device)),
                          depth)
    return pred.cpu().numpy().astype(np.int32).reshape(h, w)


def train_predict_and_write(samples_path: str, features_npy: str,
                            output_dir: str, use_sklearn: bool = True,
                            device: DeviceLike = None) -> np.ndarray:
    """The compute-and-write part of :func:`run_supervised_workflow`:
    samples.pkl + all_hierarchical_features.npy -> the forest (its joblib
    model ``rf_samples_model.pkl`` where sklearn is present) -> the
    predicted ``class_map.npy``. Needs no plotting library."""
    dev = resolve_device(device)
    feature_map = np.load(features_npy)
    x, y = training_matrix_from_samples(samples_path, feature_map)
    model_path = os.path.join(output_dir, "rf_samples_model.pkl")
    forest, depth = train_random_forest_from_samples(
        x, y, use_sklearn=use_sklearn, model_path=model_path)
    class_map = predict_image(forest, depth, feature_map, dev)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, "class_map.npy"), class_map)
    return class_map


def run_supervised_workflow(samples_path: str, features_npy: str,
                            output_dir: str, use_sklearn: bool = True,
                            device: DeviceLike = None) -> np.ndarray:
    """samples.pkl + all_hierarchical_features.npy -> rf_samples_model.pkl +
    class_map.npy (:func:`train_predict_and_write`) + the
    coarse_supervised_classification PNG."""
    class_map = train_predict_and_write(samples_path, features_npy,
                                        output_dir, use_sklearn, device)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(class_map, cmap="tab10")
    ax.set_title("Supervised classification")
    ax.axis("off")
    fig.savefig(os.path.join(output_dir,
                             "coarse_supervised_classification_AA.png"),
                dpi=150)
    plt.close(fig)
    return class_map
