"""PyTorch port vs the JAX package and ``sklearn.metrics``: the stage-4
metrics (``ops.stats``), the evaluator (``pipeline.evaluate``), and Otsu's
threshold and the median (``ops.threshold``), on the CPU. Counts are
integers and the scores the same float64 formulas, so every result is
bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.ops import stats as jstats
from rs_image_segmentation_tpu.ops import threshold as jthr
from rs_image_segmentation_tpu.pipeline import evaluate as jeval
from rs_image_segmentation_tpu_torch.ops import stats as tstats
from rs_image_segmentation_tpu_torch.ops import threshold as tthr
from rs_image_segmentation_tpu_torch.pipeline import evaluate as teval


def _labels(seed, n=2000, lo=1, hi=5):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, n), rng.integers(lo, hi, n)


@pytest.mark.parametrize("labels", [[1, 2, 3, 4], [4, 2, 1, 3], [1, 2, 3]],
                         ids=["sorted", "unsorted", "one_left_out"])
def test_metrics_bit_equal_jax_and_sklearn(labels):
    from sklearn.metrics import (accuracy_score, cohen_kappa_score,
                                 confusion_matrix,
                                 precision_recall_fscore_support)
    yt, yp = _labels(42)
    cm, oa, kappa, per = tstats.evaluate_predictions(
        torch.from_numpy(yt), torch.from_numpy(yp), labels)
    jcm, joa, jkappa, jper = jstats.evaluate_predictions(
        jnp.asarray(yt), jnp.asarray(yp), labels)
    np.testing.assert_array_equal(cm, jcm)
    np.testing.assert_array_equal(cm, confusion_matrix(yt, yp,
                                                       labels=labels))
    assert (oa, kappa) == (joa, jkappa)
    for k in per:
        np.testing.assert_array_equal(per[k], jper[k])
    if len(labels) < 4:
        # sklearn scores a subset of labels against every prediction; the
        # matrix (and so both packages) only against the labels kept
        return
    assert oa == accuracy_score(yt, yp)
    assert abs(kappa - cohen_kappa_score(yt, yp)) < 1e-15
    p, r, f, s = precision_recall_fscore_support(yt, yp, labels=labels,
                                                 zero_division=0)
    np.testing.assert_allclose(per["precision"], p, rtol=1e-15)
    np.testing.assert_allclose(per["recall"], r, rtol=1e-15)
    np.testing.assert_allclose(per["f1"], f, rtol=1e-15)
    np.testing.assert_array_equal(per["support"], s)


def test_confusion_matrix_counts_exactly_past_f32():
    """2^24 + 3 pairs in one cell: exact in int64 (an f32 count would
    round)."""
    n = (1 << 24) + 3
    y = torch.ones(n, dtype=torch.int64)
    cm = tstats.confusion_matrix(y, y, [0, 1])
    assert cm.tolist() == [[0, 0], [0, n]]


def _mapping_oracle(pred, truth, n_pred):
    """The reference's majority mapping, host numpy."""
    mapping = {}
    for c in range(n_pred):
        sel = (pred == c) & (truth > 0)
        mapping[c] = np.bincount(truth[sel]).argmax() if sel.any() else 0
    return np.vectorize(mapping.get)(pred)


def test_map_clusters_majority_vote_ties_and_empty_clusters():
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 7, (50, 50))
    pred[pred == 6] = 5                 # cluster 6 has no pixel
    truth = np.zeros((50, 50), np.int64)
    truth[rng.random((50, 50)) < 0.3] = rng.integers(1, 4)
    truth[pred == 4] = 0                # cluster 4 has no labelled pixel
    # cluster 0: a tie between classes 2 and 3 goes to 2
    sel = np.flatnonzero(pred.reshape(-1) == 0)
    truth.reshape(-1)[sel] = 0
    truth.reshape(-1)[sel[:4]] = [3, 2, 3, 2]
    got = tstats.map_clusters_to_classes(torch.from_numpy(pred),
                                         torch.from_numpy(truth), 7, 5)
    ref = np.asarray(jstats.map_clusters_to_classes(
        jnp.asarray(pred), jnp.asarray(truth), 7, 5))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(),
                                  _mapping_oracle(pred, truth, 7))
    assert int(got.reshape(-1)[sel[0]]) == 2
    assert set(got[torch.from_numpy(pred == 4)].tolist()) == {0}


def _maps(seed, shape=(40, 48)):
    rng = np.random.default_rng(seed)
    pred = rng.integers(1, 8, shape).astype(np.uint8)
    roi = np.where(rng.random(shape) < 0.4, rng.integers(1, 5, shape), 0)
    return pred, roi.astype(np.uint8)


def test_evaluator_matches_jax():
    pred, roi = _maps(4)
    ev, jev = teval.ClassificationEvaluator(device="cpu"), \
        jeval.ClassificationEvaluator()
    p, t = ev.extract_valid_samples(pred, roi)
    jp, jt = jev.extract_valid_samples(pred, roi)
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_array_equal(t.numpy(), jt)
    mapped = ev.map_clusters_to_classes(p, t)
    jmapped = jev.map_clusters_to_classes(jp, jt)
    np.testing.assert_array_equal(mapped.numpy(), jmapped)
    got = ev.calculate_metrics(t, mapped)
    ref = jev.calculate_metrics(jt, jmapped)
    assert [int(v) for v in got["labels"]] == [int(v) for v in ref["labels"]]
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  ref["confusion_matrix"])
    for k in ("overall_accuracy", "kappa", "per_class"):
        assert got[k] == ref[k], k


def test_extract_valid_samples_resizes_the_roi():
    pred, _ = _maps(5, (60, 72))
    _, roi = _maps(6, (40, 48))         # the ROI at another resolution
    ev, jev = teval.ClassificationEvaluator(device="cpu"), \
        jeval.ClassificationEvaluator()
    for got, ref in zip(ev.extract_valid_samples(pred, roi),
                        jev.extract_valid_samples(pred, roi)):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_evaluate_classification_matches_jax():
    pred, gt = _maps(7)
    got = teval.evaluate_classification(pred, gt, device="cpu")
    ref = jeval.evaluate_classification(pred, gt)
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  ref["confusion_matrix"])
    assert got["confusion_matrix"].shape == (7, 7)
    assert (got["overall_accuracy"], got["kappa"]) == (
        ref["overall_accuracy"], ref["kappa"])


# ---------------------------------------------------------- ops.threshold

def _images():
    rng = np.random.default_rng(9)
    bimodal = np.concatenate([rng.normal(-1.0, 0.3, 2000),
                              rng.normal(2.0, 0.5, 1840)]).reshape(60, 64)
    flat = np.full((30, 40), 0.25)
    with_nan = rng.normal(0.0, 1.0, (48, 50))
    with_nan[::7, ::5] = np.nan
    return {"bimodal": bimodal, "flat": flat, "with_nan": with_nan}


@pytest.mark.parametrize("name", ["bimodal", "flat", "with_nan"])
def test_otsu_and_median_match_jax(name):
    x = _images()[name].astype(np.float32)
    u8 = np.clip(np.nan_to_num(x) * 60 + 120, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(
        tthr.histogram256(torch.from_numpy(u8)).numpy(),
        np.asarray(jthr.histogram256(jnp.asarray(u8))))
    assert float(tthr.otsu_threshold_u8(torch.from_numpy(u8))) == float(
        jthr.otsu_threshold_u8(jnp.asarray(u8)))
    for above in (True, False):
        np.testing.assert_array_equal(
            tthr.threshold_otsu(torch.from_numpy(x), above).numpy(),
            np.asarray(jthr.threshold_otsu(jnp.asarray(x), above)))
    finite = x[np.isfinite(x)]
    assert float(tthr.median(torch.from_numpy(finite))) == float(
        jthr.median(jnp.asarray(finite)))
