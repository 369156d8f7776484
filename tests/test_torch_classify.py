"""PyTorch port vs the JAX package on the CPU: forest prediction
(``models.forest``: ``forest_from_sklearn``, the GEMM form within and past
the leaf cap, ``forest_predict``) and stage 3 (``pipeline.classify``: KMeans on a
stage-2 feature dict, training samples, ``forest_classify``, the
three-class map)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import FeatureStageConfig
from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.pipeline import classify as jclassify
from rs_image_segmentation_tpu.pipeline import features as jfeat
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.pipeline import classify as tclassify
from rs_image_segmentation_tpu_torch.pipeline import features as tfeat
from rs_image_segmentation_tpu_torch.pipeline import turbo as tturbo
from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
    ClassificationEvaluator)
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    stretch_stats_batch, synthetic_scenes)
from tests.forest_walk_ref import fields_of, walk_labels

CFG = FeatureStageConfig()
# The KMeans fits start from different random draws, so the port's mapped
# kappa is held within a margin of the JAX package's, averaged over SEEDS:
# one fit's kappa moves with its seed. Measured on this scene with both
# packages clustering the port's planes, seeds 40-47: JAX 0.294-0.368 and
# port 0.328-0.388 on the auto keys, JAX 0.321-0.354 and port 0.292-0.370
# on the 19-channel stack, while the means agree (JAX 0.342 / port 0.354
# and 0.332 / 0.331).
KAPPA_MARGIN = 0.05
SEEDS = (42, 43, 44, 45)


@pytest.fixture(scope="module")
def sk_forest():
    """A fitted sklearn forest on 19 random features, with fresh pixels
    to predict."""
    from sklearn.ensemble import RandomForestClassifier
    rng = np.random.default_rng(0)
    x = rng.random((300, 19)).astype(np.float32)
    y = 1 + (x[:, 2] > 0.5) + 2 * (x[:, 0] + 0.3 * rng.random(300) > 0.6)
    clf = RandomForestClassifier(n_estimators=8, max_depth=6,
                                 random_state=0).fit(x, y)
    return clf, rng.random((2500, 19)).astype(np.float32)


def _flat_fields(forest):
    return {k: np.asarray(v) for k, v in forest._asdict().items()}


def test_forest_from_sklearn_matches_jax(sk_forest):
    clf, _ = sk_forest
    forest, depth = tforest.forest_from_sklearn(clf)
    jf, jdepth = jforest.forest_from_sklearn(clf)
    assert depth == jdepth == 6
    got, ref = _flat_fields(forest), _flat_fields(jf)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # JAX keeps the class labels in 32 bits (x64 off), the port as sklearn
    assert got["classes"].dtype == clf.classes_.dtype


def test_forest_predict_matches_jax_and_sklearn(sk_forest):
    clf, x = sk_forest
    forest, depth = tforest.forest_from_sklearn(clf)
    jf, _ = jforest.forest_from_sklearn(clf)
    kernels.forest_labels.launches = 0
    labels = tforest.forest_predict(forest, torch.from_numpy(x), depth)
    assert kernels.forest_labels.launches == 0       # CPU: the plain route
    ref = np.asarray(jforest.forest_predict(jf, jnp.asarray(x), depth))
    np.testing.assert_array_equal(labels.numpy(), ref)
    np.testing.assert_array_equal(labels.numpy(), clf.predict(x))
    proba = tforest.forest_predict_proba(forest, torch.from_numpy(x), depth)
    jproba = np.asarray(jforest.forest_predict_proba(jf, jnp.asarray(x),
                                                     depth))
    # the port sums leaf distributions in f64 and rounds once, the JAX
    # package in f32 over the leaves: a few f32 roundings of values <= 1
    np.testing.assert_allclose(proba.numpy(), jproba, rtol=0, atol=1e-6)
    np.testing.assert_allclose(proba.numpy(), clf.predict_proba(x),
                               rtol=0, atol=1e-6)


def test_gemm_forest_matches_jax(sk_forest):
    clf, x = sk_forest
    forest, _ = tforest.forest_from_sklearn(clf)
    jf, _ = jforest.forest_from_sklearn(clf)
    gf, jgf = tforest._gemm_for(forest, 19), jforest._gemm_for(jf, 19)
    # a 1000-row chunk splits the 2 500 rows unevenly
    proba = tforest.gemm_forest_proba(gf, torch.from_numpy(x), chunk=1000)
    jproba = np.asarray(jforest.gemm_forest_proba(jgf, jnp.asarray(x), 1000))
    np.testing.assert_allclose(proba.numpy(), jproba, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tforest.gemm_forest_predict(gf, torch.from_numpy(x)).numpy(),
        np.asarray(jforest.gemm_forest_predict(jgf, jnp.asarray(x))))


def test_traversal_matches_jax(sk_forest, monkeypatch):
    """Past the leaf cap (patched to 16) the port's proba comes from the
    GEMM form with a sparse path; the JAX package walks the trees level
    by level there. The two agree to f32 roundings."""
    clf, x = sk_forest
    forest, depth = tforest.forest_from_sklearn(clf)
    jf, _ = jforest.forest_from_sklearn(clf)
    monkeypatch.setattr(tforest, "GEMM_MAX_LEAVES", 16)
    assert tforest._gemm_for(forest, 19).path.is_sparse
    got = tforest.forest_predict_proba(forest, torch.from_numpy(x), depth,
                                       chunk=1024)
    ref = np.asarray(jforest._traversal_proba(jf, jnp.asarray(x), depth,
                                              1024))
    # a mean of 8 f32 leaf rows, summed in another order than XLA's
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_forest_predict_past_the_leaf_cap_walks_the_trees(sk_forest,
                                                          monkeypatch):
    """Past the leaf cap (patched to 16) ``forest_predict`` still takes
    ``forest_labels`` (its plain version on the CPU) over a sparse path:
    labels equal to the JAX package's level walk, the plain walk of
    ``tests/forest_walk_ref.py`` and sklearn."""
    clf, x = sk_forest
    forest, depth = tforest.forest_from_sklearn(clf)
    jf, _ = jforest.forest_from_sklearn(clf)
    monkeypatch.setattr(tforest, "GEMM_MAX_LEAVES", 16)
    gf = tforest._gemm_for(forest, 19)
    assert gf.path.is_sparse and gf.path.shape[1] > 16
    labels = tforest.forest_predict(forest, torch.from_numpy(x), depth)
    ref = np.asarray(jforest.forest_predict(jf, jnp.asarray(x), depth))
    np.testing.assert_array_equal(labels.numpy(), ref)
    np.testing.assert_array_equal(
        labels.numpy(), walk_labels(fields_of(forest), torch.from_numpy(x)))
    np.testing.assert_array_equal(labels.numpy(), clf.predict(x))


# ------------------------------------------------------------- stage 3

@pytest.fixture(scope="module")
def scene():
    """A 7 x 64 x 80 synthetic scene: its stage-1 artifact (through its
    exact stretch LUT, f32 levels), and the port's rule map of it."""
    raw = synthetic_scenes(1, 64, 80, seed=2)
    luts = stretch_stats_batch(raw)[0]
    arr = np.stack([luts[0][c][raw[0][c]] for c in range(7)]).astype(
        np.float32)
    rule = tturbo.rule_based_scenes_turbo(raw[0], luts[0], CFG,
                                          device="cpu").numpy()
    return arr, rule


@pytest.fixture(scope="module")
def feature_dicts(scene):
    """Stage 2's feature dict from each package, as the stage-3 driver
    reads it: the top-level planes, the 19-channel stack and the shape."""
    arr, _ = scene
    out = []
    for feats, hier in (
            tfeat.extract_features(arr, CFG, include_entropy=False,
                                   device="cpu"),
            jfeat.extract_features(jnp.asarray(arr), CFG,
                                   include_entropy=False)):
        d = {k: (v if isinstance(v, torch.Tensor) else np.asarray(v))
             for k, v in feats.items() if not isinstance(v, dict)}
        d["hierarchical_all"] = (hier["all"] if isinstance(
            hier["all"], torch.Tensor) else np.asarray(hier["all"]))
        d["height"], d["width"] = arr.shape[1:]
        out.append(d)
    return out


def _mapped_kappa(maps, truth) -> float:
    ev = ClassificationEvaluator(device="cpu")
    pred, true = ev.extract_valid_samples(maps, truth)
    return ev.calculate_metrics(true, ev.map_clusters_to_classes(pred, true)
                                )["kappa"]


@pytest.mark.parametrize("keys", ["auto", "hierarchical_all"])
def test_kmeans_classify_on_feature_dicts(feature_dicts, scene, keys):
    tdict, jdict = feature_dicts
    _, rule = scene
    if keys == "auto":
        keys = tclassify.auto_kmeans_keys(tdict)
        # the same planes; their order is each dict's (jit sorts its keys)
        assert sorted(keys) == sorted(jclassify.auto_kmeans_keys(jdict))
        assert "ndvi" in keys and "hierarchical_all" not in keys
    else:
        keys = [keys]
    port, ref = [], []
    for seed in SEEDS:
        got = tclassify.kmeans_classify(tdict, keys, 7, seed=seed,
                                        device="cpu")
        assert got.shape == (64, 80) and got.dtype == torch.uint8
        assert int(got.min()) >= 1 and int(got.max()) <= 7
        port.append(_mapped_kappa(got, rule))
        ref.append(_mapped_kappa(
            jclassify.kmeans_classify(jdict, keys, 7, seed=seed), rule))
    assert np.mean(port) >= np.mean(ref) - KAPPA_MARGIN, (port, ref)


def test_kmeans_classify_needs_a_usable_key(feature_dicts):
    with pytest.raises(ValueError, match="no usable features"):
        tclassify.kmeans_classify(feature_dicts[0], ["pca_result"], 7,
                                  device="cpu")


def test_forest_classify_matches_jax(feature_dicts, scene):
    tdict, jdict = feature_dicts
    _, rule = scene
    roi = np.where(np.random.default_rng(1).random(rule.shape) < 0.02,
                   rule, 0)
    roi = roi.astype(np.float64)
    roi[0, :3] = np.nan                 # NaN labels are not samples
    fa = np.asarray(jdict["hierarchical_all"])
    x, y = tclassify.prepare_training_samples(fa, roi)
    jx, jy = jclassify.prepare_training_samples(fa, roi)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    forest, depth = tforest.fit_random_forest(x, y, n_estimators=20,
                                              seed=3)
    jf, jdepth = jforest.fit_random_forest(x, y, n_estimators=20, seed=3)
    got = tclassify.forest_classify(fa, forest, depth, device="cpu")
    ref = jclassify.forest_classify(fa, jf, jdepth)
    assert got.shape == (64, 80)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the port's own stack, as a tensor, classifies within the stacks'
    # ~1e-6 difference (ROADMAP queue 3)
    own = tclassify.forest_classify(tdict["hierarchical_all"], forest,
                                    depth, device="cpu")
    assert (own.numpy() == ref).mean() >= 0.999
    with pytest.raises(ValueError, match="no training samples"):
        tclassify.prepare_training_samples(fa, np.zeros_like(roi))


@pytest.mark.parametrize("method", ["rule_based", "random_forest", "kmeans",
                                    "other"])
def test_three_class_map_matches_jax(method):
    result = np.random.default_rng(4).integers(0, 9, (30, 40)).astype(
        np.uint8)
    got = tclassify.create_three_class_map(torch.from_numpy(result), method,
                                           device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), jclassify.create_three_class_map(result, method))
    mapping = {"water": [7], "vegetation": [1, 2], "builtup": [2, 3]}
    np.testing.assert_array_equal(
        tclassify.create_three_class_map(result, "kmeans", mapping,
                                         device="cpu").numpy(),
        jclassify.create_three_class_map(result, "kmeans", mapping))


def test_stage3_and_stage4_entry_points_need_a_device(monkeypatch, scene,
                                                      sk_forest):
    from rs_image_segmentation_tpu_torch.pipeline import evaluate as teval
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr, rule = scene
    raw = synthetic_scenes(1, 16, 16, seed=0)
    luts = stretch_stats_batch(raw)[0]
    forest, depth = tforest.forest_from_sklearn(sk_forest[0])
    feats = {"ndvi": arr[0], "height": 64, "width": 80}
    for call in (
            lambda: tturbo.kmeans_scenes_turbo_batch(raw, luts),
            lambda: tturbo.kmeans_scenes_turbo(raw[0], luts[0]),
            lambda: tclassify.kmeans_classify(feats, ["ndvi"], 7),
            lambda: tclassify.forest_classify(
                np.zeros((4, 4, 19), np.float32), forest, depth),
            lambda: teval.ClassificationEvaluator(),
            lambda: teval.evaluate_classification(rule, rule),
            lambda: tclassify.create_three_class_map(rule, "kmeans")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
