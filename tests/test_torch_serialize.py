"""PyTorch port's ``models.serialize`` against the JAX package's, on the
CPU: a forest or KMeans state saved by either package loads in the other
with equal arrays, and a loaded forest gives the same maps in both
packages and in the port's serving engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.models import kmeans as jkmeans
from rs_image_segmentation_tpu.models import serialize as jserialize
from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig,
                                                         GLCMConfig)
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.models import kmeans as tkmeans
from rs_image_segmentation_tpu_torch.models import serialize as tserialize
from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
    build_stretch_lut)
from rs_image_segmentation_tpu_torch.pipeline.turbo import (
    classify_scenes_turbo)
from rs_image_segmentation_tpu_torch.serving.engine import (EngineConfig,
                                                            InferenceEngine)

SMALL_CFG = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                               levels=8))


@pytest.fixture(scope="module")
def fitted():
    """The same 12-tree forest from each package's trainer (one seed, one
    CART code), its depth, and rows to predict."""
    rng = np.random.default_rng(0)
    x = rng.random((200, 19)).astype(np.float32)
    y = rng.integers(1, 5, 200)
    tflat, tdepth = tforest.fit_random_forest(x, y, n_estimators=12, seed=3)
    jflat, jdepth = jforest.fit_random_forest(x, y, n_estimators=12, seed=3)
    assert tdepth == jdepth
    rows = rng.random((4000, 19)).astype(np.float32)
    return tflat, jflat, tdepth, rows


def _fields_equal(tflat, jflat):
    for k in tforest.FlatForest._fields:
        np.testing.assert_array_equal(getattr(tflat, k).numpy(),
                                      np.asarray(getattr(jflat, k)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_forest_npz_loads_in_both_packages(tmp_path, fitted, writer):
    tflat, jflat, depth, rows = fitted
    path = str(tmp_path / "sub" / "forest.npz")
    if writer == "port":
        tserialize.save_flat_forest(path, tflat, depth)
    else:
        jserialize.save_flat_forest(path, jflat, depth)
    t_loaded, t_depth = tserialize.load_flat_forest(path)
    j_loaded, j_depth = jserialize.load_flat_forest(path)
    assert t_depth == j_depth == depth
    assert all(getattr(t_loaded, k).device.type == "cpu"
               for k in tforest.FlatForest._fields)
    _fields_equal(t_loaded, j_loaded)
    _fields_equal(t_loaded, jflat)
    # the same maps: the port's predict on the loaded forest, JAX's on its
    # own, on the same rows
    got = tforest.forest_predict(t_loaded, torch.from_numpy(rows), t_depth)
    want = jforest.forest_predict(j_loaded, jnp.asarray(rows), j_depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_serves_a_forest_saved_by_jax(tmp_path, fitted):
    """A JAX-saved forest, loaded by the port, serves through the engine
    with maps equal to the port's direct program on the original."""
    tflat, jflat, depth, _ = fitted
    path = str(tmp_path / "forest.npz")
    jserialize.save_flat_forest(path, jflat, depth)
    forest, depth = tserialize.load_flat_forest(path)
    scene = np.random.default_rng(4).integers(0, 256, (7, 32, 32),
                                              dtype=np.uint8)
    cal = CalibrationConfig()
    lut = build_stretch_lut(scene, np.asarray(cal.gains),
                            np.asarray(cal.biases)).astype(np.uint8)
    want = classify_scenes_turbo(scene[None], lut[None],
                                 tforest._gemm_for(tflat, 19), SMALL_CFG,
                                 device="cpu")[0].numpy()
    with InferenceEngine(forest, depth, cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=1, buckets=(1,)),
                         device="cpu") as eng:
        got = eng.classify(scene, timeout=120)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kmeans_state_loads_in_both_packages(tmp_path, writer):
    rng = np.random.default_rng(1)
    x = rng.random((500, 5)).astype(np.float32)
    path = str(tmp_path / "km.npz")
    if writer == "port":
        _, state = tkmeans.kmeans_fit_predict(torch.from_numpy(x), 3, seed=0)
        tserialize.save_kmeans(path, state)
    else:
        _, state = jkmeans.kmeans_fit_predict(jnp.asarray(x), 3, seed=0)
        jserialize.save_kmeans(path, state)
    t_state = tserialize.load_kmeans(path)
    j_state = jserialize.load_kmeans(path)
    assert t_state.centroids.dtype == torch.float32
    assert t_state.n_iter.dtype == torch.int64
    for k in ("centroids", "inertia", "n_iter"):
        np.testing.assert_array_equal(getattr(t_state, k).numpy(),
                                      np.asarray(getattr(j_state, k)))
        np.testing.assert_array_equal(getattr(t_state, k).numpy(),
                                      np.asarray(getattr(state, k)))


def test_run_manifest_crosses_packages(tmp_path):
    path = str(tmp_path / "run" / "manifest.json")
    tserialize.save_run_manifest(path, stage="classify", tiles=[1, 2],
                                 shape=(7, 600, 600), where=tmp_path)
    assert jserialize.load_run_manifest(path) == tserialize.load_run_manifest(
        path) == {"stage": "classify", "tiles": [1, 2],
                  "shape": [7, 600, 600], "where": str(tmp_path)}
