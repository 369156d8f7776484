"""PyTorch port of the tools (``tools.sampling``, ``tools.supervised``,
``tools.batch``) against the JAX package's, on the CPU (``device="cpu"``):
the JAX tests' counterparts under the same names, then each tool's files
and numbers held to the JAX package's on the same inputs, made from a
numpy seed. Scenes are 7 x 32 x 32 to 7 x 48 x 48 with the JAX tests'
small GLCM configuration (window 16, step 16, 8 levels)."""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import (
    FeatureStageConfig as JFeatureStageConfig)
from rs_image_segmentation_tpu.core.config import GLCMConfig as JGLCMConfig
from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.tools import batch as jbatch
from rs_image_segmentation_tpu.tools import sampling as jsampling
from rs_image_segmentation_tpu.tools import supervised as jsupervised
from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig,
                                                         GLCMConfig)
from rs_image_segmentation_tpu_torch.core.types import GeoMeta
from rs_image_segmentation_tpu_torch.io.tiff import read_tiff, write_tiff
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.pipeline.features import (
    hierarchical_stack_fused)
from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
    build_stretch_lut)
from rs_image_segmentation_tpu_torch.tools import batch as tbatch
from rs_image_segmentation_tpu_torch.tools import sampling as tsampling
from rs_image_segmentation_tpu_torch.tools import supervised as tsupervised
from rs_image_segmentation_tpu_torch.pipeline.turbo import (
    classify_scenes_turbo, hierarchical_stack_turbo_cm)
from rs_image_segmentation_tpu_torch.tools.fixtures import deep_forest_fields
from tests.forest_walk_ref import walk_labels

CFG = FeatureStageConfig(glcm=GLCMConfig(window_size=16, step_size=16,
                                         levels=8))
JCFG = JFeatureStageConfig(glcm=JGLCMConfig(window_size=16, step_size=16,
                                            levels=8))
META = GeoMeta(transform=(30.0, 0, 5e5, 0, -30.0, 4e6))
DEV = "cpu"
# the reference's map contract (pipeline/turbo.py): a forest's map equals
# JAX's on >= 99.9 % of pixels; a stack feature within an f32 rounding of
# a split threshold may take the other branch (FMA contraction in XLA);
# measured 1.0 on every map here
MAP_AGREEMENT = 0.999


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jflat(forest):
    """The JAX package's FlatForest of the same arrays as a port one."""
    return jforest.FlatForest(*(jnp.asarray(t.numpy()) for t in forest))


def _random_forest(seed=0, n=60, n_estimators=10):
    """A forest of the port's trainer on seeded rows, with its JAX twin
    (the same NumPy CART code gives the same trees)."""
    rng = np.random.default_rng(seed)
    forest, depth = tforest.fit_random_forest(
        rng.random((n, 19)).astype(np.float32), rng.integers(1, 4, n),
        n_estimators=n_estimators, seed=0)
    return forest, depth, _jflat(forest)


def _write_scenes(root, scenes, prefix="s"):
    paths = []
    for i, s in enumerate(scenes):
        p = os.path.join(root, f"{prefix}{i}.tif")
        write_tiff(p, s, META)
        paths.append(p)
    return paths


def _maps(results):
    return [read_tiff(r["class_map"])[0][0] for r in results]


def _hold_batch_to_jax(tres, jres):
    """Maps >= MAP_AGREEMENT of JAX's; where a map is equal, the GeoTIFF
    bytes are equal too; reports hold the same numbers."""
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        tm, jm = read_tiff(t["class_map"])[0][0], read_tiff(
            j["class_map"])[0][0]
        agree = float(np.mean(tm == jm))
        assert agree >= MAP_AGREEMENT, agree
        assert os.path.basename(t["class_map"]) == os.path.basename(
            j["class_map"])
        if agree == 1.0:
            assert filecmp.cmp(t["class_map"], j["class_map"], shallow=False)
            for k in ("overall_accuracy", "kappa"):
                assert (k in t) == (k in j)
                if k in t:
                    assert t[k] == j[k]


# --- sampling -------------------------------------------------------------

def test_sampleset_roundtrip(tmp_path):
    fm = np.arange(5 * 6 * 3, dtype=np.float32).reshape(5, 6, 3)
    s = tsampling.SampleSet(fm)
    s.add(2, 3, 1)
    s.add(5, 0, 2)
    p = str(tmp_path / "samples.pkl")
    s.save(p)
    coords, labels = tsampling.SampleSet.load(p)
    assert coords.tolist() == [[2, 3], [5, 0]]
    assert labels.tolist() == [1, 2]
    x, y = s.training_matrix()
    assert np.array_equal(x[0], fm[3, 2])  # [y, x] indexing convention
    assert np.array_equal(x[1], fm[0, 5])


def test_generate_roi_mask(tmp_path):
    s = tsampling.SampleSet()
    s.add(2, 3, 1)
    s.add(100, 100, 2)  # out of bounds for 10x10 -> skipped
    p = str(tmp_path / "s.pkl")
    s.save(p)
    out = str(tmp_path / "roi.npy")
    mask = tsampling.generate_roi_mask_from_samples(p, (10, 10), out)
    assert mask.dtype == np.int16
    assert mask[3, 2] == 1
    assert mask.sum() == 1
    assert np.array_equal(np.load(out), mask)


def test_samples_pkl_and_roi_mask_equal_across_packages(tmp_path):
    """Seeded clicks saved by either package: the same samples.pkl bytes,
    each loadable by the other, the same training rows and the same
    roi_mask.npy bytes (out-of-bounds points skipped alike)."""
    rng = np.random.default_rng(5)
    fm = rng.random((40, 50, 4)).astype(np.float32)
    fm[3, 7, 1] = np.nan
    pts = np.stack([rng.integers(-3, 55, 40), rng.integers(-3, 45, 40),
                    rng.integers(1, 4, 40)], axis=1)
    pts[0] = (7, 3, 2)          # the NaN pixel, read as 0 for training
    files = {}
    for name, mod in (("port", tsampling), ("jax", jsampling)):
        s = mod.SampleSet(fm)
        for x, y, lab in pts:
            if 0 <= x < 50 and 0 <= y < 40:
                s.add(x, y, lab)
        files[name] = str(tmp_path / f"{name}_samples.pkl")
        s.save(files[name])
    assert filecmp.cmp(files["port"], files["jax"], shallow=False)
    coords, labels = jsampling.SampleSet.load(files["port"])
    assert coords.dtype == np.int64 and labels.dtype == np.int64
    assert coords.shape[1] == 2 and len(coords) == len(labels)
    xt, yt = tsampling.training_matrix_from_samples(files["port"], fm)
    xj, yj = jsampling.training_matrix_from_samples(files["jax"], fm)
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj)
    assert not np.isnan(xt).any()
    # every point, also those outside the raster, burnt by both packages
    allp = tsampling.SampleSet()
    for x, y, lab in pts:
        allp.add(x, y, lab)
    allp.save(str(tmp_path / "all.pkl"))
    masks = {name: mod.generate_roi_mask_from_samples(
        str(tmp_path / "all.pkl"), (40, 50), str(tmp_path / f"{name}.npy"))
        for name, mod in (("port", tsampling), ("jax", jsampling))}
    assert masks["port"].dtype == np.int16
    assert np.array_equal(masks["port"], masks["jax"])
    assert filecmp.cmp(str(tmp_path / "port.npy"), str(tmp_path / "jax.npy"),
                       shallow=False)


def test_normalize_for_display_matches_jax():
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    assert np.array_equal(tsampling.normalize_for_display(rgb),
                          jsampling.normalize_for_display(rgb))


# --- supervised -----------------------------------------------------------

def _blobs(seed=42, n=100, f=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, f)) * 4
    x = np.concatenate([centers[i] + rng.standard_normal((n, f))
                        for i in range(3)]).astype(np.float32)
    return x, np.repeat([1, 2, 3], n)


def test_train_with_validation_report():
    x, y = _blobs()
    forest, depth, report = tsupervised.train_with_validation_report(
        x, y, n_estimators=20, device=DEV)
    assert report["n_train"] + report["n_val"] == 300
    assert report["accuracy"] > 0.9
    assert report["kappa"] > 0.85
    assert set(report["per_class"]) == {1, 2, 3}
    assert len(report["feature_importances"]) == 8


def test_validation_report_equals_jax():
    """The same split, the same sklearn forest: the confusion matrix, OA,
    kappa, per-class numbers and importances equal JAX's exactly."""
    x, y = _blobs(seed=3, n=40)
    y[::7] = 3                                   # some errors to count
    _, _, t = tsupervised.train_with_validation_report(
        x, y, n_estimators=10, seed=4, device=DEV)
    _, _, j = jsupervised.train_with_validation_report(x, y, n_estimators=10,
                                                       seed=4)
    assert (t["n_train"], t["n_val"]) == (j["n_train"], j["n_val"])
    assert [int(v) for v in t["labels"]] == [int(v) for v in j["labels"]]
    assert np.array_equal(t["confusion_matrix"],
                          np.asarray(j["confusion_matrix"]))
    assert t["accuracy"] == j["accuracy"] and t["kappa"] == j["kappa"]
    assert t["per_class"] == j["per_class"]
    assert t["feature_importances"] == j["feature_importances"]
    assert t["accuracy"] < 1.0


def test_grid_search_equals_jax():
    """The fold loop over the port's CART trainer: the same cv_scores and
    best depth as JAX's, and the refit forest's arrays equal."""
    rng = np.random.default_rng(8)
    x = rng.random((60, 6)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.random(60) > 0.6).astype(np.int64) + 1
    tf, td, tinfo = tsupervised.train_random_forest_grid(
        x, y, max_depth_grid=(2, None), n_estimators=5, device=DEV)
    jf, jd, jinfo = jsupervised.train_random_forest_grid(
        x, y, max_depth_grid=(2, None), n_estimators=5)
    assert tinfo == jinfo and td == jd
    for a, b in zip(tf, jf):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("use_sklearn", [True, False])
def test_train_from_samples_equals_jax(tmp_path, use_sklearn):
    """sklearn's forest (read through forest_from_sklearn) or the CART
    trainer: the same forest arrays as the JAX package's; the joblib model
    is written only with sklearn."""
    x, y = _blobs(seed=9, n=20)
    model = str(tmp_path / "m" / "rf.pkl")
    tf, td = tsupervised.train_random_forest_from_samples(
        x, y, n_estimators=5, use_sklearn=use_sklearn, model_path=model)
    jf, jd = jsupervised.train_random_forest_from_samples(
        x, y, n_estimators=5, use_sklearn=use_sklearn)
    assert td == jd
    for a, b in zip(tf, jf):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert os.path.exists(model) == use_sklearn


def test_predict_image_equals_jax():
    rng = np.random.default_rng(10)
    fmap = rng.random((24, 40, 19)).astype(np.float32)
    fmap[2, 3, 4] = np.nan
    forest, depth, jflat = _random_forest(seed=10)
    t = tsupervised.predict_image(forest, depth, fmap, device=DEV)
    j = np.asarray(jsupervised.predict_image(jflat, depth, fmap))
    assert t.shape == (24, 40) and t.dtype == j.dtype
    # same f32 features and thresholds: the labels are equal here
    assert np.array_equal(t, j)


def test_supervised_workflow_equals_jax(tmp_path):
    """samples.pkl + features npy -> model, class_map.npy and PNG: the
    class map equal to JAX's from the same sklearn forest (>= the map
    contract; measured equal); the compute-and-write part writes the same
    map without plotting."""
    rng = np.random.default_rng(11)
    fmap = rng.random((30, 36, 19)).astype(np.float32)
    feats = str(tmp_path / "feats.npy")
    np.save(feats, fmap)
    s = tsampling.SampleSet()
    for x, y in zip(rng.integers(0, 36, 33), rng.integers(0, 30, 33)):
        s.add(x, y, 1 + int(fmap[y, x, 0] * 3))
    samples = str(tmp_path / "samples.pkl")
    s.save(samples)
    t = tsupervised.run_supervised_workflow(samples, feats,
                                            str(tmp_path / "t"), device=DEV)
    j = jsupervised.run_supervised_workflow(samples, feats,
                                            str(tmp_path / "j"))
    for d in ("t", "j"):
        for f in ("rf_samples_model.pkl", "class_map.npy",
                  "coarse_supervised_classification_AA.png"):
            assert os.path.exists(tmp_path / d / f)
    tm = np.load(tmp_path / "t" / "class_map.npy")
    jm = np.load(tmp_path / "j" / "class_map.npy")
    assert np.array_equal(tm, t) and tm.dtype == jm.dtype
    assert float(np.mean(tm == jm)) >= MAP_AGREEMENT
    w = tsupervised.train_predict_and_write(samples, feats,
                                            str(tmp_path / "w"), device=DEV)
    assert np.array_equal(w, t)
    assert not os.path.exists(tmp_path / "w" /
                              "coarse_supervised_classification_AA.png")


# --- batch ----------------------------------------------------------------

def test_batch_workflow(tmp_path):
    """Three 48 x 48 scenes with ROIs through the turbo branch: files and
    reports, then held to the JAX workflow's."""
    rng = np.random.default_rng(42)
    scenes = [rng.integers(0, 255, (7, 48, 48)).astype(np.uint8)
              for _ in range(3)]
    paths = _write_scenes(str(tmp_path), scenes, "scene")
    rois = []
    for i in range(3):
        roi = np.zeros((48, 48), np.int16)
        roi[::9, ::9] = rng.integers(1, 4, roi[::9, ::9].shape)
        rp = str(tmp_path / f"roi{i}.npy")
        np.save(rp, roi)
        rois.append(rp)
    forest, depth, jflat = _random_forest()
    out = tbatch.run_batch_workflow(paths, forest, depth,
                                    str(tmp_path / "out"), roi_paths=rois,
                                    cfg=CFG, device=DEV)
    assert len(out) == 3
    for e in out:
        assert os.path.exists(e["class_map"])
        assert "kappa" in e
        stem = os.path.basename(e["class_map"])[:-len("_class_map.tif")]
        assert os.path.exists(tmp_path / "out" / f"{stem}_report.txt")
    jout = jbatch.run_batch_workflow(paths, jflat, depth,
                                     str(tmp_path / "jout"), roi_paths=rois,
                                     cfg=JCFG)
    _hold_batch_to_jax(out, jout)
    for e in out:
        stem = os.path.basename(e["class_map"])[:-len("_class_map.tif")]
        assert (open(tmp_path / "out" / f"{stem}_report.txt").read()
                == open(tmp_path / "jout" / f"{stem}_report.txt").read())


def test_batch_workflow_subbatches_and_padding(tmp_path):
    """Ten uniform scenes: sub-batches of 8 and 2. The port runs the
    trailing group at its real size where JAX pads it to 8; each map is
    equal to the port's direct program on its scene alone and held to
    JAX's."""
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        build_stretch_stats)
    from rs_image_segmentation_tpu_torch.pipeline.turbo import (
        classify_scenes_turbo)
    rng = np.random.default_rng(12)
    scenes = [rng.integers(0, 256, (7, 32, 32)).astype(np.uint8)
              for _ in range(10)]
    paths = _write_scenes(str(tmp_path), scenes)
    stack = hierarchical_stack_fused(scenes[0], CFG, device=DEV).numpy()
    forest, depth = tforest.fit_random_forest(
        stack.reshape(-1, 19)[:200], rng.integers(1, 4, 200),
        n_estimators=5, seed=0)
    results = tbatch.run_batch_workflow(paths, forest, depth,
                                        str(tmp_path / "out"), cfg=CFG,
                                        device=DEV)
    assert len(results) == 10
    for r in results:
        assert os.path.exists(r["class_map"])
    # at B = 1 with the serving engine's host inputs (params and host
    # histogram): the same maps as the batch's build_stretch_lut inputs
    cal = CalibrationConfig()
    gf = tforest._gemm_for(forest, 19)
    for s, m in zip(scenes, _maps(results)):
        lut, sp, hist = build_stretch_stats(s, cal.gains, cal.biases)
        one = classify_scenes_turbo(s[None], lut[None].astype(np.uint8), gf,
                                    CFG, stretch_params=sp[None],
                                    stretch_hists=hist[None], device=DEV)[0]
        assert np.array_equal(m, one.numpy())
    jres = jbatch.run_batch_workflow(paths, _jflat(forest), depth,
                                     str(tmp_path / "jout"), cfg=JCFG)
    _hold_batch_to_jax(results, jres)


def test_batch_workflow_roi_length_mismatch(tmp_path):
    forest, depth, _ = _random_forest(n=50, n_estimators=3)
    with pytest.raises(ValueError, match="roi_paths"):
        tbatch.run_batch_workflow(["a.tif", "b.tif"], forest, depth,
                                  str(tmp_path), roi_paths=["one.npy"],
                                  device=DEV)


def test_batch_workflow_streamed_branch_and_duplicate_stems(tmp_path):
    """16-bit scenes of two shapes take the streamed branch (preprocess,
    fused stack, forest predict, one scene at a time); two scenes share a
    basename and get distinct outputs. Held to JAX's streamed branch."""
    rng = np.random.default_rng(13)
    scenes = [(rng.integers(0, 256, (7, h, 32)) * 257
               + rng.integers(0, 257, (7, h, 32))).astype(np.uint16)
              for h in (32, 48, 32)]
    paths = []
    for i, s in enumerate(scenes):
        d = tmp_path / f"d{i % 2}"
        d.mkdir(exist_ok=True)
        paths.append(str(d / "scene.tif"))
        write_tiff(paths[-1], s, META)
    forest, depth, jflat = _random_forest(seed=13)
    out = tbatch.run_batch_workflow(paths, forest, depth,
                                    str(tmp_path / "out"), cfg=CFG,
                                    device=DEV)
    assert [os.path.basename(r["class_map"]) for r in out] == [
        "scene_class_map.tif", "scene_1_class_map.tif",
        "scene_2_class_map.tif"]
    assert [m.shape for m in _maps(out)] == [(32, 32), (48, 32), (32, 32)]
    jout = jbatch.run_batch_workflow(paths, jflat, depth,
                                     str(tmp_path / "jout"), cfg=JCFG)
    _hold_batch_to_jax(out, jout)


def test_batch_workflow_past_the_leaf_cap(tmp_path):
    """A forest past GEMM_MAX_LEAVES: the JAX workflow's streamed branch
    reads ``_gemm_for(...).path`` of None and raises AttributeError (its
    comment sends such forests to a traversal fallback); the port keeps
    the turbo branch (its GEMM form's path sparse), its maps equal to
    ``classify_scenes_turbo`` on the scenes and to the plain walk of
    ``tests/forest_walk_ref.py`` over that program's stack."""
    rng = np.random.default_rng(14)
    scenes = [rng.integers(0, 256, (7, 32, 32)).astype(np.uint8)
              for _ in range(2)]
    paths = _write_scenes(str(tmp_path), scenes)
    stack = hierarchical_stack_fused(scenes[0], CFG, device=DEV)
    fields = deep_forest_fields(stack.permute(2, 0, 1).numpy())
    deep = tforest.flat_forest_from_numpy(fields)
    assert tforest._gemm_for(deep, 19).path.is_sparse
    jdeep = jforest.FlatForest(*(jnp.asarray(fields[k])
                                 for k in jforest.FlatForest._fields))
    assert jforest._gemm_for(jdeep, 19) is None
    with pytest.raises(AttributeError, match="path"):
        jbatch.run_batch_workflow(paths, jdeep, 12, str(tmp_path / "jout"),
                                  cfg=JCFG)
    out = tbatch.run_batch_workflow(paths, deep, 12, str(tmp_path / "out"),
                                    cfg=CFG, device=DEV)
    cal = CalibrationConfig()
    luts = np.stack([build_stretch_lut(s, np.asarray(cal.gains),
                                       np.asarray(cal.biases))
                     for s in scenes]).astype(np.uint8)
    want = classify_scenes_turbo(np.stack(scenes), luts,
                                 tforest._gemm_for(deep, 19), CFG,
                                 device=DEV).numpy()
    stacks = hierarchical_stack_turbo_cm(np.stack(scenes), luts, CFG,
                                         device=DEV)
    for i, m in enumerate(_maps(out)):
        assert np.array_equal(m, want[i])
        walked = walk_labels(fields, stacks[i].reshape(19, -1).T)
        assert np.array_equal(m, walked.reshape(32, 32).numpy().astype(
            np.uint8))
        assert len(np.unique(m)) > 1


# --- no device named, no CUDA ---------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
@pytest.mark.parametrize("call", ["grid", "report", "predict", "write",
                                  "batch"])
def test_tools_raise_without_cuda(tmp_path, call):
    """Every tool that touches tensors runs on CUDA unless a device is
    named, and raises without it."""
    x, y = _blobs(n=10)
    forest, depth, _ = _random_forest(n=30, n_estimators=2)
    calls = {
        "grid": lambda: tsupervised.train_random_forest_grid(
            x, y, n_estimators=2),
        "report": lambda: tsupervised.train_with_validation_report(
            x, y, n_estimators=2),
        "predict": lambda: tsupervised.predict_image(
            forest, depth, np.zeros((4, 4, 19), np.float32)),
        "write": lambda: tsupervised.train_predict_and_write(
            "s.pkl", "f.npy", str(tmp_path)),
        "batch": lambda: tbatch.run_batch_workflow(
            ["a.tif"], forest, depth, str(tmp_path)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()
