"""PyTorch port's four-stage file pipeline against the JAX package's, on
the CPU, at 7 x 64 x 80: stage 1 (``run_preprocessing_stage``), stage 2
(``run_feature_extraction_stage``), stage 3 (``run_classification_stage``,
each method) and stage 4 (``ClassificationEvaluator.evaluate_classification``),
and ``cli.stages.stage1..stage4`` end to end with ``--device cpu``. Each
stage of the port reads the JAX package's artifact of the stage before,
so each is held on its own; its files are read back by the JAX package's
loaders. The scene is made from a numpy seed."""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import (
    ForestConfig as JForestConfig)
from rs_image_segmentation_tpu.core.types import GeoMeta as JGeoMeta
from rs_image_segmentation_tpu.io.artifacts import (
    load_features as jload_features,
    normalize_features_structure as jnormalize)
from rs_image_segmentation_tpu.io.tiff import read_tiff
from rs_image_segmentation_tpu.pipeline import classify as jcls
from rs_image_segmentation_tpu.pipeline import evaluate as jeval
from rs_image_segmentation_tpu.pipeline import features as jfeat
from rs_image_segmentation_tpu.pipeline import preprocess as jpre
from rs_image_segmentation_tpu_torch.cli import stages as tcli
from rs_image_segmentation_tpu_torch.core.types import Raster
from rs_image_segmentation_tpu_torch.io.tiff import write_tiff
from rs_image_segmentation_tpu_torch.pipeline import classify as tcls
from rs_image_segmentation_tpu_torch.pipeline import evaluate as teval
from rs_image_segmentation_tpu_torch.pipeline import features as tfeat
from rs_image_segmentation_tpu_torch.pipeline import preprocess as tpre
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    synthetic_geometa, synthetic_scenes)

H, W = 64, 80
# three GCP pairs of a small rotation (0.01 rad) plus a shift (1.5, -2)
_ROT = np.array([[np.cos(0.01), -np.sin(0.01)], [np.sin(0.01),
                                                  np.cos(0.01)]])
GCPS = [((x, y), tuple(_ROT @ (x, y) + (1.5, -2.0)))
        for x, y in ((0.0, 0.0), (79.0, 3.0), (5.0, 63.0))]
# stage 2's bounds: tests/test_torch_features.py (LOOSE and the stack's
# channels), with the reasons stated there
FEATURE_BOUNDS = {
    # EVI's denominator cancels
    "evi": 1e-3,
    # PCA: components of small eigenvalues turn by f32 rounding
    "pca_result": 1e-3,
    # sqrt of a cancelling windowed variance
    "multi_scale_features_std_dev_scale_3": 3.5e-4,
    "multi_scale_features_std_dev_scale_5": 3.5e-4,
    "multi_scale_features_std_dev_scale_7": 3.5e-4,
    # contrast reaches ~10, summed in another order
    "glcm_features_contrast": 3e-5,
}
# the JAX LBP fuses bilinear taps into FMAs: a share of equal codes
LBP_EQUAL_SHARE = 0.997
# hierarchical channels: EVI (3, 10), std5 (17), GLCM contrast (14)
CHANNEL_BOUNDS = {3: 1e-3, 10: 1e-3, 17: 3.5e-4, 14: 3e-5}
# the port's KMeans mapped kappa may trail the JAX package's by this much
# (tests/test_torch_kmeans.py: different k-means++ draws)
KAPPA_MARGIN = 0.05
# the port's forest map against the JAX package's, the same sklearn model
# (measured 1.0 here: f32 GEMM sums and the level traversal agree)
FOREST_AGREEMENT = 0.999


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One pass of both packages over the four stages; paths and results
    by name."""
    d = tmp_path_factory.mktemp("stages")
    out = {"dir": d}
    scene = synthetic_scenes(1, H, W, seed=9)[0]
    raw = str(d / "scene.tif")
    write_tiff(raw, scene, synthetic_geometa((H, W)))
    out["scene"] = scene
    # stage 1
    out["j1"], out["t1"] = str(d / "j1.tif"), str(d / "t1.tif")
    out["jraster"] = jpre.run_preprocessing_stage(raw, out["j1"])
    out["traster"] = tpre.run_preprocessing_stage(
        raw, out["t1"], vis_dir=str(d / "t1vis"), device="cpu")
    out["j1g"], out["t1g"] = str(d / "j1g.tif"), str(d / "t1g.tif")
    jpre.run_preprocessing_stage(raw, out["j1g"], gcps=GCPS)
    tpre.run_preprocessing_stage(raw, out["t1g"], gcps=GCPS, device="cpu")
    # stage 2 on the JAX package's stage-1 file
    out["jf"], out["tf"] = str(d / "jf"), str(d / "tf")
    out["jfeats"] = jfeat.run_feature_extraction_stage(out["j1"], out["jf"],
                                                       vis=False)
    out["tfeats"] = tfeat.run_feature_extraction_stage(
        out["j1"], out["tf"], vis=False, device="cpu")
    pkl = os.path.join(out["jf"], "all_features_and_metadata.pkl")
    out["pkl"] = pkl
    # stage 3 on the JAX package's pickle, each method; the port's PNGs
    # once (rule_based), its other methods through classify_and_write
    out["jc"], out["tc"] = str(d / "jc"), str(d / "tc")
    for method in ("rule_based", "kmeans"):
        out[f"j_{method}"] = jcls.run_classification_stage(pkl, method,
                                                           out["jc"])
    out["t_rule_based"] = tcls.run_classification_stage(
        pkl, "rule_based", out["tc"], device="cpu")
    out["t_kmeans"] = tcls.classify_and_write(pkl, "kmeans", out["tc"],
                                              device="cpu")[0]
    # a labelled ROI sampled from the rule map: 60 pixels a class, seeded
    rule = out["j_rule_based"]
    rng = np.random.default_rng(13)
    roi = np.zeros((H, W), np.uint8)
    for c in np.unique(rule):
        where = np.flatnonzero(rule.reshape(-1) == c)
        pick = rng.choice(where, min(60, where.size), replace=False)
        roi.reshape(-1)[pick] = c if c else 5
    out["roi"] = str(d / "labeled_roi.tif")
    write_tiff(out["roi"], roi[None], synthetic_geometa((H, W)))
    out["j_random_forest"] = jcls.run_classification_stage(
        pkl, "random_forest", out["jc"], labeled_roi_file=out["roi"],
        forest_cfg=JForestConfig(n_estimators=20))
    # the port loads the model the JAX run cached
    shutil.copy(os.path.join(out["jc"], "random_forest_model.joblib"),
                out["tc"])
    out["t_random_forest"] = tcls.classify_and_write(
        pkl, "random_forest", out["tc"], labeled_roi_file=out["roi"],
        device="cpu")[0]
    # stage 4: the JAX package's KMeans map against the ROI, clusters
    # mapped to classes
    out["je"], out["te"] = str(d / "je"), str(d / "te")
    cmap = os.path.join(out["jc"], "kmeans_classification_map.tif")
    out["cmap"] = cmap
    out["jmetrics"] = jeval.ClassificationEvaluator().evaluate_classification(
        cmap, out["roi"], out["je"])
    out["tmetrics"] = teval.ClassificationEvaluator(
        device="cpu").evaluate_classification(cmap, out["roi"], out["te"])
    return out


# ------------------------------------------------------------------ stage 1

def test_stage1_identity_file_byte_equal(run):
    assert filecmp.cmp(run["t1"], run["j1"], shallow=False)
    r = run["traster"]
    assert isinstance(r, Raster) and isinstance(r.data, np.ndarray)
    assert r.data.dtype == np.uint8 and r.shape == (7, H, W)
    np.testing.assert_array_equal(r.numpy(), np.asarray(run["jraster"].data))
    assert r.meta.transform == run["jraster"].meta.transform
    assert r.meta.crs == run["jraster"].meta.crs
    assert os.path.exists(os.path.join(run["dir"], "t1vis",
                                       "preprocessing_result.png"))


def test_stage1_gcp_route_within_one_level(run):
    got, ginfo = read_tiff(run["t1g"])
    ref, _ = read_tiff(run["j1g"])
    assert got.dtype == np.float32 and got.shape == ref.shape == (7, H, W)
    assert ginfo.meta.crs == "EPSG:32630"
    # ROADMAP queue 3: XLA fuses the calibration and the warp's weights
    # into FMAs, eager torch rounds each product; a truncation boundary
    # moves by one level (measured: 1 of 35 840 values differs here)
    assert np.mean(got == ref) >= 0.999
    assert np.abs(got - ref).max() <= 1.0


# ------------------------------------------------------------------ stage 2

def test_stage2_artifacts_match_jax(run):
    got = jnormalize(jload_features(os.path.join(
        run["tf"], "all_features_and_metadata.pkl")))
    ref = jnormalize(jload_features(run["pkl"]))
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        if not isinstance(r, np.ndarray):
            assert g == r, key
            continue
        assert isinstance(g, np.ndarray), key
        assert g.shape == r.shape and g.dtype == r.dtype, key
        bare = key.replace("all_extracted_features_dict_", "")
        if bare == "lbp_feature":
            assert np.mean(g == r) >= LBP_EQUAL_SHARE, key
        elif not key.startswith("hierarchical_"):   # the stacks: below
            bound = FEATURE_BOUNDS.get(
                "pca_result" if bare.startswith("pca_result_") else bare,
                1e-5)
            np.testing.assert_allclose(g, r, atol=bound, rtol=0,
                                       err_msg=key)


@pytest.mark.parametrize("name,channels", [
    ("level1_features.npy", range(14)),
    ("level2_features.npy", range(14, 19)),
    ("all_hierarchical_features.npy", range(19))])
def test_stage2_stacks_match_jax(run, name, channels):
    got = np.load(os.path.join(run["tf"], name))
    ref = np.load(os.path.join(run["jf"], name))
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    for i, c in enumerate(channels):
        np.testing.assert_allclose(got[..., i], ref[..., i],
                                   atol=CHANNEL_BOUNDS.get(c, 1e-5), rtol=0,
                                   err_msg=f"{name} channel {c}")


def test_stage2_feature_tif_read_by_jax(run):
    got, ginfo = read_tiff(os.path.join(run["tf"],
                                        "all_hierarchical_features.tif"))
    stack = np.load(os.path.join(run["tf"], "all_hierarchical_features.npy"))
    np.testing.assert_array_equal(got, np.moveaxis(stack, 2, 0))
    assert list(ginfo.band_names) == [f"feature_{i + 1}" for i in range(19)]
    assert ginfo.meta.transform == synthetic_geometa().transform
    feats, hier = run["tfeats"]
    assert isinstance(feats["pca_result"], list)
    assert all(isinstance(p, np.ndarray) and p.ndim == 2
               for p in feats["pca_result"])
    assert all(isinstance(v, np.ndarray) for v in hier.values())


# ------------------------------------------------------------------ stage 3

def _mapped_kappa(pred, truth):
    ev = teval.ClassificationEvaluator(device="cpu")
    p, t = ev.extract_valid_samples(pred, truth)
    return ev.calculate_metrics(t, ev.map_clusters_to_classes(p, t))["kappa"]


def test_stage3_rule_based_bit_equal(run):
    got, ref = run["t_rule_based"], run["j_rule_based"]
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_stage3_random_forest_from_cached_model(run):
    got, ref = run["t_random_forest"], run["j_random_forest"]
    assert got.shape == ref.shape == (H, W)
    assert np.mean(got == ref) >= FOREST_AGREEMENT


def test_stage3_kmeans_kappa_within_margin(run):
    got, ref = run["t_kmeans"], run["j_kmeans"]
    assert got.dtype == np.uint8 and got.min() >= 1 and got.max() <= 7
    rule = run["j_rule_based"].astype(np.int64) + 1    # background counts
    assert _mapped_kappa(got, rule) >= _mapped_kappa(ref, rule) - KAPPA_MARGIN


@pytest.mark.parametrize("method", ["rule_based", "kmeans", "random_forest"])
def test_stage3_geotiffs_byte_equal_to_jax_writers(run, tmp_path, method):
    result = run[f"t_{method}"]
    meta = JGeoMeta(transform=synthetic_geometa().transform,
                    crs="EPSG:32630")
    ref_map = str(tmp_path / "map.tif")
    ref_three = str(tmp_path / "three.tif")
    jcls.save_classification_as_geotiff(result, meta, ref_map)
    three = jcls.save_three_class_evaluation_tif(result, meta, ref_three,
                                                 method)
    tc = run["tc"]
    assert filecmp.cmp(os.path.join(tc, f"{method}_classification_map.tif"),
                       ref_map, shallow=False)
    assert filecmp.cmp(os.path.join(tc,
                                    f"{method}_three_class_evaluation.tif"),
                       ref_three, shallow=False)
    got_three, _ = read_tiff(os.path.join(
        tc, f"{method}_three_class_evaluation.tif"))
    np.testing.assert_array_equal(got_three[0], three)


def test_stage3_pngs_written(run):
    for png in ("rule_based_classification_map.png", "combined_indices.png"):
        assert os.path.exists(os.path.join(run["tc"], png)), png
    assert not os.path.exists(os.path.join(run["tc"],
                                           "kmeans_classification_map.png"))


def test_three_class_output_matches_jax(tmp_path):
    cls = np.random.default_rng(2).integers(0, 8, (20, 24)).astype(np.uint8)
    meta = {"transform": (10.0, 0.0, 1.0, 0.0, -10.0, 2.0),
            "crs": "EPSG:4326"}
    for method in ("rule_based", "kmeans"):
        got = tcls.run_three_class_evaluation_output(
            meta, str(tmp_path / "t"), method, cls, device="cpu")
        ref = jcls.run_three_class_evaluation_output(
            meta, str(tmp_path / "j"), method, cls)
        np.testing.assert_array_equal(got, ref)
        name = f"{method}_three_class_evaluation.tif"
        assert filecmp.cmp(str(tmp_path / "t" / name),
                           str(tmp_path / "j" / name), shallow=False)
    # no map, no metadata: the random placeholder and synthetic georeference
    got = tcls.run_three_class_evaluation_output(
        None, str(tmp_path / "t0"), shape=(16, 16), device="cpu")
    ref = jcls.run_three_class_evaluation_output(
        None, str(tmp_path / "j0"), shape=(16, 16))
    np.testing.assert_array_equal(got, ref)


def test_classification_geotiff_dtypes_match_jax(tmp_path):
    meta = JGeoMeta(transform=(1.0, 0.0, 0.0, 0.0, -1.0, 0.0))
    for mx in (200, 60000, 70000):
        res = np.array([[0, 1], [2, mx]], np.int64)
        tcls.save_classification_as_geotiff(torch.from_numpy(res), meta,
                                            str(tmp_path / f"t{mx}.tif"))
        jcls.save_classification_as_geotiff(res, meta,
                                            str(tmp_path / f"j{mx}.tif"))
        assert filecmp.cmp(str(tmp_path / f"t{mx}.tif"),
                           str(tmp_path / f"j{mx}.tif"), shallow=False)


def test_load_roi_raster(run, tmp_path):
    roi = tcls.load_roi_raster(run["roi"], (H, W))
    np.testing.assert_array_equal(roi, jcls.load_roi_raster(run["roi"]))
    p = str(tmp_path / "roi.npy")
    np.save(p, roi[:10])
    np.testing.assert_array_equal(tcls.load_roi_raster(p), roi[:10])
    with pytest.raises(ValueError, match="ROI shape"):
        tcls.load_roi_raster(p, (H, W))


def test_train_or_load_forest_without_sklearn(run, tmp_path, monkeypatch):
    """Without joblib and sklearn, the port's CART trainer: the forest of
    ``fit_random_forest`` with the configuration's seed, and no cache."""
    import builtins
    from rs_image_segmentation_tpu_torch.core.config import ForestConfig
    from rs_image_segmentation_tpu_torch.models.forest import (
        fit_random_forest)
    real_import = builtins.__import__

    def no_ml(name, *args, **kwargs):
        if name.split(".")[0] in ("sklearn", "joblib"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    rng = np.random.default_rng(4)
    x = rng.random((80, 5)).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(np.int64) + 1
    cfg = ForestConfig(n_estimators=7)
    path = str(tmp_path / "m.joblib")
    shutil.copy(os.path.join(run["jc"], "random_forest_model.joblib"), path)
    monkeypatch.setattr(builtins, "__import__", no_ml)
    forest, depth = tcls.train_or_load_forest(x, y, path, cfg)
    ref, ref_depth = fit_random_forest(x, y, 7, None, cfg.seed)
    assert depth == ref_depth
    for a, b in zip(forest, ref):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ stage 4

def test_stage4_metrics_and_report_equal(run):
    got, ref = run["tmetrics"], run["jmetrics"]
    assert got["labels"] == [int(v) for v in ref["labels"]]
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  ref["confusion_matrix"])
    assert got["overall_accuracy"] == ref["overall_accuracy"]
    assert got["kappa"] == ref["kappa"]
    assert got["per_class"] == ref["per_class"]
    with open(os.path.join(run["te"], "evaluation_report.txt")) as f:
        got_report = f.read()
    with open(os.path.join(run["je"], "evaluation_report.txt")) as f:
        assert got_report == f.read()
    for png in ("confusion_matrix.png", "accuracy_comparison.png",
                "classification_comparison.png"):
        assert os.path.exists(os.path.join(run["te"], png)), png


def test_stage4_without_mapping_and_resized_roi(run, tmp_path):
    """``map_clusters=False``, and a ROI of another shape, nearest-resized
    (tests/test_tools_and_io.py::test_evaluator_roi_resize_path)."""
    rng = np.random.default_rng(42)
    cls = rng.integers(1, 4, (60, 60)).astype(np.int64)
    roi_small = np.zeros((30, 30), np.int16)
    roi_small[::5, ::5] = rng.integers(1, 4, roi_small[::5, ::5].shape)
    cpath = str(tmp_path / "c.npy")
    np.save(cpath, cls)
    rpath = str(tmp_path / "r.npy")
    np.save(rpath, roi_small)
    got = teval.ClassificationEvaluator(device="cpu").evaluate_classification(
        cpath, rpath, str(tmp_path / "t"), map_clusters=False)
    ref = jeval.ClassificationEvaluator().evaluate_classification(
        cpath, rpath, str(tmp_path / "j"), map_clusters=False)
    assert got["overall_accuracy"] == ref["overall_accuracy"]
    assert got["kappa"] == ref["kappa"]
    assert (open(tmp_path / "t" / "evaluation_report.txt").read()
            == open(tmp_path / "j" / "evaluation_report.txt").read())


def test_module_evaluate_classification_save_dir(tmp_path):
    rng = np.random.default_rng(8)
    pred = rng.integers(1, 5, (30, 40))
    gt = rng.integers(0, 5, (30, 40))
    got = teval.evaluate_classification(pred, gt, {1: "a"},
                                        str(tmp_path / "t"), device="cpu")
    ref = jeval.evaluate_classification(pred, gt, {1: "a"},
                                        str(tmp_path / "j"))
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  ref["confusion_matrix"])
    assert got["kappa"] == ref["kappa"]
    assert os.path.exists(tmp_path / "t" / "confusion_matrix.png")


# ---------------------------------------------------------------- the CLI

def test_cli_stages_end_to_end(run, tmp_path, capsys):
    d = str(tmp_path)
    pre = os.path.join(d, "pre.tif")
    tcli.stage1(["--input", os.path.join(run["dir"], "scene.tif"),
                 "--output", pre, "--vis-dir", d, "--device", "cpu"])
    assert filecmp.cmp(pre, run["j1"], shallow=False)
    feat_dir = os.path.join(d, "features")
    tcli.stage2(["--input", pre, "--output-dir", feat_dir, "--device",
                 "cpu"])
    for png in ("index_maps.png", "feature_pca.png",
                "pca_variance_explained.png", "combined_features.png"):
        assert os.path.exists(os.path.join(feat_dir, png)), png
    pkl = os.path.join(feat_dir, "all_features_and_metadata.pkl")
    seg = os.path.join(d, "seg")
    tcli.stage3(["--features", pkl, "--method", "rule_based",
                 "--output-dir", seg, "--device", "cpu"])
    got, _ = read_tiff(os.path.join(seg, "rule_based_classification_map.tif"))
    np.testing.assert_array_equal(got[0], run["t_rule_based"])
    ev = os.path.join(d, "eval")
    tcli.stage4(["--classification", run["cmap"], "--roi", run["roi"],
                 "--output-dir", ev, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    m = run["jmetrics"]
    assert out == [f"stage 1 done -> {pre}", f"stage 2 done -> {feat_dir}",
                   f"stage 3 done -> {seg}",
                   f"OA={m['overall_accuracy']:.4f} "
                   f"Kappa={m['kappa']:.4f} -> {ev}"]


# ------------------------------------------------------- no device, no CUDA

def _entry_points(run, d):
    pkl, roi = run["pkl"], run["roi"]
    raw = os.path.join(run["dir"], "scene.tif")
    return {
        "run_preprocessing_stage": lambda: tpre.run_preprocessing_stage(
            raw, os.path.join(d, "x.tif")),
        "run_feature_extraction_stage":
            lambda: tfeat.run_feature_extraction_stage(run["j1"], d),
        "run_classification_stage": lambda: tcls.run_classification_stage(
            pkl, "rule_based", d),
        "classify_and_write": lambda: tcls.classify_and_write(pkl, "kmeans",
                                                              d),
        "run_three_class_evaluation_output":
            lambda: tcls.run_three_class_evaluation_output(
                None, d, classification_map=np.zeros((4, 4), np.uint8)),
        "ClassificationEvaluator": lambda: teval.ClassificationEvaluator(),
        "evaluate_classification": lambda: teval.evaluate_classification(
            np.ones((4, 4)), np.ones((4, 4))),
        "cli.stage1": lambda: tcli.stage1(["--input", raw, "--output",
                                           os.path.join(d, "y.tif")]),
        "cli.stage2": lambda: tcli.stage2(["--input", run["j1"],
                                           "--output-dir", d]),
        "cli.stage3": lambda: tcli.stage3(["--features", pkl,
                                           "--output-dir", d]),
        "cli.stage4": lambda: tcli.stage4(["--classification", roi, "--roi",
                                           roi, "--output-dir", d]),
    }


ENTRY_POINTS = ["run_preprocessing_stage", "run_feature_extraction_stage",
                "run_classification_stage", "classify_and_write",
                "run_three_class_evaluation_output",
                "ClassificationEvaluator", "evaluate_classification",
                "cli.stage1", "cli.stage2", "cli.stage3", "cli.stage4"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_a_device(run, tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(run, d)[name]()
    # raised before any artifact was written
    assert not os.path.exists(d) or not os.listdir(d)


def test_stage4_uint16_rasters_match_jax(tmp_path):
    """A class map past 255 labels is written as uint16
    (``save_classification_as_geotiff``); the evaluator reads it as the
    JAX package's does (torch compares no uint16 on the CPU)."""
    rng = np.random.default_rng(21)
    cls = rng.integers(0, 300, (40, 48))
    cpath = str(tmp_path / "cls.tif")
    jcls.save_classification_as_geotiff(cls, JGeoMeta(), cpath)
    assert read_tiff(cpath)[0].dtype == np.uint16
    roi = np.zeros((40, 48), np.uint16)
    roi[::3, ::4] = rng.integers(1, 5, roi[::3, ::4].shape)
    rpath = str(tmp_path / "roi.npy")
    np.save(rpath, roi)
    got = teval.ClassificationEvaluator(device="cpu").evaluate_classification(
        cpath, rpath, str(tmp_path / "t"))
    ref = jeval.ClassificationEvaluator().evaluate_classification(
        cpath, rpath, str(tmp_path / "j"))
    assert got["overall_accuracy"] == ref["overall_accuracy"]
    assert got["kappa"] == ref["kappa"]
    assert (open(tmp_path / "t" / "evaluation_report.txt").read()
            == open(tmp_path / "j" / "evaluation_report.txt").read())
    m = teval.evaluate_classification(read_tiff(cpath)[0][0], roi,
                                      device="cpu")
    r = jeval.evaluate_classification(read_tiff(cpath)[0][0], roi)
    np.testing.assert_array_equal(m["confusion_matrix"],
                                  r["confusion_matrix"])
