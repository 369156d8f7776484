"""PyTorch port of the rest of the CLI (``cli.stages.classify_large`` and
``batch_classify``, ``cli.tools_cli``, ``cli.serve_cli``) against the JAX
package's CLIs, on the CPU with ``--device cpu``, on a 7 x 64 x 64 scene
made from a numpy seed (``tests/test_cli.py``'s). Files are compared
byte for byte, or, where a map comes from a forest, held to >= 99.9 % of
JAX's (the reference's map contract). Each new entry point raises without
CUDA when no device is named."""

import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.cli import serve_cli as jserve_cli
from rs_image_segmentation_tpu.cli import stages as jstages
from rs_image_segmentation_tpu.cli import tools_cli as jtools_cli
from rs_image_segmentation_tpu.serving import server as jserver
from rs_image_segmentation_tpu_torch.cli import serve_cli as tserve_cli
from rs_image_segmentation_tpu_torch.cli import stages as tstages
from rs_image_segmentation_tpu_torch.cli import tools_cli as ttools_cli
from rs_image_segmentation_tpu_torch.core.types import GeoMeta
from rs_image_segmentation_tpu_torch.io.tiff import read_tiff, write_tiff
from rs_image_segmentation_tpu_torch.models.forest import fit_random_forest
from rs_image_segmentation_tpu_torch.models.serialize import save_flat_forest
from rs_image_segmentation_tpu_torch.pipeline.features import (
    hierarchical_stack_fused)
from rs_image_segmentation_tpu_torch.serving import server as tserver
from rs_image_segmentation_tpu_torch.tools.sampling import SampleSet

DEV = ["--device", "cpu"]
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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``tests/test_cli.py``'s scene, a second scene, 30 seeded samples
    labelled from the scene's stack, and a forest npz trained on them."""
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(1)
    meta = GeoMeta(transform=(30.0, 0.0, 5e5, 0.0, -30.0, 4e6),
                   crs="EPSG:32630")
    scenes = [rng.integers(0, 255, (7, 64, 64)).astype(np.uint8)]
    scenes.append(np.random.default_rng(2).integers(
        0, 255, (7, 64, 64)).astype(np.uint8))
    paths = []
    for i, s in enumerate(scenes):
        paths.append(str(d / f"scene{i}.tif"))
        write_tiff(paths[-1], s, meta)
    stack = hierarchical_stack_fused(scenes[0], device="cpu").numpy()
    xy = np.stack([rng.integers(0, 64, 30), rng.integers(0, 64, 30)], 1)
    labels = 1 + np.digitize(stack[xy[:, 1], xy[:, 0], 2], (-0.05, 0.05))
    s = SampleSet()
    for (x, y), lab in zip(xy, labels):
        s.add(x, y, lab)
    samples = str(d / "samples.pkl")
    s.save(samples)
    forest, depth = fit_random_forest(stack[xy[:, 1], xy[:, 0]], labels,
                                      n_estimators=10, seed=0)
    model = str(d / "forest.npz")
    save_flat_forest(model, forest, depth)
    roi = np.zeros((64, 64), np.int16)
    roi[::7, ::7] = rng.integers(1, 4, roi[::7, ::7].shape)
    roi_path = str(d / "roi.npy")
    np.save(roi_path, roi)
    return {"dir": d, "scenes": paths, "arrays": scenes, "samples": samples,
            "model": model, "roi": roi_path}


def _band(path):
    return read_tiff(path)[0][0]


def _hold_map(tpath, jpath, exact=False):
    """The port's map file against JAX's: >= MAP_AGREEMENT (equal when
    ``exact``), and byte-equal files wherever the maps are equal."""
    t, j = _band(tpath), _band(jpath)
    assert t.shape == j.shape
    agree = float(np.mean(t == j))
    assert agree == 1.0 if exact else agree >= MAP_AGREEMENT, agree
    if agree == 1.0:
        assert filecmp.cmp(tpath, jpath, shallow=False)
    return agree


# --- classify_large -------------------------------------------------------

def test_classify_large_cli_methods(files):
    """--method kmeans / rule_based run the model-free large-scene paths
    end to end from a raw scene; the rule map's file equals the JAX CLI's
    (KMeans cluster ids come from other random streams:
    tests/test_torch_large_scene.py holds them by mapped kappa)."""
    d, p = files["dir"], files["scenes"][0]
    for method in ("kmeans", "rule_based"):
        outs = {}
        for name, cli, extra in (("t", tstages.classify_large, DEV),
                                 ("j", jstages.classify_large, [])):
            outs[name] = str(d / f"large_{method}_{name}.tif")
            cli(["--scene", p, "--raw", "--method", method, "--clusters",
                 "4", "--tile-rows", "42", "--output", outs[name]] + extra)
        cls, info = read_tiff(outs["t"])
        assert cls.shape == (1, 64, 64)
        assert info.meta.crs == "EPSG:32630"
        if method == "kmeans":
            assert cls.min() >= 1 and cls.max() <= 4
        else:
            assert cls.max() <= 4  # labels {0..4}
            _hold_map(outs["t"], outs["j"], exact=True)


@pytest.mark.parametrize("source", ["npz", "samples"])
def test_classify_large_cli_random_forest(files, source, capsys):
    """--method random_forest from an npz forest, or trained from the
    samples over the fused stack: the streamed GeoTIFF held to the JAX
    CLI's, and the printed line the same."""
    d, p = files["dir"], files["scenes"][0]
    model = (["--model", files["model"]] if source == "npz"
             else ["--samples", files["samples"]])
    outs = {}
    lines = {}
    for name, cli, extra in (("t", tstages.classify_large, DEV),
                             ("j", jstages.classify_large, [])):
        outs[name] = str(d / f"large_rf_{source}_{name}.tif")
        cli(["--scene", p, "--raw", "--tile-rows", "42", "--output",
             outs[name]] + model + extra)
        lines[name] = capsys.readouterr().out.replace(outs[name], "OUT")
    assert lines["t"] == lines["j"]
    _hold_map(outs["t"], outs["j"])


@pytest.mark.parametrize("method", ["random_forest", "kmeans", "rule_based"])
def test_classify_large_cli_checkpoint_dir(files, method):
    """--checkpoint-dir: the resumable classifiers write the map the direct
    run writes (the same port, the same tiles)."""
    d, p = files["dir"], files["scenes"][0]
    args = ["--scene", p, "--raw", "--method", method, "--clusters", "4",
            "--tile-rows", "42", "--model", files["model"]] + DEV
    direct = str(d / f"ck_direct_{method}.tif")
    resumed = str(d / f"ck_resumed_{method}.tif")
    tstages.classify_large(args + ["--output", direct])
    tstages.classify_large(args + ["--output", resumed, "--checkpoint-dir",
                                   str(d / f"ck_{method}")])
    assert np.array_equal(_band(direct), _band(resumed))
    assert os.listdir(d / f"ck_{method}")


# --- batch_classify -------------------------------------------------------

@pytest.mark.parametrize("source", ["npz", "samples"])
def test_batch_classify_cli(files, source, capsys):
    """``rs-seg-torch-batch`` on two scenes with ROIs: each class map held
    to the JAX CLI's, the reports and printed lines equal where the maps
    are."""
    d = files["dir"]
    model = (["--model", files["model"]] if source == "npz"
             else ["--samples", files["samples"]])
    out = {}
    lines = {}
    for name, cli, extra in (("t", tstages.batch_classify, DEV),
                             ("j", jstages.batch_classify, [])):
        out[name] = str(d / f"batch_{source}_{name}")
        cli(files["scenes"] + model + ["--rois", files["roi"], files["roi"],
                                       "--output-dir", out[name]] + extra)
        lines[name] = capsys.readouterr().out.replace(out[name], "OUT")
    agree = [_hold_map(os.path.join(out["t"], f"scene{i}_class_map.tif"),
                       os.path.join(out["j"], f"scene{i}_class_map.tif"))
             for i in range(2)]
    for i, a in enumerate(agree):
        if a == 1.0:
            assert filecmp.cmp(os.path.join(out["t"], f"scene{i}_report.txt"),
                               os.path.join(out["j"], f"scene{i}_report.txt"),
                               shallow=False)
    if all(a == 1.0 for a in agree):
        assert lines["t"] == lines["j"]
    assert lines["t"].splitlines()[-1] == (
        "batch classification: 2 scene(s) -> OUT")


# --- tools_cli ------------------------------------------------------------

def test_generate_roi_mask_cli_matches_jax(files, capsys):
    d = files["dir"]
    out = {}
    for name, cli in (("t", ttools_cli.generate_roi_mask_cli),
                      ("j", jtools_cli.generate_roi_mask_cli)):
        out[name] = str(d / f"roi_{name}" / "roi_mask.npy")
        cli(["--samples", files["samples"], "--reference",
             files["scenes"][0], "--output", out[name]])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace(out["t"], "") == printed[1].replace(
        out["j"], "")
    assert filecmp.cmp(out["t"], out["j"], shallow=False)
    mask = np.load(out["t"])
    assert mask.dtype == np.int16 and mask.shape == (64, 64)
    assert (mask != 0).sum() == len(np.unique(pickle.load(open(
        files["samples"], "rb"))[0], axis=0))


def test_supervised_cli_matches_jax(files):
    """samples + features npy -> model, class_map.npy and PNG: the class
    map held to JAX's from the same sklearn forest."""
    d = files["dir"]
    feats = str(d / "all_hierarchical_features.npy")
    np.save(feats, hierarchical_stack_fused(files["arrays"][0],
                                            device="cpu").numpy())
    for name, cli, extra in (("t", ttools_cli.supervised_cli, DEV),
                             ("j", jtools_cli.supervised_cli, [])):
        cli(["--samples", files["samples"], "--features", feats,
             "--output-dir", str(d / f"sup_{name}")] + extra)
    for name in ("t", "j"):
        for f in ("rf_samples_model.pkl",
                  "coarse_supervised_classification_AA.png"):
            assert os.path.exists(d / f"sup_{name}" / f)
    t = np.load(d / "sup_t" / "class_map.npy")
    j = np.load(d / "sup_j" / "class_map.npy")
    assert t.dtype == j.dtype and t.shape == j.shape == (64, 64)
    assert float(np.mean(t == j)) >= MAP_AGREEMENT
    if np.array_equal(t, j):
        assert filecmp.cmp(d / "sup_t" / "class_map.npy",
                           d / "sup_j" / "class_map.npy", shallow=False)


# --- serve_cli ------------------------------------------------------------

def _captured_engine(monkeypatch, module, cli, argv):
    """Run ``cli(argv)`` with its ``serve`` replaced by a capture."""
    got = {}

    def fake_serve(engine, host, port, request_timeout=None):
        got.update(engine=engine, host=host, port=port,
                   request_timeout=request_timeout)

    monkeypatch.setattr(module, "serve", fake_serve)
    cli(argv)
    return got


@pytest.mark.parametrize("source", ["npz", "samples"])
def test_serve_cli_builds_the_jax_engine(files, monkeypatch, source):
    """The engine the port's CLI hands to ``serve``: the JAX CLI's config
    and address, on the CPU, and its maps held to the JAX engine's (rule
    maps equal; forest maps >= the map contract)."""
    model = (["--model", files["model"]] if source == "npz"
             else ["--samples", files["samples"], "--scene",
                   files["scenes"][0]])
    argv = (model + ["--port", "8123", "--max-batch", "4",
                     "--batch-window-ms", "2.5", "--max-pending", "16",
                     "--request-timeout", "0", "--program-cache", "5",
                     "--strict-shapes", "64x64", "--kmeans-shared-fit",
                     "--kmeans-fit-stride", "2", "--kmeans-warm-start",
                     "--clusters", "4"])
    # the port warms its programs up (eager: nothing to compile); the JAX
    # engine compiles on its first request instead of for every bucket
    t = _captured_engine(monkeypatch, tserver, tserve_cli.serve_cli,
                         argv + ["--warmup", "64x64"] + DEV)
    j = _captured_engine(monkeypatch, jserver, jserve_cli.serve_cli, argv)
    te, je = t.pop("engine"), j.pop("engine")
    try:
        assert t == j == {"host": "127.0.0.1", "port": 8123,
                          "request_timeout": None}
        assert te.device == torch.device("cpu")
        assert te._ecfg.__dict__ == je._ecfg.__dict__
        assert te.available_methods() == je.available_methods()
        scene = files["arrays"][1]
        rule_t = te.classify(scene, timeout=120, method="rule_based")
        rule_j = je.classify(scene, timeout=120, method="rule_based")
        assert np.array_equal(rule_t, rule_j)
        rf_t = te.classify(scene, timeout=120)
        rf_j = je.classify(scene, timeout=120)
        assert float(np.mean(rf_t == rf_j)) >= MAP_AGREEMENT
    finally:
        te.shutdown()
        je.shutdown()


def test_serve_cli_without_a_model(monkeypatch):
    """--method rule_based needs no forest; the default method and the
    defaults of every flag are the JAX CLI's."""
    t = _captured_engine(monkeypatch, tserver, tserve_cli.serve_cli,
                         ["--method", "rule_based"] + DEV)
    j = _captured_engine(monkeypatch, jserver, jserve_cli.serve_cli,
                         ["--method", "rule_based"])
    te, je = t.pop("engine"), j.pop("engine")
    try:
        assert t == j == {"host": "127.0.0.1", "port": 8471,
                          "request_timeout": 600.0}
        assert te._ecfg.__dict__ == je._ecfg.__dict__
        assert te.available_methods() == je.available_methods()
    finally:
        te.shutdown()
        je.shutdown()


# --- no device named, no CUDA ---------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
@pytest.mark.parametrize("entry", ["classify_large", "batch_classify",
                                   "supervised_cli", "serve_cli"])
def test_entry_points_raise_without_cuda(files, entry, tmp_path):
    """With no --device, every new entry point that touches tensors runs
    on CUDA, and raises here before it writes anything."""
    argv = {
        "classify_large": (tstages.classify_large,
                           ["--scene", files["scenes"][0], "--model",
                            files["model"], "--output",
                            str(tmp_path / "o.tif")]),
        "batch_classify": (tstages.batch_classify,
                           files["scenes"] + ["--model", files["model"],
                                              "--output-dir",
                                              str(tmp_path / "b")]),
        "supervised_cli": (ttools_cli.supervised_cli,
                           ["--samples", files["samples"], "--features",
                            "f.npy", "--output-dir", str(tmp_path / "s")]),
        "serve_cli": (tserve_cli.serve_cli, ["--model", files["model"]]),
    }
    cli, args = argv[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(args)
    assert not os.listdir(tmp_path)
