"""PyTorch port vs the JAX package, on the CPU: the tiled large-scene
pipeline (``pipeline.large_scene``): host statistics, ``preprocess_large``,
the global passes, the supervised drivers (resident, streamed, and with a
writer), KMeans, and the resumable drivers. Inputs come from
``tools.fixtures.synthetic_scenes`` at 252 x 252 and 260 x 252 (a ragged
last tile) with ``tile_rows=63``."""

import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import (
    CalibrationConfig as JCalibrationConfig)
from rs_image_segmentation_tpu.core.config import (
    FeatureStageConfig as JFeatureStageConfig)
from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.pipeline import large_scene as jlarge
from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig)
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.pipeline import large_scene as tlarge
from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
    ClassificationEvaluator)
from rs_image_segmentation_tpu_torch.pipeline.features import (
    hierarchical_stack_fused)
from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
    preprocess_bands)
from rs_image_segmentation_tpu_torch.tools.fixtures import (rule_labels,
                                                            synthetic_scenes)

CFG = FeatureStageConfig()
JCFG = JFeatureStageConfig()
CAL = CalibrationConfig()
TILE = 63
SHAPES = {"252x252": (252, 252, 41), "260x252": (260, 252, 42)}
# the port's KMeans kappa may trail the JAX package's by this much: the
# k-means++ draws come from other random streams (ROADMAP queue 3)
KAPPA_MARGIN = 0.05


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenes():
    """name -> (raw (7, H, W) uint8, its stage-1 output, its stretched
    histograms)."""
    out = {}
    for name, (h, w, seed) in SHAPES.items():
        raw = synthetic_scenes(1, h, w, seed=seed)[0]
        pre, hists = tlarge.preprocess_large(raw, CAL, return_hist=True,
                                             device="cpu")
        out[name] = (raw, pre, hists)
    return out


@pytest.fixture(scope="module")
def forest(scenes):
    """A 15-tree forest trained by the JAX package on rule labels of 60
    pixels of the 252 x 252 scene's monolithic stack: ``(JAX GemmForest,
    its port twin carried across as numpy, the port FlatForest, depth,
    the port's monolithic (H, W, 19) stack)``."""
    _, pre, _ = scenes["252x252"]
    stack = hierarchical_stack_fused(pre, CFG, device="cpu").numpy()
    flat = stack.reshape(-1, 19)
    pick = np.random.default_rng(3).choice(flat.shape[0], 60, replace=False)
    flat_forest, depth = jforest.fit_random_forest(
        flat[pick], rule_labels(stack.transpose(2, 0, 1), pick),
        n_estimators=15, seed=0)
    gf = jforest._gemm_for(flat_forest, 19)
    tgf = tforest.gemm_forest_from_numpy(
        {k: np.asarray(v) for k, v in gf._asdict().items()})
    tflat = tforest.flat_forest_from_numpy(
        {k: np.asarray(v) for k, v in flat_forest._asdict().items()})
    return gf, tgf, tflat, depth, stack


@pytest.fixture(scope="module")
def jax_refs(scenes, forest):
    """The JAX package's global passes and supervised maps of each
    scene."""
    gf = forest[0]
    refs = {}
    for name, (raw, pre, _) in scenes.items():
        refs[name] = {
            "globals": jlarge._global_passes(pre, JCFG, TILE),
            "map": jlarge.classify_large_scene(pre, gf, JCFG, tile_rows=TILE),
            "streamed": jlarge.classify_large_scene_streamed(
                raw, gf, JCalibrationConfig(), JCFG, tile_rows=TILE)}
    return refs


# ------------------------------------------------------- host statistics

@pytest.mark.parametrize("n,values", [(1, "levels"), (5000, "levels"),
                                      (123457, "levels"), (5000, "float")])
def test_percentile_from_hist_matches_jax(n, values):
    rng = np.random.default_rng(n)
    hist = np.bincount(rng.integers(0, 256, n), minlength=256)
    vals = (np.arange(256, dtype=np.float64) if values == "levels"
            else np.sort(rng.random(256)))
    for q in (0.0, 2.0, 25.0, 50.0, 75.0, 98.0, 100.0):
        assert (tlarge.percentile_from_hist(hist, vals, q)
                == jlarge.percentile_from_hist(hist, vals, q)), q


@pytest.mark.parametrize("name", ["252x252", "260x252", "uniform"])
def test_compute_global_stats_matches_jax(scenes, name):
    if name == "uniform":
        pre = np.random.default_rng(7).integers(0, 256, (7, 90, 70),
                                                dtype=np.uint8)
    else:
        pre = scenes[name][1]
    ref = jlarge.compute_global_stats(pre, JCFG)
    got = tlarge.compute_global_stats(pre, CFG)
    for key in ("p_lo", "p_hi", "median", "iqr", "tex_lo", "tex_hi"):
        # the per-level table is the same f32 arithmetic: bit-equal
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key),
                                      err_msg=key)


def test_fit_sample_plan_matches_jax():
    cases = [(600, 600, 504), (601, 600, 504), (6000, 6000, 504),
             (5000, 7000, 504), (126, 126, 63), (10, 10, 63), (1, 1, 504),
             (260, 252, 63)]
    for h, w, tr in cases:
        for frac, cap in ((0.1, 2_000_000), (0.5, 1000), (1.0, 10 ** 9)):
            assert (tlarge._fit_sample_plan(h, w, tr, frac, cap)
                    == jlarge._fit_sample_plan(h, w, tr, frac, cap))


# ------------------------------------------------------- preprocess_large

@pytest.mark.parametrize("name", list(SHAPES))
def test_preprocess_large_matches_jax_and_preprocess_bands(scenes, name):
    raw, pre, hists = scenes[name]
    np.testing.assert_array_equal(
        pre, jlarge.preprocess_large(raw, JCalibrationConfig(),
                                     tile_rows=TILE))
    np.testing.assert_array_equal(
        pre, preprocess_bands(raw, CAL.gains, CAL.biases,
                              device="cpu").numpy())
    np.testing.assert_array_equal(hists, tlarge.band_histograms_u8(pre))
    assert hists.dtype == np.int64


def test_preprocess_large_streaming_mode_equals_resident(scenes,
                                                         monkeypatch):
    raw, pre, hists = scenes["260x252"]
    dev = tlarge.preprocess_large(raw, CAL, return_device=True, device="cpu")
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), pre)
    monkeypatch.setattr(tlarge, "DEVICE_RESIDENT_MAX_BYTES", 0)
    out, h = tlarge.preprocess_large(raw, CAL, tile_rows=TILE,
                                     return_hist=True, device="cpu")
    np.testing.assert_array_equal(out, pre)
    np.testing.assert_array_equal(h, hists)


# ------------------------------------------------------- global passes

@pytest.mark.parametrize("name", list(SHAPES))
def test_global_passes_match_jax(scenes, jax_refs, name):
    ref = jax_refs[name]["globals"]
    got = tlarge._global_passes(scenes[name][1], CFG, TILE, device="cpu")
    assert set(got) == set(ref)
    for key in ("p_lo", "p_hi", "median", "iqr", "tex_lo", "tex_hi"):
        # histogram percentiles: exact
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("pca_mean", "pca_comp1", "sobel_max"):
        # f32 tile sums added in f64 in tile order, as JAX does; the f32
        # sums themselves run in another order than XLA's (1e-7 measured)
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    for key in ("contrast_grid", "homog_grid"):
        # the XLA GLCM route's f32 sums of 32 x 32 terms in another order
        # (ROADMAP queue 3: relative 2e-6)
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], rtol=2e-6, atol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(SHAPES))
def test_global_passes_equal_fit_global_pca(scenes, name):
    pre = scenes[name][1]
    g = tlarge._global_passes(pre, CFG, TILE, device="cpu")
    stats = tlarge.compute_global_stats(pre, CFG)
    tlarge._fit_global_pca(pre, stats, TILE, device="cpu")
    # the same tile rows through the same ops: equal
    np.testing.assert_array_equal(g["pca_mean"], stats.pca_mean)
    np.testing.assert_array_equal(g["pca_comp1"], stats.pca_comp1)


def test_unaligned_tile_rows_raise(scenes, forest):
    raw, pre, _ = scenes["252x252"]
    with pytest.raises(ValueError, match="multiple of 21"):
        tlarge._global_passes(pre, CFG, 50, device="cpu")
    with pytest.raises(ValueError, match="multiple of 21"):
        tlarge.classify_large_scene_streamed(raw, forest[1], CAL, CFG,
                                             tile_rows=50, device="cpu")


# ------------------------------------------------------- supervised drivers

@pytest.mark.parametrize("name", list(SHAPES))
def test_classify_large_scene_matches_jax(scenes, forest, jax_refs, name):
    got = tlarge.classify_large_scene(scenes[name][1], forest[1], CFG,
                                      tile_rows=TILE, device="cpu")
    ref = jax_refs[name]["map"]
    assert got.shape == ref.shape and got.dtype == np.int32
    agreement = (got == ref).mean()
    assert agreement >= 0.999, agreement      # the port's map contract
    assert len(np.unique(ref)) > 1


def test_tiled_matches_monolithic(scenes, forest):
    _, tgf, tflat, depth, stack = forest
    mono = tforest.forest_predict(tflat, torch.from_numpy(
        stack.reshape(-1, 19)), depth).numpy().reshape(252, 252)
    got = tlarge.classify_large_scene(scenes["252x252"][1], tgf, CFG,
                                      tile_rows=TILE, device="cpu")
    agreement = (got == mono).mean()
    # the bound of tests/test_large_scene.py: the tiled PCA, Sobel maximum
    # and texture percentiles are the whole scene's, but PC1's f64 fit and
    # the stencils at tile seams round differently
    assert agreement >= 0.995, agreement


def test_hists_and_streaming_mode_bit_equal(scenes, forest, monkeypatch):
    _, pre, hists = scenes["260x252"]
    tgf = forest[1]
    base = tlarge.classify_large_scene(pre, tgf, CFG, tile_rows=TILE,
                                       device="cpu")
    with_h = tlarge.classify_large_scene(pre, tgf, CFG, tile_rows=TILE,
                                         hists=hists, device="cpu")
    np.testing.assert_array_equal(with_h, base)
    g = tlarge._global_passes(pre, CFG, TILE, device="cpu")
    monkeypatch.setattr(tlarge, "DEVICE_RESIDENT_MAX_BYTES", 0)
    g_st = tlarge._global_passes(pre, CFG, TILE, device="cpu")
    for key in g:
        np.testing.assert_array_equal(g_st[key], g[key], err_msg=key)
    streamed_mode = tlarge.classify_large_scene(pre, tgf, CFG,
                                                tile_rows=TILE, device="cpu")
    np.testing.assert_array_equal(streamed_mode, base)


@pytest.mark.parametrize("name", list(SHAPES))
def test_streamed_equals_resident_and_matches_jax(scenes, forest, jax_refs,
                                                  name):
    raw, _, _ = scenes[name]
    tgf = forest[1]
    got = tlarge.classify_large_scene_streamed(raw, tgf, CAL, CFG,
                                               tile_rows=TILE, device="cpu")
    pre, hists = tlarge.preprocess_large(raw, CAL, return_hist=True,
                                         device="cpu")
    resident = tlarge.classify_large_scene(pre, tgf, CFG, tile_rows=TILE,
                                           hists=hists, device="cpu")
    np.testing.assert_array_equal(got, resident)   # the JAX contract
    agreement = (got == jax_refs[name]["streamed"]).mean()
    assert agreement >= 0.999, agreement


class _Recorder:
    """A writer stub: keeps a copy of every block of rows it is handed."""

    def __init__(self):
        self.blocks = []

    def write_rows(self, rows):
        self.blocks.append(np.array(rows))


@pytest.mark.parametrize("route", ["resident", "streaming mode", "streamed"])
def test_writer_receives_every_row_once_in_order(scenes, forest,
                                                 monkeypatch, route):
    raw, pre, _ = scenes["260x252"]
    tgf = forest[1]
    rec = _Recorder()
    if route == "streamed":
        out = tlarge.classify_large_scene_streamed(
            raw, tgf, CAL, CFG, tile_rows=TILE, writer=rec, device="cpu")
    else:
        if route == "streaming mode":
            monkeypatch.setattr(tlarge, "DEVICE_RESIDENT_MAX_BYTES", 0)
        out = tlarge.classify_large_scene(pre, tgf, CFG, tile_rows=TILE,
                                          writer=rec, device="cpu")
    assert [b.shape[0] for b in rec.blocks] == [63, 63, 63, 63, 8]
    np.testing.assert_array_equal(np.concatenate(rec.blocks), out)


# ------------------------------------------------------- KMeans

def _mapped_kappa(maps, truth) -> float:
    ev = ClassificationEvaluator(device="cpu")
    pred, true = ev.extract_valid_samples(torch.as_tensor(maps),
                                          torch.as_tensor(truth))
    return ev.calculate_metrics(true, ev.map_clusters_to_classes(pred, true)
                                )["kappa"]


@pytest.fixture(scope="module")
def kmeans_refs(scenes):
    """The JAX package's KMeans fit state and map of the 252 x 252 scene
    (k = 5, half the pixels), and the port's map."""
    pre = scenes["252x252"][1]
    src = jlarge._tile_src(pre)
    stack_tile, _ = jlarge._make_stack_fn(pre, JCFG, TILE, src=src)
    fit = jlarge._kmeans_fit_large(pre, 5, JCFG, TILE, 42, 0.5, 2_000_000,
                                   src, stack_tile)
    assign = jlarge._kmeans_assign_fn(*fit, 5)
    jmap = np.concatenate([np.asarray(assign(s)).reshape(rows, -1)
                           for _, rows, s in jlarge._kmeans_tiles(
                               pre, JCFG, TILE, src, stack_tile)])
    got = tlarge.kmeans_large_scene(pre, n_clusters=5, cfg=CFG,
                                    tile_rows=TILE, fit_fraction=0.5,
                                    device="cpu")
    return [np.array(v) for v in fit], jmap.astype(np.int32), got


def test_kmeans_large_scene_labels(kmeans_refs):
    got = kmeans_refs[2]
    assert got.shape == (252, 252) and got.dtype == np.int32
    assert got.min() >= 1 and got.max() <= 5       # 1-based
    assert len(np.unique(got)) >= 3


def test_kmeans_assignment_to_jax_fit_matches_jax(scenes, kmeans_refs):
    (mins, rng, cents), jmap, _ = kmeans_refs
    pre = scenes["252x252"][1]
    src = tlarge._tile_src(pre, torch.device("cpu"))
    stack_tile, _ = tlarge._make_stack_fn(pre, CFG, TILE, src=src,
                                          device="cpu")
    assign = tlarge._kmeans_assign_fn(
        *(torch.from_numpy(v) for v in (mins, rng, cents)), 5)
    got = torch.cat([assign(s).reshape(rows, -1) for _, rows, s in
                     tlarge._kmeans_tiles(pre, CFG, TILE, src, stack_tile)])
    agreement = (got.numpy() == jmap).mean()
    # the stacks agree to ~1e-6, so only near-tied pixels may part
    assert agreement >= 0.999, agreement


def test_kmeans_quality_within_margin_of_jax(scenes, kmeans_refs):
    _, jmap, got = kmeans_refs
    rule = tlarge.rule_based_large_scene(scenes["252x252"][1], CFG,
                                         device="cpu")
    assert (_mapped_kappa(got, rule)
            >= _mapped_kappa(jmap, rule) - KAPPA_MARGIN)


# ------------------------------------------------------- resumable drivers

def _run(driver, pre, forest, ckpt, **kw):
    if driver == "classify":
        return tlarge.classify_large_scene_resumable(
            pre, forest[1], ckpt, CFG, tile_rows=TILE, device="cpu", **kw)
    if driver == "kmeans":
        return tlarge.kmeans_large_scene_resumable(
            pre, ckpt, n_clusters=4, cfg=CFG, tile_rows=TILE, device="cpu",
            **kw)
    return tlarge.rule_based_large_scene_resumable(pre, ckpt, CFG,
                                                   device="cpu", **kw)


def _uninterrupted(driver, pre, forest):
    if driver == "classify":
        return tlarge.classify_large_scene(pre, forest[1], CFG,
                                           tile_rows=TILE, device="cpu")
    if driver == "kmeans":
        return tlarge.kmeans_large_scene(pre, n_clusters=4, cfg=CFG,
                                         tile_rows=TILE, device="cpu")
    return tlarge.rule_based_large_scene(pre, CFG, device="cpu")


@pytest.mark.parametrize("driver", ["classify", "kmeans", "rule"])
def test_resumable_survives_interrupt(scenes, forest, tmp_path, driver):
    import json
    pre = scenes["260x252"][1]
    ref = _uninterrupted(driver, pre, forest)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(tlarge.TileInterrupt):
        _run(driver, pre, forest, ckpt, interrupt_after=2)
    with open(tmp_path / "ckpt" / "manifest.json") as f:
        assert len(json.load(f)["done"]) == 2      # progress persisted
    resumed = _run(driver, pre, forest, ckpt)
    np.testing.assert_array_equal(resumed, ref)
    assert resumed.dtype == ref.dtype
    # a third run recomputes nothing and returns the same map
    np.testing.assert_array_equal(_run(driver, pre, forest, ckpt), ref)


@pytest.mark.parametrize("driver", ["classify", "kmeans", "rule"])
def test_resumable_discards_foreign_checkpoint(scenes, forest, tmp_path,
                                               driver):
    pre = scenes["252x252"][1]
    scene_a = np.ascontiguousarray(pre[:, :126, :126])
    scene_b = np.ascontiguousarray(pre[:, 126:, 126:])
    ckpt = str(tmp_path / "ckpt")
    map_a = _run(driver, scene_a, forest, ckpt)
    map_b = _run(driver, scene_b, forest, ckpt)
    np.testing.assert_array_equal(map_b,
                                  _uninterrupted(driver, scene_b, forest))
    assert not np.array_equal(map_a, map_b)


# ------------------------------------------------------- device rule

ENTRY_POINTS = {
    "preprocess_large": lambda raw, pre, gf, d: tlarge.preprocess_large(raw),
    "classify_large_scene": lambda raw, pre, gf, d:
        tlarge.classify_large_scene(pre, gf),
    "classify_large_scene_streamed": lambda raw, pre, gf, d:
        tlarge.classify_large_scene_streamed(raw, gf),
    "kmeans_large_scene": lambda raw, pre, gf, d:
        tlarge.kmeans_large_scene(pre),
    "classify_large_scene_resumable": lambda raw, pre, gf, d:
        tlarge.classify_large_scene_resumable(pre, gf, d),
    "kmeans_large_scene_resumable": lambda raw, pre, gf, d:
        tlarge.kmeans_large_scene_resumable(pre, d),
    "rule_based_large_scene_resumable": lambda raw, pre, gf, d:
        tlarge.rule_based_large_scene_resumable(pre, d),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(scenes, forest, tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    raw, pre, _ = scenes["252x252"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](raw, pre, forest[1], str(tmp_path / "c"))


# ---------------------------------------- the streamed route's raw counts

def test_streamed_counts_every_chunk_once(scenes, forest, monkeypatch):
    """The streamed route counts each raw chunk once, into one
    accumulator, and derives the LUT and histogram ``build_stretch_stats``
    gives."""
    from rs_image_segmentation_tpu_torch.pipeline import preprocess as tpre
    raw = scenes["260x252"][0]
    calls, derived = [], []
    real_count = tlarge.raw_counts
    real_derive = tlarge.stretch_tables_from_counts

    def count(chunk, acc):
        calls.append((tuple(chunk.shape), acc.data_ptr()))
        return real_count(chunk, acc)

    def derive(counts, gains, biases):
        derived.append(real_derive(counts, gains, biases))
        return derived[-1]

    monkeypatch.setattr(tlarge, "raw_counts", count)
    monkeypatch.setattr(tlarge, "stretch_tables_from_counts", derive)
    tlarge.classify_large_scene_streamed(raw, forest[1], CAL, CFG,
                                         tile_rows=TILE, device="cpu")
    assert [s for s, _ in calls] == [(7, 63, 252)] * 4 + [(7, 8, 252)]
    assert len({p for _, p in calls}) == 1
    lut, _, hist = tpre.build_stretch_stats(raw, CAL.gains, CAL.biases)
    assert len(derived) == 1 and len(derived[0]) == 2
    for g, r in zip(derived[0], (lut, hist)):
        assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.mark.card
def test_streamed_counts_on_the_card_once_a_chunk():
    """On the card a streamed 6000 x 6000 call launches the count kernel
    once a chunk (12), records the raw bytes it counted on
    ``large.host_stats`` and those it copied on the host, once each, on
    ``stretch.hist``, and maps as the resident route does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from rs_image_segmentation_tpu_torch.models.forest import GemmForest
    from rs_image_segmentation_tpu_torch.ops import kernels
    from rs_image_segmentation_tpu_torch.tools.fixtures import rule_forest
    from rs_image_segmentation_tpu_torch.tools.kernel_times import (
        reflected_tiling)
    from rs_image_segmentation_tpu_torch.utils import timing
    dev = torch.device("cuda")
    tile = synthetic_scenes(1, 600, 600, seed=0)[0]
    raw = reflected_tiling(tile, 6000)
    pre, hists = tlarge.preprocess_large(raw, CAL, return_hist=True,
                                         device=dev)
    stack = hierarchical_stack_fused(pre[:, :600, :600], CFG,
                                     device=dev).cpu().numpy()
    gf = GemmForest(*(t.to(dev) for t in rule_forest(
        stack.transpose(2, 0, 1))[0]))
    before = kernels.raw_counts.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = tlarge.classify_large_scene_streamed(raw, gf, CAL, CFG,
                                                   tile_rows=504, device=dev)
    assert kernels.raw_counts.launches == before + 12
    host, = [r for r in timing.spans() if r.name == "large.host_stats"]
    assert host.counts["bytes"] == raw.nbytes
    hist, = [r for r in timing.spans() if r.name == "stretch.hist"]
    assert hist.counts["host_copy_bytes"] == raw.nbytes   # one host copy
    np.testing.assert_array_equal(got, tlarge.classify_large_scene(
        pre, gf, CFG, tile_rows=504, hists=hists, device=dev))
