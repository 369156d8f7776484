"""Device times of the redesigned kernels at the main paths' shapes, three
ways: back to back (a mean of calls in a row, whose inputs
may stay in the 50 MB L2), one call with the L2 flushed (the median of
CUDA-event times), and each CUDA kernel alone, by name, from a
``torch.profiler`` trace of calls with the L2 flushed before each.

Measured on one CUDA card, with the ``chip_smoke.py`` inputs (8 synthetic
scenes of 7 x 600 x 600 from seed 0):

* ``forest_labels`` over the batch's 19-channel stacks with the bundled
  scale's forest (``tools.fixtures.rule_forest``), a large forest (100
  trees fitted on ``LARGE_FOREST_SAMPLES`` pixels, some 6 000 leaves) and
  a deep one (on ``DEEP_FOREST_SAMPLES``, an ROI raster's labelled
  pixels: some 20 000 leaves at depth 23 to 25, past
  ``GEMM_MAX_LEAVES``);
* ``ccmin_prop`` over the batched rule path's 24 first-stage masks with
  their run-rank seeds;
* ``cc_labels`` over the four masks the single-scene rule graph labels,
  at 600 x 600 and at 6000 x 6000 (a reflected tiling of scene 0);
* ``hist_dense`` over the ids the batched rule path counts: its 24
  first-stage masks and its 8 bare-land masks (bins 32768); and stacks of
  24 that are all background (the empty-input floor), uniform random ids
  (an atomic per id) and one id (the worst contention); with the kernels
  a call launches, from a trace of three calls;
* ``glcm_grid`` over stage 2's texture band of scene 0 (levels 32, window
  = step = 21, four offsets), the batch's 8 texture bands, a flat band
  (every pair on one cell) and a band of uniform random levels (pairs
  spread over the cells);
* ``lut_hist``: the batch with ``skip_hist`` and f32 out (the
  supervised path's preamble), the batch with its histogram, scene 0 with
  its histogram (the single-scene rule path), and the batch with
  ``skip_hist`` and uint8 out;
* ``fused_calibrate_stretch`` on scene 0 as 16-bit DNs and as float DNs
  (``stage1_dns``), with gains and biases passed as host values (as
  ``preprocess_bands_f32`` passes the configuration's) and as tensors on
  the card;
* ``fused_spectral_indices`` on stage 2's normalised bands of scene 0
  (the uint8 stage-1 artifact through ``normalize_bands``);
* ``raw_counts`` on the streamed large scene's raw chunk (7 x 504 x 6000
  of a 6000 x 6000 reflected tiling of scene 0) and on the whole scene
  as the route counts it, 12 chunks into one accumulator, with its plain
  version's time on the chunk;
* ``kmeans_lloyd``: one ``lloyd_pass`` (its two kernels) over the KMeans
  batch's (8, 360 000, 19) scaled features from k-means++ centroids (k 7,
  every problem kept active), with the plain version's time (one
  ``models.kmeans._lloyd``), and both loops' host-clock ms an iteration
  over 50 iterations, each iteration's host sync included.

``lut_hist``, ``fused_calibrate_stretch`` and ``fused_spectral_indices``
also report the kernels one call launches and whether its trace holds a
host-to-device copy; the
stretch on host gains also stage 1's route around it (``stage1_wall_ms``).

``--root DIR`` imports the port's package from the checkout at ``DIR``
(for example an unpacked parent commit), so that two versions of the
kernels can be timed by one script on one card:

    python3 rs_image_segmentation_tpu_torch/tools/kernel_times.py \\
        [--root DIR] [--kernels hist_dense,glcm_grid] [--out FILE.json]

``--kernels`` picks the kernels to time (default: all ten).

The timing helpers (``l2_flusher``, ``cold_ms``, ``trace_ms``,
``kernel_device_ms``, ``kernel_numbers``) and the fixtures
(``large_forest``, ``reflected_tiling``, ``spied_calls``,
``graph_cc_masks``, ``rule_hist_ids``, ``stage2_glcm_bands``, ``dn16``,
``stage1_dns``) are also used by ``chip_smoke.py``. They need a card
and raise without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

L2_FLUSH_BYTES = 256 << 20     # over five times the H100's 50 MB L2
LARGE_FOREST_SAMPLES = 2000
# an ROI raster's labelled pixels, as an analyst trains the source's forest
DEEP_FOREST_SAMPLES = 20000
BATCH, SIZE, LARGE, SEED = 8, 600, 6000, 0
BINS = 32768                   # the batched rule path's component-id cap
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
KERNELS = ("forest_labels", "ccmin_prop", "cc_labels", "hist_dense",
           "glcm_grid", "lut_hist", "fused_calibrate_stretch",
           "fused_spectral_indices", "raw_counts", "kmeans_lloyd")
CHUNK_ROWS = 504               # the streamed large scene's row chunk


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel timing needs a CUDA device")


def l2_flusher(dev) -> Callable[[], None]:
    """A call that evicts the L2 (writes ``L2_FLUSH_BYTES``), then spins the
    card for about half a millisecond, so that the host has enqueued the
    timed call before the card reaches it."""
    _need_card()
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def flush():
        buf.zero_()
        torch.cuda._sleep(1_000_000)
    return flush


def cold_ms(fn, flush, reps: int = 20) -> float:
    """Median device ms of one call of ``fn`` (CUDA events around it), with
    the L2 flushed before each call: the inputs come from HBM, as the
    byte bound assumes."""
    _need_card()
    fn()
    ts = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        ts.append(start.elapsed_time(stop))
    return statistics.median(ts)


def _device_us(ev) -> float:
    return float(getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0)))


def _trace(fn, reps: int) -> Dict[str, float]:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: _device_us(ev) for ev in prof.key_averages()
            if _device_us(ev) > 0}


# the flush's kernels (the zero fill and the spin); a wrapper's own zero
# fill has the same name and is left out with them
_FLUSH_KERNELS = ("spin_kernel", "FillFunctor")


def trace_ms(fn, flush, reps: int = 20) -> Dict[str, float]:
    """Device ms per call of ``fn`` of each CUDA kernel it launches, by
    kernel name, from a torch.profiler trace of ``reps`` calls with the L2
    flushed before each (the kernels alone, without the host's time). The
    flush's kernels are left out; empty when the trace shows no device
    time."""
    _need_card()
    fn()
    torch.cuda.synchronize()
    both = _trace(lambda: (flush(), fn()), reps)
    return {k: v / reps / 1e3 for k, v in both.items()
            if not any(f in k for f in _FLUSH_KERNELS)}


def kernel_device_ms(fn, kernel: str, flush, reps: int = 20):
    """Device ms per call of ``fn`` of the CUDA kernels whose names hold
    ``kernel`` (:func:`trace_ms`); None when the trace shows none."""
    total = sum(v for k, v in trace_ms(fn, flush, reps).items()
                if kernel in k)
    return total if total > 0 else None


def launched_kernels(fn, reps: int = 3) -> list:
    """The names of the CUDA kernels a call of ``fn`` launches, memsets,
    fills and copies included, from a torch.profiler trace of ``reps``
    calls (a trace of one call can miss its first launch), each after a
    spin of the card (left out of the names); traced again with twice the
    calls, up to three times, while the trace is empty."""
    _need_card()
    fn()
    torch.cuda.synchronize()

    def spun():             # a trace of a few short calls has come back
        torch.cuda._sleep(1_000_000)    # empty; the spin lengthens it, as
        fn()                            # the flush does in trace_ms
    for tries in range(4):
        names = sorted(short_name(k) for k in _trace(spun, reps << tries)
                       if "spin_kernel" not in k)
        if names:
            break
    return names


def launch_numbers(fn) -> dict:
    """The kernels one call of ``fn`` launches (:func:`launched_kernels`)
    and whether the trace shows a host-to-device copy."""
    names = launched_kernels(fn)
    return {"kernels_a_call_launches": names,
            "htod_memcpy": any("HtoD" in k for k in names)}


def short_name(kernel: str) -> str:
    """``void (anonymous namespace)::cc_tile<2, false>(...)`` ->
    ``cc_tile<2, false>``."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip()


def kernel_numbers(fn, flush, hot_reps: int = 20, cold_reps: int = 20,
                   trace_reps: int = 20) -> dict:
    """``fn``'s back-to-back mean ms, its cold-L2 median ms, and its
    kernels' device ms alone (each, and their sum)."""
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms
    passes: Dict[str, float] = {}
    for k, v in trace_ms(fn, flush, trace_reps).items():
        passes[short_name(k)] = passes.get(short_name(k), 0.0) + v
    return {"ms": cuda_time_ms(fn, hot_reps, 1),
            "cold_ms": cold_ms(fn, flush, cold_reps),
            "alone_ms": sum(passes.values()) if passes else None,
            "passes": passes}


def mean_numbers(runs) -> dict:
    """The mean of several :func:`kernel_numbers` results, pass by pass."""
    out = {k: statistics.mean(r[k] for r in runs)
           for k in ("ms", "cold_ms")}
    alone = [r["alone_ms"] for r in runs]
    out["alone_ms"] = None if None in alone else statistics.mean(alone)
    names = sorted({k for r in runs for k in r["passes"]})
    out["passes"] = {k: statistics.mean(r["passes"].get(k, 0.0)
                                        for r in runs) for k in names}
    return out


def spied_calls(module, name: str, run):
    """``run()``, and the arguments of every call it makes to
    ``module.<name>`` (tensors cloned)."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        out = run()
    finally:
        setattr(module, name, real)
    return out, seen


def graph_cc_masks(run):
    """``run()``, and the masks it hands to
    ``ops.components.connected_components_best``, with their
    connectivities."""
    from rs_image_segmentation_tpu_torch.ops import components
    out, seen = spied_calls(components, "connected_components_best", run)
    return out, [(a[0], a[1] if len(a) > 1 else 8) for a in seen]


def rule_hist_ids(scenes_d, luts_d, cfg, hists_d):
    """The id stacks the batched rule program hands to ``hist_dense``: its
    first-stage masks (3 per scene) and its bare-land masks (1 per scene),
    with the ``bins_hi`` of each call."""
    from rs_image_segmentation_tpu_torch.ops import components
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    _, calls = spied_calls(components, "hist_dense", lambda: (
        turbo.rule_based_scenes_turbo_batch(
            scenes_d, luts_d, cfg, stretch_hists=hists_d,
            device=scenes_d.device)))
    if len(calls) != 2:
        raise RuntimeError(f"the rule program counted {len(calls)} stacks")
    return calls


def stage2_glcm_bands(scene, cfg, dev):
    """The levels stage 2 hands to ``glcm_grid`` for a raw (7, H, W) uint8
    scene (``preprocess_bands`` into ``extract_features``)."""
    from rs_image_segmentation_tpu_torch.core.config import (
        CalibrationConfig)
    from rs_image_segmentation_tpu_torch.ops import texture
    from rs_image_segmentation_tpu_torch.pipeline import features
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        preprocess_bands)
    cal = CalibrationConfig()
    art = preprocess_bands(scene, np.asarray(cal.gains),
                           np.asarray(cal.biases), device=dev)
    _, calls = spied_calls(texture, "glcm_grid", lambda: (
        features.extract_features(art, cfg, device=dev)))
    if len(calls) != 1:
        raise RuntimeError(f"stage 2 called glcm_grid {len(calls)} times")
    return calls[0][0]


def batch_glcm_bands(scenes_d, luts_d, cfg):
    """The batch's texture bands quantised to the configuration's levels,
    (B, H, W) int32: each scene stretched, normalised as stage 2 does, its
    texture band renormalised."""
    from rs_image_segmentation_tpu_torch.ops import kernels
    from rs_image_segmentation_tpu_torch.ops.normalize import (
        robust_normalize)
    from rs_image_segmentation_tpu_torch.pipeline import features
    stretched = kernels.lut_hist_plain(scenes_d, luts_d, skip_hist=True)
    bands01 = features.normalize_bands(stretched, cfg)
    tex01 = robust_normalize(bands01[:, cfg.texture_band_index])
    return (tex01 * (cfg.glcm.levels - 1)).to(torch.uint8).to(torch.int32)


def stage1_wall_ms(x, gains, biases, reps: int = 20) -> float:
    """Median host-clock ms of stage 1's f32 route on DNs ``x`` already on
    the card (``preprocess_bands`` with host gains, into uint8), each call
    ended by a synchronize."""
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        preprocess_bands)
    ts = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preprocess_bands(x, gains, biases, device=x.device)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts[1:])


def dn16(scene: np.ndarray) -> np.ndarray:
    """A 16-bit scene from a uint8 one: DN * 257 plus seeded noise in
    [0, 257)."""
    noise = np.random.default_rng(SEED + 32).integers(0, 257, scene.shape)
    return scene.astype(np.uint16) * 257 + noise.astype(np.uint16)


def stage1_dns(scene: np.ndarray) -> dict:
    """Stage 1's f32-route inputs from a uint8 scene: 16-bit DNs
    (:func:`dn16`) and float DNs (DN * 1.37 plus seeded noise in [0, 1))."""
    return {"uint16": dn16(scene),
            "f32": scene.astype(np.float32) * 1.37 + np.random.default_rng(
                SEED + 33).random(scene.shape, dtype=np.float32)}


def reflected_tiling(scene: np.ndarray, size: int) -> np.ndarray:
    """A (C, size, size) scene from a (C, h, w) one: the scene and its
    mirror images in a 2 x 2 block, tiled; continuous across every seam."""
    block = np.concatenate([np.concatenate([scene, scene[:, :, ::-1]], 2),
                            np.concatenate([scene[:, ::-1],
                                            scene[:, ::-1, ::-1]], 2)], 1)
    reps = (1, -(-size // block.shape[1]), -(-size // block.shape[2]))
    return np.ascontiguousarray(np.tile(block, reps)[:, :size, :size])


def fitted_forest(stack0: np.ndarray, samples: int):
    """A 100-tree FlatForest fitted by the port's trainer on the rule
    labels of ``samples`` random pixels of a (19, H, W) stack (seed 7)."""
    from rs_image_segmentation_tpu_torch.core.config import ForestConfig
    from rs_image_segmentation_tpu_torch.models.forest import (
        fit_random_forest)
    from rs_image_segmentation_tpu_torch.tools.fixtures import rule_labels
    cfg = ForestConfig()
    flat = stack0.reshape(stack0.shape[0], -1)
    pick = np.random.default_rng(7).choice(flat.shape[1], samples,
                                           replace=False)
    forest, _ = fit_random_forest(flat[:, pick].T, rule_labels(stack0, pick),
                                  n_estimators=cfg.n_estimators,
                                  seed=cfg.seed)
    return forest


def large_forest(stack0: np.ndarray, samples: int = LARGE_FOREST_SAMPLES):
    """The GemmForest of :func:`fitted_forest`: some 6 000 leaves at 2 000
    samples, within ``GEMM_MAX_LEAVES``; some 20 000 at
    ``DEEP_FOREST_SAMPLES``, past it (its path sparse)."""
    from rs_image_segmentation_tpu_torch.models.forest import _gemm_for
    return _gemm_for(fitted_forest(stack0, samples), stack0.shape[0])


def measure(dev, which=KERNELS) -> dict:
    """Every number of this script's JSON, on ``dev``, for the kernels
    named in ``which``."""
    from rs_image_segmentation_tpu_torch.core.config import (
        CalibrationConfig, FeatureStageConfig, RuleBasedConfig)
    from rs_image_segmentation_tpu_torch.models.forest import GemmForest
    from rs_image_segmentation_tpu_torch.ops import components, kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        build_stretch_lut)
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        rule_forest, stretch_stats_batch, synthetic_scenes)

    cfg = FeatureStageConfig()
    scenes = synthetic_scenes(BATCH, SIZE, SIZE, seed=SEED)
    luts, _, hists = stretch_stats_batch(scenes)
    scenes_d, luts_d, hists_d = (
        torch.from_numpy(a).to(dev) for a in (scenes, luts, hists))
    flush = l2_flusher(dev)
    out = {}

    if "forest_labels" in which:
        stacks = turbo.hierarchical_stack_turbo_cm(scenes_d, luts_d, cfg,
                                                   device=dev)
        x_cm = stacks.reshape(BATCH, 19, SIZE * SIZE)
        stack0 = stacks[0].cpu().numpy()
        forests = {"bundled": rule_forest(stack0)[0],
                   "large": large_forest(stack0),
                   "deep": large_forest(stack0, DEEP_FOREST_SAMPLES)}
        for key, gf_cpu in forests.items():
            gf = GemmForest(*(t.to(dev) for t in gf_cpu))
            got = kernels.forest_labels(gf, x_cm)
            torch.cuda.synchronize()
            res = kernel_numbers(lambda: kernels.forest_labels(gf, x_cm),
                                 flush, 5, 10, 5)
            res["leaves"] = int(gf.path.shape[1])
            res["instance"] = kernels.forest_instance(gf)
            res["walk_depth"] = kernels._packed_on(gf, dev)[2]["walk_depth"]
            res["labels_sum"] = int(got.long().sum().item())
            out[f"forest_labels, {key} forest"] = res

    if "ccmin_prop" in which:
        rc = RuleBasedConfig()
        nd = turbo._rule_front(scenes_d, luts_d, cfg, hists_d)
        stack3, _ = turbo._rule_first_stage(*nd, rc)
        fg3 = stack3 != 0
        seeds = components.run_rank_seeds(fg3)
        out["ccmin_prop, 24 x 600 x 600"] = kernel_numbers(
            lambda: kernels.ccmin_prop(fg3, seeds, 8), flush)

    if "cc_labels" in which:
        def single(raw_d, lut_d):
            return turbo.rule_based_scenes_turbo(raw_d, lut_d, cfg,
                                                 device=dev)

        _, masks = graph_cc_masks(lambda: single(scenes_d[0], luts_d[0]))
        cal = CalibrationConfig()
        big = reflected_tiling(scenes[0], LARGE)
        big_lut = build_stretch_lut(big, np.asarray(cal.gains),
                                    np.asarray(cal.biases)).astype(np.uint8)
        _, big_masks = graph_cc_masks(lambda: single(
            torch.from_numpy(big).to(dev), torch.from_numpy(big_lut).to(dev)))
        for key, ms_, reps in ((f"{SIZE} x {SIZE}", masks, 20),
                               (f"{LARGE} x {LARGE}", big_masks, 5)):
            out[f"cc_labels, {key}, mean of the graph's four masks"] = \
                mean_numbers([kernel_numbers(
                    lambda m=m: kernels.cc_labels(m, c), flush, reps, reps,
                    reps) for m, c in ms_])

    if "hist_dense" in which:
        (ids3, hi3), (ids_bare, hi_bare) = rule_hist_ids(
            scenes_d, luts_d, cfg, hists_d)
        empty = torch.full_like(ids3, BINS)
        noise = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, BINS, tuple(ids3.shape), dtype=np.int32)).to(dev)
        for key, ids, bins_hi in (
                ("24 first-stage masks", ids3, hi3),
                ("8 bare-land masks", ids_bare, hi_bare),
                ("24 all-background masks (floor)", empty, hi3),
                ("24 masks of uniform random ids (no runs)", noise, hi3),
                ("24 masks of one id", torch.full_like(ids3, 5), hi3)):
            res = kernel_numbers(lambda: kernels.hist_dense(ids, bins_hi),
                                 flush)
            res["kernels_a_call_launches"] = launched_kernels(
                lambda: kernels.hist_dense(ids, bins_hi))
            res["counts_sum"] = int(kernels.hist_dense(ids, bins_hi)
                                    .long().sum().item())
            out[f"hist_dense, {key} x {SIZE} x {SIZE}, bins "
                f"{bins_hi * kernels.HIST_LO}"] = res

    if "glcm_grid" in which:
        g = cfg.glcm
        from rs_image_segmentation_tpu_torch.ops.texture import (
            _offset_for_angle)
        offsets = tuple(_offset_for_angle(1, a) for a in g.angles)
        band = stage2_glcm_bands(scenes[0], cfg, dev)
        for key, q in (
                ("stage 2's band", band),
                ("the batch's 8 bands", batch_glcm_bands(scenes_d, luts_d,
                                                         cfg)),
                ("a flat band (floor)", torch.zeros_like(band)),
                ("a band of uniform random levels", torch.from_numpy(
                    np.random.default_rng(SEED).integers(
                        0, g.levels, tuple(band.shape), dtype=np.int32))
                 .to(dev))):
            res = kernel_numbers(lambda: kernels.glcm_grid(
                q, g.levels, g.window_size, g.step_size, offsets), flush)
            res["shape"] = list(q.shape)
            out[f"glcm_grid, {key}, levels {g.levels}, window "
                f"{g.window_size}"] = res

    if "lut_hist" in which:
        planes, n = BATCH * scenes.shape[1], SIZE * SIZE
        for key, args, kw, n_planes in (
                ("skip_hist, f32 out, the batch", (scenes_d, luts_d),
                 dict(skip_hist=True), planes),
                ("histogram, f32 out, the batch", (scenes_d, luts_d),
                 dict(), planes),
                ("histogram, f32 out, scene 0", (scenes_d[0], luts_d[0]),
                 dict(), planes // BATCH),
                ("skip_hist, uint8 out, the batch", (scenes_d, luts_d),
                 dict(skip_hist=True, out_u8=True), planes)):
            res = kernel_numbers(lambda: kernels.lut_hist(*args, **kw), flush)
            res.update(launch_numbers(lambda: kernels.lut_hist(*args, **kw)))
            # each input byte read once, each output byte written once
            nbytes = n_planes * (n * (1 + (1 if kw.get("out_u8") else 4))
                                 + 256 + (0 if kw.get("skip_hist")
                                          else 256 * 4))
            res["bytes"] = nbytes
            res["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            shape = tuple(args[0].shape)
            out[f"lut_hist, {key}, {' x '.join(map(str, shape))}"] = res

    if "fused_calibrate_stretch" in which:
        cal = CalibrationConfig()
        gains, biases = np.asarray(cal.gains), np.asarray(cal.biases)
        gains_d = torch.from_numpy(gains.astype(np.float32)).to(dev)
        biases_d = torch.from_numpy(biases.astype(np.float32)).to(dev)
        for dtype, dn in stage1_dns(scenes[0]).items():
            x = torch.from_numpy(dn).to(dev)
            for how, g, b in (("host gains", gains, biases),
                              ("gains on the card", gains_d, biases_d)):
                def call(x=x, g=g, b=b):
                    return kernels.fused_calibrate_stretch(x, g, b)
                res = kernel_numbers(call, flush)
                res.update(launch_numbers(call))
                if how == "host gains":
                    res["stage1_wall_ms"] = stage1_wall_ms(x, gains, biases)
                nbytes = x.numel() * (x.element_size() + 4)
                res["bytes"] = nbytes
                res["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                out[f"fused_calibrate_stretch, {dtype} DNs, {how}, "
                    f"{' x '.join(map(str, dn.shape))}"] = res

    if "fused_spectral_indices" in which:
        from rs_image_segmentation_tpu_torch.pipeline.features import (
            normalize_bands)
        bands01 = normalize_bands(kernels.lut_hist_plain(
            scenes_d[0], luts_d[0], skip_hist=True), cfg)
        res = kernel_numbers(lambda: kernels.fused_spectral_indices(bands01),
                             flush)
        res.update(launch_numbers(
            lambda: kernels.fused_spectral_indices(bands01)))
        # five bands read (blue, green, red, NIR, SWIR1), seven written
        nbytes = SIZE * SIZE * (5 + 7) * 4
        res["bytes"] = nbytes
        res["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[f"fused_spectral_indices, stage 2's normalised bands, "
            f"{' x '.join(map(str, bands01.shape))}"] = res

    if "raw_counts" in which:
        big = reflected_tiling(scenes[0], LARGE)
        chunks = [torch.from_numpy(np.ascontiguousarray(
            big[:, y:y + CHUNK_ROWS])).to(dev)
            for y in range(0, LARGE, CHUNK_ROWS)]
        # the timed calls add into acc until its bins wrap (integer adds,
        # harmless to the times); the counts are checked after, from zero
        acc = torch.zeros((big.shape[0], 256), dtype=torch.int32, device=dev)
        # each input byte read once, a call's counts read and written once
        acc_bytes = 2 * acc.numel() * 4
        for key, call, nbytes in (
                (f"the chunk, {' x '.join(map(str, chunks[0].shape))}",
                 lambda: kernels.raw_counts(chunks[0], acc),
                 chunks[0].numel() + acc_bytes),
                (f"the scene, {len(chunks)} chunks into one accumulator, "
                 f"{big.shape[0]} x {LARGE} x {LARGE}",
                 lambda: [kernels.raw_counts(c, acc) for c in chunks],
                 big.size + len(chunks) * acc_bytes)):
            res = kernel_numbers(call, flush)
            res.update(launch_numbers(call))
            res["bytes"] = nbytes
            res["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            if key.startswith("the chunk"):
                res["plain_ms"] = cold_ms(
                    lambda: kernels.raw_counts_plain(chunks[0], acc), flush, 5)
            out[f"raw_counts, {key}"] = res
        acc.zero_()
        for c in chunks:
            kernels.raw_counts(c, acc)
        want = np.stack([np.bincount(b.reshape(-1), minlength=256)
                         for b in big])
        if not np.array_equal(acc.cpu().numpy(), want):
            raise RuntimeError("raw_counts: the scene's counts differ from "
                               "np.bincount")

    if "kmeans_lloyd" in which:
        out.update(lloyd_numbers(scenes_d, luts_d, cfg, flush))
    return out


def lloyd_numbers(scenes_d, luts_d, cfg, flush, k: int = 7,
                  loop_iters: int = 50) -> dict:
    """The ``kmeans_lloyd`` row: one ``lloyd_pass`` over the batch's scaled
    features, every problem active (``tol_abs`` -1), against one plain
    ``_lloyd``; and both loops' host ms an iteration."""
    from rs_image_segmentation_tpu_torch.models import kmeans
    from rs_image_segmentation_tpu_torch.ops import kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    x = turbo.kmeans_features(scenes_d, luts_d, cfg).transpose(1, 2)
    x = x.contiguous()
    b, n, f = x.shape
    dev = x.device
    start = kmeans.kmeans_plus_plus_init(
        x, k, torch.Generator().manual_seed(42))
    xn = kmeans._sq_norms(x)

    def state():
        return (torch.full((b,), -1.0, device=dev),
                torch.full((b,), float("inf"), device=dev),
                torch.zeros((b,), dtype=torch.int64, device=dev))
    tol_abs, shift, n_iter = state()
    cents = start.clone()
    scratch = kernels.lloyd_scratch(x, k)
    res = kernel_numbers(lambda: kernels.lloyd_pass(
        x, cents, shift, n_iter, tol_abs, 1 << 40, scratch), flush)
    res["plain_ms"] = cold_ms(lambda: kmeans._lloyd(x, start, xn), flush, 10)
    loops = {"fused": lambda it: kmeans._lloyd_loop_fused(
                 x, start, *state(), it),
             "plain": lambda it: kmeans._lloyd_loop(
                 x, start, xn, *state(), it, None)}
    for name, loop in loops.items():
        loop(2)                                     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, iters = loop(loop_iters)
        torch.cuda.synchronize()
        res[f"{name}_loop_ms_an_iteration"] = (
            (time.perf_counter() - t0) * 1e3 / iters)
    # each point read once; the centroids read and written once
    nbytes = x.numel() * 4 + 2 * b * k * f * 4
    res["bytes"] = nbytes
    res["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["ops"] = b * n * (2 * k * f + f)
    return {f"kmeans_lloyd, one pass, {b} x {n} x {f}, k {k}": res}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None,
                        help="checkout whose rs_image_segmentation_tpu_torch "
                             "package is timed (default: this one)")
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="comma-separated kernels to time (default: "
                             "all)")
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import rs_image_segmentation_tpu_torch as pkg
    from rs_image_segmentation_tpu_torch.backend import resolve_device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    which = tuple(args.kernels.split(","))
    unknown = set(which) - set(KERNELS)
    if unknown:
        parser.error(f"unknown kernels {sorted(unknown)}")
    numbers = measure(resolve_device(None), which)
    result = {"card": smi, "package": os.path.dirname(pkg.__file__),
              "seconds": time.perf_counter() - t0, "numbers": numbers}
    for key, r in numbers.items():
        passes = "; ".join(f"{k} {v:.4f}" for k, v in r["passes"].items())
        launched = r.get("kernels_a_call_launches")
        wall = r.get("stage1_wall_ms")
        print(f"{key}: back to back {r['ms']:.4f} ms, cold L2 "
              f"{r['cold_ms']:.4f} ms, alone {r['alone_ms']} ms ({passes})"
              + (f"; a call launches {launched}" if launched else "")
              + (f"; host-to-device copy {r['htod_memcpy']}"
                 if "htod_memcpy" in r else "")
              + (f"; stage 1's 16-bit route {wall:.4f} ms wall" if wall
                 else ""))
    print(smi)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
