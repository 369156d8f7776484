"""GPU smoke run of the PyTorch port's paths on one CUDA card: the
supervised turbo classifier (19 channels, a 100-tree forest), the batched
rule program and the KMeans batch program (k = 7) on an 8-scene
7 x 600 x 600 batch; the single-scene rule program with its uncapped
large-scene route on one 7 x 600 x 600 scene, a noise scene and one
7 x 6000 x 6000 scene; stage 1 (preprocess, uint8 and 16-bit DNs) into
stage 2 (the feature graph, full width) on one 7 x 600 x 600 scene;
forest predict and stage 4's metrics; the tiled large-scene pipeline
(supervised, streamed, KMeans, resumable) on 7 x 6000 x 6000 scenes;
the serving engine with its HTTP server on 7 x 600 x 600 requests;
the four-stage file pipeline (GeoTIFF -> stage 1 -> stage 2 artifacts ->
stage 3 maps -> stage 4 report) on one 7 x 600 x 600 scene; the tools
and the rest of the CLI (batch workflow, batch and large-scene CLIs, the
supervised tools, the server as a subprocess, the utils); and
``parallel/`` on ``torch.distributed`` (a one-rank NCCL group, two gloo
ranks on the card, the rehearsal CLI, stage pipelining on two streams).

Phases, in order; any failed check raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit); build every CUDA kernel
     from ``rs_image_segmentation_tpu_torch/csrc`` with nvcc (sm_90a);
  2. synthetic scenes from a fixed seed and their host stretch stats;
  3. a 100-tree forest fitted with the port's trainer on rule labels of
     scene 0's stack;
  4. the supervised path's kernels against their plain PyTorch versions
     on the card, at the path's shapes (bit-equal outputs required):
     ``lut_hist`` in its three variants on the batch, scene 0, a
     7 x 601 x 599 scene and scene 0 in views whose bases sit 1 and 4
     bytes past alignment (each on the unit it must take),
     with a 20-class forest fitted by the port's trainer beside the path's
     own (the forest kernel sums classes in chunks of 16), and a large
     forest (100 trees on 2 000 sampled pixels, some 6 000 leaves) whose
     packed form takes the kernel's global-memory instance;
  5. the supervised path, ``classify_scenes_turbo``, with launch counts
     read around one run, then timed; scene 0 again on the CPU (>= 99.9 %
     label agreement with the card);
  6. the supervised kernels' numbers: back to back, with the L2 flushed
     before each call, and each kernel alone in a torch.profiler trace
     (``tools/kernel_times.py``), the large forest's too; the kernels a
     ``lut_hist`` call launches (``skip_hist``: its kernel alone);
  7. the rule path's kernels against their plain versions on the card,
     bit-equal: the 24 first-stage masks of the batch with their run-rank
     seeds and ids, speckle masks, a serpentine mask, a 3 x 599 x 601
     stack and a 1 x 100001 row (both connectivities), and ids out of
     range; ``hist_dense`` also on a single id, an all-background stack,
     uniform random ids, negative ids and ids >= bins, ``n % 4 != 0``, a
     base offset by one element, bins 128, bins past a cluster's shared
     memory and M = 1, each on the instance the wrapper must pick;
  8. the rule path, ``rule_based_scenes_turbo_batch``, with launch counts
     read around one run, class histogram and overflow flags, then timed
     by stage; scene 0 again on the CPU (>= 99.9 % agreement);
  9. the rule kernels' numbers, back to back, L2 flushed and alone, with
     the device time of each of ``ccmin_prop``'s four launches, and the
     kernels one ``hist_dense`` call launches (its kernel, no memset);
 10. ``cc_labels`` against its plain version on the card, bit-equal: the
     four masks scene 0's single-scene graph hands to
     ``connected_components_best``, speckle, a spiral, a serpentine, empty
     and full masks, a wide striped mask, a 599 x 601 mask, a 1 x 100001
     row, a stack of four masks (also
     against each mask on its own), and the four masks of the
     6000 x 6000 scene, at both connectivities; and ``cc_labels`` against
     ``ccmin_prop`` over flat indices;
 11. the single-scene rule program, ``rule_based_scenes_turbo``, on scene
     0 with launch counts read around one run, bit-equal to the batched
     program's scene 0, timed, then by stage; scene 0 again on the CPU
     (>= 99.9 % agreement);
 12. the uncapped route, ``rule_based_large_scene``: (a) a uniform-noise
     scene that the batched program flags for its id cap, on the card and
     on the CPU (>= 99.9 % agreement) and against the single-scene
     program; (b) a 7 x 6000 x 6000 scene (a reflected tiling of scene
     0), bit-equal to the single-scene program, timed, with its peak
     device memory; then the ``cc_labels`` numbers at both sizes, with the
     device time of each of its four launches;
 13. the stage kernels against their plain versions, bit-equal:
     ``fused_spectral_indices`` on the batch's normalised bands and on
     bands whose EVI denominators sit at the 1e-3 guard;
     ``fused_calibrate_stretch`` on a 16-bit and a float 7 x 600 x 600
     scene with positive and negative gains, on the host and on the card,
     a float scene with a NaN, a flat band, uint8 DNs, a 7 x 601 x 599
     scene, and 7 x 6000 x 6000 16-bit and float scenes (the streamed
     instance); ``glcm_grid`` on the batch's eight NIR texture bands at
     the default configuration, at levels 8 / window 12, on a band with
     flat windows, at levels 256 (counts in global memory), at window 23
     (which does not divide 600), at levels 1 and 2, on inputs from -1 to
     levels, and with 16 offsets, some negative;
 14. the path: scene 0 (uint8) through ``preprocess_bands`` and a 16-bit
     copy of it (DN * 257 plus seeded noise) through the f32 route, each
     into ``extract_features``, with launch counts read around each run
     (stage 1 f32: ``fused_calibrate_stretch`` once; stage 2:
     ``fused_spectral_indices`` and ``glcm_grid`` once each; nothing
     else), timed, then stage 2 by family with CUDA events,
     ``include_gabor`` and ``hierarchical_stack_fused``; scene 0 again on
     the CPU (every key within the CPU tests' bounds);
 15. the stage kernels' numbers, each call timed with the L2 flushed
     before it (the stretch with host gains, as stage 1 passes them, and
     with gains on the card); the kernels a stretch call launches (its
     kernel alone, no host-to-device copy); what the two fused kernels
     would save inside the supervised stack (printed, not routed);
 16. the KMeans batch program, ``kmeans_scenes_turbo_batch`` (fit stride
     8), in three runs: per-scene fits, a shared fit, and a warm start
     that feeds the shared fit's centroids back as ``init_cents``; each
     with launch counts read around one call (``lut_hist`` once,
     ``lloyd_pass`` twice an iteration of the fit, nothing else), timed (median of 5 after a warm-up), split into stack, fit
     and assignment by CUDA events, with each fit's Lloyd iterations; the
     same run on the CPU (the CPU's assignment to the card's centroids
     >= 99.9 % equal to the card's maps, the card's mapped kappa against
     the rule maps within 0.05 of the CPU's); stage 4's metrics of two
     scenes on the card equal to the CPU's;
 17. forest predict, ``forest_classify`` on scene 0's (600, 600, 19)
     features with the path's forest, launch counts read around one call
     (``forest_labels`` once, nothing else), timed, against the CPU's
     plain route and the supervised path's scene 0 (>= 99.9 %), and
     ``evaluate_classification`` on the card equal to the CPU's;
 18. the large-scene pipeline (``pipeline.large_scene``), supervised and
     KMeans, on 7 x 6000 x 6000 reflected tilings of scenes 0 and 1 with
     tile_rows 504 and the path's forest: ``preprocess_large`` equal to
     the host LUT and its histogram to ``band_histograms_u8``, its
     streaming mode (cap 0) equal to the resident one; ``lut_hist`` (uint8
     out; the 504-row chunk with and without ``skip_hist``, the
     456-row last chunk, the whole scene), ``raw_counts`` (both chunks, at
     16-byte aligned bases and 1 and 4 bytes past, and the scene's 12
     chunks into one accumulator, whose tables equal
     ``build_stretch_stats``'s) and ``forest_labels`` (the first and last
     tiles' stacks) bit-equal to their plain versions;
     ``classify_large_scene_streamed`` bit-equal to ``preprocess_large``
     -> ``classify_large_scene`` on both scenes, launching ``raw_counts``
     and ``lut_hist`` once a chunk and ``forest_labels`` once a tile and
     no plain version;
     the tiled map against ``classify_scenes_turbo`` (>= 0.995, at 600^2
     with tile_rows 63 and 504, and at 6000^2 when it fits); card against
     CPU on a 1260^2 tiling (supervised >= 99.9 %, KMeans assignment to
     the card's centroids >= 99.9 % and mapped kappa within 0.002, the
     rule resumable equal to ``rule_based_large_scene``); the three
     resumable drivers interrupted after 2 tiles or masks and resumed,
     equal to their uninterrupted runs; times (streamed first and warm,
     the resident route by passes, KMeans fit and assignment) and peak
     device memory;
 19. serving (``serving.engine.InferenceEngine``, default ``EngineConfig``:
     max_batch 8, buckets 1/2/4/8) with the supervised cell's forest on
     the batch's 7 x 600 x 600 scenes: ``io.native`` loads and the host
     stretch stats are timed at 600^2 and 6000^2 (native count and
     ``np.bincount``); the stack's channels bit-equal at B = 8 and B = 1,
     and the PCA Gram as a batched ``bmm`` against one product a scene;
     ``warmup`` per method; for ``random_forest``
     and ``rule_based`` every scene alone, 3 together (padded to 4) and 8
     together, each map bit-equal to its scene's direct program at B = 1;
     KMeans per-scene, shared-fit and warm-start engines equal to the
     direct program; phase 12's noise scene rerouted once and equal to
     ``rule_based_scenes_turbo``; a 20 480-leaf forest (past
     ``GEMM_MAX_LEAVES``) on the batched program, equal to its direct
     program at B = 1 and to the plain walk; the launches of
     each route (one supervised batch: ``lut_hist`` and ``forest_labels``
     once each, and no plain version); HTTP on port 0 (``/healthz`` backend cuda, npy and
     GeoTIFF round trips equal to the engine, ``/metrics``, the server's
     decode, engine and encode ms); p50 and p90 of 8 concurrent requests
     per method, engine against direct ms per scene and the host stats'
     share;
 20. the four-stage file pipeline on scene 0 written as a GeoTIFF with
     ``synthetic_geometa``: stage 1 (``run_preprocessing_stage``) at the
     identity and with three GCP pairs of a small rotation plus shift;
     stage 2 (``run_feature_extraction_stage``, full width, no plots);
     stage 3 (``classify_and_write``: ``rule_based``, ``kmeans`` and
     ``random_forest`` on a labelled-ROI GeoTIFF sampled from the rule
     map, 200 pixels a class; the rule map's three-class GeoTIFF read back
     equal to ``create_three_class_map``); stage 4
     (``ClassificationEvaluator.evaluate_and_report``, the rule map
     against the ROI, which scores 1.0 since the ROI is its sample, and
     the KMeans map with its clusters mapped). Launch counts around each
     driver (stage 1 at the identity: none; with GCPs:
     ``fused_calibrate_stretch`` once; stage 2: ``fused_spectral_indices``
     and ``glcm_grid`` once each; rule_based: ``cc_labels`` four times;
     random_forest: ``forest_labels`` once; KMeans and stage 4: none) and
     no plain version of any kernel, counted in every module of the port;
     the forest's map equal to ``gemm_labels_cm`` of the same forest on
     the card; the other drivers with ``device="cpu"`` (stage-1 file
     byte-equal at the identity, the GCP route >= 99.9 % and within one
     level, stage-2 arrays within the CPU tests' bounds, the rule map
     >= 99.9 %, KMeans mapped kappa within 0.002 as in phase 16, stage-4
     metrics and report equal); each driver's host wall time
     (median of 3 after a warm-up) and the artifacts' sizes; it prints a
     ``{"file_pipeline": ...}`` line. The plots of stages 3 and 4 are not
     drawn: the card's machine has no matplotlib;
 21. the tools and the rest of the CLI: ``tools.batch.run_batch_workflow``
     on ten 7 x 600 x 600 GeoTIFFs (``synthetic_geometa``) with ROIs and
     the supervised cell's forest, its turbo branch (sub-batches of 8 and
     2: ``lut_hist`` and ``forest_labels`` twice each, no plain version;
     each map bit-equal to ``classify_scenes_turbo`` of its scene at
     B = 1 with the host stretch stats; OA and kappa equal stage 4's),
     its streamed branch on two 16-bit copies (per scene one launch each
     of the stretch, the indices, ``glcm_grid`` and the forest; >= 99.9 %
     equal to its ``device="cpu"`` run) and a 20 480-leaf forest past the
     leaf cap on the turbo branch (one launch each of ``lut_hist`` and
     ``forest_labels``, equal to its direct program at B = 1 and to the
     plain walk);
     ``rs-seg-torch-batch`` with an npz forest (every file byte-equal to
     the workflow's); ``rs-seg-torch-classify-large`` ``--raw`` with the
     npz on a 7 x 6000 x 6000 reflected tiling (the map read back
     bit-equal to ``preprocess_large`` + ``classify_large_scene``, the
     same launches), and KMeans, rules and a ``--checkpoint-dir`` run
     interrupted after 2 tiles and resumed on a 1260^2 tiling, each equal
     to its library calls; ``tools.supervised`` on scene 0's stack from
     33 samples (``predict_image`` equal to ``gemm_labels_cm`` of its
     forest, the grid's cv scores and the validation report equal to
     their ``device="cpu"`` runs, ``class_map.npy`` written);
     ``rs-seg-torch-serve`` as a subprocess (``/healthz`` backend cuda,
     scene 0 as npy and as GeoTIFF equal to the direct program at B = 1,
     stopped by SIGINT); ``device_trace`` around a supervised batch (a
     CUDA lane holds the ``lut_hist`` and ``forest_labels`` kernels),
     ``StageTimer``, and ``checked`` (raises on ``log(-1)`` and ``1/0`` on
     CUDA tensors, and passes or raises on stage 1 and the stack exactly
     as on the CPU); launch counts around each route, and host wall times
     (median of 3 after a warm-up); it prints a ``{"tools_cli": ...}``
     line;
 22. ``parallel/`` on ``torch.distributed`` at full width (the batch,
     the path's forest, the default configuration, phase 18's
     7 x 6000 x 6000 tiling): in a one-rank NCCL group here,
     ``classify_batch_multihost`` bit-equal to phase 5's maps,
     ``sharded_method_batch`` (rule, KMeans) to the batch programs, the
     DP and TP forests to ``forest_predict`` / ``gemm_forest_predict``,
     ``sharded_hierarchical_stack`` to ``hierarchical_stack``,
     ``sharded_kmeans_fit_predict`` within ``CARD_CPU_KAPPA_MARGIN`` of
     its CPU run by mapped kappa, ``sharded_classify_scene`` and
     ``classify_large_scene_sharded`` >= 99.9 % of the monolithic
     programs, ``run_batch_workflow(mesh=...)`` on ten GeoTIFFs byte-equal
     to ``mesh=None`` (two 16-bit ones too); the same calls in a
     two-rank gloo group with both ranks on this card (this script,
     spawned with ``--parallel-rank``), each rank's result bit-equal to
     the one-rank group's, with the bytes the ring staged through the
     host; ``rs-seg-torch-multihost-rehearse`` as processes (gloo even
     and uneven exit 0, an injected failure and NCCL at two ranks on one
     card fail with their reasons); ``pp_classify_scenes`` on two streams
     equal to the serial maps, its stage-2 and forest kernels on two
     lanes in each of three traces, with their overlap; launches around
     every call, no plain version, host wall times (median of 3 after a
     warm-up; the one-rank group's once the spawned processes are gone),
     the 6000^2 call's peak memory; it prints a ``{"parallel": ...}``
     line;
 24. (after phase 23, ``deep_forest_phase``) the supervised stack as CUDA
     graph replays: ``classify_scenes_turbo`` with the path's forest and
     the deep one, bit-equal to the eager route (with the host
     histograms, with numpy in and none, and scene 0 alone), one
     ``lut_hist`` and one ``forest_labels`` launch a replayed batch, one
     capture per batch shape, the count ``stack_graph`` of a replay, and
     eager against graphed wall ms a batch;
 25. (after phase 16) ``lloyd_pass`` at the KMeans batch's (8, 360 000,
     19), k 7, against the plain ``_lloyd`` on the same inputs: two
     launches, counts equal but for f32 near ties (by f64 distances),
     the centroids of clusters no near tie touches within 1e-6 of the f64
     means;
     back to back, L2 flushed and alone against its byte bound, and both
     loops' host ms an iteration; its row in the kernels' line;
 then the card's line, the kernels' JSON line and the result line.

Run from the repository root: ``python3 chip_smoke.py``. It needs no
network and no arguments (``--parallel-rank`` is phase 22's own rank
entry); the kernel build goes to
``rs_image_segmentation_tpu_torch/_build/``.
"""

from __future__ import annotations

import filecmp
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from rs_image_segmentation_tpu_torch.tools.kernel_times import (  # noqa: E402
    DEEP_FOREST_SAMPLES, cold_ms, dn16, fitted_forest, graph_cc_masks,
    kernel_device_ms, kernel_numbers, l2_flusher, large_forest,
    launch_numbers, launched_kernels, mean_numbers, reflected_tiling,
    stage1_dns)

BATCH, BANDS, HEIGHT, WIDTH = 8, 7, 600, 600
N_TREES = 100
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_OPS_PER_S = 67e12              # H100 SXM, f32 outside the tensor cores
INT32_OPS_PER_S = 33.5e12          # H100 SXM, int32 (half the f32 rate)
BINS = 32768                       # the rule path's component-id cap
LARGE = 6000                       # the large scene's height and width
OFFSETS_16 = ((0, 1), (1, 0), (1, 1), (1, -1), (-1, 0), (0, -1), (-1, -1),
              (-1, 1), (0, 2), (2, 0), (2, 2), (-2, 3), (3, -2), (0, -3),
              (-3, 0), (2, -1))        # GLCM offsets, four warps' worth
PALLAS = "rs_image_segmentation_tpu/ops/pallas_kernels.py"
CSRC = "rs_image_segmentation_tpu_torch/csrc"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def tie_and_fractional_forests():
    """The 2-tree tie forest and the fractional-leaf forest of the JAX
    package's kernel tests, with the pixels they are checked on."""
    from rs_image_segmentation_tpu_torch.models.forest import (
        _gemm_for, fit_random_forest)
    out = {}
    rng = np.random.default_rng(11)
    x = rng.random((32, 19)).astype(np.float32)
    forest, _ = fit_random_forest(x, rng.integers(1, 4, 32), n_estimators=2,
                                  seed=1)
    out["ties"] = (_gemm_for(forest, 19),
                   rng.random((19, 4096)).astype(np.float32))
    rng = np.random.default_rng(3)
    half = rng.random((24, 19)).astype(np.float32)
    x = np.concatenate([half, half])
    forest, _ = fit_random_forest(x, rng.integers(1, 4, 48),
                                  n_estimators=10, seed=2)
    gf = _gemm_for(forest, 19)
    check(not np.isin(gf.leaf_dist.numpy(), (0.0, 1.0)).all(),
          "the fractional-leaf forest has impure leaves")
    out["fractional"] = (gf, rng.random((19, 4096)).astype(np.float32))
    return out


def fired_decisions(gf, x: torch.Tensor, chunk: int = 32768) -> int:
    """Decisions this input needs: over all pixels, the path lengths of the
    leaves that fire (one per tree), computed with plain ops."""
    sel_t, thr = gf.selector.T, gf.thresholds[:, None]
    path_t, plen = gf.path.T, gf.path_len[:, None]
    total = 0
    for b in range(x.shape[0]):
        for s in range(0, x.shape[2], chunk):
            sgn = torch.where(sel_t @ x[b, :, s:s + chunk] <= thr, 1.0, -1.0)
            fired = (path_t @ sgn == plen).to(torch.float64)
            total += int((plen[:, 0].double() @ fired).sum().item())
    return total


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate, in ms, and which of
    the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def wide_stripes() -> np.ndarray:
    """130 x 4224: full-width row stripes stitched by columns, with a gap
    (the JAX package's wide-mask test)."""
    m = np.zeros((130, 4224), bool)
    m[::3, :] = True
    m[:, ::97] = True
    m[60:70, 1000:3000] = False
    return m


def stretch(scene: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """The stage-1 artifact of a raw (7, H, W) scene: each band through
    its stretch LUT (host)."""
    return np.stack([lut[c][scene[c]] for c in range(scene.shape[0])])


def timing_keys(nums: dict) -> dict:
    """The JSON keys of :func:`kernel_numbers`'s result: back to back
    (``ms_back_to_back``), cold L2 (``cold_ms``), alone in a trace
    (``kernel_only_ms``, and per launch ``passes``)."""
    return {"ms_back_to_back": nums["ms"], "cold_ms": nums["cold_ms"],
            "kernel_only_ms": nums["alone_ms"], "passes": nums["passes"]}


def all_kernels():
    from rs_image_segmentation_tpu_torch.ops import kernels
    return (kernels.lut_hist, kernels.forest_labels, kernels.ccmin_prop,
            kernels.hist_dense, kernels.keep_lut, kernels.cc_labels,
            kernels.fused_calibrate_stretch, kernels.fused_spectral_indices,
            kernels.glcm_grid, kernels.raw_counts, kernels.lloyd_pass)


STAGE_KERNELS = ("fused_calibrate_stretch", "fused_spectral_indices",
                 "glcm_grid")


def wide_forest(stack0: np.ndarray):
    """A 10-tree forest of 20 classes, fitted by the port's trainer on 120
    pixels of scene 0's stack with 20 seeded labels (each class at least
    once): wider than one 16-class chunk of the forest kernel."""
    from rs_image_segmentation_tpu_torch.models.forest import (
        _gemm_for, fit_random_forest)
    rng = np.random.default_rng(SEED + 20)
    flat = stack0.reshape(stack0.shape[0], -1)
    pick = rng.choice(flat.shape[1], 120, replace=False)
    labels = np.concatenate([np.arange(20), rng.integers(0, 20, 100)])
    forest, _ = fit_random_forest(flat[:, pick].T, labels, n_estimators=10,
                                  seed=SEED + 20)
    gf = _gemm_for(forest, flat.shape[0])
    check(gf.leaf_dist.shape[1] == 20, "the wide forest has 20 classes")
    return gf


def counted(run):
    """``run()`` with every kernel's launch count set to 0 just before it;
    returns its result and the counts read just after."""
    for k in all_kernels():
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in all_kernels()}


def ccmin_cases(stack3, seeds, dev):
    """The ccmin_prop checks: name -> (mask, values, connectivity)."""
    rng = np.random.default_rng(SEED)
    i32 = np.iinfo(np.int32)
    speckle = torch.from_numpy(rng.random((4, HEIGHT, WIDTH)) < 0.5).to(dev)
    speckle_v = torch.from_numpy(rng.integers(
        i32.min, i32.max, speckle.shape, dtype=np.int32)).to(dev)
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        serpentine_mask)
    serp = torch.from_numpy(serpentine_mask(300, 140)).to(dev)
    serp_v = torch.from_numpy(rng.integers(
        0, 1 << 20, serp.shape, dtype=np.int32)).to(dev)
    solid = torch.stack([torch.zeros((HEIGHT, WIDTH), dtype=torch.bool),
                         torch.ones((HEIGHT, WIDTH), dtype=torch.bool)]).to(dev)
    solid_v = speckle_v[:2].contiguous()
    odd, row = (torch.from_numpy(m).to(dev) for m in edge_masks())
    odd_v, row_v = (torch.from_numpy(rng.integers(
        i32.min, i32.max, m.shape, dtype=np.int32)).to(dev)
        for m in (odd, row))
    cases = {}
    for conn in (8, 4):
        cases[f"first stage, conn {conn}"] = (stack3, seeds, conn)
        cases[f"speckle p=0.5, conn {conn}"] = (speckle, speckle_v, conn)
        cases[f"serpentine 300x140, conn {conn}"] = (serp, serp_v, conn)
        cases[f"empty and full, conn {conn}"] = (solid, solid_v, conn)
        cases[f"odd 599x601, conn {conn}"] = (odd, odd_v, conn)
        cases[f"one row 1x100001, conn {conn}"] = (row, row_v, conn)
    return cases


def edge_masks():
    """Edge shapes of the union-find: a (3, 599, 601) stack at p = 0.55 (2 x
    2 blocks cut at the right and bottom edges) and a 1 x 100001 row at
    p = 0.6 (one row of tiles)."""
    rng = np.random.default_rng(SEED + 4)
    return (rng.random((3, HEIGHT - 1, WIDTH + 1)) < 0.55,
            rng.random((1, 100001)) < 0.6)


def hist_cases(ids, dev) -> dict:
    """The hist_dense edge cases: name -> (ids, bins_hi, the instance the
    wrapper must pick)."""
    from rs_image_segmentation_tpu_torch.ops import kernels
    m3, n = ids.shape[0], ids[0].numel()
    bins_hi = BINS // kernels.HIST_LO
    rng = np.random.default_rng(SEED + 5)
    big_hi = kernels.HIST_CLUSTER_MAX_BINS // kernels.HIST_LO + 1
    base = torch.from_numpy(rng.integers(0, BINS, 4 * n + 1,
                                         dtype=np.int32)).to(dev)

    def on(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    return {
        "a single id (worst contention)": (
            torch.full_like(ids, 5), bins_hi, "cluster"),
        "all background": (torch.full_like(ids, BINS), bins_hi, "cluster"),
        "uniform random in-range ids (no runs)": (
            on(rng.integers(0, BINS, (m3, n))), bins_hi, "cluster"),
        "negative ids and ids >= bins": (
            on(rng.integers(-BINS, 2 * BINS, (m3, n))), bins_hi, "cluster"),
        "n % 4 != 0": (on(rng.integers(-3, BINS + 3, (4, n - 1))), bins_hi,
                       "global"),
        "base offset by one element": (base[1:].reshape(4, n), bins_hi,
                                       "global"),
        "bins 128": (on(rng.integers(-5, 140, (6, n))), 1, "cluster"),
        f"bins {big_hi * kernels.HIST_LO} (past a cluster)": (
            on(rng.integers(-5, big_hi * kernels.HIST_LO + 5, (4, n))),
            big_hi, "global"),
        "M = 1": (ids[:1].contiguous(), bins_hi, "global"),
    }


def rule_phases(dev, cfg, scenes, luts, hists, scenes_d, luts_d, hists_d,
                lut_row) -> list:
    """Phases 7-9: the rule path's kernels against their plain versions,
    the rule path itself, and the rule kernels' rows of the JSON line."""
    from rs_image_segmentation_tpu_torch.core.config import RuleBasedConfig
    from rs_image_segmentation_tpu_torch.ops import components, kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    rc = RuleBasedConfig()
    bins_hi = BINS // kernels.HIST_LO

    # ---- 7. kernels against their plain versions at the rule path's shapes
    nd = turbo._rule_front(scenes_d, luts_d, cfg, hists_d)
    stack3, min3 = turbo._rule_first_stage(*nd, rc)
    fg3 = stack3 != 0
    seeds = components.run_rank_seeds(fg3)
    m3 = stack3.shape[0]
    check(m3 == 3 * BATCH, "24 first-stage masks")
    errs = {}
    for label, (mask, values, conn) in ccmin_cases(fg3, seeds, dev).items():
        got = kernels.ccmin_prop(mask, values, conn)
        ref = kernels.ccmin_prop_plain(mask, values, conn)
        torch.cuda.synchronize()
        diff = int((got != ref).sum().item())
        err = float((got.long() - ref.long()).abs().max().item())
        check(diff == 0, f"ccmin_prop [{label}] bit-equal ({diff} differ)")
        errs["ccmin_prop"] = max(errs.get("ccmin_prop", 0.0), err)
        n_comp = int((ref[mask != 0] == values[mask != 0]).sum().item())
        print(f"check ccmin_prop [{label}] at {tuple(mask.shape)}: "
              f"bit-equal; {int((mask != 0).sum().item())} foreground "
              f"pixels, {n_comp} of them hold their component's minimum")
    ids, overflow = components.component_ids(stack3, 8, BINS)
    check(not bool(overflow.any()), f"first stage under the cap: {overflow}")
    runs = int(seeds.amax().item()) + 1
    rng = np.random.default_rng(SEED + 1)
    wild = torch.from_numpy(rng.integers(-300, BINS + 300, (4, 4096),
                                         dtype=np.int32)).to(dev)
    for label, x in (("first-stage ids", ids), ("ids out of range", wild)):
        counts = kernels.hist_dense(x, bins_hi)
        counts_ref = kernels.hist_dense_plain(x, bins_hi)
        torch.cuda.synchronize()
        err = float((counts - counts_ref).abs().max().item())
        check(err == 0, f"hist_dense [{label}] bit-equal (max err {err})")
        errs["hist_dense"] = max(errs.get("hist_dense", 0.0), err)
        areas = (min3 if x is ids else
                 torch.full((x.shape[0],), 2, dtype=torch.int32, device=dev))
        table = counts_ref >= areas.reshape(-1, 1, 1)
        keep = kernels.keep_lut(x, table)
        keep_ref = kernels.keep_lut_plain(x, table)
        torch.cuda.synchronize()
        err = float((keep - keep_ref).abs().max().item())
        check(err == 0, f"keep_lut [{label}] bit-equal (max err {err})")
        errs["keep_lut"] = max(errs.get("keep_lut", 0.0), err)
        print(f"check hist_dense, keep_lut [{label}] at {tuple(x.shape)}, "
              f"bins {BINS}: bit-equal")
    cases = {"first-stage ids": (ids, bins_hi, "cluster"),
             **hist_cases(ids, dev)}
    for label, (x, hi, instance) in cases.items():
        flat = x.reshape(x.shape[0], -1)
        picked = kernels.hist_dense_instance(flat, hi * kernels.HIST_LO)
        check(picked == instance, f"hist_dense [{label}] takes the "
              f"{instance} instance, not {picked}")
        counts = kernels.hist_dense(x, hi)
        counts_ref = kernels.hist_dense_plain(x, hi)
        torch.cuda.synchronize()
        err = float((counts - counts_ref).abs().max().item())
        check(err == 0, f"hist_dense [{label}] bit-equal (max err {err})")
        errs["hist_dense"] = max(errs["hist_dense"], err)
        print(f"check hist_dense [{label}] at {tuple(x.shape)}, bins "
              f"{hi * kernels.HIST_LO}, {instance} instance: bit-equal; "
              f"{int(counts_ref.long().sum().item())} ids counted",
              flush=True)
    print(f"first stage: {m3} masks, at most {runs} row runs in a mask "
          f"(cap {BINS})")

    # ---- 8. the rule path
    def rule_path():
        return turbo.rule_based_scenes_turbo_batch(
            scenes_d, luts_d, cfg, stretch_hists=hists_d,
            return_overflow=True, device=dev)

    (labels, overflow), launches = counted(rule_path)
    check(all(launches[k] > 0 for k in ("lut_hist", "ccmin_prop",
                                        "hist_dense", "keep_lut"))
          and launches["forest_labels"] == launches["cc_labels"] == 0
          and all(launches[k] == 0 for k in STAGE_KERNELS),
          f"the rule path's kernels ran, and no other: {launches}")
    check(labels.shape == (BATCH, HEIGHT, WIDTH)
          and labels.dtype == torch.uint8, "rule maps (B, H, W) uint8")
    counts = torch.bincount(labels.reshape(-1).long(), minlength=256)
    hist = {int(c): int(counts[c]) for c in torch.nonzero(counts)[:, 0]}
    check(set(hist) <= {0, 1, 2, 3, 4}, f"rule labels in 0..4: {hist}")
    check(overflow.shape == (BATCH,) and not bool(overflow.any()),
          f"no scene hit the id cap: {overflow.tolist()}")
    print(f"rule path: launches {launches}; class histogram {hist}; "
          f"overflow {overflow.tolist()}")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rule_path()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    batch_ms = statistics.median(walls[1:])
    print(f"rule path: median {batch_ms:.3f} ms/batch, "
          f"{batch_ms / BATCH:.3f} ms/scene, "
          f"{BATCH * HEIGHT * WIDTH / batch_ms / 1e3:.3f} MP/s "
          f"(inputs resident on the card; runs {[round(w, 3) for w in walls]})")
    stage = {
        "front (preamble, percentiles, indices)": cuda_time_ms(
            lambda: turbo._rule_front(scenes_d, luts_d, cfg, hists_d), 5),
        "thresholds and closings": cuda_time_ms(
            lambda: turbo._rule_first_stage(*nd, rc), 5),
        "min-area removal, first stage (24 masks)": cuda_time_ms(
            lambda: components.remove_small_components_batch(
                stack3, min3, return_overflow=True), 5),
    }
    whole = cuda_time_ms(rule_path, 5)
    stage["the rest (openings, paint, bare-land stage)"] = (
        whole - sum(stage.values()))
    print(f"rule path, device ms per batch (events): whole {whole:.4f}; "
          + "; ".join(f"{k} {v:.4f}" for k, v in stage.items()))
    t0 = time.perf_counter()
    cpu0 = turbo.rule_based_scenes_turbo_batch(
        scenes[:1], luts[:1], cfg, stretch_hists=hists[:1], device="cpu")
    agreement = float((cpu0[0] == labels[0].cpu()).double().mean())
    check(agreement >= 0.999, f"rule path card vs CPU agreement {agreement}")
    print(f"rule path, scene 0 on the CPU in {time.perf_counter() - t0:.1f} "
          f"s: agreement with the card {agreement:.6f}")

    # ---- 9. rule kernel numbers at the first stage's shapes
    n = HEIGHT * WIDTH
    flush = l2_flusher(dev)
    nums = {"ccmin_prop": kernel_numbers(
        lambda: kernels.ccmin_prop(fg3, seeds, 8), flush)}
    cc_ms = cuda_time_ms(lambda: kernels.ccmin_prop(fg3, seeds, 8), 20)
    cc_plain_ms = cuda_time_ms(
        lambda: kernels.ccmin_prop_plain(fg3, seeds, 8), 2, 1)
    table = kernels.hist_dense_plain(ids, bins_hi) >= min3.reshape(-1, 1, 1)
    nums["hist_dense"] = kernel_numbers(
        lambda: kernels.hist_dense(ids, bins_hi), flush)
    launched = launched_kernels(lambda: kernels.hist_dense(ids, bins_hi))
    check(len(launched) == 1 and "hist_cluster_kernel" in launched[0],
          f"a hist_dense call launches its kernel and no memset: "
          f"{launched}")
    print(f"hist_dense, a call at {tuple(ids.shape)} launches {launched}")
    nums["keep_lut"] = kernel_numbers(lambda: kernels.keep_lut(ids, table),
                                      flush)
    hist_ms = cuda_time_ms(lambda: kernels.hist_dense(ids, bins_hi), 20)
    hist_plain_ms = cuda_time_ms(
        lambda: kernels.hist_dense_plain(ids, bins_hi), 3, 1)
    keep_ms = cuda_time_ms(lambda: kernels.keep_lut(ids, table), 20)
    keep_plain_ms = cuda_time_ms(
        lambda: kernels.keep_lut_plain(ids, table), 5)
    # the yardsticks: one PyTorch call each, over flat ids offset by mask
    # (one extra slot per mask takes the background id), int64 indices
    # built beforehand
    lib_idx = (ids.long() + torch.arange(m3, device=dev)[:, None, None]
               * (BINS + 1)).reshape(-1)
    hist_lib_ms = cuda_time_ms(
        lambda: torch.bincount(lib_idx, minlength=m3 * (BINS + 1)), 20)
    table_ext = torch.cat([table.reshape(m3, BINS),
                           table.new_zeros((m3, 1))], 1).to(torch.int32)
    flat_table = table_ext.reshape(-1)
    keep_lib_ms = cuda_time_ms(
        lambda: torch.gather(flat_table, 0, lib_idx), 20)
    print(f"rule kernels at {m3} x {HEIGHT} x {WIDTH}, device ms: ccmin_prop "
          f"{cc_ms:.4f} (plain {cc_plain_ms:.4f}), hist_dense {hist_ms:.4f} "
          f"(plain {hist_plain_ms:.4f}, bincount {hist_lib_ms:.4f}), "
          f"keep_lut {keep_ms:.4f} (plain {keep_plain_ms:.4f}, gather "
          f"{keep_lib_ms:.4f})")
    print("rule kernels, device ms (back to back / L2 flushed / alone; per "
          "launch): " + "; ".join(
              f"{k} {v['ms']:.4f} / {v['cold_ms']:.4f} / {v['alone_ms']} ("
              + ", ".join(f"{p} {t:.4f}" for p, t in v["passes"].items())
              + ")" for k, v in nums.items()))

    px = m3 * n
    cc_bytes = px * (1 + 4 + 4)
    hist_bytes = px * 4 + m3 * BINS * 4
    keep_bytes = px * 4 * 2 + m3 * BINS
    lut_row["launches_rule_path"] = launches["lut_hist"]
    rows = []
    for kname, src, line, ms, plain, lib, lib_note, nbytes in (
            ("ccmin_prop", "ccmin_prop.cu", 1328, cc_ms, cc_plain_ms, None,
             "no single PyTorch call computes connected components",
             cc_bytes),
            ("hist_dense", "hist_keep.cu", 1428, hist_ms, hist_plain_ms,
             hist_lib_ms, "torch.bincount over int64 ids + mask * (bins + 1),"
             " built beforehand", hist_bytes),
            ("keep_lut", "hist_keep.cu", 1471, keep_ms, keep_plain_ms,
             keep_lib_ms, "torch.gather over the flat (M, bins + 1) int32 "
             "table with int64 ids + mask * (bins + 1), built beforehand",
             keep_bytes)):
        bms, by = bound(nbytes, px, INT32_OPS_PER_S)
        rows.append({
            "name": kname, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": f"{PALLAS}:{line}", "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
            "library_ms": lib, "library_note": lib_note, "bytes": nbytes,
            "shape": [m3, HEIGHT, WIDTH], "rule_path_ms": batch_ms,
            **timing_keys(nums[kname])})
    rows[1]["kernels_a_call_launches"] = launched
    return rows


def cc_checks(cases, errs) -> None:
    """``cc_labels`` against ``cc_labels_plain`` on the card, bit-equal;
    2-D masks also against ``ccmin_prop`` over flat indices, and stacks
    against each of their masks on its own."""
    from rs_image_segmentation_tpu_torch.ops import kernels
    for label, mask in cases.items():
        for conn in (8, 4):
            got = kernels.cc_labels(mask, conn)
            ref = kernels.cc_labels_plain(mask, conn)
            torch.cuda.synchronize()
            diff = int((got != ref).sum().item())
            err = float((got.long() - ref.long()).abs().max().item())
            check(diff == 0, f"cc_labels [{label}, conn {conn}] bit-equal "
                  f"({diff} differ)")
            errs["cc_labels"] = max(errs.get("cc_labels", 0.0), err)
            if mask.dim() == 2:
                flat = torch.arange(mask.numel(), dtype=torch.int32,
                                    device=mask.device).reshape(mask.shape)
                check(torch.equal(got, kernels.ccmin_prop(mask, flat, conn)),
                      f"cc_labels == ccmin_prop over flat indices [{label}]")
            else:
                for i in range(mask.shape[0]):
                    check(torch.equal(got[i], kernels.cc_labels(
                        mask[i].contiguous(), conn)),
                          f"cc_labels [{label}] mask {i} equals its own "
                          "labels")
            h, w = ref.shape[-2:]
            own = torch.arange(h * w, device=ref.device).reshape(h, w)
            fg = ref >= 0
            n_comp = int((ref == own).sum().item())    # one root each
            print(f"check cc_labels [{label}, conn {conn}] at "
                  f"{tuple(mask.shape)}: bit-equal; {int(fg.sum().item())} "
                  f"foreground pixels in {n_comp} components", flush=True)


def single_scene_phases(dev, cfg, scenes, luts, scenes_d, luts_d) -> dict:
    """Phases 10-12: ``cc_labels`` against its plain version, the
    single-scene rule program, the uncapped large-scene route; returns the
    ``cc_labels`` row of the JSON line."""
    from rs_image_segmentation_tpu_torch.core.config import (
        CalibrationConfig, RuleBasedConfig)
    from rs_image_segmentation_tpu_torch.ops import components, kernels
    from rs_image_segmentation_tpu_torch.ops.morphology import closing
    from rs_image_segmentation_tpu_torch.ops.threshold import (
        threshold_binary)
    from rs_image_segmentation_tpu_torch.pipeline import large_scene, turbo
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        build_stretch_lut)
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        serpentine_mask, spiral_mask, stretch_stats_batch)
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    rc = RuleBasedConfig()

    def single(raw_d, lut_d):
        return turbo.rule_based_scenes_turbo(raw_d, lut_d, cfg, device=dev)

    # ---- 10. cc_labels against its plain version
    t0 = time.perf_counter()
    cal = CalibrationConfig()
    big = reflected_tiling(scenes[0], LARGE)
    big_lut = build_stretch_lut(big, np.asarray(cal.gains),
                                np.asarray(cal.biases)).astype(np.uint8)
    big_arr = stretch(big, big_lut)
    big_hists = large_scene.band_histograms_u8(big_arr)
    print(f"large scene: {big.shape} uint8, a reflected tiling of scene 0 "
          f"(the fixture's host smoothing grows with the pixel count), LUT, "
          f"stretched scene and histograms in "
          f"{time.perf_counter() - t0:.2f} s on the host", flush=True)
    big_d = torch.from_numpy(big).to(dev)
    big_lut_d = torch.from_numpy(big_lut).to(dev)
    _, masks = graph_cc_masks(lambda: single(scenes_d[0], luts_d[0]))
    big_map, big_masks = graph_cc_masks(lambda: single(big_d, big_lut_d))
    check(len(masks) == 4 and len(big_masks) == 4
          and all(c == 8 for _, c in masks + big_masks),
          "the single-scene graph hands four masks to connected components, "
          "8-connected")
    names = ("vegetation", "water", "built-up", "bare land")
    rng = np.random.default_rng(SEED + 2)
    cases = {f"scene 0 {n} mask": m for n, (m, _) in zip(names, masks)}
    cases.update({
        "speckle p=0.5": torch.from_numpy(
            rng.random((HEIGHT, WIDTH)) < 0.5).to(dev),
        "spiral 300x300": torch.from_numpy(spiral_mask(300, 300)).to(dev),
        "serpentine 300x140": torch.from_numpy(
            serpentine_mask(300, 140)).to(dev),
        "empty": torch.zeros((HEIGHT, WIDTH), dtype=torch.bool, device=dev),
        "full": torch.ones((HEIGHT, WIDTH), dtype=torch.bool, device=dev),
        "wide stripes": torch.from_numpy(wide_stripes()).to(dev),
        "odd 599x601": torch.from_numpy(edge_masks()[0][0]).to(dev),
        "one row 1x100001": torch.from_numpy(edge_masks()[1]).to(dev),
        "stack of 4 (p 0.3-0.7)": torch.from_numpy(
            rng.random((4, HEIGHT, WIDTH))
            < np.array([0.3, 0.5, 0.6, 0.7])[:, None, None]).to(dev),
    })
    cases.update({f"{LARGE}x{LARGE} {n} mask": m
                  for n, (m, _) in zip(names, big_masks)})
    errs = {}
    cc_checks(cases, errs)

    # ---- 11. the single-scene rule program on scene 0
    out, launches = counted(lambda: single(scenes_d[0], luts_d[0]))
    check(launches["lut_hist"] == 1 and launches["cc_labels"] > 0
          and all(launches[k] == 0 for k in ("ccmin_prop", "hist_dense",
                                             "keep_lut", "forest_labels",
                                             *STAGE_KERNELS)),
          f"the single-scene program ran lut_hist once, cc_labels, and no "
          f"other kernel: {launches}")
    check(out.shape == (HEIGHT, WIDTH) and out.dtype == torch.uint8,
          "single-scene map (H, W) uint8")
    batch0 = turbo.rule_based_scenes_turbo_batch(scenes_d[:1], luts_d[:1],
                                                 cfg, device=dev)[0]
    check(torch.equal(out, batch0),
          "single-scene map bit-equal to the batched program's scene 0")
    counts = torch.bincount(out.reshape(-1).long(), minlength=5)
    hist = {int(c): int(counts[c]) for c in torch.nonzero(counts)[:, 0]}
    print(f"single-scene path: launches {launches}; class histogram {hist}; "
          "bit-equal to the batched program's scene 0")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single(scenes_d[0], luts_d[0])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    scene_ms = statistics.median(walls[1:])
    print(f"single-scene path: median {scene_ms:.3f} ms/scene, "
          f"{HEIGHT * WIDTH / scene_ms / 1e3:.3f} MP/s (inputs resident on "
          f"the card; runs {[round(w, 3) for w in walls]})")
    nd = [p[0] for p in turbo._rule_front(scenes_d[:1], luts_d[:1], cfg)]
    area = HEIGHT * WIDTH
    min_areas = [int(area * f) for f in (
        rc.veg_min_area_frac, rc.water_min_area_frac,
        rc.builtup_min_area_frac, rc.bareland_min_area_frac)]
    mask4 = [m for m, _ in masks]
    labels4 = [kernels.cc_labels(m) for m in mask4]

    def thresholds_and_closings():
        veg = threshold_binary(nd[0], rc.ndvi_threshold)
        water = threshold_binary(nd[2], rc.mndwi_threshold)
        built = ((threshold_binary(nd[3], rc.ndbi_threshold) != 0)
                 & (threshold_binary(nd[0], rc.ndvi_threshold_for_builtup,
                                     above=False) != 0)).to(torch.uint8)
        return (closing(veg, 3, shape="ellipse"),
                closing(water, 3, shape="ellipse"),
                closing(built, 5, shape="ellipse"))

    def areas_and_keep():
        return [((m != 0) & (components._areas_per_pixel(lab) >= a))
                .to(torch.uint8)
                for m, lab, a in zip(mask4, labels4, min_areas)]

    stage = {
        "front (preamble, percentiles, indices)": cuda_time_ms(
            lambda: turbo._rule_front(scenes_d[:1], luts_d[:1], cfg), 5),
        "thresholds and closings (veg, water, built-up)": cuda_time_ms(
            thresholds_and_closings, 5),
        "four connected-components calls": cuda_time_ms(
            lambda: [kernels.cc_labels(m) for m in mask4], 10),
        "areas and keep (four masks)": cuda_time_ms(areas_and_keep, 5),
    }
    whole = cuda_time_ms(lambda: single(scenes_d[0], luts_d[0]), 5)
    stage["the rest (openings, paint, bare-land threshold and closing)"] = (
        whole - sum(stage.values()))
    print(f"single-scene path, device ms per scene (events): whole "
          f"{whole:.4f}; " + "; ".join(f"{k} {v:.4f}"
                                       for k, v in stage.items()))
    t0 = time.perf_counter()
    cpu0 = turbo.rule_based_scenes_turbo(scenes[0], luts[0], cfg,
                                         device="cpu")
    agreement = float((cpu0 == out.cpu()).double().mean())
    check(agreement >= 0.999, f"single-scene card vs CPU agreement "
          f"{agreement}")
    print(f"single-scene path, scene 0 on the CPU in "
          f"{time.perf_counter() - t0:.1f} s: agreement with the card "
          f"{agreement:.6f}")

    # ---- 12a. the reroute: a scene past the batched program's id cap
    noise = np.random.default_rng(SEED + 3).integers(
        0, 256, (1, BANDS, HEIGHT, WIDTH), dtype=np.uint8)
    noise_lut = stretch_stats_batch(noise)[0]
    noise_d = torch.from_numpy(noise).to(dev)
    noise_lut_d = torch.from_numpy(noise_lut).to(dev)
    _, overflow = turbo.rule_based_scenes_turbo_batch(
        noise_d, noise_lut_d, cfg, return_overflow=True, device=dev)
    check(overflow.tolist() == [True],
          f"the batched program flags the noise scene: {overflow.tolist()}")
    noise_arr = stretch(noise[0], noise_lut[0])
    rerouted, launches_large = counted(lambda: large_scene
                                       .rule_based_large_scene(
                                           noise_arr, cfg, device=dev))
    check(launches_large["cc_labels"] > 0 and launches_large["lut_hist"] == 0
          and launches_large["ccmin_prop"] == 0,
          f"the large-scene route ran cc_labels only: {launches_large}")
    noise_cpu = large_scene.rule_based_large_scene(noise_arr, cfg,
                                                   device="cpu")
    agreement_noise = float((noise_cpu == rerouted).mean())
    check(agreement_noise >= 0.999, f"noise scene card vs CPU agreement "
          f"{agreement_noise}")
    noise_single = single(noise_d[0], noise_lut_d[0]).cpu().numpy()
    check(np.array_equal(rerouted, noise_single),
          "the large-scene route equals the single-scene program on the "
          "noise scene")
    print(f"reroute: the batched program flags the noise scene (overflow "
          f"{overflow.tolist()}); rule_based_large_scene launches "
          f"{launches_large}; card vs CPU agreement {agreement_noise:.6f}; "
          f"equal to rule_based_scenes_turbo")

    # ---- 12b. full size: 7 x 6000 x 6000
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    big_out, launches_big = counted(lambda: large_scene
                                    .rule_based_large_scene(
                                        big_arr, cfg, hists=big_hists,
                                        device=dev))
    # the route's own peak, above what this script holds on the card
    peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
    check(big_out.shape == (LARGE, LARGE) and big_out.dtype == np.uint8,
          "large-scene map (H, W) uint8")
    check(np.array_equal(big_out, big_map.cpu().numpy()),
          f"{LARGE}x{LARGE}: rule_based_large_scene bit-equal to "
          "rule_based_scenes_turbo")
    check(launches_big["cc_labels"] == 4, f"large-scene launches "
          f"{launches_big}")
    large_walls, single_walls = [], []
    for _ in range(4):
        for walls_, fn in ((large_walls, lambda: large_scene
                            .rule_based_large_scene(big_arr, cfg,
                                                    hists=big_hists,
                                                    device=dev)),
                           (single_walls, lambda: single(big_d, big_lut_d))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls_.append((time.perf_counter() - t0) * 1e3)
    large_ms = statistics.median(large_walls[1:])
    single_ms = statistics.median(single_walls[1:])
    counts = np.bincount(big_out.reshape(-1), minlength=5)
    print(f"{LARGE}x{LARGE}: rule_based_large_scene bit-equal to "
          f"rule_based_scenes_turbo; launches {launches_big}; class counts "
          f"{counts.tolist()}; rule_based_large_scene (host numpy in and "
          f"out) median {large_ms:.3f} ms/scene, "
          f"{LARGE * LARGE / large_ms / 1e3:.3f} MP/s "
          f"(runs {[round(w, 3) for w in large_walls]}); "
          f"rule_based_scenes_turbo (inputs resident) median "
          f"{single_ms:.3f} ms/scene, {LARGE * LARGE / single_ms / 1e3:.3f} "
          f"MP/s (runs {[round(w, 3) for w in single_walls]}); peak device "
          f"memory of rule_based_large_scene {peak_gb:.3f} GB "
          f"(max_memory_allocated above the {resident / 1e9:.3f} GB "
          f"resident)")

    # ---- cc_labels numbers at both sizes, per mask
    def per_mask(masks_, reps, warmup=2):
        return statistics.mean(cuda_time_ms(lambda: kernels.cc_labels(m),
                                            reps, warmup) for m, _ in masks_)

    def per_mask_plain(masks_, reps, warmup):
        return statistics.mean(cuda_time_ms(
            lambda: kernels.cc_labels_plain(m), reps, warmup)
            for m, _ in masks_)

    flush = l2_flusher(dev)
    nums = {size: mean_numbers([kernel_numbers(
        lambda m=m: kernels.cc_labels(m), flush, reps, reps, reps)
        for m, _ in masks_]) for size, masks_, reps in (
            (HEIGHT, masks, 20), (LARGE, big_masks, 5))}
    print("cc_labels, device ms per mask (back to back / L2 flushed / alone;"
          " per launch): " + "; ".join(
              f"{size}^2 {v['ms']:.4f} / {v['cold_ms']:.4f} / "
              f"{v['alone_ms']} (" + ", ".join(
                  f"{p} {t:.4f}" for p, t in v["passes"].items()) + ")"
              for size, v in nums.items()))
    ms, ms_big = per_mask(masks, 20), per_mask(big_masks, 5)
    plain, plain_big = per_mask_plain(masks, 2, 1), per_mask_plain(
        big_masks, 1, 0)
    bms, by = bound(HEIGHT * WIDTH * 5, 0)
    bms_big, by_big = bound(LARGE * LARGE * 5, 0)
    print(f"cc_labels, device ms per mask (mean of the graph's four): "
          f"{HEIGHT}x{WIDTH} {ms:.4f} (plain {plain:.4f}, bound "
          f"{bms * 1e3:.3f} us); {LARGE}x{LARGE} {ms_big:.4f} (plain "
          f"{plain_big:.4f}, bound {bms_big * 1e3:.3f} us)")
    return {
        "name": "cc_labels", "route": "cuda",
        "source": f"{CSRC}/ccmin_prop.cu", "replaces": f"{PALLAS}:1251",
        "launches": launches["cc_labels"], "max_abs_err": errs["cc_labels"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_us": bms * 1e3,
        "bound_by": by, "library_ms": None,
        "library_note": "no single PyTorch call computes connected "
                        "components",
        "bound_note": "bytes: mask 1 B + labels 4 B per pixel; at 600 x 600 "
                      "three launches' latency exceeds it",
        "bytes": HEIGHT * WIDTH * 5, "shape": [HEIGHT, WIDTH],
        "ms_6000": ms_big, "plain_ms_6000": plain_big,
        "bound_ms_6000": bms_big, "bound_by_6000": by_big,
        "bytes_6000": LARGE * LARGE * 5, "shape_6000": [LARGE, LARGE],
        "launches_large_scene": launches_big["cc_labels"],
        **timing_keys(nums[HEIGHT]),
        "timing_6000": timing_keys(nums[LARGE]),
        "single_scene_ms": scene_ms, "large_scene_ms_6000": large_ms,
        "single_scene_ms_6000": single_ms, "peak_gb_6000": peak_gb}


# card vs CPU bounds of the stage-2 keys: the CPU tests' bounds
# (tests/test_torch_features.py), atol or (None, share of equal pixels)
STAGE2_LOOSE = {
    "evi": 1e-3,
    "pca_result": 1e-3,
    "multi_scale_features.std_dev_scale_3": 3.5e-4,
    "multi_scale_features.std_dev_scale_5": 3.5e-4,
    "multi_scale_features.std_dev_scale_7": 3.5e-4,
    "glcm_features.contrast": 3e-5,
    "lbp_feature": (None, 0.997),
}
FAMILIES = ("normalize", "indices", "PCA", "GLCM", "LBP", "multi-scale",
            "morphology", "filters", "assemble")


def flat_features(d, pre=""):
    """Feature dict -> {dotted key: tensor}, lists by index."""
    for k, v in d.items():
        if isinstance(v, dict):
            yield from flat_features(v, f"{pre}{k}.")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                yield f"{pre}{k}[{i}]", x
        else:
            yield pre + k, v


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many f32 elements differ in their bits (NaNs compare by bits)."""
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum().item())


def finite_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| where both are finite (0.0 if none is)."""
    ok = torch.isfinite(got) & torch.isfinite(ref)
    return float((got - ref)[ok].abs().max().item()) if bool(ok.any()) \
        else 0.0


def guard_bands(dev, n: int = 1 << 20) -> torch.Tensor:
    """(5, 1, n) bands whose EVI denominators nir + 6 red - 7.5 blue + 1
    sit within a few ulps of the 1e-3 guard: blue is solved for a
    denominator of 1e-3 and stepped by -8..8 ulps."""
    rng = np.random.default_rng(SEED + 30)
    red = rng.random(n, dtype=np.float32)
    nir = rng.random(n, dtype=np.float32)
    blue = ((nir.astype(np.float64) + 6.0 * red + 1.0 - 1e-3) / 7.5
            ).astype(np.float32)
    steps = rng.integers(-8, 9, n).astype(np.int32)
    blue = (blue.view(np.int32) + steps).view(np.float32)
    green = rng.random(n, dtype=np.float32)
    swir = rng.random(n, dtype=np.float32)
    return torch.from_numpy(np.stack([blue, green, red, nir, swir])[:, None]
                            ).to(dev)


def flat_window_band(h: int, w: int) -> np.ndarray:
    """Quantised levels (32) with flat 21 x 21 windows: a constant block,
    a block at level 0, a block of vertical stripes, over seeded noise."""
    q = np.random.default_rng(SEED + 31).integers(0, 32, (h, w)).astype(
        np.int32)
    q[:21, :21] = 17
    q[21:42, 21:42] = 0
    q[42:63, :21] = np.arange(21)[None] % 32
    return q


def stage_phases(dev, cfg, scenes, luts, scenes_d, luts_d) -> list:
    """Phases 13-15: the stage kernels against their plain versions, stage
    1 (uint8 and 16-bit) into stage 2 with launch counts, times and the
    CPU check, and the stage kernels' rows of the JSON line."""
    from rs_image_segmentation_tpu_torch.core.config import (
        CalibrationConfig)
    from rs_image_segmentation_tpu_torch.models.pca import pca_bands
    from rs_image_segmentation_tpu_torch.ops import kernels, texture
    from rs_image_segmentation_tpu_torch.ops.indices import spectral_indices
    from rs_image_segmentation_tpu_torch.ops.multiscale import (
        multi_scale_features)
    from rs_image_segmentation_tpu_torch.ops.normalize import (
        robust_normalize)
    from rs_image_segmentation_tpu_torch.pipeline import features
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        preprocess_bands)
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    cal = CalibrationConfig()
    gains = np.asarray(cal.gains, np.float32)
    biases = np.asarray(cal.biases, np.float32)
    # stage 1 takes the configuration's f64 values, as the host LUTs do
    gains64, biases64 = np.asarray(cal.gains), np.asarray(cal.biases)
    neg = gains * np.where(np.arange(BANDS) % 2 == 1, -1, 1).astype(
        np.float32)
    offsets = tuple(texture._offset_for_angle(1, a) for a in cfg.glcm.angles)
    g = cfg.glcm
    errs = {k: 0.0 for k in STAGE_KERNELS}

    # ---- 13. stage kernels against their plain versions, bit-equal
    stretched = kernels.lut_hist_plain(scenes_d, luts_d, skip_hist=True)
    bands01 = features.normalize_bands(stretched, cfg)          # (B, 7, H, W)
    tex01 = robust_normalize(bands01[:, cfg.texture_band_index])
    idx_cases = {"the batch's normalised bands": bands01,
                 "EVI denominators at the 1e-3 guard": guard_bands(dev)}
    for label, x in idx_cases.items():
        got = kernels.fused_spectral_indices(x)
        ref = kernels.fused_spectral_indices_plain(x)
        torch.cuda.synchronize()
        diff = bits_equal(got, ref)
        errs["fused_spectral_indices"] = max(
            errs["fused_spectral_indices"], finite_err(got, ref))
        check(diff == 0, f"fused_spectral_indices [{label}] bit-equal "
              f"({diff} differ)")
        extra = ""
        if x.shape[-2] == 1:
            den = x[3] + 6.0 * x[2] - 7.5 * x[0] + 1.0
            above = int((den > 1e-3).sum().item())
            extra = (f"; {above} of {den.numel()} denominators above the "
                     f"guard, {int((ref[1] == 0).sum().item())} EVI "
                     f"zeros")
        print(f"check fused_spectral_indices [{label}] at "
              f"{tuple(x.shape)}: bit-equal{extra}", flush=True)
    dns = stage1_dns(scenes[0])
    scene16, float_dn = dns["uint16"], dns["f32"]
    nan_dn = float_dn.copy()
    nan_dn[3, HEIGHT // 2, WIDTH // 3] = np.nan
    flat_dn = scene16.copy()
    flat_dn[2] = 777
    big = reflected_tiling(scenes[0], LARGE)
    gains_card = torch.from_numpy(neg).to(dev)
    biases_card = torch.from_numpy(biases).to(dev)
    stretch_cases = (
        ("uint16, gains", scene16, gains, biases),
        ("uint16, negative gains", scene16, neg, biases),
        ("uint16, negative gains on the card", scene16, gains_card,
         biases_card),
        ("f32, gains", float_dn, gains, biases),
        ("f32, negative gains", float_dn, neg, biases),
        ("f32 with a NaN", nan_dn, gains, biases),
        ("uint16, a flat band", flat_dn, gains, biases),
        ("uint8, gains", scenes[0], gains, biases),
        ("uint16, 601 x 599 (units of one pixel)", stage1_dns(
            np.random.default_rng(SEED + 34).integers(
                0, 256, (BANDS, 601, 599), dtype=np.uint8))["uint16"],
         neg, biases),
        (f"uint16, {LARGE} x {LARGE}", lambda: dn16(big),
         gains, biases),
        (f"f32, {LARGE} x {LARGE}, negative gains on the card",
         lambda: big.astype(np.float32) * 1.37, gains_card, biases_card))
    for label, dn, gg, bb in stretch_cases:
        x = torch.from_numpy(dn() if callable(dn) else dn).to(dev)
        got = kernels.fused_calibrate_stretch(x, gg, bb)
        ref = kernels.fused_calibrate_stretch_plain(x, gg, bb)
        torch.cuda.synchronize()
        diff = bits_equal(got, ref)
        errs["fused_calibrate_stretch"] = max(
            errs["fused_calibrate_stretch"], finite_err(got, ref))
        check(diff == 0, f"fused_calibrate_stretch [{label}] bit-equal "
              f"({diff} differ)")
        c, h, w = x.shape
        span, instance = kernels.calibrate_stretch_plan(h * w,
                                                        x.element_size())
        check(instance == ("streamed" if h == LARGE else "staged"),
              f"fused_calibrate_stretch [{label}] instance {instance}")
        special = ("NaN" in label or "flat" in label)
        band = 3 if "NaN" in label else 2
        if special:     # that band NaN, the others stretched
            check(bool(torch.isnan(got[band]).all())
                  and bool(torch.isfinite(got[band + 1]).all()),
                  f"fused_calibrate_stretch [{label}]: band {band} NaN, "
                  f"band {band + 1} finite")
        else:
            # (x * 255) / x rounds twice, so the top need not be 255
            lo, hi = float(got.min()), float(got.max())
            check(bool(torch.isfinite(got).all()) and lo == 0.0
                  and abs(hi - 255.0) < 1e-3,
                  f"fused_calibrate_stretch [{label}] spans [0, 255]: "
                  f"[{lo}, {hi}]")
        print(f"check fused_calibrate_stretch [{label}] at {tuple(x.shape)}:"
              f" bit-equal, {instance} instance, {span} pixels a block",
              flush=True)
        del x, got, ref
    del big
    torch.cuda.empty_cache()
    q_batch = (tex01 * (g.levels - 1)).to(torch.uint8).to(torch.int32)

    def rand_levels(lo, hi, seed):
        return torch.from_numpy(np.random.default_rng(SEED + 40 + seed)
                                .integers(lo, hi, (2, HEIGHT, WIDTH),
                                          dtype=np.int32)).to(dev)
    glcm_cases = {
        f"the batch's 8 NIR bands, levels {g.levels}, window "
        f"{g.window_size}":
            (q_batch, g.levels, g.window_size),
        "levels 8, window 12": ((tex01 * 7).to(torch.uint8).to(torch.int32),
                                8, 12),
        "flat windows, levels 32, window 21": (torch.from_numpy(
            flat_window_band(HEIGHT, WIDTH)).to(dev), 32, 21),
        "levels 256 (global counts), window 21": (
            (tex01[:2] * 255).to(torch.uint8).to(torch.int32), 256, 21),
        "window 23 (does not divide 600), levels 32": (q_batch[:2], 32, 23),
        "levels 1, inputs -1..1": (rand_levels(-1, 2, 1), 1, 21),
        "levels 2": ((tex01[:2] * 1).to(torch.uint8).to(torch.int32), 2, 21),
        "inputs -1..levels, levels 32": (rand_levels(-1, 33, 2), 32, 21),
        "16 offsets, some negative, levels 32": (q_batch[:2], 32, 21,
                                                 OFFSETS_16),
    }
    for label, case in glcm_cases.items():
        q, levels, window = case[:3]
        offs = case[3] if len(case) > 3 else offsets
        got = kernels.glcm_grid(q, levels, window, window, offs)
        ref = kernels.glcm_grid_plain(q, levels, window, window, offs)
        torch.cuda.synchronize()
        diff = bits_equal(got, ref)
        check(diff == 0, f"glcm_grid [{label}] bit-equal ({diff} differ)")
        errs["glcm_grid"] = max(errs["glcm_grid"], finite_err(got, ref))
        if label.startswith("flat"):
            want = torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0], device=dev)
            check(torch.equal(got[0, 0], want) and torch.equal(got[1, 1],
                                                               want),
                  f"flat windows give 0, 0, 1, 1, 1: {got[0, 0].tolist()}")
        instance = ("shared" if kernels._glcm_counts_in_smem(
            levels, window, len(offs)) else "global")
        check(instance == ("global" if levels == 256 else "shared"),
              f"glcm_grid [{label}] instance {instance}")
        print(f"check glcm_grid [{label}] at {tuple(q.shape)}, "
              f"{len(offs)} offsets, {instance} instance: bit-equal; "
              f"{got.shape[-3] * got.shape[-2]} windows per band",
              flush=True)

    # ---- 14. the path: stage 1 (uint8 and 16-bit) -> stage 2
    def stage1_u8():
        return preprocess_bands(scenes[0], gains64, biases64, device=dev)

    def stage1_f32():
        return preprocess_bands(scene16_d, gains64, biases64, device=dev)

    def stage2(arr):
        return features.extract_features(arr, cfg, device=dev)

    scene16_d = torch.from_numpy(scene16).to(dev)
    art_u8, l1_u8 = counted(stage1_u8)
    check(art_u8.dtype == torch.uint8 and art_u8.shape == (BANDS, HEIGHT,
                                                           WIDTH)
          and all(v == 0 for v in l1_u8.values()),
          f"stage 1 on uint8: (7, H, W) uint8, no kernel: {l1_u8}")
    check(torch.equal(art_u8.cpu(), torch.from_numpy(
        stretch(scenes[0], luts[0]))), "stage 1 on uint8 equals the "
          "host LUT's stretched scene")
    art16, l1_16 = counted(stage1_f32)
    check(art16.dtype == torch.uint8 and l1_16["fused_calibrate_stretch"] == 1
          and sum(l1_16.values()) == 1,
          f"stage 1 f32 route: fused_calibrate_stretch once and nothing "
          f"else: {l1_16}")
    near = float(((art16.int() - art_u8.int()).abs() <= 1).double().mean())
    print(f"stage 1: uint8 route launches {l1_u8}; 16-bit route launches "
          f"{l1_16}; 16-bit artifact within one level of the uint8 one on "
          f"{near:.6f} of pixels")
    runs = {}
    for label, art in (("uint8", art_u8), ("16-bit", art16)):
        (feats, hier), l2 = counted(lambda: stage2(art))
        check(l2["fused_spectral_indices"] == 1 and l2["glcm_grid"] == 1
              and sum(l2.values()) == 2,
              f"stage 2 [{label}]: fused_spectral_indices and glcm_grid "
              f"once each, nothing else: {l2}")
        check(hier["all"].shape == (HEIGHT, WIDTH, 19)
              and bool(torch.isfinite(hier["all"]).all()),
              f"stage 2 [{label}]: a finite (H, W, 19) stack")
        flat = dict(flat_features(feats))
        check(all(bool(torch.isfinite(v).all()) for v in flat.values()),
              f"stage 2 [{label}]: every feature finite")
        runs[label] = (feats, hier, l2)
        print(f"stage 2 [{label}]: launches {l2}; {len(flat)} feature "
              f"planes, (H, W, 19) stack finite", flush=True)
    launches = {**l1_16, "fused_spectral_indices": runs["16-bit"][2][
        "fused_spectral_indices"], "glcm_grid": runs["16-bit"][2][
        "glcm_grid"]}
    walls = {}
    for label, fn in (("stage 1, uint8", stage1_u8),
                      ("stage 1, 16-bit", stage1_f32),
                      ("stage 2", lambda: stage2(art_u8))):
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        walls[label] = statistics.median(ts[1:])
        print(f"{label}: median {walls[label]:.3f} ms/scene (runs "
              f"{[round(t, 3) for t in ts]})")

    # by family, CUDA events; each family's inputs made beforehand
    b32 = art_u8.to(torch.float32)
    b01 = features.normalize_bands(b32, cfg)
    idx = features.index_features(b01)
    pc, _ = pca_bands(b01, use_robust_scaling=True)
    t01 = features.texture_band(b01, cfg)
    glcm = features.glcm_features(t01, cfg)
    ms = multi_scale_features(t01, cfg.multiscale.scales,
                              cfg.multiscale.entropy_max_scale)
    morph = features.morphological_features(t01, cfg.morphology.kernel_sizes)
    filt = features.filter_responses(t01)
    fam = dict(zip(FAMILIES, (
        cuda_time_ms(lambda: features.normalize_bands(b32, cfg), 5),
        cuda_time_ms(lambda: features.index_features(b01), 20),
        cuda_time_ms(lambda: pca_bands(b01, use_robust_scaling=True), 5),
        cuda_time_ms(lambda: features.glcm_features(
            features.texture_band(b01, cfg), cfg), 10),
        cuda_time_ms(lambda: texture.lbp_feature(
            t01, cfg.lbp.n_points, float(cfg.lbp.radius)), 5),
        cuda_time_ms(lambda: multi_scale_features(
            t01, cfg.multiscale.scales, cfg.multiscale.entropy_max_scale),
            3),
        cuda_time_ms(lambda: features.morphological_features(
            t01, cfg.morphology.kernel_sizes), 5),
        cuda_time_ms(lambda: features.filter_responses(t01), 5),
        cuda_time_ms(lambda: features.assemble(
            idx, pc[0], glcm, morph["gradient_5"], ms["std_dev_scale_5"],
            filt["sobel_mag"], cfg.context.window_size), 10))))
    whole = cuda_time_ms(lambda: stage2(art_u8), 3)
    print("stage 2 by family, device ms (events): " + "; ".join(
        f"{k} {v:.4f}" for k, v in fam.items())
        + f"; sum {sum(fam.values()):.4f}; whole {whole:.4f}")
    gabor_cfg = type(cfg)(include_gabor=True)
    gabor_feats, _ = features.extract_features(art_u8, gabor_cfg, device=dev)
    check(len(gabor_feats["gabor_features"]) == 24
          and all(bool(torch.isfinite(x).all())
                  for x in gabor_feats["gabor_features"]),
          "include_gabor: 24 finite responses")
    gabor_ms = cuda_time_ms(lambda: features.extract_features(
        art_u8, gabor_cfg, device=dev), 2, 1)
    fused_ms = cuda_time_ms(lambda: features.hierarchical_stack_fused(
        art_u8, cfg, device=dev), 5)
    print(f"stage 2 with include_gabor: {gabor_ms:.4f} device ms; "
          f"hierarchical_stack_fused {fused_ms:.4f} device ms")

    # scene 0 again on the CPU
    t0 = time.perf_counter()
    cpu_art = preprocess_bands(scenes[0], gains64, biases64, device="cpu")
    check(torch.equal(cpu_art, art_u8.cpu()), "stage 1 uint8: card == CPU")
    cpu_art16 = preprocess_bands(scene16, gains64, biases64, device="cpu")
    check(torch.equal(cpu_art16, art16.cpu()), "stage 1 16-bit: card == CPU")
    cpu_feats, cpu_hier = features.extract_features(cpu_art, cfg,
                                                    device="cpu")
    card, host = dict(flat_features(runs["uint8"][0])), dict(
        flat_features(cpu_feats))
    check(sorted(card) == sorted(host), "the same feature keys")
    worst = {}
    for key, ref in host.items():
        got = card[key].cpu()
        bnd = STAGE2_LOOSE.get(key, 1e-5)
        if isinstance(bnd, tuple):
            share = float((got == ref).double().mean())
            check(share >= bnd[1], f"stage 2 card vs CPU [{key}]: {share} "
                  f"equal")
            worst[key] = 1.0 - share
            continue
        err = float((got - ref).abs().max())
        check(err <= bnd, f"stage 2 card vs CPU [{key}]: max err {err} > "
              f"{bnd}")
        worst[key] = err
    for key in cpu_hier:
        err = float((runs["uint8"][1][key].cpu() - cpu_hier[key]).abs()
                    .max())
        check(err <= 1e-3, f"stage 2 card vs CPU [{key}] max err {err}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"stage 2, scene 0 on the CPU in {time.perf_counter() - t0:.1f} "
          f"s: every key within the CPU tests' bounds; largest differences "
          f"{[(k, float(f'{v:.3g}')) for k, v in top]}")

    # ---- 15. the stage kernels' numbers at the path's shapes, each call
    # with the L2 flushed before it (the inputs fit the 50 MB L2, and
    # back-to-back calls would read them from there)
    n = HEIGHT * WIDTH
    flush = l2_flusher(dev)
    # the configuration's host values, as preprocess_bands_f32 passes them
    def stretch_call():
        return kernels.fused_calibrate_stretch(scene16_d, gains64, biases64)

    stretch_launch = launch_numbers(stretch_call)
    check(len(stretch_launch["kernels_a_call_launches"]) == 1
          and "calibrate_stretch_kernel" in stretch_launch[
              "kernels_a_call_launches"][0]
          and not stretch_launch["htod_memcpy"],
          f"a fused_calibrate_stretch call with host gains launches its "
          f"kernel and nothing else, no copy: {stretch_launch}")
    print(f"a fused_calibrate_stretch call launches "
          f"{stretch_launch['kernels_a_call_launches']}, host-to-device "
          f"copy: {stretch_launch['htod_memcpy']}", flush=True)
    gains_d = torch.from_numpy(gains).to(dev)
    biases_d = torch.from_numpy(biases).to(dev)
    stretch_card_ms = cold_ms(lambda: kernels.fused_calibrate_stretch(
        scene16_d, gains_d, biases_d), flush)
    q0 = (t01 * (g.levels - 1)).to(torch.uint8).to(torch.int32)
    calls = {
        "fused_calibrate_stretch": (
            stretch_call,
            lambda: kernels.fused_calibrate_stretch_plain(
                scene16_d, gains64, biases64), "calibrate_stretch_kernel"),
        "fused_spectral_indices": (
            lambda: kernels.fused_spectral_indices(b01),
            lambda: kernels.fused_spectral_indices_plain(b01),
            "spectral_indices_kernel"),
        "glcm_grid": (
            lambda: kernels.glcm_grid(q0, g.levels, g.window_size,
                                      g.step_size, offsets),
            lambda: kernels.glcm_grid_plain(q0, g.levels, g.window_size,
                                            g.step_size, offsets),
            "glcm_kernel"),
    }
    ms_k = {k: cold_ms(fn, flush) for k, (fn, _, _) in calls.items()}
    # the kernels alone, from a profiler trace
    kernel_only = {k: kernel_device_ms(fn, name, flush)
                   for k, (fn, _, name) in calls.items()}
    plain = {k: cold_ms(fn, flush, 3 if k == "glcm_grid" else 10)
             for k, (_, fn, _) in calls.items()}
    n_i = (HEIGHT - g.window_size) // g.step_size + 1
    n_j = (WIDTH - g.window_size) // g.step_size + 1
    pairs = sum((g.window_size - abs(dr)) * (g.window_size - abs(dc))
                for dr, dc in offsets) * n_i * n_j
    # the GLCM reads only the pixels its windows cover
    covered = (((n_i - 1) * g.step_size + g.window_size)
               * ((n_j - 1) * g.step_size + g.window_size))
    sizes = {   # bytes moved (each input read once, output written once), ops
        "fused_calibrate_stretch": (BANDS * n * (2 + 4), BANDS * n * 5),
        "fused_spectral_indices": (n * (5 + 7) * 4, n * 40),
        "glcm_grid": (covered * 4 + n_i * n_j * 5 * 4, pairs * 8),
    }
    notes = {
        "fused_calibrate_stretch": "no single PyTorch call calibrates and "
                                   "stretches per band",
        "fused_spectral_indices": "no single PyTorch call computes the "
                                  "seven indices",
        "glcm_grid": "no single PyTorch call computes GLCM properties",
    }
    shapes = {"fused_calibrate_stretch": [BANDS, HEIGHT, WIDTH],
              "fused_spectral_indices": [BANDS, HEIGHT, WIDTH],
              "glcm_grid": [HEIGHT, WIDTH]}
    lines = {"fused_calibrate_stretch": ("stretch_indices.cu", 222),
             "fused_spectral_indices": ("stretch_indices.cu", 66),
             "glcm_grid": ("glcm.cu", 146)}
    rows = []
    for k in STAGE_KERNELS:
        nbytes, ops = sizes[k]
        bms, by = bound(nbytes, ops, INT32_OPS_PER_S if k == "glcm_grid"
                        else F32_OPS_PER_S)
        src, line = lines[k]
        rows.append({
            "name": k, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": f"{PALLAS}:{line}", "launches": launches[k],
            "max_abs_err": errs[k], "ms": ms_k[k], "plain_ms": plain[k],
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
            "kernel_only_ms": kernel_only[k], "timing": "L2 flushed before "
            "each call; ms and plain_ms median of CUDA-event times",
            "library_ms": None, "library_note": notes[k], "bytes": nbytes,
            "ops": ops, "shape": shapes[k],
            "stage1_f32_ms": walls["stage 1, 16-bit"],
            "stage2_ms": walls["stage 2"]})
    print("stage kernels, device ms: " + "; ".join(
        f"{r['name']} {r['ms']:.4f} (the kernel alone "
        f"{r['kernel_only_ms']}; plain {r['plain_ms']:.4f}; bound "
        f"{r['bound_us']:.3f} us, {r['bound_by']})" for r in rows))

    # what the two fused kernels would save inside the supervised stack
    # (printed, not routed: the stack keeps its plain routes)
    stack_idx = cuda_time_ms(lambda: spectral_indices(bands01), 10)
    kern_idx = cuda_time_ms(lambda: kernels.fused_spectral_indices(bands01),
                            20)
    stack_glcm = cuda_time_ms(lambda: texture.glcm_feature_maps(
        tex01, g.levels, g.window_size, g.step_size, g.distances, g.angles),
        5)
    kern_glcm = cuda_time_ms(lambda: texture.glcm_feature_maps(
        tex01, g.levels, g.window_size, g.step_size, g.distances, g.angles,
        backend="kernel"), 10)
    print(f"supervised stack lead ({BATCH} scenes): indices {stack_idx:.4f} "
          f"ms plain vs {kern_idx:.4f} ms fused; GLCM maps {stack_glcm:.4f} "
          f"ms (XLA route) vs {kern_glcm:.4f} ms (glcm_grid); would save "
          f"{stack_idx - kern_idx + stack_glcm - kern_glcm:.4f} ms per "
          f"batch")
    rows[1]["supervised_stack_plain_ms"] = stack_idx
    rows[1]["supervised_stack_kernel_ms"] = kern_idx
    rows[2]["supervised_stack_xla_ms"] = stack_glcm
    rows[2]["supervised_stack_kernel_ms"] = kern_glcm
    print(f"fused_calibrate_stretch with gains on the card: "
          f"{stretch_card_ms:.4f} ms (L2 flushed)")
    rows[0]["family_ms"] = fam
    rows[0]["ms_gains_on_the_card"] = stretch_card_ms
    rows[0].update(stretch_launch)
    return rows


KMEANS_K = 7
KMEANS_SEED = 42
KMEANS_STRIDE = 8
# the card's mapped kappa may differ from its CPU run's by at most this
# much on a scene. Both runs draw the same CPU Gumbel noise, so only the
# near-tied pixels that f32 matmuls split differently part them: 0.0004 at
# most over the three runs' 24 scenes on an H100 (phase 16), five times that
CARD_CPU_KAPPA_MARGIN = 0.002


def mapped_kappa(ev, maps, truth) -> float:
    """Cohen's kappa of cluster maps against a class map, each cluster
    mapped to its majority class (stage 4's evaluator on ``ev``'s
    device)."""
    pred, true = ev.extract_valid_samples(maps, truth)
    return ev.calculate_metrics(true, ev.map_clusters_to_classes(pred, true)
                                )["kappa"]


def kmeans_phases(dev, cfg, scenes, luts, hists, scenes_d, luts_d,
                  hists_d) -> dict:
    """Phase 16: the KMeans batch program, ``kmeans_scenes_turbo_batch``,
    in three runs (per-scene fits, a shared fit, and a warm start from the
    shared fit's centroids), each with launch counts read around one call,
    timed (median of 5 after a warm-up), split into stack, fit and
    assignment with CUDA events, and checked against the same run on the
    CPU; stage 4's metrics on the card against the CPU's. Returns the
    launches of each run."""
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
        ClassificationEvaluator)
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    sc, lt, hh = turbo._batch_inputs(scenes, luts, hists, "cpu")
    xs_cpu = turbo.kmeans_features(sc, lt, cfg, hh)
    cpu_stack_s = time.perf_counter() - t0
    rule_d = turbo.rule_based_scenes_turbo_batch(
        scenes_d, luts_d, cfg, stretch_hists=hists_d, device=dev)
    rule_cpu = rule_d.cpu()
    ev_d = ClassificationEvaluator(device=dev)
    ev_cpu = ClassificationEvaluator(device="cpu")
    runs = {"per-scene fits": {}, "shared fit": {"shared_fit": True},
            "warm start": {"shared_fit": True}}
    launches_by_run = {}
    for label, kw in runs.items():
        if label == "warm start":
            kw = dict(kw, init_cents=shared_cents)

        def run():
            return turbo.kmeans_scenes_turbo_batch(
                scenes_d, luts_d, KMEANS_K, cfg, KMEANS_SEED, KMEANS_STRIDE,
                stretch_hists=hists_d, return_cents=True, device=dev, **kw)

        (maps, cents), launches = counted(run)
        launches_by_run[label] = launches
        shared = "shared_fit" in kw
        # the fit's iterations, from the same fit run again
        xs_d = turbo.kmeans_features(scenes_d, luts_d, cfg, hists_d)
        fit_args = (KMEANS_K, KMEANS_SEED, KMEANS_STRIDE, shared,
                    kw.get("init_cents"))
        cents_b, _, n_iter = turbo.kmeans_fit(xs_d, *fit_args)
        iters = int(n_iter.max())
        check(launches["lut_hist"] == 1
              and launches["lloyd_pass"] == 2 * iters > 0
              and all(n == 0 for k, n in launches.items()
                      if k not in ("lut_hist", "lloyd_pass")),
              f"KMeans [{label}]: one lut_hist launch, two lloyd_pass "
              f"launches an iteration of the fit ({iters}) and no other "
              f"kernel: {launches}")
        check(maps.shape == (BATCH, HEIGHT, WIDTH)
              and maps.dtype == torch.uint8
              and int(maps.min()) >= 1 and int(maps.max()) <= KMEANS_K,
              f"KMeans [{label}] maps (B, H, W) uint8 in 1..{KMEANS_K}")
        check(tuple(cents.shape) == ((KMEANS_K, 19) if shared
                                     else (BATCH, KMEANS_K, 19))
              and bool(torch.isfinite(cents).all()),
              f"KMeans [{label}] centroids finite, {tuple(cents.shape)}")
        if label == "shared fit":
            shared_cents = cents
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        batch_ms = statistics.median(walls[1:])
        # the split, with CUDA events; the fit syncs once an iteration
        stack_ms = cuda_time_ms(lambda: turbo.kmeans_features(
            scenes_d, luts_d, cfg, hists_d), 3, 1)
        fit_ms = cuda_time_ms(lambda: turbo.kmeans_fit(xs_d, *fit_args), 3, 1)
        assign_ms = cuda_time_ms(lambda: turbo.assign_clusters(xs_d, cents_b),
                                 5, 1)
        print(f"KMeans [{label}]: launches {launches}; median {batch_ms:.3f}"
              f" ms per batch, {batch_ms / BATCH:.3f} ms per scene (runs "
              f"{[round(w, 3) for w in walls]}); by events stack "
              f"{stack_ms:.4f}, fit {fit_ms:.4f}, assignment "
              f"{assign_ms:.4f} ms; Lloyd iterations "
              f"{n_iter.tolist()}", flush=True)

        # the card against its CPU run
        init = kw.get("init_cents")
        t1 = time.perf_counter()
        cents_cpu, _, n_iter_cpu = turbo.kmeans_fit(
            xs_cpu, KMEANS_K, KMEANS_SEED, KMEANS_STRIDE, shared,
            None if init is None else init.cpu())
        maps_cpu = (turbo.assign_clusters(xs_cpu, cents_cpu).reshape(
            BATCH, HEIGHT, WIDTH) + 1).to(torch.uint8)
        same_cents = (turbo.assign_clusters(
            xs_cpu, cents.cpu().expand(BATCH, KMEANS_K, 19)).reshape(
            BATCH, HEIGHT, WIDTH) + 1).to(torch.uint8)
        agree = float((same_cents == maps.cpu()).double().mean())
        check(agree >= 0.999, f"KMeans [{label}]: the CPU's assignment to "
              f"the card's centroids agrees with the card on {agree}")
        kappas = [(mapped_kappa(ev_d, maps[b], rule_d[b]),
                   mapped_kappa(ev_cpu, maps_cpu[b], rule_cpu[b]))
                  for b in range(BATCH)]
        gap = max(abs(k_d - k_c) for k_d, k_c in kappas)
        check(gap <= CARD_CPU_KAPPA_MARGIN,
              f"KMeans [{label}]: the card's mapped kappa within "
              f"{CARD_CPU_KAPPA_MARGIN} of the CPU's: {kappas}")
        print(f"KMeans [{label}] on the CPU in {time.perf_counter() - t1:.1f}"
              f" s (stack {cpu_stack_s:.1f} s, once): assignment to the "
              f"card's centroids agrees on {agree:.6f}; Lloyd iterations "
              f"{n_iter_cpu.tolist()}; mapped kappa against the rule maps, "
              f"card / CPU: {kappas}; largest gap {gap}")
        # stage 4's metrics: the card's counts equal the CPU's
        for b in (0, BATCH - 1):
            got = ev_d.calculate_metrics(*ev_d.extract_valid_samples(
                maps[b], rule_d[b])[::-1])
            ref = ev_cpu.calculate_metrics(*ev_cpu.extract_valid_samples(
                maps[b].cpu(), rule_cpu[b])[::-1])
            check(got["labels"] == ref["labels"]
                  and np.array_equal(got["confusion_matrix"],
                                     ref["confusion_matrix"])
                  and all(got[k] == ref[k] for k in (
                      "overall_accuracy", "kappa", "per_class")),
                  f"KMeans [{label}] scene {b}: metrics on the card equal "
                  f"the CPU's")
    return launches_by_run


def near_ties(x: torch.Tensor, cents: torch.Tensor, rel: float = 1e-5):
    """(B, N, F) points and (B, K, F) centroids: ``(points whose two
    nearest centroids lie within rel * (|x|^2 + max |c|^2) of each other by
    f64 distances, (B, K) how many of them have each cluster among their
    two)``, the points that f32 rounding may send to either."""
    b, _, k = *x.shape[:2], cents.shape[1]
    touch = torch.zeros((b, k), dtype=torch.int64, device=x.device)
    if k < 2:
        return 0, touch
    x64, c64 = x.double(), cents.double()
    d = torch.cdist(x64, c64) ** 2
    two = torch.topk(d, 2, dim=2, largest=False)
    scale = (x64 * x64).sum(-1) + (c64 * c64).sum(-1).amax(-1)[:, None]
    tie = two.values[..., 1] - two.values[..., 0] <= rel * scale
    for j in range(2):
        touch.scatter_add_(1, two.indices[..., j], tie.long())
    return int(tie.sum()), touch


def lloyd_phase(dev, cfg, scenes_d, luts_d, hists_d, flush,
                kmeans_launches) -> dict:
    """Phase 25: ``lloyd_pass`` at the KMeans batch's shape, (8, 360 000,
    19) scaled features, k 7, from k-means++ centroids, against one plain
    ``_lloyd`` on the same inputs: its two launches, each cluster's count
    the plain version's but for points whose two nearest centroids tie to
    f32 rounding (:func:`near_ties`), and the centroids of the clusters no
    such point touches within 1e-6 of the f64 means of their points (the
    plain version's own f32 means printed beside). Returns its kernels row: back to back, L2 flushed and alone
    (``tools/kernel_times.py::lloyd_numbers``), the kernels a call
    launches, the byte bound, and the launches of phase 16's runs."""
    from rs_image_segmentation_tpu_torch.models import kmeans
    from rs_image_segmentation_tpu_torch.ops import kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.tools.kernel_times import (
        lloyd_numbers)

    x = turbo.kmeans_features(scenes_d, luts_d, cfg, hists_d).transpose(
        1, 2).contiguous()
    b, n, f = x.shape
    check((b, n, f) == (BATCH, HEIGHT * WIDTH, 19),
          f"the KMeans batch's features are ({BATCH}, {HEIGHT * WIDTH}, 19): "
          f"{tuple(x.shape)}")
    start = kmeans.kmeans_plus_plus_init(
        x, KMEANS_K, torch.Generator().manual_seed(KMEANS_SEED))
    want, labels, _ = kmeans._lloyd(x, start)
    counts = torch.stack([torch.bincount(lab, minlength=KMEANS_K)
                          for lab in labels])
    cents = start.clone()
    tol_abs = torch.full((b,), -1.0, device=dev)        # every problem on
    shift = torch.full((b,), float("inf"), device=dev)
    n_iter = torch.zeros((b,), dtype=torch.int64, device=dev)
    scratch = kernels.lloyd_scratch(x, KMEANS_K)
    _, launches = counted(lambda: kernels.lloyd_pass(
        x, cents, shift, n_iter, tol_abs, 300, scratch))
    check(launches["lloyd_pass"] == 2
          and all(v == 0 for k, v in launches.items() if k != "lloyd_pass"),
          f"one lloyd_pass call: two launches and no other kernel: "
          f"{launches}")
    # the kernel and cuBLAS add the distances' terms in other orders, so
    # a point whose two nearest centroids tie to f32 rounding may go to
    # either: such points, by f64 distances, bound how far the counts part
    near, touch = near_ties(x, start)
    got = scratch.counts.sum(dim=-1).long()
    gap = (got - counts).abs()
    check(bool((gap <= touch).all()), f"lloyd_pass: each cluster's count "
          f"equals the plain version's but for near ties: {got.tolist()} / "
          f"{counts.tolist()}, near ties touching each {touch.tolist()}")
    # a cluster no near tie touches has the same points on both routes:
    # its centroid within 1e-6 of their f64 mean
    sums = torch.zeros((b, KMEANS_K, f), dtype=torch.float64, device=dev)
    for i in range(b):
        sums[i].index_add_(0, labels[i], x[i].double())
    same = ((counts > 0) & (touch == 0))[..., None].expand_as(cents)
    mean = sums / counts.clamp_min(1)[..., None]
    err = ((cents.double() - mean).abs() / mean.abs().clamp_min(1e-30))[same]
    plain_err = ((want.double() - mean).abs()
                 / mean.abs().clamp_min(1e-30))[same]
    worst = float(err.max()) if err.numel() else float("nan")
    check(err.numel() > 0 and worst <= 1e-6 and bool((n_iter == 1).all()),
          f"lloyd_pass: centroids within 1e-6 of the f64 means: {worst} "
          f"over {err.numel()} values")
    print(f"lloyd_pass at {b} x {n} x {f}, k {KMEANS_K}: counts of "
          f"{int((gap == 0).sum())} of {gap.numel()} clusters equal to the "
          f"plain _lloyd's, {int(gap.sum()) // 2} points moved between "
          f"clusters, {near} near ties by f64 distances; worst relative gap "
          f"to the f64 means where no near tie touches "
          f"({int(same[..., 0].sum())} clusters) {worst:.3e} (the plain f32 "
          f"means: {float(plain_err.max()):.3e})", flush=True)
    row_nums, = lloyd_numbers(scenes_d, luts_d, cfg, flush).values()
    launch = launch_numbers(lambda: kernels.lloyd_pass(
        x, cents, shift, n_iter, tol_abs, 1 << 40, scratch))
    check(len(launch["kernels_a_call_launches"]) == 2
          and not launch["htod_memcpy"],
          f"a lloyd_pass call launches two kernels and copies nothing to "
          f"the card: {launch}")
    print(f"lloyd_pass, device ms a pass (back to back / L2 flushed / "
          f"alone): {row_nums['ms']:.4f} / {row_nums['cold_ms']:.4f} / "
          f"{row_nums['alone_ms']} ({row_nums['passes']}); bound "
          f"{row_nums['bound_ms']:.4f} ms by bytes; plain _lloyd "
          f"{row_nums['plain_ms']:.4f}; loops, host ms an iteration: fused "
          f"{row_nums['fused_loop_ms_an_iteration']:.4f}, plain "
          f"{row_nums['plain_loop_ms_an_iteration']:.4f}; launches "
          f"{launch['kernels_a_call_launches']}", flush=True)
    return {"name": "lloyd_pass", "route": "cuda",
            "source": f"{CSRC}/kmeans_lloyd.cu",
            "replaces": "none (the JAX package's Lloyd step is XLA matmuls)",
            "launches": {"one call": launches["lloyd_pass"],
                         **{f"kmeans_scenes_turbo_batch [{label}]":
                            d["lloyd_pass"]
                            for label, d in kmeans_launches.items()}},
            "counts_moved": int(gap.sum()) // 2, "near_ties": near,
            "max_rel_err_f64_means": worst,
            "plain_max_rel_err_f64_means": float(plain_err.max()),
            "kernel_ms": row_nums["ms"], "bound_us": row_nums["bound_ms"] * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "library_note": "no single PyTorch call computes a Lloyd step",
            **row_nums, **launch}


def forest_predict_phase(dev, stack0, forest, depth, main_labels0) -> dict:
    """Phase 17: ``forest_classify`` on scene 0's (H, W, 19) features with
    the path's forest (fitted by the port's trainer), launch counts read
    around one call, timed, against the CPU's plain route and the
    supervised path's scene 0; stage 4's evaluation on the card against
    the CPU's. Returns its launches."""
    from rs_image_segmentation_tpu_torch.pipeline import classify
    from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
        evaluate_classification)

    hwc = np.ascontiguousarray(stack0.transpose(1, 2, 0))
    hwc_d = torch.from_numpy(hwc).to(dev)
    labels, launches = counted(lambda: classify.forest_classify(
        hwc_d, forest, depth, device=dev))
    check(launches["forest_labels"] == 1
          and all(n == 0 for k, n in launches.items()
                  if k != "forest_labels"),
          f"forest_classify launches forest_labels once and no other "
          f"kernel: {launches}")
    check(labels.shape == (HEIGHT, WIDTH)
          and set(torch.unique(labels).tolist())
          <= set(forest.classes.tolist()), "forest labels (H, W) classes")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        classify.forest_classify(hwc_d, forest, depth, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cpu = classify.forest_classify(hwc, forest, depth, device="cpu")
    cpu_s = time.perf_counter() - t0
    # the kernel matches gemm_labels_cm exactly (phase 4), and the supervised
    # path's scene 0 runs it on the same stack with the same forest
    agree = float((cpu == labels.cpu()).double().mean())
    check(torch.equal(cpu, labels.cpu()),
          f"forest_classify card equals the CPU (agreement {agree})")
    agree_main = float((labels.to(torch.uint8) == main_labels0)
                       .double().mean())
    check(torch.equal(labels.to(torch.uint8), main_labels0),
          f"forest_classify equals the supervised path's scene 0 "
          f"(agreement {agree_main})")
    three = classify.create_three_class_map(labels, "random_forest",
                                            device=dev)
    check(three.device == labels.device and torch.equal(
        three.cpu(), classify.create_three_class_map(cpu, "random_forest",
                                                     device="cpu")),
          "create_three_class_map on the card equals the CPU's")
    got = evaluate_classification(labels, main_labels0, device=dev)
    ref = evaluate_classification(labels.cpu(), main_labels0.cpu(),
                                  device="cpu")
    check(np.array_equal(got["confusion_matrix"], ref["confusion_matrix"])
          and got["overall_accuracy"] == ref["overall_accuracy"]
          and got["kappa"] == ref["kappa"],
          "evaluate_classification on the card equals the CPU's")
    print(f"forest predict: launches {launches}; median "
          f"{statistics.median(walls[1:]):.3f} ms per 600 x 600 scene (runs "
          f"{[round(w, 3) for w in walls]}); on the CPU in {cpu_s:.1f} s, "
          f"agreement with the card {agree:.6f}; with the supervised path's "
          f"scene 0 {agree_main:.6f} (OA {got['overall_accuracy']:.6f})")
    return launches


def deep_forest_phase(dev, cfg, scenes_d, luts_d, hists_d, stack0,
                      flush) -> dict:
    """Phase 23: the source's forest at an ROI raster's scale (100 trees
    of unlimited depth fitted by the port's trainer on rule labels of
    ``DEEP_FOREST_SAMPLES`` pixels of scene 0's stack, an ROI raster's
    labelled pixels: some 20 000 leaves, past ``GEMM_MAX_LEAVES``) on the
    main path at 8 x 19 x 600 x 600: its GEMM form's path sparse, its
    packing on the kernel's global-memory instance; one launch each of
    ``lut_hist`` and ``forest_labels`` a batch through
    ``classify_scenes_turbo``, whose maps are bit-equal to the plain walk
    of ``tests/forest_walk_ref.py`` over the program's own stacks on the
    card (scene 0 also to ``gemm_labels_cm`` over the sparse path); the
    kernel's device ms back to back, L2 flushed and alone, against its
    bound, and the main path's wall ms a batch."""
    from rs_image_segmentation_tpu_torch.models.forest import (
        GEMM_MAX_LEAVES, GemmForest, _gemm_for)
    from rs_image_segmentation_tpu_torch.ops import kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from tests.forest_walk_ref import fields_of, walk_labels

    t0 = time.perf_counter()
    flat = fitted_forest(stack0, DEEP_FOREST_SAMPLES)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gf = GemmForest(*(t.to(dev) for t in _gemm_for(flat, 19)))
    facts = kernels._packed_on(gf, dev)[2]
    pack_s = time.perf_counter() - t0
    leaves = int(gf.path.shape[1])
    check(leaves > GEMM_MAX_LEAVES and gf.path.is_sparse
          and facts["global_instance"] == 1,
          f"the deep forest ({leaves} leaves) is past the cap, its path "
          f"sparse, on the global-memory instance: {facts}")

    def deep_path():
        return turbo.classify_scenes_turbo(
            scenes_d, luts_d, gf, cfg, stretch_hists=hists_d, device=dev)

    maps, launches = counted(deep_path)
    check(launches["lut_hist"] == 1 and launches["forest_labels"] == 1
          and all(n == 0 for k, n in launches.items()
                  if k not in ("lut_hist", "forest_labels")),
          f"the deep forest's batch launches lut_hist and forest_labels "
          f"once each: {launches}")
    stacks = turbo._stack_cm_from_parts(
        *turbo._preamble(scenes_d, luts_d, hists_d), cfg)
    x_cm = stacks.reshape(BATCH, 19, HEIGHT * WIDTH)
    labels = kernels.forest_labels(gf, x_cm)
    fields = fields_of(flat)
    walked = torch.stack([walk_labels(fields, xb.T) for xb in x_cm])
    diff = int((labels.long() != walked).sum().item())
    check(diff == 0, f"forest_labels with the deep forest bit-equal to the "
          f"plain walk ({diff} differ)")
    check(torch.equal(maps.reshape(BATCH, -1).long(), walked),
          "the deep forest's maps are the plain walk over the program's "
          "stacks")
    plain0 = kernels.gemm_labels_cm(gf, x_cm[0])
    check(torch.equal(plain0, labels[0]), "scene 0: forest_labels equals "
          "gemm_labels_cm over the sparse path")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deep_path()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    nums = kernel_numbers(lambda: kernels.forest_labels(gf, x_cm), flush,
                          3, 5, 3)
    decisions = fired_decisions(gf, x_cm, 8192)
    n_classes = gf.leaf_dist.shape[1]
    px = BATCH * HEIGHT * WIDTH
    bms, by = bound(x_cm.numel() * 4 + px * 4,
                    decisions + px * (N_TREES * n_classes + n_classes))
    out = {"leaves": leaves, "fit_s": fit_s, "pack_s": pack_s, **facts,
           "decisions": decisions,
           "walk_efficiency": decisions / (px * facts["walk_depth"]),
           "launches": {k: n for k, n in launches.items() if n},
           "main_path_ms": statistics.median(walls[1:]),
           "bound_ms": bms, "bound_by": by, **timing_keys(nums)}
    print(f"deep forest: {leaves} leaves fitted in {fit_s:.1f} s, packed "
          f"in {pack_s:.2f} s ({facts}); launches {out['launches']}; maps "
          f"bit-equal to the plain walk; forest_labels device ms (back to "
          f"back / L2 flushed / alone) {nums['ms']:.4f} / "
          f"{nums['cold_ms']:.4f} / {nums['alone_ms']} against a bound of "
          f"{bms:.4f} ({by}); walk efficiency "
          f"{out['walk_efficiency']:.4f}; main path {out['main_path_ms']:.3f}"
          f" ms a batch (runs {[round(w, 3) for w in walls]})", flush=True)
    return out, gf


def graph_phase(dev, cfg, scenes, luts, scenes_d, luts_d, hists_d,
                forests) -> dict:
    """Phase 24: the supervised program's stack as CUDA graph replays
    (``pipeline.turbo._StackGraphs``) against the eager route, bit for bit,
    with each of ``forests`` (name -> GemmForest on the card): the batch
    with the host histograms (the serving engine's call), with numpy in
    and no histograms (the benchmark's), and scene 0 alone; one
    ``lut_hist`` and one ``forest_labels`` launch a replayed batch and
    nothing else; one capture per batch shape; the count ``stack_graph``
    of a replayed batch's ``turbo.batch`` span; wall ms a batch, eager and
    graphed, inputs on the card."""
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.utils import timing
    from rs_image_segmentation_tpu_torch.utils.timing import span

    def eager(gf, sd, ld, hh=None):
        return turbo._labels_eager(sd, ld, hh, gf, cfg).reshape(
            sd.shape[0], HEIGHT, WIDTH).to(torch.uint8)

    captures = turbo._StackGraphs.captures
    out = {}
    for name, gf in forests.items():
        calls = {
            "with the host histograms": (
                lambda: turbo.classify_scenes_turbo(
                    scenes_d, luts_d, gf, cfg, stretch_hists=hists_d,
                    device=dev),
                eager(gf, scenes_d, luts_d, hists_d)),
            "numpy in, no histograms": (
                lambda: turbo.classify_scenes_turbo(scenes, luts, gf, cfg,
                                                    device=dev),
                eager(gf, scenes_d, luts_d)),
            "scene 0": (
                lambda: turbo.classify_scenes_turbo(scenes[:1], luts[:1], gf,
                                                    cfg, device=dev),
                eager(gf, scenes_d[:1], luts_d[:1]))}
        for label, (run, want) in calls.items():
            for _ in range(2):          # a capture or a replay, then a replay
                got, launches = counted(run)
            check(torch.equal(got, want), f"graphed maps bit-equal to the "
                  f"eager route [{name} forest, {label}]")
            check(launches["lut_hist"] == 1 and launches["forest_labels"] == 1
                  and sum(launches.values()) == 2,
                  f"a replayed batch launches lut_hist and forest_labels once "
                  f"each [{name}, {label}]: {launches}")
        with span("unrecorded"):
            pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            calls["numpy in, no histograms"][0]()
        root, = [r for r in timing.spans() if r.name == "turbo.batch"]
        check(root.counts.get("stack_graph") == 1,
              f"a replayed batch's turbo.batch counts stack_graph 1: "
              f"{root.counts}")
        walls = {}
        graphed = (lambda: turbo.classify_scenes_turbo(
            scenes_d, luts_d, gf, cfg, device=dev))
        for route, fn in (("eager", lambda: eager(gf, scenes_d, luts_d)),
                          ("graphed", graphed),
                          ("eager", lambda: eager(gf, scenes_d, luts_d)),
                          ("graphed", graphed)):
            fn()
            torch.cuda.synchronize()
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.setdefault(route, []).append(
                    (time.perf_counter() - t0) * 1e3)
        out[name] = {k: statistics.median(v) for k, v in walls.items()}
    new = turbo._StackGraphs.captures - captures
    check(new <= 2, f"one capture per batch shape (8 and 1 scenes): {new}")
    out["captures"] = new
    out["graph_shapes"] = len(turbo._STACK_GRAPHS)
    print(f"stack graphs: maps bit-equal to the eager route, one lut_hist "
          f"and one forest_labels launch a batch; wall ms a batch, inputs "
          f"on the card: {out}", flush=True)
    return out


LARGE_TILE = 504                   # bench.py's tile_rows at 36 MP
MID = 1260                         # side of the card-against-CPU tiling


def wall_s(fn, reps: int = 5):
    """Median host seconds of ``fn()`` over ``reps`` calls after a
    warm-up, each closed by a synchronise; and every run's seconds."""
    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls[1:]), walls


def event_ms(fn, reps: int = 5) -> float:
    """Median ms between CUDA events around ``fn()`` over ``reps`` calls
    after a warm-up (host work inside ``fn`` that waits on the card
    counts)."""
    ts = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        ts.append(start.elapsed_time(stop))
    return statistics.median(ts[1:])


def peak_gb(fn):
    """``fn()``'s result, and its peak device memory in GB above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


# the plain versions of the ten kernels (``ops.kernels``)
PLAIN_FUNCTIONS = ("lut_hist_plain", "gemm_labels_cm", "ccmin_prop_plain",
                   "hist_dense_plain", "keep_lut_plain", "cc_labels_plain",
                   "glcm_grid_plain", "fused_spectral_indices_plain",
                   "fused_calibrate_stretch_plain", "raw_counts_plain")


def plain_calls(run):
    """``run()``, and how often it called each of ``PLAIN_FUNCTIONS``
    through any module of the port that binds it."""
    from rs_image_segmentation_tpu_torch.ops import kernels
    calls = dict.fromkeys(PLAIN_FUNCTIONS, 0)
    real = {n: getattr(kernels, n) for n in PLAIN_FUNCTIONS}

    def spy(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    patched = [(mod, n) for mod in list(sys.modules.values())
               if getattr(mod, "__name__", "").startswith(
                   "rs_image_segmentation_tpu_torch")
               for n, f in real.items() if getattr(mod, n, None) is f]
    for mod, n in patched:
        setattr(mod, n, spy(n))
    try:
        out = run()
    finally:
        for mod, n in patched:
            setattr(mod, n, real[n])
    return out, calls


def large_scene_phases(dev, cfg, scenes, luts, gf, gf_cpu, rows) -> dict:
    """Phase 18: the large-scene pipeline, supervised and KMeans, on
    7 x 6000 x 6000 reflected tilings of scenes 0 and 1 with tile_rows
    504: ``preprocess_large`` (resident and streaming), the two kernels at
    the path's shapes against their plain versions, the streamed route
    against the resident one (launch counts, no plain version), tiled
    against monolithic, card against CPU at 1260 x 1260 (supervised,
    KMeans, the rule resumable), the three resumable drivers interrupted
    and resumed, then times and peak memory. Adds its numbers to the
    kernel rows ``rows`` and returns them."""
    import tempfile
    from rs_image_segmentation_tpu_torch.core.config import (
        CalibrationConfig)
    from rs_image_segmentation_tpu_torch.io.stream import HostToDevice
    from rs_image_segmentation_tpu_torch.ops import kernels
    from rs_image_segmentation_tpu_torch.pipeline import large_scene as ls
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
        ClassificationEvaluator)
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        build_stretch_stats, stretch_tables_from_counts)
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    torch.cuda.empty_cache()
    cal = CalibrationConfig()
    gains, biases = np.asarray(cal.gains), np.asarray(cal.biases)
    tr = LARGE_TILE
    n_tiles = -(-LARGE // tr)
    mp = LARGE * LARGE / 1e6
    out = {}
    t0 = time.perf_counter()
    big = reflected_tiling(scenes[0], LARGE)
    big2 = reflected_tiling(scenes[1], LARGE)
    lut_big, _, hist_big = build_stretch_stats(big, gains, biases)
    lut_big = lut_big.astype(np.uint8)
    host_pre = stretch(big, lut_big)
    host_hists = ls.band_histograms_u8(host_pre)
    print(f"large scenes: 2 x {big.shape} uint8 (reflected tilings of "
          f"scenes 0 and 1), host LUT, stretch and histograms in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 18a. preprocess_large: resident, and streaming (cap 0)
    (pre_big, hists_big), pre_peak = peak_gb(lambda: ls.preprocess_large(
        big, cal, return_hist=True, device=dev))
    check(np.array_equal(pre_big, host_pre), "preprocess_large (resident) "
          "equals the host f64 LUT applied on the host")
    check(np.array_equal(hists_big, host_hists), "preprocess_large's "
          "histogram equals band_histograms_u8")
    cap = ls.DEVICE_RESIDENT_MAX_BYTES
    ls.DEVICE_RESIDENT_MAX_BYTES = 0
    try:
        (pre_st, hists_st), launches_pre = counted(lambda: ls.preprocess_large(
            big, cal, return_hist=True, device=dev))
    finally:
        ls.DEVICE_RESIDENT_MAX_BYTES = cap
    check(np.array_equal(pre_st, pre_big)
          and np.array_equal(hists_st, hists_big),
          "preprocess_large's streaming mode equals its resident mode")
    check(launches_pre["lut_hist"] == -(-LARGE // 2048),
          f"the streaming mode launches lut_hist once a tile: {launches_pre}")
    pre_s, _ = wall_s(lambda: ls.preprocess_large(big, cal, return_hist=True,
                                                  device=dev))
    print(f"preprocess_large at {LARGE}^2: equal to the host LUT, histogram "
          f"equal; streaming mode equal ({launches_pre['lut_hist']} "
          f"lut_hist launches); median {pre_s:.4f} s with host numpy in and "
          f"out, peak {pre_peak:.3f} GB", flush=True)
    del pre_st, host_pre

    # ---- 18b. the two kernels at the path's shapes
    up = HostToDevice(dev)
    last0 = (n_tiles - 1) * tr
    chunk, last = up.put(big[:, :tr]), up.put(big[:, last0:])
    big_d = up.put(big)
    lut_d = torch.from_numpy(lut_big).to(dev)
    errs = {"lut_hist": 0.0, "forest_labels": 0.0}
    for label, x, kw in (
            (f"chunk {tr} rows, skip_hist", chunk, dict(skip_hist=True)),
            (f"chunk {tr} rows, with its histogram", chunk, {}),
            (f"last chunk {LARGE - last0} rows, skip_hist", last,
             dict(skip_hist=True)),
            (f"the {LARGE}^2 scene, with its histogram", big_d, {})):
        got = kernels.lut_hist(x, lut_d, out_u8=True, **kw)
        ref = kernels.lut_hist_plain(x, lut_d, out_u8=True,
                                     skip_hist="skip_hist" in kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            check(g.shape == r.shape and g.dtype == r.dtype and torch.equal(
                g, r), f"lut_hist uint8 out [{label}] bit-equal")
        unit = kernels.lut_hist_unit(x, got[0])
        check(unit == 16, f"lut_hist [{label}] takes the 16-byte unit: "
              f"{unit}")
        print(f"check lut_hist uint8 out [{label}] at {tuple(x.shape)}: "
              f"bit-equal, unit {unit}")
    # raw_counts at the route's chunks, from 16-byte aligned and offset
    # bases, and the scene's chunks counted into one accumulator
    zeros = torch.zeros((BANDS, 256), dtype=torch.int32, device=dev)
    for label, x in ((f"chunk {tr} rows", chunk),
                     (f"last chunk {LARGE - last0} rows", last)):
        for off, want_unit in ((0, 16), (1, 1), (4, 4)):
            xv = x
            if off:
                buf = torch.empty(x.numel() + 16, dtype=torch.uint8,
                                  device=dev)
                xv = buf[off:off + x.numel()].view(x.shape)
                xv.copy_(x)
            got = kernels.raw_counts(xv, zeros.clone())
            ref = kernels.raw_counts_plain(xv, zeros.clone())
            torch.cuda.synchronize()
            unit = kernels.lut_hist_unit(xv)
            check(unit == want_unit and torch.equal(got, ref),
                  f"raw_counts [{label}, base + {off}] bit-equal, unit "
                  f"{unit}")
            print(f"check raw_counts [{label}, base + {off}] at "
                  f"{tuple(xv.shape)}: bit-equal, unit {unit}")
    chunks = [up.put(big[:, y:y + tr]) for y in range(0, LARGE, tr)]
    counts_d = zeros.clone()
    for x in chunks:
        kernels.raw_counts(x, counts_d)
    ref = kernels.raw_counts_plain(big_d, zeros.clone())
    torch.cuda.synchronize()
    check(torch.equal(counts_d, ref), f"raw_counts over the {len(chunks)} "
          f"chunks into one accumulator equals the scene's counts")
    card_tables = stretch_tables_from_counts(counts_d.cpu().numpy(), gains,
                                             biases)
    check(all(np.array_equal(g, r) for g, r in zip(
        card_tables, (lut_big, hist_big))), "the tables derived from the "
          "card's counts equal build_stretch_stats on the scene")
    print(f"check raw_counts over the scene's {len(chunks)} chunks: equal "
          f"to the scene's counts; tables from them equal "
          f"build_stretch_stats", flush=True)
    src = ls._tile_src(pre_big, dev)
    g_big = ls._global_passes(pre_big, cfg, tr, src=src, hists=hists_big,
                              device=dev)
    stack_tile, _ = ls._make_stack_fn(pre_big, cfg, tr, globals_dict=g_big,
                                      device=dev)
    tiles = list(ls._halo_tiles(LARGE, tr))
    tile_x = None
    for y0, rows_, ys, ye in (tiles[0], tiles[-1]):
        x = stack_tile(src[:, ys:ye], y0, y0 - ys, rows_).reshape(19, -1)
        tile_x = x if tile_x is None else tile_x
        got = kernels.forest_labels(gf, x)
        ref = kernels.gemm_labels_cm(gf, x)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"forest_labels bit-equal on the tile "
              f"at row {y0} ({tuple(x.shape)})")
        print(f"check forest_labels on the tile at row {y0}, "
              f"{tuple(x.shape)}: bit-equal")
    flush = l2_flusher(dev)
    chunk_nums = kernel_numbers(lambda: kernels.lut_hist(
        chunk, lut_d, out_u8=True, skip_hist=True), flush)
    idx64 = chunk.reshape(BANDS, -1).long()
    gather_ms = cold_ms(lambda: torch.gather(lut_d, 1, idx64), flush)
    chunk_bytes = chunk.numel() * 2 + lut_d.numel()
    tile_ms = cuda_time_ms(lambda: kernels.forest_labels(gf, tile_x), 5, 1)
    # the timed calls add into the accumulator (integer adds, wrapping
    # harmlessly); a call reads its chunk and reads and writes the counts
    count_bytes = chunk.numel() + 2 * zeros.numel() * 4
    count_nums = kernel_numbers(lambda: kernels.raw_counts(chunk, counts_d),
                                flush)
    count_scene = kernel_numbers(lambda: [kernels.raw_counts(x, counts_d)
                                          for x in chunks], flush, 5, 5, 5)
    count_plain_ms = cold_ms(lambda: kernels.raw_counts_plain(
        chunk, counts_d), flush, 5)
    scene_count_bytes = big.size + len(chunks) * 2 * zeros.numel() * 4
    print(f"lut_hist uint8 out at the chunk shape {tuple(chunk.shape)}, "
          f"device ms (back to back / L2 flushed / alone): "
          f"{chunk_nums['ms']:.4f} / {chunk_nums['cold_ms']:.4f} / "
          f"{chunk_nums['alone_ms']}; torch.gather (int64 indices widened "
          f"beforehand) {gather_ms:.4f} flushed; bound "
          f"{bound(chunk_bytes, 0)[0]:.4f}; forest_labels on a tile "
          f"{tile_ms:.4f} ms; raw_counts on the chunk "
          f"{count_nums['ms']:.4f} / {count_nums['cold_ms']:.4f} / "
          f"{count_nums['alone_ms']} (plain {count_plain_ms:.4f} flushed, "
          f"bound {bound(count_bytes, 0)[0]:.4f}), on the scene's "
          f"{len(chunks)} chunks {count_scene['ms']:.4f} / "
          f"{count_scene['cold_ms']:.4f} / {count_scene['alone_ms']} (bound "
          f"{bound(scene_count_bytes, 0)[0]:.4f})", flush=True)
    del big_d, last, chunks

    # ---- 18c. the supervised routes
    def streamed(raw):
        return ls.classify_large_scene_streamed(raw, gf, cal, cfg,
                                                tile_rows=tr, device=dev)

    def resident(pre, hists):
        return ls.classify_large_scene(pre, gf, cfg, tile_rows=tr,
                                       hists=hists, device=dev)

    t0 = time.perf_counter()
    ((map_st, plain), launches_st), st_peak = peak_gb(
        lambda: counted(lambda: plain_calls(lambda: streamed(big))))
    first_s = time.perf_counter() - t0
    check(launches_st["lut_hist"] == n_tiles
          and launches_st["raw_counts"] == n_tiles
          and launches_st["forest_labels"] == n_tiles
          and all(n == 0 for k, n in launches_st.items()
                  if k not in ("lut_hist", "raw_counts", "forest_labels")),
          f"the streamed route launches raw_counts and lut_hist once a "
          f"chunk and forest_labels once a tile, nothing else: "
          f"{launches_st}")
    check(not any(plain.values()), f"no plain version on the streamed "
          f"route: {plain}")
    map_res, res_peak = peak_gb(lambda: resident(pre_big, hists_big))
    check(map_st.shape == (LARGE, LARGE) and map_st.dtype == np.int32
          and set(np.unique(map_st)) <= set(gf_cpu.classes.tolist()),
          "streamed map (H, W) int32 of forest classes")
    check(np.array_equal(map_st, map_res), "classify_large_scene_streamed "
          "bit-equal to preprocess_large -> classify_large_scene (scene 0)")
    pre2, hists2 = ls.preprocess_large(big2, cal, return_hist=True,
                                       device=dev)
    check(np.array_equal(streamed(big2), resident(pre2, hists2)),
          "classify_large_scene_streamed bit-equal to the resident route "
          "(scene 1)")
    counts = np.bincount(map_st.reshape(-1), minlength=5)
    print(f"supervised at {LARGE}^2: streamed bit-equal to resident on "
          f"both scenes; launches {launches_st}; plain calls {plain}; class "
          f"counts {counts.tolist()}", flush=True)
    warm_s, warm_runs = wall_s(lambda: streamed(big2))

    def route_stats():
        """The route's statistics step: each raw chunk staged and counted
        on the card, the counts fetched, the tables derived."""
        acc = torch.zeros((BANDS, 256), dtype=torch.int32, device=dev)
        for y in range(0, LARGE, tr):
            kernels.raw_counts(up.put(big2[:, y:y + tr]), acc)
        return stretch_tables_from_counts(acc.cpu().numpy(), gains, biases)

    stats_s, _ = wall_s(route_stats, 3)
    res_s, res_runs = wall_s(lambda: resident(pre_big, hists_big))
    classify_tile = ls._tile_classifier(g_big, gf, cfg, (LARGE, LARGE), dev)
    passes = {
        "A (histograms, stats)": event_ms(lambda: ls.compute_global_stats(
            pre_big, cfg, ls._scene_hists(pre_big, src, tr))),
        "B/C (PCA sums, GLCM grid, Sobel max)": event_ms(
            lambda: ls._global_passes(pre_big, cfg, tr, src=src,
                                      hists=hists_big, device=dev)),
        "D (stack and forest, every tile)": event_ms(lambda: [
            classify_tile(src[:, ys:ye], y0, y0 - ys, r)
            for y0, r, ys, ye in tiles])}
    out["supervised"] = {
        "large_scene_first_e2e_s": first_s, "large_scene_warm_e2e_s": warm_s,
        "large_scene_mp_per_s": mp / warm_s,
        "warm_runs_s": warm_runs, "route_stretch_stats_s": stats_s,
        "resident_e2e_s": res_s,
        "resident_runs_s": res_runs, "resident_passes_ms": passes,
        "preprocess_large_s": pre_s, "peak_gb": {
            "streamed": st_peak, "resident_classify": res_peak,
            "preprocess_large": pre_peak},
        "launches_streamed": launches_st}
    print(f"supervised at {LARGE}^2, streamed (host numpy in and out): "
          f"first {first_s:.4f} s, warm median {warm_s:.4f} s "
          f"({mp / warm_s:.3f} MP/s; runs "
          f"{[round(w, 4) for w in warm_runs]}), of which the statistics "
          f"(chunks staged and counted on the card, counts fetched, tables "
          f"derived) {stats_s:.4f} s; resident classify median "
          f"{res_s:.4f} s (runs {[round(w, 4) for w in res_runs]}), by "
          f"events " + "; ".join(f"{k} {v:.2f} ms" for k, v in passes.items())
          + f"; peak GB streamed {st_peak:.3f}, resident {res_peak:.3f}",
          flush=True)
    print(json.dumps({"large_scene_warm_e2e_s": warm_s,
                      "large_scene_mp_per_s": mp / warm_s,
                      "large_scene_first_e2e_s": first_s}))
    del pre2

    # ---- 18d. tiled against monolithic
    pre0 = ls.preprocess_large(scenes[0], cal, device=dev)
    mono0 = turbo.classify_scenes_turbo(scenes[:1], luts[:1], gf, cfg,
                                        device=dev)[0].cpu().numpy()
    agree = {}
    for t in (63, 504):
        tiled = ls.classify_large_scene(pre0, gf, cfg, tile_rows=t,
                                        device=dev)
        agree[f"{HEIGHT}^2, tile_rows {t}"] = float((tiled == mono0).mean())
    try:
        mono_big, mono_peak = peak_gb(lambda: turbo.classify_scenes_turbo(
            big[None], lut_big[None], gf, cfg, device=dev)[0].cpu().numpy())
        agree[f"{LARGE}^2, tile_rows {tr}"] = float((map_res == mono_big)
                                                    .mean())
        del mono_big
    except torch.cuda.OutOfMemoryError:
        mono_peak = None
        torch.cuda.empty_cache()
    check(all(a >= 0.995 for a in agree.values()), f"tiled against "
          f"monolithic >= 0.995: {agree}")
    out["tiled_vs_monolithic"] = {"agreement": agree,
                                  "monolithic_peak_gb_6000": mono_peak}
    print(f"tiled against monolithic (classify_scenes_turbo): {agree}; "
          f"monolithic peak at {LARGE}^2: "
          + ("did not fit" if mono_peak is None else f"{mono_peak:.3f} GB"),
          flush=True)

    # ---- 18e. card against CPU at MID x MID
    t0 = time.perf_counter()
    mid = reflected_tiling(scenes[0], MID)
    pre_mid = ls.preprocess_large(mid, cal, device="cpu")
    sup_d = ls.classify_large_scene(pre_mid, gf, cfg, tr, device=dev)
    sup_c = ls.classify_large_scene(pre_mid, gf_cpu, cfg, tr, device="cpu")
    sup_agree = float((sup_d == sup_c).mean())
    check(sup_agree >= 0.999, f"supervised card against CPU at {MID}^2: "
          f"{sup_agree}")

    def kmeans_parts(device):
        src_m = ls._tile_src(pre_mid, device)
        fn, _ = ls._make_stack_fn(pre_mid, cfg, tr, src=src_m, device=device)
        return src_m, fn

    def assign_map(parts, fit):
        assign = ls._kmeans_assign_fn(*fit, KMEANS_K)
        return torch.cat([assign(s).reshape(r, -1) for _, r, s in
                          ls._kmeans_tiles(pre_mid, cfg, tr, *parts)]
                         ).cpu().numpy().astype(np.int32)

    parts_d, parts_c = kmeans_parts(dev), kmeans_parts(torch.device("cpu"))
    fit_d = ls._kmeans_fit_large(pre_mid, KMEANS_K, cfg, tr, KMEANS_SEED,
                                 0.1, 2_000_000, *parts_d)
    km_d = assign_map(parts_d, fit_d)
    same = assign_map(parts_c, [t.cpu() for t in fit_d])
    km_agree = float((same == km_d).mean())
    check(km_agree >= 0.999, f"KMeans at {MID}^2: the CPU's assignment to "
          f"the card's centroids agrees with the card on {km_agree}")
    km_c = ls.kmeans_large_scene(pre_mid, KMEANS_K, cfg, tr, KMEANS_SEED,
                                 device="cpu")
    rule_d = ls.rule_based_large_scene(pre_mid, cfg, device=dev)
    rule_c = ls.rule_based_large_scene(pre_mid, cfg, device="cpu")
    kappa_d = mapped_kappa(ClassificationEvaluator(device=dev),
                           torch.from_numpy(km_d).to(dev),
                           torch.from_numpy(rule_d).to(dev))
    kappa_c = mapped_kappa(ClassificationEvaluator(device="cpu"),
                           torch.from_numpy(km_c), torch.from_numpy(rule_c))
    check(abs(kappa_d - kappa_c) <= CARD_CPU_KAPPA_MARGIN,
          f"KMeans at {MID}^2: mapped kappa card {kappa_d} and CPU "
          f"{kappa_c} within {CARD_CPU_KAPPA_MARGIN}")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        rres_d = ls.rule_based_large_scene_resumable(pre_mid, d1, cfg,
                                                     device=dev)
        rres_c = ls.rule_based_large_scene_resumable(pre_mid, d2, cfg,
                                                     device="cpu")
    check(np.array_equal(rres_d, rule_d) and np.array_equal(rres_c, rule_c),
          f"rule_based_large_scene_resumable equals rule_based_large_scene "
          f"at {MID}^2, on the card and on the CPU")
    rule_agree = float((rule_d == rule_c).mean())
    check(rule_agree >= 0.999, f"rule route card against CPU at {MID}^2: "
          f"{rule_agree}")
    out["card_vs_cpu_1260"] = {
        "supervised_agreement": sup_agree, "kmeans_assignment_agreement":
        km_agree, "kmeans_mapped_kappa": [kappa_d, kappa_c],
        "rule_agreement": rule_agree}
    print(f"card against CPU at {MID}^2 in {time.perf_counter() - t0:.1f} s: "
          f"supervised {sup_agree:.6f}; KMeans assignment to the card's "
          f"centroids {km_agree:.6f}, mapped kappa card {kappa_d:.6f} / CPU "
          f"{kappa_c:.6f}; rule {rule_agree:.6f}, resumable equal on both",
          flush=True)
    del mid, pre_mid

    # ---- 18f. KMeans at full size: fit, assignment, peak
    km_big, km_peak = peak_gb(lambda: ls.kmeans_large_scene(
        pre_big, KMEANS_K, cfg, tr, KMEANS_SEED, device=dev))
    check(km_big.shape == (LARGE, LARGE) and km_big.min() >= 1
          and km_big.max() <= KMEANS_K, f"KMeans map at {LARGE}^2, 1-based")
    fit_ms = event_ms(lambda: ls._kmeans_fit_large(
        pre_big, KMEANS_K, cfg, tr, KMEANS_SEED, 0.1, 2_000_000, src,
        stack_tile), 3)
    fit = ls._kmeans_fit_large(pre_big, KMEANS_K, cfg, tr, KMEANS_SEED, 0.1,
                               2_000_000, src, stack_tile)
    assign = ls._kmeans_assign_fn(*fit, KMEANS_K)
    assign_ms = event_ms(lambda: [assign(s) for _, _, s in ls._kmeans_tiles(
        pre_big, cfg, tr, src, stack_tile)], 3)
    km_s, km_runs = wall_s(lambda: ls.kmeans_large_scene(
        pre_big, KMEANS_K, cfg, tr, KMEANS_SEED, device=dev), 3)
    out["kmeans"] = {"e2e_s": km_s, "runs_s": km_runs, "fit_ms": fit_ms,
                     "assignment_ms": assign_ms, "peak_gb": km_peak}
    print(f"kmeans_large_scene at {LARGE}^2 (k {KMEANS_K}, 2^20 fit "
          f"pixels): median {km_s:.4f} s (runs "
          f"{[round(w, 4) for w in km_runs]}); by events fit (stacks, "
          f"sample, Lloyd) {fit_ms:.2f} ms, assignment (stacks and "
          f"argmin) {assign_ms:.2f} ms; peak {km_peak:.3f} GB", flush=True)

    # ---- 18g. the resumable drivers, interrupted and resumed
    rule_big = ls.rule_based_large_scene(pre_big, cfg, hists=hists_big,
                                         device=dev)
    drivers = {
        "classify": (lambda d, **kw: ls.classify_large_scene_resumable(
            pre_big, gf, d, cfg, tile_rows=tr, hists=hists_big, device=dev,
            **kw), map_res),
        "kmeans": (lambda d, **kw: ls.kmeans_large_scene_resumable(
            pre_big, d, KMEANS_K, cfg, tile_rows=tr, seed=KMEANS_SEED,
            device=dev, **kw), km_big),
        "rule": (lambda d, **kw: ls.rule_based_large_scene_resumable(
            pre_big, d, cfg, hists=hists_big, device=dev, **kw), rule_big)}
    resumed_launches = {}
    for name, (run, ref) in drivers.items():
        with tempfile.TemporaryDirectory() as d:
            try:
                run(d, interrupt_after=2)
                check(False, f"{name} resumable: interrupt_after=2 raises")
            except ls.TileInterrupt:
                pass
            got, resumed_launches[name] = counted(lambda: run(d))
        check(np.array_equal(got, ref), f"{name} resumable: interrupted "
              f"after 2 and resumed, equal to the uninterrupted run")
    check(resumed_launches["rule"]["cc_labels"] == 2
          and resumed_launches["classify"]["forest_labels"] == n_tiles - 2,
          f"the resumed runs compute only what was left: {resumed_launches}")
    out["resumed_launches"] = resumed_launches
    print(f"resumable drivers at {LARGE}^2: each interrupted after 2 and "
          f"resumed, bit-equal to its uninterrupted run; the resumed runs "
          f"launch {resumed_launches}", flush=True)

    by_name = {r["name"]: r for r in rows}
    by_name["lut_hist"]["large_scene"] = {
        "launches_streamed": launches_st["lut_hist"],
        "chunk_shape": list(chunk.shape), "chunk_uint8_out":
        timing_keys(chunk_nums), "chunk_gather_ms": gather_ms,
        "chunk_bound_ms": bound(chunk_bytes, 0)[0],
        "launches_preprocess_large_streaming": launches_pre["lut_hist"]}
    by_name["forest_labels"]["large_scene"] = {
        "launches_streamed": launches_st["forest_labels"],
        "tile_shape": list(tile_x.shape), "tile_ms": tile_ms,
        "launches_classify_resumed": resumed_launches["classify"][
            "forest_labels"]}
    by_name["cc_labels"]["launches_rule_resumed"] = resumed_launches[
        "rule"]["cc_labels"]
    bms, by = bound(count_bytes, 0)
    rows.append({
        "name": "raw_counts", "route": "cuda",
        "source": f"{CSRC}/lut_hist.cu", "replaces": None,
        "launches": launches_st["raw_counts"], "max_abs_err": 0,
        "max_diff": 0, "ms": count_nums["ms"],
        "kernel_ms": count_nums["ms"], "plain_ms": count_plain_ms,
        "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
        "library_ms": None, "library_note": "no library call on the card "
        "counts the bins (torch.bincount, histc and scatter_add_ are kept "
        "off the route); plain_ms is the plain version's scatter_add_",
        "bytes": count_bytes, "shape": list(chunk.shape),
        **timing_keys(count_nums),
        "scene": {"chunks": n_tiles, "bytes": scene_count_bytes,
                  "bound_ms": bound(scene_count_bytes, 0)[0],
                  **timing_keys(count_scene)}})
    return out


SERVING_METHODS = ("random_forest", "kmeans", "rule_based")
LATENCY_ROUNDS = 5


def submit_together(eng, scenes, method):
    """Futures of ``scenes`` submitted while holding the engine's lock, so
    the dispatch thread finds the whole group pending when it wakes (the
    group is then one batch, whatever the host's load)."""
    with eng._lock:
        return [eng.submit(s, method=method) for s in scenes]


def results(futures, timeout: float = 300.0):
    return [f.result(timeout=timeout) for f in futures]


def concurrent_latency(eng, scenes, method, rounds: int = LATENCY_ROUNDS):
    """Per-request seconds of ``rounds`` rounds of one request per scene
    from as many client threads at once (a barrier releases them), each
    round's wall seconds, and the engine's batch sizes meanwhile."""
    import concurrent.futures as cf
    import threading
    before = dict(eng.stats()["batch_sizes"])
    lat, walls = [], []
    with cf.ThreadPoolExecutor(max_workers=len(scenes)) as pool:
        for _ in range(rounds):
            barrier = threading.Barrier(len(scenes))

            def one(s):
                barrier.wait(timeout=60)
                t0 = time.perf_counter()
                eng.classify(s, timeout=300, method=method)
                return t0, time.perf_counter()

            spans = list(pool.map(one, scenes))
            lat += [t1 - t0 for t0, t1 in spans]
            walls.append(max(t1 for _, t1 in spans)
                         - min(t0 for t0, _ in spans))
    after = eng.stats()["batch_sizes"]
    sizes = {n: after[n] - before.get(n, 0) for n in after
             if after[n] != before.get(n, 0)}
    return lat, walls, sizes


def stack_batch_invariance(dev, cfg, scenes_d, luts_d) -> dict:
    """Which channels of the 19-channel stack differ, bit for bit, between
    the batch's program (B = 8) and each scene's alone (B = 1), with the
    largest difference: an op that changes its algorithm with the batch
    size (a batched ``bmm`` did, for the PCA Gram) shows here as a channel
    difference before any map does."""
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    batch = turbo.hierarchical_stack_turbo_cm(scenes_d, luts_d, cfg,
                                              device=dev)
    diff = {}
    for b in range(scenes_d.shape[0]):
        one = turbo.hierarchical_stack_turbo_cm(scenes_d[b:b + 1],
                                                luts_d[b:b + 1], cfg,
                                                device=dev)[0]
        for c in range(one.shape[0]):
            d = float((one[c] - batch[b, c]).abs().max())
            if not torch.equal(one[c], batch[b, c]):
                diff[c] = max(diff.get(c, 0.0), d)
    return diff


def serving_phases(dev, cfg, scenes, flat_forest, depth, gf, stack0, smi,
                   rows) -> dict:
    """Phase 19: the serving engine (``serving.engine.InferenceEngine``,
    default ``EngineConfig``) and its HTTP server on the card, with the
    supervised cell's forest, at 7 x 600 x 600: warm-up, bucket padding
    bit-exact per scene, the three KMeans modes, the rule overflow
    reroute, a forest past ``GEMM_MAX_LEAVES``, HTTP npy and
    GeoTIFF round trips, launch counts, and latencies. Returns the
    launches of one supervised and one rule batch, and the numbers."""
    import tempfile
    import threading
    import urllib.request

    from rs_image_segmentation_tpu_torch.core.types import GeoMeta
    from rs_image_segmentation_tpu_torch.io import native, tiff
    from rs_image_segmentation_tpu_torch.models.forest import (
        GEMM_MAX_LEAVES, GemmForest, _gemm_for, flat_forest_from_numpy,
        n_leaves)
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.serving import client
    from rs_image_segmentation_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine)
    from rs_image_segmentation_tpu_torch.serving.server import make_server
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        deep_forest_fields, stretch_stats_batch)
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms
    from tests.forest_walk_ref import walk_labels

    out = {}
    # ---- 19a. the native codec and the host statistics
    check(native.available(), "io.native builds and loads (g++ on the host)")
    big = reflected_tiling(scenes[0], LARGE)[None]
    stats_s = {}
    for route in ("np.bincount", "native", "np.bincount ", "native "):
        # the parent's count (np.bincount: the route build_stretch_stats
        # takes without the library) and the native one, in turns
        real = native.hist_u8
        if route.startswith("np"):
            native.hist_u8 = lambda arr: None
        try:
            for label, sc in (("batch", scenes), ("large", big)):
                t0 = time.perf_counter()
                got = stretch_stats_batch(sc)
                stats_s.setdefault(label, {}).setdefault(
                    route.strip(), []).append(time.perf_counter() - t0)
                if label == "batch":
                    luts, _, hists = got
        finally:
            native.hist_u8 = real
    stats_ms = min(stats_s["batch"]["native"]) * 1e3
    print(f"serving: native codec {native.library_path().name}; host "
          f"stretch stats, s per {BATCH} x 7 x {HEIGHT} x {WIDTH} batch and "
          f"per 7 x {LARGE} x {LARGE} scene, by count route: {stats_s}; "
          f"{smi}", flush=True)
    out["host_stats_s"] = stats_s

    # ---- 19b. the stack's batch invariance, channel by channel
    scenes_d = torch.from_numpy(scenes).to(dev)
    luts_d = torch.from_numpy(luts).to(dev)
    inv = stack_batch_invariance(dev, cfg, scenes_d, luts_d)
    check(not inv, f"the stack's channels are bit-equal at B = {BATCH} and "
          f"B = 1 (channel: max abs diff): {inv}")
    # the PCA Gram, a batched bmm against one product a scene (the
    # stack's form): the bmm's sums change with the batch size
    x = scenes_d.float().reshape(BATCH, BANDS, -1)
    bmm8 = torch.bmm(x, x.transpose(1, 2))
    bmm1 = torch.cat([torch.bmm(x[i:i + 1], x[i:i + 1].transpose(1, 2))
                      for i in range(BATCH)])
    gram_ms = {
        "bmm": cuda_time_ms(lambda: torch.bmm(x, x.transpose(1, 2)), 20),
        "mm_per_scene": cuda_time_ms(
            lambda: torch.stack([f @ f.T for f in x]), 20)}
    # the PCA mean's sum over (B, 7, 256) rows, and the eigh of the Grams,
    # batched against one scene at a time
    rows3 = torch.rand((BATCH, BANDS, 256), generator=torch.Generator()
                       .manual_seed(SEED)).to(dev)
    sum_equal = torch.equal(torch.sum(rows3, dim=-1),
                            torch.stack([torch.sum(r, dim=-1)
                                         for r in rows3]))
    grams = torch.stack([f @ f.T for f in x]) / x.shape[-1]
    vals8, vecs8 = torch.linalg.eigh(grams)
    ones = [torch.linalg.eigh(gm[None]) for gm in grams]
    eigh_equal = (torch.equal(vals8, torch.cat([o[0] for o in ones]))
                  and torch.equal(vecs8, torch.cat([o[1] for o in ones])))
    out["batch_equal"] = {"gram_bmm": torch.equal(bmm8, bmm1),
                          "row_sum": sum_equal, "eigh": eigh_equal}
    print(f"serving: the stack's channels are bit-equal at B = {BATCH} and "
          f"B = 1; batched against one scene at a time, equal: "
          f"{out['batch_equal']} (the Gram as one bmm differs by "
          f"{float((bmm8 - bmm1).abs().max())}); device ms of the {BATCH} "
          f"Grams {gram_ms}; {smi}", flush=True)
    out["gram_ms"] = gram_ms

    eng = InferenceEngine(flat_forest, depth, cfg=cfg, device=dev)
    check(eng.device == dev and eng.stats()["gemm_forest"],
          "the engine runs on the card with the GEMM forest")
    # ---- 19c. warm-up, per method
    warm_s = {}
    for m in SERVING_METHODS:
        t0 = time.perf_counter()
        eng.warmup([(HEIGHT, WIDTH)], methods=[m])
        torch.cuda.synchronize()
        warm_s[m] = time.perf_counter() - t0
    print(f"serving: warmup(({HEIGHT}, {WIDTH})) seconds by method "
          f"{warm_s}", flush=True)
    out["warmup_s"] = warm_s

    # ---- 19d. bucket padding, bit for bit against B = 1
    def direct(m, i, **kw):
        args = (scenes[i:i + 1], luts[i:i + 1])
        sk = dict(stretch_hists=hists[i:i + 1], device=dev)
        if m == "random_forest":
            got = turbo.classify_scenes_turbo(*args, gf, cfg, **sk)
        elif m == "rule_based":
            got = turbo.rule_based_scenes_turbo_batch(*args, cfg, **sk)
        else:
            got = turbo.kmeans_scenes_turbo_batch(
                *args, KMEANS_K, cfg, KMEANS_SEED, KMEANS_STRIDE, **sk, **kw)
        return got[0].cpu().numpy()

    for m in ("random_forest", "rule_based"):
        want = [direct(m, i) for i in range(BATCH)]
        before = eng.stats()
        alone = [eng.classify(s, timeout=300, method=m) for s in scenes]
        three = results(submit_together(eng, scenes[:3], m))
        eight = results(submit_together(eng, scenes, m))
        after = eng.stats()
        grown = {n: after["batch_sizes"].get(n, 0)
                 - before["batch_sizes"].get(n, 0) for n in (1, 3, BATCH)}
        check(grown == {1: BATCH, 3: 1, BATCH: 1}
              and after["padded_scenes"] - before["padded_scenes"] == 1,
              f"{m}: {BATCH} batches of 1, one of 3 padded to 4, one of "
              f"{BATCH}: {grown}, padded {after['padded_scenes']}")
        bad = [(label, i) for label, got in (("alone", alone),
                                             ("3 -> 4", three),
                                             ("8", eight))
               for i, g in enumerate(got)
               if g.shape != (HEIGHT, WIDTH) or g.dtype != np.uint8
               or not np.array_equal(g, want[i])]
        check(not bad, f"{m}: every map bit-equal to its scene's direct "
              f"program at B = 1 (buckets 1, 4, 8); differ: {bad}")
        print(f"serving [{m}]: buckets 1, 4 (3 padded) and 8 bit-equal to "
              f"B = 1 on all {BATCH} scenes", flush=True)

    # ---- 19e. KMeans: per-scene fits, shared fit, warm start
    launches = {}
    eight, launches["kmeans"] = counted(
        lambda: results(submit_together(eng, scenes, "kmeans")))
    bad = [i for i in range(BATCH)
           if not np.array_equal(eight[i], direct("kmeans", i))]
    check(not bad, f"KMeans per-scene fits equal the direct program at "
          f"B = 1: differ {bad}")
    sk = dict(stretch_hists=hists, shared_fit=True, return_cents=True,
              device=dev)
    kargs = (scenes, luts, KMEANS_K, cfg, KMEANS_SEED, KMEANS_STRIDE)
    with InferenceEngine(cfg=cfg, method="kmeans", device=dev,
                         engine_cfg=EngineConfig(kmeans_shared_fit=True)
                         ) as shared_eng:
        shared = results(submit_together(shared_eng, scenes, "kmeans"))
    want, cents = turbo.kmeans_scenes_turbo_batch(*kargs, **sk)
    want = want.cpu().numpy()
    check(all(np.array_equal(shared[i], want[i]) for i in range(BATCH)),
          "KMeans shared fit equals the direct shared-fit batch")
    with InferenceEngine(cfg=cfg, method="kmeans", device=dev,
                         engine_cfg=EngineConfig(kmeans_shared_fit=True,
                                                 kmeans_warm_start=True)
                         ) as warm_eng:
        first = results(submit_together(warm_eng, scenes, "kmeans"))
        second = results(submit_together(warm_eng, scenes, "kmeans"))
    want2, _ = turbo.kmeans_scenes_turbo_batch(*kargs, **sk,
                                               init_cents=cents)
    want2 = want2.cpu().numpy()
    check(all(np.array_equal(first[i], want[i])
              and np.array_equal(second[i], want2[i])
              for i in range(BATCH)),
          "KMeans warm start equals the direct chain (init_cents)")
    print("serving [kmeans]: per-scene fits, the shared fit and the warm "
          "start each bit-equal to the direct program", flush=True)

    # ---- 19f. the rule overflow reroute on the noise scene
    noise = np.random.default_rng(SEED + 3).integers(
        0, 256, (1, BANDS, HEIGHT, WIDTH), dtype=np.uint8)
    noise_lut = stretch_stats_batch(noise)[0]
    before = eng.stats()["rule_overflow_reroutes"]
    got, launches["rule_based, rerouted"] = counted(
        lambda: eng.classify(noise[0], timeout=600, method="rule_based"))
    reroutes = eng.stats()["rule_overflow_reroutes"] - before
    want = turbo.rule_based_scenes_turbo(noise[0], noise_lut[0], cfg,
                                         device=dev).cpu().numpy()
    check(reroutes == 1 and np.array_equal(got, want),
          f"the noise scene is rerouted once ({reroutes}) and equals "
          f"rule_based_scenes_turbo")
    print("serving [rule_based]: the noise scene rerouted "
          f"({reroutes}), equal to rule_based_scenes_turbo", flush=True)

    # ---- 19g. a forest past GEMM_MAX_LEAVES on the batched program
    deep_fields = deep_forest_fields(stack0)
    deep = flat_forest_from_numpy(deep_fields)
    leaves = n_leaves(deep)
    deep_gf = _gemm_for(deep, 19)
    check(leaves > GEMM_MAX_LEAVES and deep_gf.path.is_sparse,
          f"the deep forest ({leaves} leaves) is past the cap, its path "
          f"sparse")
    with InferenceEngine(deep, 12, cfg=cfg, device=dev) as deep_eng:
        check(deep_eng.stats()["gemm_forest"] is True,
              "the engine holds the deep forest's GEMM form")
        t0 = time.perf_counter()
        fb, launches["random_forest, past the cap"] = counted(
            lambda: results(submit_together(deep_eng, scenes[:2],
                                            "random_forest")))
        fb_s = time.perf_counter() - t0
        fb_sizes = deep_eng.stats()["batch_sizes"]
    deep_d = GemmForest(*(t.to(dev) for t in deep_gf))
    for i in range(2):
        want = turbo.classify_scenes_turbo(
            scenes[i:i + 1], luts[i:i + 1], deep_d, cfg,
            stretch_hists=hists[i:i + 1], device=dev)[0].cpu().numpy()
        st = turbo.hierarchical_stack_turbo_cm(scenes_d[i], luts_d[i], cfg,
                                               device=dev)
        walked = walk_labels(deep_fields, st.reshape(19, -1).T).reshape(
            HEIGHT, WIDTH).to(torch.uint8).cpu().numpy()
        check(np.array_equal(fb[i], want) and np.array_equal(fb[i], walked)
              and len(np.unique(want)) > 1,
              f"past the cap, scene {i} equals its direct program at B = 1 "
              f"and the plain walk over its stack on the card")
    print(f"serving [past the cap]: {leaves} leaves, 2 scenes ({fb_sizes}) "
          f"in {fb_s:.3f} s, bit-equal to the direct program and the "
          f"plain walk", flush=True)
    out["past_cap_s_2_scenes"] = fb_s

    # ---- 19h. launches of one supervised and one rule batch
    for m in ("random_forest", "rule_based"):
        (maps, plain), launches[m] = counted(lambda: plain_calls(
            lambda: results(submit_together(eng, scenes, m))))
        check(not any(plain.values()), f"{m}: no plain version ran: {plain}")
    rf = launches["random_forest"]
    check(rf["lut_hist"] == 1 and rf["forest_labels"] == 1
          and all(n == 0 for k, n in rf.items()
                  if k not in ("lut_hist", "forest_labels")),
          f"a supervised batch launches lut_hist and forest_labels once: "
          f"{rf}")
    deep_rf = launches["random_forest, past the cap"]
    check(deep_rf["lut_hist"] == 1 and deep_rf["forest_labels"] == 1
          and launches["rule_based, rerouted"]["cc_labels"] > 0,
          f"past the cap a 2-scene batch launches lut_hist and forest_labels "
          f"once each, and the reroute labels components with cc_labels: "
          f"{launches}")
    print(f"serving: launches of one {BATCH}-scene batch (KMeans: {BATCH} "
          f"single-scene programs), of the rerouted noise scene and of 2 "
          f"scenes with the forest past the cap: {launches}", flush=True)

    # ---- 19i. HTTP: healthz, npy and GeoTIFF round trips, metrics
    httpd = make_server(eng, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = "http://%s:%d" % httpd.server_address[:2]
    try:
        hz = client.healthz(base)
        check(hz["ok"] and hz["backend"] == "cuda",
              f"/healthz reports the card: {hz}")
        ref = eng.classify(scenes[0], timeout=300)
        with client.ServingSession(base) as sess:
            for _ in range(3):
                got = sess.classify_array(scenes[0])
            npy_timing = sess.last_timing
        check(np.array_equal(got, ref), "npy round trip equals the engine")
        meta = GeoMeta(transform=(30.0, 0.0, 500000.0, 0.0, -30.0,
                                  4000000.0), crs="EPSG:32650")
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "scene.tif")
            tiff.write_tiff(src, scenes[0], meta)
            with open(src, "rb") as f:
                body = f.read()
            for _ in range(3):
                req = urllib.request.Request(
                    f"{base}/v1/classify", data=body, method="POST",
                    headers={"Content-Type": "image/tiff"})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    payload = resp.read()
                    tif_timing = {k: float(resp.headers[h]) for k, h in (
                        ("decode_ms", "X-Decode-Ms"),
                        ("engine_ms", "X-Engine-Ms"),
                        ("encode_ms", "X-Encode-Ms"))}
            dst = os.path.join(tmp, "map.tif")
            with open(dst, "wb") as f:
                f.write(payload)
            arr, info = tiff.read_tiff(dst)
        check(np.array_equal(arr[0], ref) and info.meta.crs == meta.crs
              and info.meta.transform == meta.transform,
              "GeoTIFF round trip equals the engine, geo metadata kept")
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        check(f"rsseg_requests_total {eng.stats()['requests']}" in metrics,
              "/metrics counts the requests")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    print(f"serving HTTP: healthz {hz}; npy decode/engine/encode ms "
          f"{npy_timing}; GeoTIFF {tif_timing}; {smi}", flush=True)
    out["http_npy_ms"] = npy_timing
    out["http_tiff_ms"] = tif_timing

    # ---- 19j. latency of 8 concurrent requests, engine against direct
    direct_ms = {}
    hh_d = torch.from_numpy(hists).to(dev)
    programs = {
        "random_forest": lambda: turbo.classify_scenes_turbo(
            scenes_d, luts_d, gf, cfg, stretch_hists=hh_d, device=dev),
        "rule_based": lambda: turbo.rule_based_scenes_turbo_batch(
            scenes_d, luts_d, cfg, stretch_hists=hh_d, device=dev),
        "kmeans": lambda: [turbo.kmeans_scenes_turbo_batch(
            scenes_d[i:i + 1], luts_d[i:i + 1], KMEANS_K, cfg, KMEANS_SEED,
            KMEANS_STRIDE, stretch_hists=hh_d[i:i + 1], device=dev)
            for i in range(BATCH)]}
    lat_out = {}
    for m in SERVING_METHODS:
        lat, walls, sizes = concurrent_latency(eng, list(scenes), m)
        direct_s, _ = wall_s(programs[m])
        direct_ms[m] = direct_s * 1e3 / BATCH
        engine_ms = statistics.median(walls) * 1e3 / BATCH
        p50, p90 = np.percentile(lat, (50, 90)) * 1e3
        lat_out[m] = {"p50_ms": float(p50), "p90_ms": float(p90),
                      "engine_ms_per_scene": engine_ms,
                      "direct_ms_per_scene": direct_ms[m],
                      "host_stats_share": stats_ms / BATCH / engine_ms,
                      "batch_sizes": sizes}
        print(f"serving latency [{m}], {BATCH} concurrent {HEIGHT} x "
              f"{WIDTH} requests x {LATENCY_ROUNDS} rounds: p50 {lat_out[m]['p50_ms']:.3f} ms, "
              f"p90 {lat_out[m]['p90_ms']:.3f} ms; engine "
              f"{engine_ms:.3f} ms per scene against the direct program's "
              f"{direct_ms[m]:.3f} (inputs resident); host stretch stats "
              f"{stats_ms / BATCH:.3f} ms per scene "
              f"({lat_out[m]['host_stats_share']:.3f} of the engine's); "
              f"batch sizes {sizes}; {smi}", flush=True)
    out["latency"] = lat_out
    eng.shutdown()
    for row in rows:
        row["launches_serving"] = {m: launches[m].get(row["name"], 0)
                                   for m in launches}
    return out


ROI_PER_CLASS = 200                # labelled pixels a class of the rule map
# each driver's kernels and how often it must launch each; every other
# kernel, never. The rule classifier labels four masks' components.
FILE_LAUNCHES = {
    "stage1_identity": {},
    "stage1_gcps": {"fused_calibrate_stretch": 1},
    "stage2": {"fused_spectral_indices": 1, "glcm_grid": 1},
    "stage3_rule_based": {"cc_labels": 4},
    "stage3_kmeans": {"lloyd_pass": "2 an iteration"},
    "stage3_random_forest": {"forest_labels": 1},
    "stage4": {},
    "stage4_kmeans": {},
}


def file_gcps(h: int, w: int) -> list:
    """Three GCP pairs of a 0.01 rad rotation plus a (1.5, -2) shift, at
    three corners of an h x w scene."""
    rot = np.array([[np.cos(0.01), -np.sin(0.01)],
                    [np.sin(0.01), np.cos(0.01)]])
    return [((x, y), tuple(rot @ (x, y) + (1.5, -2.0)))
            for x, y in ((0.0, 0.0), (w - 1.0, 5.0), (5.0, h - 1.0))]


def file_sizes(root: str) -> dict:
    """Bytes of every file under ``root``, by path relative to it."""
    return {os.path.relpath(os.path.join(d, f), root):
            os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(root) for f in sorted(files)}


def file_pipeline_phase(scene0: np.ndarray, dev, smi: str, rows) -> dict:
    """Phase 20: the four-stage file pipeline on scene 0 written as a
    GeoTIFF, the drivers a user runs (``run_preprocessing_stage`` at the
    identity and with GCPs, ``run_feature_extraction_stage``, and the
    compute-and-write parts of stages 3 and 4, ``classify_and_write`` per
    method and ``ClassificationEvaluator.evaluate_and_report``: the
    card's machine has no matplotlib for the PNGs): launch counts and
    plain calls around each driver, card against the CPU (the forest's
    map against ``gemm_labels_cm`` of the same forest on the card), host
    wall times and artifact sizes. Adds each kernel's launches to its
    row."""
    import filecmp
    import shutil
    import tempfile

    from rs_image_segmentation_tpu_torch.io.artifacts import (
        load_features, normalize_features_structure)
    from rs_image_segmentation_tpu_torch.io.tiff import read_tiff, write_tiff
    from rs_image_segmentation_tpu_torch.models.forest import forest_to_gemm
    from rs_image_segmentation_tpu_torch.ops.kernels import gemm_labels_cm
    from rs_image_segmentation_tpu_torch.pipeline import (
        classify, evaluate, features, preprocess)
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        synthetic_geometa)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        h, w = scene0.shape[1:]
        raw = os.path.join(tmp, "scene0.tif")
        write_tiff(raw, scene0, synthetic_geometa((h, w)))
        roots = {"card": os.path.join(tmp, "card"),
                 "cpu": os.path.join(tmp, "cpu")}
        devs = {"card": dev, "cpu": "cpu"}

        def at(side, *parts):
            return os.path.join(roots[side], *parts)

        pkl = at("card", "features", "all_features_and_metadata.pkl")
        roi_path = os.path.join(tmp, "labeled_roi.tif")
        drivers = {
            "stage1_identity": lambda side="card":
                preprocess.run_preprocessing_stage(
                    raw, at(side, "stage1_identity.tif"), device=devs[side]),
            "stage1_gcps": lambda side="card":
                preprocess.run_preprocessing_stage(
                    raw, at(side, "stage1_gcps.tif"), gcps=file_gcps(h, w),
                    device=devs[side]),
            # both sides read the card's artifact of the stage before
            "stage2": lambda side="card":
                features.run_feature_extraction_stage(
                    at("card", "stage1_identity.tif"), at(side, "features"),
                    vis=False, device=devs[side]),
            **{f"stage3_{m}": (lambda side="card", m=m:
                               classify.classify_and_write(
                                   pkl, m, at(side, "classes"),
                                   labeled_roi_file=roi_path,
                                   device=devs[side])[0])
               for m in ("rule_based", "kmeans", "random_forest")},
            **{name: (lambda side="card", m=m, name=name:
                      evaluate.ClassificationEvaluator(
                          device=devs[side]).evaluate_and_report(
                          at("card", "classes",
                             f"{m}_classification_map.tif"),
                          roi_path, at(side, name)))
               for name, m in (("stage4", "rule_based"),
                               ("stage4_kmeans", "kmeans"))},
        }
        card, launches = {}, {}
        for name, fn in drivers.items():
            if name == "stage3_kmeans":
                # the labelled ROI of the random forest and stage 4: a
                # seeded sample of the rule map, class 0 labelled 5
                rule = card["stage3_rule_based"]
                rng = np.random.default_rng(SEED + 40)
                roi = np.zeros((h, w), np.uint8)
                for c in np.unique(rule):
                    where = np.flatnonzero(rule.reshape(-1) == c)
                    pick = rng.choice(where, min(ROI_PER_CLASS, where.size),
                                      replace=False)
                    roi.reshape(-1)[pick] = c if c else 5
                write_tiff(roi_path, roi[None], synthetic_geometa((h, w)))
            (card[name], calls), launches[name] = counted(
                lambda fn=fn: plain_calls(fn))
            want = FILE_LAUNCHES[name]
            check(all(n > 0 and n % 2 == 0 if want.get(k) == "2 an iteration"
                      else n == want.get(k, 0)
                      for k, n in launches[name].items()),
                  f"{name}: launches {launches[name]}, want {want} and no "
                  f"other kernel")
            check(not any(calls.values()),
                  f"{name}: no plain version on the card: {calls}")
            print(f"file pipeline [{name}]: launches "
                  f"{ {k: n for k, n in launches[name].items() if n} }, "
                  f"no plain version", flush=True)

        # ---- what came out, on the card
        r1 = card["stage1_identity"]
        check(r1.data.dtype == np.uint8 and r1.shape == scene0.shape
              and isinstance(r1.data, np.ndarray), "stage 1 Raster uint8")
        s1, info1 = read_tiff(at("card", "stage1_identity.tif"))
        check(s1.dtype == np.float32 and np.array_equal(s1, r1.data)
              and info1.meta.transform == synthetic_geometa().transform,
              "the stage-1 file holds the levels as f32 with the input's "
              "georeferencing")
        raw_pkl = open(pkl, "rb").read()
        check(b"torch" not in raw_pkl, "the stage-2 pickle holds no tensor")
        flat_card = normalize_features_structure(load_features(pkl))
        check(flat_card["height"] == h and flat_card["width"] == w
              and flat_card["hierarchical_all"].shape == (h, w, 19)
              and all(np.isfinite(v).all() for v in flat_card.values()
                      if isinstance(v, np.ndarray)),
              "stage-2 artifacts: (H, W, 19) finite stacks and metadata")
        three_file, _ = read_tiff(at(
            "card", "classes", "rule_based_three_class_evaluation.tif"))
        three = classify.create_three_class_map(
            card["stage3_rule_based"], "rule_based", device=dev)
        check(np.array_equal(three_file[0], three.cpu().numpy()),
              "rule_based's three-class GeoTIFF equals "
              "create_three_class_map of its map")
        check(set(np.unique(card["stage3_random_forest"]).tolist())
              <= {1, 2, 3, 4, 5}, "forest labels are ROI classes")

        # ---- the forest's map against the plain version of its kernel on
        # the card: the same training rows give the same forest (the
        # cached model, or the seeded trainer where sklearn is absent)
        fa = flat_card["hierarchical_all"]
        x, y = classify.prepare_training_samples(
            fa, classify.load_roi_raster(roi_path, (h, w)))
        forest, _ = classify.train_or_load_forest(
            x, y, at("card", "classes", "random_forest_model.joblib"))
        x_cm = torch.nan_to_num(torch.from_numpy(fa).to(
            dev, torch.float32).reshape(h * w, -1)).T.contiguous()
        plain_rf = gemm_labels_cm(forest_to_gemm(forest, fa.shape[-1]),
                                  x_cm).reshape(h, w).cpu().numpy()
        agree = {"random_forest": float(np.mean(
            card["stage3_random_forest"] == plain_rf))}
        check(np.array_equal(card["stage3_random_forest"], plain_rf),
              f"stage 3 [random_forest]: the map equals gemm_labels_cm of "
              f"its forest on the card ({agree['random_forest']} agree)")

        # ---- the same drivers on the CPU but the forest's, whose plain
        # GEMM over some 15 000 leaves at 600 x 600 takes minutes there
        t0 = time.perf_counter()
        cpu = {name: fn("cpu") for name, fn in drivers.items()
               if name != "stage3_random_forest"}
        cpu_s = time.perf_counter() - t0
        check(filecmp.cmp(at("card", "stage1_identity.tif"),
                          at("cpu", "stage1_identity.tif"), shallow=False),
              "stage 1 at the identity: the card's file byte-equal to the "
              "CPU's")
        g_card, _ = read_tiff(at("card", "stage1_gcps.tif"))
        g_cpu, _ = read_tiff(at("cpu", "stage1_gcps.tif"))
        gcp_equal = float(np.mean(g_card == g_cpu))
        check(gcp_equal >= 0.999 and np.abs(g_card - g_cpu).max() <= 1,
              f"stage 1 with GCPs: card vs CPU {gcp_equal} equal, within "
              f"one level")
        (feats, hier), (cfeats, chier) = card["stage2"], cpu["stage2"]
        fc, fh = dict(flat_features(feats)), dict(flat_features(cfeats))
        check(sorted(fc) == sorted(fh), "stage 2: the same feature keys")
        worst = {}
        for key, ref in fh.items():
            got = fc[key]
            bnd = STAGE2_LOOSE.get(key.split("[")[0], 1e-5)
            if isinstance(bnd, tuple):
                worst[key] = 1.0 - float(np.mean(got == ref))
                check(worst[key] <= 1.0 - bnd[1],
                      f"stage 2 [{key}]: {1 - worst[key]} equal")
            else:
                worst[key] = float(np.abs(got - ref).max()) if got.size \
                    else 0.0
                check(worst[key] <= bnd, f"stage 2 [{key}]: max err "
                      f"{worst[key]} > {bnd}")
        for key in chier:
            err = float(np.abs(hier[key] - chier[key]).max())
            check(err <= 1e-3, f"stage 2 [{key}] max err {err}")
        check(sorted(normalize_features_structure(load_features(at(
            "cpu", "features", "all_features_and_metadata.pkl"))))
              == sorted(flat_card), "stage 2: the same pickle keys")
        agree["rule_based"] = float(np.mean(card["stage3_rule_based"]
                                            == cpu["stage3_rule_based"]))
        check(agree["rule_based"] >= 0.999, f"stage 3 [rule_based]: card vs "
              f"CPU {agree['rule_based']}")
        ev = evaluate.ClassificationEvaluator(device=dev)
        truth = card["stage3_rule_based"].astype(np.int64) + 1
        kappa = {s: mapped_kappa(ev, run["stage3_kmeans"], truth)
                 for s, run in (("card", card), ("cpu", cpu))}
        check(abs(kappa["card"] - kappa["cpu"]) <= CARD_CPU_KAPPA_MARGIN,
              f"stage 3 [kmeans]: mapped kappa card {kappa['card']} vs CPU "
              f"{kappa['cpu']}")
        for name in ("stage4", "stage4_kmeans"):
            (m_card, *_), (m_cpu, *_) = card[name], cpu[name]
            reports = [open(at(side, name, "evaluation_report.txt")).read()
                       for side in ("card", "cpu")]
            check(m_card["labels"] == m_cpu["labels"]
                  and np.array_equal(m_card["confusion_matrix"],
                                     m_cpu["confusion_matrix"])
                  and m_card["overall_accuracy"] == m_cpu["overall_accuracy"]
                  and m_card["kappa"] == m_cpu["kappa"]
                  and m_card["per_class"] == m_cpu["per_class"]
                  and reports[0] == reports[1],
                  f"{name}: the card's metrics and report equal the CPU's")
        m_rule, m_km = card["stage4"][0], card["stage4_kmeans"][0]
        # the ROI is a sample of the rule map itself, so stage 4 on that map
        # checks the ROI's round trip and the cluster mapping (a perfect
        # score); the KMeans map is the comparison that can differ
        check(m_rule["overall_accuracy"] == 1.0 and m_rule["kappa"] == 1.0
              and m_km["overall_accuracy"] < 1.0,
              f"stage 4: the rule map scores 1.0 against its own sample, "
              f"the KMeans map less: {m_rule['overall_accuracy']}, "
              f"{m_km['overall_accuracy']}")
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
        print(f"file pipeline, card vs CPU (the CPU's drivers in "
              f"{cpu_s:.1f} s): stage 1 file byte-equal, GCP route "
              f"{gcp_equal:.6f} equal; stage 2 within the CPU tests' "
              f"bounds, largest {[(k, float(f'{v:.3g}')) for k, v in top]}; "
              f"stage 3 rule {agree['rule_based']:.6f}, forest against "
              f"gemm_labels_cm on the card {agree['random_forest']:.6f}, "
              f"KMeans mapped kappa "
              f"{kappa['card']:.4f} / {kappa['cpu']:.4f}; stage 4 equal "
              f"(rule map OA {m_rule['overall_accuracy']:.4f}, kappa "
              f"{m_rule['kappa']:.4f}; KMeans map OA "
              f"{m_km['overall_accuracy']:.4f}, kappa {m_km['kappa']:.4f})",
              flush=True)

        # ---- host wall time of each driver on the card
        wall = {}
        for name, fn in drivers.items():
            wall[name] = wall_s(fn, reps=3)[0]
        sizes = file_sizes(roots["card"])
        print(f"file pipeline wall s (median of 3 after a warm-up, "
              f"{h} x {w}): "
              f"{ {k: round(v, 4) for k, v in wall.items()} }; artifacts "
              f"{sum(sizes.values())} bytes; {smi}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        row["launches_file_pipeline"] = {name: launches[name].get(
            row["name"], 0) for name in launches}
    return {"launches": launches, "wall_s": wall, "artifact_bytes": sizes,
            "stage1_gcp_card_cpu_equal": gcp_equal,
            "stage2_largest_card_cpu_err": dict(top),
            "stage3_card_cpu_agreement": agree,
            "stage3_kmeans_mapped_kappa": kappa,
            "stage4_overall_accuracy": m_rule["overall_accuracy"],
            "stage4_kappa": m_rule["kappa"],
            "stage4_kmeans_overall_accuracy": m_km["overall_accuracy"],
            "stage4_kmeans_kappa": m_km["kappa"], "cpu_drivers_s": cpu_s}


TOOLS_SCENES = 10                  # one turbo sub-batch of 8, one of 2
TOOLS_REPS = 3                     # wall times: median of 3 after a warm-up
SERVE_START_S = 300                # the server's start, its build and warm-up
# each batch route's kernels and how often it must launch each; every
# other kernel, never: the turbo branch launches both of its kernels once
# a sub-batch (a forest past the leaf cap too), the streamed branch each
# stage kernel and the forest once a scene (16-bit DNs: the
# calibrate-stretch route)
TOOLS_LAUNCHES = {
    "batch_turbo": {"lut_hist": 2, "forest_labels": 2},
    "batch_streamed": {"fused_calibrate_stretch": 2,
                       "fused_spectral_indices": 2, "glcm_grid": 2,
                       "forest_labels": 2},
    "batch_past_cap": {"lut_hist": 1, "forest_labels": 1},
}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tools_cli_phase(dev, cfg, scenes, flat_forest, depth, gf, stack0, smi,
                    rows) -> dict:
    """Phase 21: the tools and the rest of the CLI on the card, the entry
    points a user runs: ``tools.batch.run_batch_workflow`` (turbo branch
    on ten 600 x 600 GeoTIFFs, streamed branch on two 16-bit ones, a
    forest past the leaf cap), ``rs-seg-torch-batch``,
    ``rs-seg-torch-classify-large`` (random forest at 6000^2, KMeans,
    rules and a resumed checkpoint at 1260^2), ``tools.supervised`` on
    scene 0's stack, ``rs-seg-torch-serve`` as a subprocess, and
    ``utils`` (``device_trace`` with ``utils.traceview``, ``StageTimer``,
    ``checked``). Launch counts and plain calls around each route,
    each against its library call or its ``device="cpu"`` run, and host
    wall times. Adds each kernel's launches to its row."""
    import filecmp
    import shutil
    import signal
    import tempfile

    from rs_image_segmentation_tpu_torch.cli import stages as cli_stages
    from rs_image_segmentation_tpu_torch.core.config import (
        CalibrationConfig, ForestConfig)
    from rs_image_segmentation_tpu_torch.io.tiff import read_tiff, write_tiff
    from rs_image_segmentation_tpu_torch.models.forest import (
        GemmForest, _gemm_for, flat_forest_from_numpy)
    from rs_image_segmentation_tpu_torch.models.serialize import (
        save_flat_forest)
    from rs_image_segmentation_tpu_torch.ops.kernels import (forest_labels,
                                                             gemm_labels_cm)
    from rs_image_segmentation_tpu_torch.pipeline import large_scene as ls
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
        ClassificationEvaluator)
    from rs_image_segmentation_tpu_torch.pipeline.features import (
        hierarchical_stack_fused)
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        build_stretch_lut, build_stretch_stats, preprocess_bands)
    from rs_image_segmentation_tpu_torch.serving import client
    from rs_image_segmentation_tpu_torch.tools import (batch, sampling,
                                                       supervised)
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        deep_forest_fields, rule_labels, synthetic_geometa, synthetic_scenes)
    from rs_image_segmentation_tpu_torch.utils import guards, traceview
    from rs_image_segmentation_tpu_torch.utils.timing import (StageTimer,
                                                              device_trace)
    from tests.forest_walk_ref import walk_labels

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    cal = CalibrationConfig()
    out, launches, wall = {}, {}, {}

    def at(*parts):
        return os.path.join(tmp, *parts)

    def run_counted(name, fn):
        """``fn()`` with launches and plain calls counted around it; no
        plain version may run."""
        (res, calls), launches[name] = counted(lambda: plain_calls(fn))
        check(not any(calls.values()), f"{name}: no plain version on the "
              f"card: {calls}")
        return res

    def want_launches(name):
        want = TOOLS_LAUNCHES[name]
        check(all(n == want.get(k, 0) for k, n in launches[name].items()),
              f"{name}: launches {launches[name]}, want {want} and no other "
              f"kernel")

    def band0(path):
        return read_tiff(path)[0][0]

    def direct_b1(scene, forest=gf):
        """The supervised program on one scene at B = 1 with the serving
        engine's host inputs (the LUT and the host histogram)."""
        lut, _, hist = build_stretch_stats(scene, cal.gains, cal.biases)
        return turbo.classify_scenes_turbo(
            scene[None], lut[None].astype(np.uint8), forest, cfg,
            stretch_hists=hist[None], device=dev)[0].cpu().numpy()

    try:
        # ---- 21a. run_batch_workflow, turbo branch: ten GeoTIFFs
        ten = np.concatenate([scenes, synthetic_scenes(
            TOOLS_SCENES - len(scenes), HEIGHT, WIDTH, seed=SEED + 50)])
        meta = synthetic_geometa((HEIGHT, WIDTH))
        os.makedirs(at("in"))
        paths, rois = [], []
        rng = np.random.default_rng(SEED + 51)
        for i, s in enumerate(ten):
            paths.append(at("in", f"scene{i}.tif"))
            write_tiff(paths[-1], s, meta)
            roi = np.zeros((HEIGHT, WIDTH), np.int16)
            roi[::15, ::15] = rng.integers(1, 5, roi[::15, ::15].shape)
            rois.append(at("in", f"roi{i}.npy"))
            np.save(rois[-1], roi)

        def batch_turbo():
            return batch.run_batch_workflow(paths, flat_forest, depth,
                                            at("batch"), roi_paths=rois,
                                            cfg=cfg, device=dev)

        res = run_counted("batch_turbo", batch_turbo)
        want_launches("batch_turbo")
        maps = [band0(r["class_map"]) for r in res]
        bad = [i for i, s in enumerate(ten)
               if not np.array_equal(maps[i], direct_b1(s))]
        check(not bad, f"batch turbo: each map bit-equal to "
              f"classify_scenes_turbo of its scene at B = 1; differ {bad}")
        ev = ClassificationEvaluator(device=dev)
        for i, r in enumerate(res):
            m, *_ = ev.evaluate_and_report(r["class_map"], rois[i],
                                           at("stage4", str(i)),
                                           map_clusters=False)
            check(m["overall_accuracy"] == r["overall_accuracy"]
                  and m["kappa"] == r["kappa"], f"batch turbo scene {i}: OA "
                  f"and kappa equal stage 4's on the same map")
        print(f"tools [batch turbo]: {TOOLS_SCENES} scenes, launches "
              f"{ {k: n for k, n in launches['batch_turbo'].items() if n} }, "
              f"no plain version; each map bit-equal to its B = 1 program "
              f"(host stretch stats), OA/kappa equal stage 4's "
              f"(scene 0: {res[0]['overall_accuracy']:.4f} / "
              f"{res[0]['kappa']:.4f})", flush=True)
        wall["batch_turbo"] = wall_s(batch_turbo, TOOLS_REPS)[0]

        # ---- 21b. the streamed branch: two 16-bit scenes; past the cap
        paths16 = []
        for i in range(2):
            paths16.append(at("in", f"dn16_{i}.tif"))
            write_tiff(paths16[-1], dn16(ten[i]), meta)

        def batch_streamed(device=dev, where="streamed"):
            return batch.run_batch_workflow(paths16, flat_forest, depth,
                                            at(where), cfg=cfg,
                                            device=device)

        res16 = run_counted("batch_streamed", batch_streamed)
        want_launches("batch_streamed")
        cpu16 = batch_streamed("cpu", "streamed_cpu")
        agree16 = [float(np.mean(band0(a["class_map"])
                                 == band0(b["class_map"])))
                   for a, b in zip(res16, cpu16)]
        check(all(a >= 0.999 for a in agree16), f"batch streamed: card "
              f"against CPU {agree16}")
        deep_fields = deep_forest_fields(stack0)
        deep = flat_forest_from_numpy(deep_fields)
        deep_gf = GemmForest(*(t.to(dev) for t in _gemm_for(deep, 19)))
        check(deep_gf.path.is_sparse, "the deep forest is past the cap")

        def batch_past_cap():
            return batch.run_batch_workflow(paths[:2], deep, 12, at("deep"),
                                            cfg=cfg, device=dev)

        res_deep = run_counted("batch_past_cap", batch_past_cap)
        want_launches("batch_past_cap")
        for i in range(2):
            want = direct_b1(ten[i], deep_gf)
            lut = build_stretch_lut(ten[i], cal.gains, cal.biases)
            st = turbo.hierarchical_stack_turbo_cm(
                ten[i], lut.astype(np.uint8), cfg, device=dev)
            walked = walk_labels(deep_fields, st.reshape(19, -1).T).reshape(
                HEIGHT, WIDTH).cpu().numpy().astype(np.uint8)
            got = band0(res_deep[i]["class_map"])
            check(np.array_equal(got, want) and np.array_equal(got, walked)
                  and len(np.unique(want)) > 1,
                  f"past the cap, scene {i}: equal to its direct program at "
                  f"B = 1 and to the plain walk over its stack on the card")
        print(f"tools [batch streamed]: 2 16-bit scenes, launches "
              f"{ {k: n for k, n in launches['batch_streamed'].items() if n} }"
              f", card against CPU {agree16}; past the cap (20 480 leaves) "
              f"launches {({k: n for k, n in launches['batch_past_cap'].items() if n})}"
              f", equal to the direct route", flush=True)
        wall["batch_streamed"] = wall_s(batch_streamed, TOOLS_REPS)[0]
        wall["batch_past_cap"] = wall_s(batch_past_cap, TOOLS_REPS)[0]

        # ---- 21c. rs-seg-torch-batch with an npz forest
        npz = at("forest.npz")
        save_flat_forest(npz, flat_forest, depth)

        def batch_cli():
            cli_stages.batch_classify(paths + ["--model", npz, "--rois",
                                               *rois, "--output-dir",
                                               at("batch_cli"), "--device",
                                               str(dev)])

        run_counted("batch_cli", batch_cli)
        check(launches["batch_cli"] == launches["batch_turbo"],
              f"rs-seg-torch-batch launches what the workflow does: "
              f"{launches['batch_cli']}")
        names = sorted(os.listdir(at("batch")))
        check(names == sorted(os.listdir(at("batch_cli"))) and all(
            filecmp.cmp(at("batch", n), at("batch_cli", n), shallow=False)
            for n in names), "rs-seg-torch-batch: every file byte-equal to "
              "the workflow's")
        print(f"tools [rs-seg-torch-batch]: {len(names)} files byte-equal "
              f"to the workflow's", flush=True)
        wall["batch_cli"] = wall_s(batch_cli, TOOLS_REPS)[0]

        # ---- 21d. rs-seg-torch-classify-large
        big = reflected_tiling(scenes[0], LARGE)
        big_path = at("in", "big.tif")
        write_tiff(big_path, big, synthetic_geometa((LARGE, LARGE)))
        gf_npz = _gemm_for(flat_forest, 19)

        def large_cli(scene_path, method, output, *extra):
            return lambda: cli_stages.classify_large(
                ["--scene", scene_path, "--raw", "--method", method,
                 "--model", npz, "--output", output, "--device", str(dev),
                 *extra])

        def large_rf_library():
            pre, hists = ls.preprocess_large(big, cal, return_hist=True,
                                             device=dev)
            return ls.classify_large_scene(pre, gf_npz, hists=hists,
                                           device=dev)

        rf_cli = large_cli(big_path, "random_forest", at("large_rf.tif"))
        run_counted("classify_large_rf", rf_cli)
        want_big, lib_launches = counted(large_rf_library)
        check(np.array_equal(band0(at("large_rf.tif")),
                             want_big.astype(np.uint8)),
              f"classify_large --raw random_forest at {LARGE}^2: the map "
              f"read back equals preprocess_large + classify_large_scene")
        check(launches["classify_large_rf"] == lib_launches
              and lib_launches["forest_labels"] == -(-LARGE // LARGE_TILE),
              f"classify_large launches what its library calls do, "
              f"forest_labels once a tile: {launches['classify_large_rf']} "
              f"/ {lib_launches}")
        del big, want_big
        mid = reflected_tiling(scenes[0], MID)
        mid_path = at("in", "mid.tif")
        write_tiff(mid_path, mid, synthetic_geometa((MID, MID)))
        pre_mid, hists_mid = ls.preprocess_large(mid, cal, return_hist=True,
                                                 device=dev)
        def raw_mid():
            # the CLI's --raw step
            return ls.preprocess_large(mid, cal, return_hist=True,
                                       device=dev)

        def kmeans_library():
            return ls.kmeans_large_scene(raw_mid()[0], 7, device=dev)

        def rule_library():
            pre, hists = raw_mid()
            return ls.rule_based_large_scene(pre, hists=hists, device=dev)

        library = {"kmeans": kmeans_library, "rule_based": rule_library}
        for m, lib in library.items():
            name = f"classify_large_{m}"
            run_counted(name, large_cli(mid_path, m, at(f"{name}.tif")))
            want, lib_launches = counted(lib)
            check(np.array_equal(band0(at(f"{name}.tif")),
                                 want.astype(np.uint8))
                  and launches[name] == lib_launches,
                  f"classify_large --method {m} at {MID}^2 equals its "
                  f"library calls and launches what they do: "
                  f"{launches[name]} / {lib_launches}")
        ck = at("checkpoint")
        try:
            ls.classify_large_scene_resumable(pre_mid, gf_npz, ck,
                                              hists=hists_mid,
                                              interrupt_after=2, device=dev)
            check(False, "classify_large_scene_resumable: interrupt_after=2 "
                  "raises")
        except ls.TileInterrupt:
            pass
        run_counted("classify_large_rf_resumed", large_cli(
            mid_path, "random_forest", at("large_resumed.tif"),
            "--checkpoint-dir", ck))
        want_mid = ls.classify_large_scene(pre_mid, gf_npz, hists=hists_mid,
                                           device=dev)
        mid_tiles = -(-MID // LARGE_TILE)
        check(np.array_equal(band0(at("large_resumed.tif")),
                             want_mid.astype(np.uint8))
              and launches["classify_large_rf_resumed"]["forest_labels"]
              == mid_tiles - 2,
              f"classify_large --checkpoint-dir, interrupted after 2 tiles "
              f"and resumed at {MID}^2: equal to classify_large_scene, the "
              f"resumed run computing only the last tile: "
              f"{launches['classify_large_rf_resumed']}")
        print(f"tools [rs-seg-torch-classify-large]: random_forest at "
              f"{LARGE}^2 (--raw, npz) bit-equal to its library calls, "
              f"launches "
              f"{ {k: n for k, n in launches['classify_large_rf'].items() if n} }"
              f"; at {MID}^2 kmeans, rule_based and the resumed "
              f"checkpoint equal theirs, launches "
              + "; ".join(f"{k} { {a: n for a, n in launches[k].items() if n} }"
                          for k in ("classify_large_kmeans",
                                    "classify_large_rule_based",
                                    "classify_large_rf_resumed")),
              flush=True)
        wall["classify_large_rf_6000"] = wall_s(rf_cli, TOOLS_REPS)[0]
        for m in library:
            wall[f"classify_large_{m}_{MID}"] = wall_s(large_cli(
                mid_path, m, at(f"w_{m}.tif")), TOOLS_REPS)[0]

        def checkpointed():
            shutil.rmtree(at("ck_wall"), ignore_errors=True)
            large_cli(mid_path, "random_forest", at("w_ck.tif"),
                      "--checkpoint-dir", at("ck_wall"))()

        wall[f"classify_large_rf_checkpointed_{MID}"] = wall_s(
            checkpointed, TOOLS_REPS)[0]
        del mid, pre_mid

        # ---- 21e. tools.supervised on scene 0's stack
        fmap = np.ascontiguousarray(stack0.transpose(1, 2, 0))
        flat = stack0.reshape(stack0.shape[0], -1)
        # rule_forest's first draw: 33 pixels, the bundled sample count
        pick = np.random.default_rng(ForestConfig().seed).choice(
            flat.shape[1], 33, replace=False)
        samples = sampling.SampleSet()
        for p, lab in zip(pick, rule_labels(stack0, pick)):
            samples.add(p % WIDTH, p // WIDTH, lab)
        samples_path, feats_path = at("samples.pkl"), at("features.npy")
        samples.save(samples_path)
        np.save(feats_path, fmap)
        x, y = sampling.training_matrix_from_samples(samples_path, fmap)
        forest_s, depth_s = supervised.train_random_forest_from_samples(x, y)
        pred = run_counted("supervised_predict", lambda:
                           supervised.predict_image(forest_s, depth_s, fmap,
                                                    device=dev))
        gf_s = GemmForest(*(t.to(dev) for t in _gemm_for(forest_s, 19)))
        want = gemm_labels_cm(gf_s, torch.from_numpy(flat).to(dev)).reshape(
            HEIGHT, WIDTH).cpu().numpy()
        check(np.array_equal(pred, want) and launches["supervised_predict"][
            "forest_labels"] == 1, f"predict_image equals gemm_labels_cm of "
              f"its forest on the card, one forest_labels launch: "
              f"{launches['supervised_predict']}")
        grid = run_counted("supervised_grid", lambda:
                           supervised.train_random_forest_grid(x, y,
                                                               device=dev))
        grid_cpu = supervised.train_random_forest_grid(x, y, device="cpu")
        check(grid[2] == grid_cpu[2], f"train_random_forest_grid: card "
              f"{grid[2]} against CPU {grid_cpu[2]}")
        rep = run_counted("supervised_report", lambda:
                          supervised.train_with_validation_report(
                              x, y, device=dev))[2]
        rep_cpu = supervised.train_with_validation_report(x, y,
                                                          device="cpu")[2]
        check(rep["accuracy"] == rep_cpu["accuracy"]
              and rep["kappa"] == rep_cpu["kappa"]
              and np.array_equal(rep["confusion_matrix"],
                                 rep_cpu["confusion_matrix"]),
              f"train_with_validation_report: card {rep['accuracy']}, "
              f"{rep['kappa']} against CPU {rep_cpu['accuracy']}, "
              f"{rep_cpu['kappa']}")

        def write_class_map():
            return supervised.train_predict_and_write(
                samples_path, feats_path, at("supervised"), device=dev)

        written = run_counted("supervised_write", write_class_map)
        check(np.array_equal(np.load(at("supervised", "class_map.npy")),
                             pred) and np.array_equal(written, pred),
              "train_predict_and_write's class_map.npy equals predict_image")
        print(f"tools [supervised]: 33 samples, {forest_s.feature.shape[0]} "
              f"trees, predict_image equal to gemm_labels_cm on the card; "
              f"grid {grid[2]} equal to the CPU's; validation accuracy "
              f"{rep['accuracy']:.4f}, kappa {rep['kappa']:.4f} equal to the "
              f"CPU's; class_map.npy equal", flush=True)
        wall["supervised_predict_image"] = wall_s(
            lambda: supervised.predict_image(forest_s, depth_s, fmap,
                                             device=dev), TOOLS_REPS)[0]
        wall["supervised_grid"] = wall_s(
            lambda: supervised.train_random_forest_grid(x, y, device=dev),
            TOOLS_REPS)[0]
        wall["supervised_report"] = wall_s(
            lambda: supervised.train_with_validation_report(x, y,
                                                            device=dev),
            TOOLS_REPS)[0]
        wall["supervised_write"] = wall_s(write_class_map, TOOLS_REPS)[0]

        # ---- 21f. rs-seg-torch-serve as a subprocess
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        log_path = at("serve.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "rs_image_segmentation_tpu_torch.cli.serve_cli", "--model",
                 npz, "--port", str(port), "--warmup",
                 f"{HEIGHT}x{WIDTH}"], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while True:
                check(proc.poll() is None, "rs-seg-torch-serve exited: "
                      + open(log_path).read()[-2000:])
                try:
                    hz = client.healthz(base, timeout=5)
                    break
                except OSError:
                    check(time.perf_counter() - t0 < SERVE_START_S,
                          "rs-seg-torch-serve did not answer: "
                          + open(log_path).read()[-2000:])
                    time.sleep(0.5)
            serve_start = time.perf_counter() - t0
            check(hz["ok"] and hz["backend"] == "cuda",
                  f"/healthz reports the card: {hz}")
            want0 = direct_b1(ten[0])
            got_npy = client.classify_array(base, ten[0])
            got_tif = client.classify_tiff(base, paths[0])
            check(np.array_equal(got_npy, want0)
                  and np.array_equal(got_tif, want0),
                  "rs-seg-torch-serve: the npy and GeoTIFF maps equal "
                  "classify_scenes_turbo at B = 1")
            wall["serve_npy_request"] = wall_s(
                lambda: client.classify_array(base, ten[0]), TOOLS_REPS)[0]
            wall["serve_tiff_request"] = wall_s(
                lambda: client.classify_tiff(base, paths[0]), TOOLS_REPS)[0]
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = None
        check(rc == 0, f"rs-seg-torch-serve stopped on SIGINT (exit code "
              f"{rc})")
        print(f"tools [rs-seg-torch-serve]: answered /healthz {hz} "
              f"{serve_start:.1f} s after start (build and warm-up "
              f"included); npy and GeoTIFF maps equal the direct program; "
              f"stopped, exit code {rc}", flush=True)

        # ---- 21g. utils: a trace, the stage timer, the guards
        scenes_d = torch.from_numpy(scenes).to(dev)
        luts = np.stack([build_stretch_stats(s, cal.gains, cal.biases)[0]
                         for s in scenes]).astype(np.uint8)
        luts_d = torch.from_numpy(luts).to(dev)
        # a trace of a few short calls has come back empty on the card
        # (tools/kernel_times.py::launched_kernels): spin the card first,
        # and trace again with twice the batches while no lane shows both
        for tries in range(3):
            with device_trace(at("trace", str(tries))):
                if dev.type == "cuda":
                    torch.cuda._sleep(1_000_000)
                for _ in range(1 << tries):
                    turbo.classify_scenes_turbo(scenes_d, luts_d, gf, cfg,
                                                device=dev)
            events = traceview.device_exec_events(at("trace", str(tries)))
            lanes = traceview.device_exec_intervals(at("trace", str(tries)))
            cuda_lane = [k for k, evs in events.items()
                         if k.startswith("cuda:")
                         and any("lut_hist" in n for *_, n in evs)
                         and any("forest_labels" in n for *_, n in evs)]
            if cuda_lane:
                break
        check(bool(cuda_lane), f"device_exec_intervals finds a CUDA lane "
              f"with lut_hist and forest_labels: "
              f"{ {k: len(v) for k, v in lanes.items()} }")
        timer = StageTimer()
        box = {}
        with timer.stage("preamble", sync=box):
            box["parts"] = turbo._preamble(scenes_d, luts_d)
        with timer.stage("stack", sync=box):
            box["stacks"] = turbo._stack_cm_from_parts(*box["parts"], cfg)
        with timer.stage("forest", sync=box):
            box["labels"] = forest_labels(gf, box["stacks"].reshape(
                len(scenes), 19, -1))
        report = timer.report()
        check(all(s in report for s in ("preamble", "stack", "forest",
                                        "total")), report)
        guard = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            x1 = torch.tensor([1.0, 2.0], device=device)
            for label, fn in (
                    ("log(-1)", lambda: torch.log(-x1)),
                    ("1/0", lambda: 1.0 / (x1 - x1)),
                    ("preprocess_bands", lambda: preprocess_bands(
                        ten[0], cal.gains, cal.biases, device=device)),
                    ("preprocess_bands 16-bit", lambda: preprocess_bands(
                        dn16(ten[0]), cal.gains, cal.biases, device=device)),
                    ("hierarchical_stack_fused", lambda:
                     hierarchical_stack_fused(preprocess_bands(
                         ten[0], cal.gains, cal.biases, device=device
                     ).float(), cfg, device=device))):
                try:
                    guards.checked(fn)()
                    guard[(where, label)] = "pass"
                except guards.CheckError as e:
                    guard[(where, label)] = f"raise: {e}"
        check(all(guard[("card", k)].startswith("raise")
                  for k in ("log(-1)", "1/0")), f"checked raises on log(-1) "
              f"and 1/0 on CUDA tensors: {guard}")
        check(all(guard[("card", k)] == guard[("cpu", k)]
                  for _, k in guard), f"checked passes or raises on the card "
              f"exactly where on the CPU: {guard}")
        print(f"tools [utils]: device_trace lanes "
              f"{ {k: len(v) for k, v in lanes.items() if k.startswith('cuda')} }"
              f", lut_hist and forest_labels on {cuda_lane}; StageTimer "
              f"{dict((k, round(v * 1e3, 3)) for k, v in timer.timings.items())}"
              f" ms; checked on the card "
              f"{ {k: v.split(':')[0] for (w, k), v in guard.items() if w == 'card'} }"
              f", the same on the CPU", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"tools wall s (median of {TOOLS_REPS} after a warm-up): "
          f"{ {k: round(v, 4) for k, v in wall.items()} }; {smi}", flush=True)
    for row in rows:
        row["launches_tools_cli"] = {name: launches[name].get(row["name"], 0)
                                     for name in launches}
    out.update(launches=launches, wall_s=wall, batch_streamed_card_cpu=agree16,
               supervised_grid_cv_scores={str(k): v for k, v in
                                          grid[2]["cv_scores"].items()},
               supervised_validation={"accuracy": rep["accuracy"],
                                      "kappa": rep["kappa"]},
               serve_start_s=serve_start, stage_timer_ms={
                   k: v * 1e3 for k, v in timer.timings.items()},
               trace_cuda_lanes=cuda_lane,
               guards={f"{w}: {k}": v for (w, k), v in guard.items()})
    return out


PARALLEL_REPS = 3                  # walls: median of 3 after a warm-up
PARALLEL_TIMEOUT_S = 420           # a spawned rank or rehearsal, at most
# the rehearsal CLI's runs (rs-seg-torch-multihost-rehearse as a process):
# name -> (arguments, environment, whether it must pass)
REHEARSALS = {
    "gloo_even": (["--nproc", "2", "--backend", "gloo"], {}, True),
    "gloo_uneven": (["--nproc", "2", "--backend", "gloo", "--mode",
                     "uneven"], {}, True),
    "gloo_fail_pid_1": (["--nproc", "2", "--backend", "gloo"],
                        {"RS_SEG_MULTIHOST_FAIL_PID": "1"}, False),
    "nccl_two_ranks": (["--nproc", "2", "--backend", "nccl"], {}, False),
}

def parallel_inputs(tmp: str, dev, cfg, scenes, luts, gf_cpu, flat_forest,
                    depth, stack0) -> dict:
    """Phase 22's inputs, written to ``tmp`` for the spawned ranks (the
    6000^2 scene as a .npy they map) and returned."""
    from rs_image_segmentation_tpu_torch.core.config import CalibrationConfig
    from rs_image_segmentation_tpu_torch.io.tiff import write_tiff
    from rs_image_segmentation_tpu_torch.pipeline import large_scene as ls
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
        build_stretch_stats)
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        synthetic_geometa, synthetic_scenes)
    cal = CalibrationConfig()
    big = reflected_tiling(scenes[0], LARGE)
    pre_big = stretch(big, build_stretch_stats(big, cal.gains, cal.biases)[0]
                      .astype(np.uint8))
    np.save(os.path.join(tmp, "pre_big.npy"), pre_big)
    xk = turbo.kmeans_features(torch.from_numpy(scenes[:1]).to(dev),
                               torch.from_numpy(luts[:1]).to(dev), cfg).cpu()
    inp = {"scenes": scenes, "luts": luts,
           "x_rows": np.ascontiguousarray(stack0.reshape(19, -1).T),
           "xk": np.ascontiguousarray(
               xk[0, :, ::KMEANS_STRIDE].T.numpy()),
           "pre0": stretch(scenes[0], luts[0]),
           "hists": ls.band_histograms_u8(pre_big),
           "depth": np.array(depth),
           **{f"gf_{k}": v.numpy() for k, v in gf_cpu._asdict().items()},
           **{f"ff_{k}": v.numpy() for k, v in
              flat_forest._asdict().items()}}
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    ten = np.concatenate([scenes, synthetic_scenes(
        TOOLS_SCENES - len(scenes), HEIGHT, WIDTH, seed=SEED + 50)])
    meta = synthetic_geometa((HEIGHT, WIDTH))
    paths = {"u8": [], "u16": []}
    os.makedirs(os.path.join(tmp, "in"))
    for i, s in enumerate(ten):
        paths["u8"].append(os.path.join(tmp, "in", f"scene{i}.tif"))
        write_tiff(paths["u8"][-1], s, meta)
    for i in range(2):
        paths["u16"].append(os.path.join(tmp, "in", f"dn16_{i}.tif"))
        write_tiff(paths["u16"][-1], dn16(ten[i]), meta)
    with open(os.path.join(tmp, "paths.json"), "w") as f:
        json.dump(paths, f)
    inp.update(pre_big=pre_big, paths=paths)
    return inp


def load_parallel_inputs(tmp: str) -> dict:
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    inp["pre_big"] = np.load(os.path.join(tmp, "pre_big.npy"), mmap_mode="r")
    with open(os.path.join(tmp, "paths.json")) as f:
        inp["paths"] = json.load(f)
    return inp


def parallel_calls(inp: dict, dev, cfg, tmp: str, tag: str):
    """Phase 22's calls over meshes of the current group on ``dev``, each
    run once with its launches and plain calls counted around it (no
    plain version may run): ``(results, launches, calls)``, each keyed by
    call; a result is this rank's block as numpy (the TP, DP-forest and
    large-scene results whole), a call the thunk to time (every rank of
    the group times the same calls in the same order)."""
    from rs_image_segmentation_tpu_torch.models import forest as tforest
    from rs_image_segmentation_tpu_torch.parallel import (forest_tp,
                                                          multihost, sharded,
                                                          spatial)
    from rs_image_segmentation_tpu_torch.parallel.mesh import (
        data_sharding, make_mesh)
    from rs_image_segmentation_tpu_torch.tools.batch import (
        run_batch_workflow)

    def fields(prefix):
        return {k[len(prefix):]: inp[k] for k in inp
                if k.startswith(prefix)}

    gf = tforest.gemm_forest_from_numpy(fields("gf_"), device=dev)
    flat = tforest.flat_forest_from_numpy(fields("ff_"))
    depth = int(inp["depth"])
    data = make_mesh(axis_names=("data",), device=dev)
    tile = make_mesh(axis_names=("tile",), device=dev)
    model = make_mesh(axis_names=("model",), device=dev)
    block = data_sharding(data, 4).block
    scenes, luts = inp["scenes"], inp["luts"]
    res, launches, thunks = {}, {}, {}

    def run(name, fn):
        (res[name], calls), launches[name] = counted(
            lambda: plain_calls(fn))
        thunks[name] = fn
        check(not any(calls.values()), f"phase 22 [{tag}] {name}: no plain "
              f"version on the card: {calls}")

    def host(t):
        return t.cpu().numpy()

    run("classify_batch_multihost", lambda: multihost.classify_batch_multihost(
        block(scenes), block(luts), gf, cfg, data))
    run("method_rule", lambda: host(sharded.sharded_method_batch(
        scenes, luts, data, "rule_based", cfg)))
    run("method_kmeans", lambda: host(sharded.sharded_method_batch(
        scenes, luts, data, "kmeans", cfg, n_clusters=KMEANS_K,
        seed=KMEANS_SEED, fit_stride=KMEANS_STRIDE)))
    run("forest_dp", lambda: host(sharded.sharded_forest_predict(
        flat, inp["x_rows"], depth, data)))
    run("forest_tp", lambda: host(forest_tp.tp_forest_predict(
        gf, inp["x_rows"], model)))
    run("kmeans_fit", lambda: tuple(host(t) for t in
                                    sharded.sharded_kmeans_fit_predict(
                                        inp["xk"], KMEANS_K, data,
                                        seed=KMEANS_SEED)))
    run("stack_dp", lambda: host(sharded.sharded_hierarchical_stack(
        scenes[:2].astype(np.float32), data, cfg)))
    run("spatial_scene", lambda: host(spatial.sharded_classify_scene(
        inp["pre0"], gf, tile)))
    run("spatial_large", lambda: spatial.classify_large_scene_sharded(
        inp["pre_big"], gf, tile, hists=inp["hists"]))
    for name, key in (("batch_workflow", "u8"),
                      ("batch_workflow_16bit", "u16")):
        run(name, lambda key=key: run_batch_workflow(
            inp["paths"][key], flat, depth,
            os.path.join(tmp, f"{key}_{tag}"), mesh=data, cfg=cfg))
    return res, launches, thunks


def parallel_walls(thunks: dict) -> dict:
    """Host wall seconds of each call: ``{name: (median, runs)}`` over
    ``PARALLEL_REPS`` runs after a warm-up (:func:`wall_s`)."""
    return {name: wall_s(fn, PARALLEL_REPS) for name, fn in thunks.items()}


def parallel_rank(argv) -> int:
    """One rank of phase 22's gloo group on the card: ``chip_smoke.py
    --parallel-rank <rank> <world> <host:port> <dir>`` runs
    :func:`parallel_calls` and a CPU KMeans fit over the same group, and
    pickles its results to ``<dir>/rank<rank>.pkl``."""
    import pickle

    from rs_image_segmentation_tpu_torch.core.config import FeatureStageConfig
    from rs_image_segmentation_tpu_torch.parallel import sharded
    from rs_image_segmentation_tpu_torch.parallel.collectives import (
        ppermute_ring)
    from rs_image_segmentation_tpu_torch.parallel.mesh import make_mesh
    from rs_image_segmentation_tpu_torch.parallel.multihost import (
        init_multihost)
    rank, world, address, tmp = (int(argv[0]), int(argv[1]), argv[2],
                                 argv[3])
    dev = init_multihost(address, world, rank, backend="gloo",
                         device="cuda")
    cfg = FeatureStageConfig()
    inp = load_parallel_inputs(tmp)
    res, launches, thunks = parallel_calls(inp, dev, cfg, tmp, f"w{world}")
    staged = ppermute_ring.staged_bytes     # the calls' first runs
    wall = {k: v[0] for k, v in parallel_walls(thunks).items()}
    cpu = make_mesh(axis_names=("data",), device="cpu")
    labels_cpu, _ = sharded.sharded_kmeans_fit_predict(
        inp["xk"], KMEANS_K, cpu, seed=KMEANS_SEED)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"res": res, "launches": launches, "wall": wall,
                     "kmeans_cpu": labels_cpu.numpy(), "device": str(dev),
                     "staged_bytes": staged}, f)
    torch.distributed.destroy_process_group()
    return 0


def parallel_phase(dev, cfg, scenes, luts, gf, gf_cpu, flat_forest, depth,
                   stack0, main_labels, smi, rows) -> dict:
    """Phase 22: ``parallel/`` on the card at full width (600 x 600
    scenes, the default ``FeatureStageConfig``, the path's 100-tree
    forest, the 7 x 6000 x 6000 tiling of phase 18): the calls of
    :func:`parallel_calls` in a one-rank NCCL group here, each held to its
    library program, and in a two-rank gloo group with both ranks on this
    card (spawned), each rank's result bit-equal to the one-rank group's
    (the KMeans fit: mapped kappa within ``CARD_CPU_KAPPA_MARGIN`` of its
    CPU run); ``pp_classify_scenes`` on two streams, equal to the serial
    maps, the two stages' kernels on two lanes of each of three traces,
    with their overlap; ``rs-seg-torch-multihost-rehearse`` as a process
    (gloo even and uneven pass, an injected failure and NCCL at two ranks
    on one card fail with their reasons). Launches of every call, host
    wall seconds of every call (median of 3 after a warm-up), the 6000^2
    call's peak memory, the bytes the ring staged through the host. Adds
    each kernel's launches to its row."""
    import pickle
    import shutil
    import signal
    import tempfile

    from rs_image_segmentation_tpu_torch.models.forest import (
        forest_predict, gemm_forest_predict)
    from rs_image_segmentation_tpu_torch.models.kmeans import (
        kmeans_fit_predict)
    from rs_image_segmentation_tpu_torch.ops.kernels import forest_labels
    from rs_image_segmentation_tpu_torch.parallel.collectives import (
        ppermute_ring)
    from rs_image_segmentation_tpu_torch.parallel.mesh import make_mesh
    from rs_image_segmentation_tpu_torch.parallel.multihost import (
        free_local_port)
    from rs_image_segmentation_tpu_torch.parallel.pipeline_pp import (
        pp_classify_scenes)
    from rs_image_segmentation_tpu_torch.pipeline import large_scene as ls
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
        ClassificationEvaluator)
    from rs_image_segmentation_tpu_torch.pipeline.features import (
        hierarchical_stack, hierarchical_stack_fused)
    from rs_image_segmentation_tpu_torch.tools.batch import (
        run_batch_workflow)
    from rs_image_segmentation_tpu_torch.utils import traceview
    from rs_image_segmentation_tpu_torch.utils.timing import device_trace

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    procs = {}
    out = {"card": smi}
    try:
        inp = parallel_inputs(tmp, dev, cfg, scenes, luts, gf_cpu,
                              flat_forest, depth, stack0)
        print(f"parallel: inputs in {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        # ---- 22a. the rehearsal CLI and the two-rank group, spawned
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for name, (args, extra, _) in REHEARSALS.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m",
                 "rs_image_segmentation_tpu_torch.cli.multihost_cli",
                 "--timeout", str(PARALLEL_TIMEOUT_S - 60)] + args,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=ROOT, env={**env, **extra}, start_new_session=True)
        address = f"127.0.0.1:{free_local_port()}"
        for r in range(2):
            procs[f"rank{r}"] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank",
                 str(r), "2", address, tmp], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env,
                start_new_session=True)

        # ---- 22b. the one-rank NCCL group, here
        mesh = make_mesh(axis_names=("data",), device=dev)
        check(torch.distributed.get_backend() == "nccl"
              and torch.distributed.get_world_size() == 1,
              "a one-rank NCCL group on the card")
        one, launches, thunks = parallel_calls(inp, dev, cfg, tmp, "w1")
        ref = {
            "classify_batch_multihost": main_labels.cpu().numpy(),
            "method_rule": turbo.rule_based_scenes_turbo_batch(
                scenes, luts, cfg, device=dev).cpu().numpy(),
            "method_kmeans": turbo.kmeans_scenes_turbo_batch(
                scenes, luts, KMEANS_K, cfg, seed=KMEANS_SEED,
                fit_stride=KMEANS_STRIDE, device=dev).cpu().numpy(),
            "forest_dp": forest_predict(flat_forest, torch.from_numpy(
                inp["x_rows"]).to(dev), depth).cpu().numpy(),
            "forest_tp": gemm_forest_predict(gf, torch.from_numpy(
                inp["x_rows"]).to(dev)).cpu().numpy()}
        for name, want in ref.items():
            check(np.array_equal(one[name], want), f"phase 22 {name} "
                  f"(one-rank NCCL) bit-equal to its library program")
        for s in range(2):
            check(np.array_equal(one["stack_dp"][s], hierarchical_stack(
                scenes[s].astype(np.float32), cfg, device=dev).cpu().numpy()),
                f"sharded_hierarchical_stack's scene {s} bit-equal to "
                f"hierarchical_stack")
        ev = ClassificationEvaluator(device=dev)
        truth = one["method_rule"][0].reshape(1, -1)[:, ::KMEANS_STRIDE]
        k_card = mapped_kappa(ev, one["kmeans_fit"][0][None] + 1, truth)
        cpu_labels, _ = kmeans_fit_predict(torch.from_numpy(inp["xk"]),
                                           KMEANS_K, KMEANS_SEED)
        k_cpu = mapped_kappa(ev, cpu_labels.numpy()[None] + 1, truth)
        check(abs(k_card - k_cpu) <= CARD_CPU_KAPPA_MARGIN,
              f"sharded_kmeans_fit_predict mapped kappa {k_card:.6f} within "
              f"{CARD_CPU_KAPPA_MARGIN} of its CPU run's {k_cpu:.6f}")
        mono0 = gemm_forest_predict(gf, hierarchical_stack_fused(
            inp["pre0"], cfg, device=dev).reshape(-1, 19)).reshape(
            HEIGHT, WIDTH).cpu().numpy()
        agree_scene = float((one["spatial_scene"] == mono0).mean())
        check(agree_scene >= 0.999, f"sharded_classify_scene against "
              f"hierarchical_stack_fused + forest: {agree_scene}")
        mono_big = ls.classify_large_scene(inp["pre_big"], gf, cfg,
                                           tile_rows=LARGE_TILE,
                                           hists=inp["hists"], device=dev)
        agree_large = float((one["spatial_large"] == mono_big).mean())
        check(agree_large >= 0.999, f"classify_large_scene_sharded against "
              f"classify_large_scene at {LARGE}^2: {agree_large}")
        wf = {}
        for key in ("u8", "u16"):
            wf[key] = run_batch_workflow(inp["paths"][key], flat_forest,
                                         depth, os.path.join(tmp, key),
                                         cfg=cfg, device=dev)
        for key, name in (("u8", "batch_workflow"),
                          ("u16", "batch_workflow_16bit")):
            check([e["scene"] for e in one[name]] == inp["paths"][key],
                  f"{name}: every scene, in order")
        wf_u8_equal = all(filecmp.cmp(a["class_map"], b["class_map"],
                                      shallow=False)
                          for a, b in zip(one["batch_workflow"], wf["u8"]))
        check(wf_u8_equal, "run_batch_workflow(mesh) files byte-equal to "
              "its mesh=None run (turbo route)")
        wf_16_equal = all(filecmp.cmp(a["class_map"], b["class_map"],
                                      shallow=False)
                          for a, b in zip(one["batch_workflow_16bit"],
                                          wf["u16"]))
        check(wf_16_equal, "run_batch_workflow(mesh) files byte-equal to "
              "its mesh=None run (streamed route, 16-bit DNs)")
        print(f"parallel [one-rank NCCL]: every call equal to its library "
              f"program; KMeans mapped kappa card {k_card:.6f} / CPU "
              f"{k_cpu:.6f}; spatial {agree_scene:.6f} (600^2), "
              f"{agree_large:.6f} ({LARGE}^2); workflow files byte-equal "
              f"to mesh=None on both routes; launches {launches}",
              flush=True)

        # ---- 22c. the two-rank group and the rehearsals
        logs = {}
        for name, p in procs.items():
            try:
                logs[name] = p.communicate(timeout=PARALLEL_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                logs[name] = p.communicate()[0]
                check(False, f"{name} timed out:\n{logs[name][-3000:]}")
        for r in range(2):
            check(procs[f"rank{r}"].returncode == 0, f"rank {r} of the "
                  f"two-rank gloo group:\n{logs[f'rank{r}'][-4000:]}")
        two = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                two.append(pickle.load(f))
        check(all(t["device"] == "cuda:0" for t in two),
              f"both ranks on cuda:0: {[t['device'] for t in two]}")
        for r, t in enumerate(two):
            for name in ("classify_batch_multihost", "method_rule",
                         "method_kmeans", "stack_dp", "spatial_scene"):
                lo = r * (len(one[name]) // 2)
                check(np.array_equal(t["res"][name], one[name][
                    lo:lo + len(t["res"][name])]), f"rank {r}'s {name} "
                      f"bit-equal to the one-rank group's")
            for name in ("forest_dp", "forest_tp", "spatial_large"):
                check(np.array_equal(t["res"][name], one[name]),
                      f"rank {r}'s {name} bit-equal to the one-rank group's")
            for name in ("batch_workflow", "batch_workflow_16bit"):
                check(all(filecmp.cmp(a["class_map"], b["class_map"],
                                      shallow=False)
                          for a, b in zip(t["res"][name], one[name])),
                      f"rank {r}'s {name} files byte-equal to the one-rank "
                      f"group's")
        labels2 = np.concatenate([t["res"]["kmeans_fit"][0] for t in two])
        labels2_cpu = np.concatenate([t["kmeans_cpu"] for t in two])
        k2_card = mapped_kappa(ev, labels2[None] + 1, truth)
        k2_cpu = mapped_kappa(ev, labels2_cpu[None] + 1, truth)
        check(abs(k2_card - k2_cpu) <= CARD_CPU_KAPPA_MARGIN,
              f"two-rank sharded_kmeans_fit_predict mapped kappa "
              f"{k2_card:.6f} within {CARD_CPU_KAPPA_MARGIN} of its CPU "
              f"run's {k2_cpu:.6f}")
        staged = [t["staged_bytes"] for t in two]
        check(all(s > 0 for s in staged), f"gloo staged the ring's CUDA rows "
              f"through the host: {staged}")
        print(f"parallel [two-rank gloo, both on cuda:0]: every rank's result "
              f"bit-equal to the one-rank group's; KMeans mapped kappa card "
              f"{k2_card:.6f} / CPU {k2_cpu:.6f}; ring bytes staged through "
              f"the host {staged}; launches "
              f"{[t['launches'] for t in two]}; wall s median of "
              f"{PARALLEL_REPS} after a warm-up, each rank beside the other "
              f"and the rehearsals {[round_values(t['wall']) for t in two]}",
              flush=True)
        rehearse = {}
        for name, (_, _, must_pass) in REHEARSALS.items():
            rc, log = procs[name].returncode, logs[name]
            rehearse[name] = rc
            if must_pass:
                check(rc == 0 and "multihost rehearsal OK" in log,
                      f"rehearsal {name} exits 0:\n{log[-3000:]}")
            else:
                check(rc != 0 and "multihost rehearsal FAILED" in log,
                      f"rehearsal {name} fails loudly:\n{log[-3000:]}")
        check("MULTIHOST_INJECTED_FAILURE 1" in logs["gloo_fail_pid_1"],
              "the injected failure ran")
        check("NCCL takes one CUDA device a rank" in logs["nccl_two_ranks"],
              f"NCCL at two ranks on one card fails with its reason:\n"
              f"{logs['nccl_two_ranks'][-3000:]}")
        rehearse_launches = [json.loads(ln.split(" ", 1)[1]) for name in
                             ("gloo_even", "gloo_uneven")
                             for ln in logs[name].splitlines()
                             if ln.startswith("MULTIHOST_LAUNCHES ")]
        check(len(rehearse_launches) == 4
              and all(d["lut_hist"] == 1 and d["forest_labels"] == 1
                      for d in rehearse_launches),
              f"each rehearsal rank launched lut_hist and forest_labels "
              f"once: {rehearse_launches}")
        print(f"parallel [rs-seg-torch-multihost-rehearse]: exit codes "
              f"{rehearse}; rank launches {rehearse_launches}", flush=True)

        # ---- 22d. pipelining on two streams of the card, once the spawned
        # processes are gone (their contexts time-slice the card)
        pre8 = [stretch(s, lt).astype(np.float32)
                for s, lt in zip(scenes, luts)]

        def serial():
            return [forest_labels(gf, hierarchical_stack_fused(
                p, cfg, device=dev).permute(2, 0, 1).reshape(19, -1)
                .contiguous()).reshape(HEIGHT, WIDTH).cpu().numpy()
                for p in pre8]

        want = serial()
        got, pp_launches = counted(lambda: pp_classify_scenes(pre8, gf, cfg))
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              "pp_classify_scenes equal to the serial maps")
        # whether the forest's kernel meets a stage-2 kernel on the card
        # depends on how far the host runs ahead of it: three traces, each
        # with its overlap reported
        overlaps, lane_sets = [], []
        for i in range(3):
            trace = os.path.join(tmp, "pp_trace", str(i))
            with device_trace(trace):
                pp_classify_scenes(pre8, gf, cfg)
            events = traceview.device_exec_events(trace)
            lanes = traceview.device_exec_intervals(trace)
            stage = [k for k, evs in events.items()
                     if any("spectral_indices" in n or "glcm" in n
                            for *_, n in evs)]
            forest = [k for k, evs in events.items()
                      if any("forest_labels" in n for *_, n in evs)]
            summary = {k: (len(v), round(v[0][0]), round(v[-1][1]))
                       for k, v in lanes.items() if v}
            check(bool(stage) and bool(forest)
                  and set(stage).isdisjoint(forest), f"trace {i}: stage 2 "
                  f"and the forest on two stream lanes: stage {stage}, "
                  f"forest {forest}; lanes {summary}")
            lane_sets.append((stage, forest))
            overlaps.append(traceview.total_cross_lane_overlap_us(
                {stage[0]: lanes[stage[0]], forest[0]: lanes[forest[0]]}))
        pp_s = wall_s(lambda: pp_classify_scenes(pre8, gf, cfg),
                      PARALLEL_REPS)[0]
        serial_s = wall_s(serial, PARALLEL_REPS)[0]
        print(f"parallel [pp]: equal to the serial maps; lanes (stage 2, "
              f"forest) {lane_sets}; overlap us in three traces "
              f"{[round(o, 1) for o in overlaps]}; launches {pp_launches}; "
              f"wall s median of {PARALLEL_REPS}: pipelined {pp_s:.4f}, "
              f"serial {serial_s:.4f}", flush=True)

        # ---- 22e. the one-rank group's calls timed alone, and the 6000^2
        # call's peak memory
        staged0 = ppermute_ring.staged_bytes
        timed = parallel_walls(thunks)
        wall = {k: v[0] for k, v in timed.items()}
        large_s, large_runs = timed["spatial_large"]
        _, large_peak = peak_gb(thunks["spatial_large"])
        check(ppermute_ring.staged_bytes == staged0, "NCCL at one rank "
              "stages nothing through the host")
        print(f"parallel [one-rank NCCL, alone on the card]: wall s median "
              f"of {PARALLEL_REPS} after a warm-up {round_values(wall)}; "
              f"{LARGE}^2 classify_large_scene_sharded runs "
              f"{[round(w, 4) for w in large_runs]}, peak "
              f"{large_peak:.3f} GB; {smi}", flush=True)
        torch.distributed.destroy_process_group()
    finally:
        # each process leads its own session: the rehearsals' ranks go too
        for p in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        row["launches_parallel"] = {
            **{f"one_rank.{k}": v.get(row["name"], 0)
               for k, v in launches.items()},
            **{f"rank{r}.{k}": v.get(row["name"], 0)
               for r, t in enumerate(two) for k, v in t["launches"].items()},
            "pp_classify_scenes": pp_launches.get(row["name"], 0)}
    out.update(
        launches_one_rank=launches, launches_two_ranks=[t["launches"]
                                                        for t in two],
        launches_pp=pp_launches, launches_rehearsal=rehearse_launches,
        wall_s_one_rank=wall, wall_s_two_ranks=[t["wall"] for t in two],
        large_sharded_median_s=large_s, large_sharded_runs_s=large_runs,
        large_sharded_peak_gb=large_peak, pp_wall_s=pp_s,
        serial_wall_s=serial_s, pp_overlap_us=overlaps,
        staged_bytes_two_ranks=staged, kmeans_kappa={
            "one_rank_card": k_card, "one_rank_cpu": k_cpu,
            "two_rank_card": k2_card, "two_rank_cpu": k2_cpu},
        agreement={"spatial_scene": agree_scene,
                   "spatial_large": agree_large},
        rehearsal_exit_codes=rehearse,
        phase_s=time.perf_counter() - t_phase)
    return out


def round_values(d: dict) -> dict:
    return {k: round(v, 4) for k, v in d.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rs_image_segmentation_tpu_torch.backend import resolve_device
    from rs_image_segmentation_tpu_torch.core.config import FeatureStageConfig
    from rs_image_segmentation_tpu_torch.models.forest import (
        GEMM_MAX_LEAVES, GemmForest)
    from rs_image_segmentation_tpu_torch.ops import _build, kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        rule_forest, stretch_stats_batch, synthetic_scenes)
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    t_start = time.perf_counter()
    # ---- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report)}")
    for k, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {k}: {r['seconds']:.2f} s; " + " | ".join(regs))

    # ---- 2. data
    cfg = FeatureStageConfig()
    t0 = time.perf_counter()
    scenes = synthetic_scenes(BATCH, HEIGHT, WIDTH, seed=SEED)
    t1 = time.perf_counter()
    luts, _, hists = stretch_stats_batch(scenes)
    stats_ms = (time.perf_counter() - t1) * 1e3
    print(f"data: {scenes.shape} uint8 in {time.perf_counter() - t0:.2f} s, "
          f"host stretch stats {stats_ms:.1f} ms per batch")
    scenes_d = torch.from_numpy(scenes).to(dev)
    luts_d = torch.from_numpy(luts).to(dev)
    hists_d = torch.from_numpy(hists).to(dev)

    # ---- 3. forest
    t0 = time.perf_counter()
    stack0 = turbo.hierarchical_stack_turbo_cm(scenes_d[0], luts_d[0], cfg,
                                               device=dev).cpu().numpy()
    check(stack0.shape == (19, HEIGHT, WIDTH)
          and bool(np.isfinite(stack0).all()), "scene 0 stack is finite")
    gf_cpu, plan, n_samples, depth, flat_forest = rule_forest(stack0)
    gf = GemmForest(*(t.to(dev) for t in gf_cpu))
    m, n_leaves = gf.path.shape
    n_classes = gf.leaf_dist.shape[1]
    check(n_classes <= 8, "at most 8 classes")
    n_trees = round(1.0 / float(gf_cpu.inv_trees))
    check(n_trees == N_TREES, f"{N_TREES} trees")
    print(f"forest: {n_trees} trees on {n_samples} samples in "
          f"{time.perf_counter() - t0:.2f} s; M={m} L={n_leaves} "
          f"C={n_classes} depth={depth} plan groups={len(plan)}")

    # ---- 4. kernels against their plain versions on the card
    errs = {}
    rng = np.random.default_rng(SEED + 35)
    ragged = torch.from_numpy(rng.integers(0, 256, (BANDS, 601, 599),
                                           dtype=np.uint8)).to(dev)
    ragged_lut = torch.from_numpy(rng.integers(0, 256, (BANDS, 256),
                                               dtype=np.uint8)).to(dev)
    # scene 0 in views whose bases sit 1 and 4 bytes past an aligned one
    views = {}
    for off in (1, 4):
        buf = torch.empty(scenes_d[0].numel() + 16, dtype=torch.uint8,
                          device=dev)
        views[off] = buf[off:off + scenes_d[0].numel()].view(
            scenes_d[0].shape)
        views[off].copy_(scenes_d[0])
    lut_cases = {"the batch": (scenes_d, luts_d),
                 "scene 0": (scenes_d[0], luts_d[0]),
                 "601 x 599 (planes of n % 4 == 3)": (ragged, ragged_lut),
                 "scene 0 at a base 1 byte past alignment": (
                     views[1], luts_d[0]),
                 "scene 0 at a base 4 bytes past alignment": (
                     views[4], luts_d[0])}
    units = {}
    for where, (sc, lt) in lut_cases.items():
        for label, kw in (("skip_hist", dict(skip_hist=True)),
                          ("hist", {}),
                          ("table+out_u8", dict(out_u8=True))):
            got = kernels.lut_hist(sc, lt, **kw)
            ref = kernels.lut_hist_plain(sc, lt,
                                         out_u8=kw.get("out_u8", False),
                                         skip_hist=kw.get("skip_hist", False))
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                check(g.shape == r.shape and g.dtype == r.dtype,
                      f"lut_hist {label} [{where}] shape/dtype")
                err = (g.double() - r.double()).abs().max().item()
                check(err == 0, f"lut_hist {label} [{where}] bit-equal (max "
                      f"err {err})")
                errs["lut_hist"] = max(errs.get("lut_hist", 0.0), err)
            unit = units[(where, label)] = kernels.lut_hist_unit(sc, got[0])
            instance = kernels.lut_hist_instance(
                sc.numel() // sc.shape[-1] // sc.shape[-2],
                sc.shape[-1] * sc.shape[-2], unit, "skip_hist" in kw)
            print(f"check lut_hist [{label}] [{where}] at {tuple(sc.shape)}"
                  f": bit-equal, {unit} pixels a unit, {instance} instance")
    check(units[("scene 0 at a base 1 byte past alignment", "hist")] == 1
          and units[("scene 0 at a base 4 bytes past alignment",
                     "hist")] == 4
          and units[("the batch", "table+out_u8")] == 16,
          f"lut_hist units by alignment: {units}")

    stacks = turbo.hierarchical_stack_turbo_cm(scenes_d, luts_d, cfg,
                                               device=dev)
    x_cm = stacks.reshape(BATCH, 19, HEIGHT * WIDTH)
    check(bool(torch.isfinite(x_cm).all()), "batch stacks are finite")
    cases = {"batch stacks": (gf, x_cm)}
    for key, (g, xc) in tie_and_fractional_forests().items():
        cases[key] = (GemmForest(*(t.to(dev) for t in g)),
                      torch.from_numpy(xc).to(dev))
    gf20 = GemmForest(*(t.to(dev) for t in wide_forest(stack0)))
    cases["20 classes, batch stacks"] = (gf20, x_cm)
    cases["20 classes, random pixels"] = (gf20, torch.from_numpy(
        np.random.default_rng(SEED + 21).random((19, 4096)).astype(
            np.float32)).to(dev))
    t0 = time.perf_counter()
    gf_big = GemmForest(*(t.to(dev) for t in large_forest(stack0)))
    big_leaves = gf_big.path.shape[1]
    check(4000 <= big_leaves <= GEMM_MAX_LEAVES
          and kernels.forest_instance(gf_big) == "global"
          and kernels.forest_instance(gf) == "shared",
          f"the large forest ({big_leaves} leaves) takes the global-memory "
          f"instance, the path's forest the shared-memory one")
    print(f"large forest: {big_leaves} leaves, fitted and packed in "
          f"{time.perf_counter() - t0:.2f} s; instances: large "
          f"{kernels.forest_instance(gf_big)}, path's "
          f"{kernels.forest_instance(gf)}")
    cases["large forest, batch stacks"] = (gf_big, x_cm)
    for label, (g, xc) in cases.items():
        got = kernels.forest_labels(g, xc)
        ref = kernels.gemm_labels_cm(g, xc)
        torch.cuda.synchronize()
        diff = int((got != ref).sum().item())
        err = float((got - ref).abs().max().item())
        check(diff == 0, f"forest_labels [{label}] bit-equal ({diff} differ)")
        errs["forest_labels"] = max(errs.get("forest_labels", 0.0), err)
        print(f"check forest_labels [{label}] at {tuple(xc.shape)}, "
              f"{g.leaf_dist.shape[1]} classes: bit-equal; "
              f"{int(torch.unique(ref).numel())} classes in the labels")

    # ---- 5. the main path
    def main_path():
        return turbo.classify_scenes_turbo(
            scenes_d, luts_d, gf, cfg, stretch_hists=hists_d, device=dev)

    labels, launches = counted(main_path)
    check(launches["lut_hist"] > 0 and launches["forest_labels"] > 0
          and all(launches[k] == 0 for k in STAGE_KERNELS),
          f"both kernels ran on the main path, and no stage kernel: "
          f"{launches}")
    check(labels.shape == (BATCH, HEIGHT, WIDTH)
          and labels.dtype == torch.uint8, "label maps (B, H, W) uint8")
    classes = set(gf_cpu.classes.tolist())
    counts = torch.bincount(labels.reshape(-1).long(), minlength=256)
    hist = {int(c): int(counts[c]) for c in torch.nonzero(counts)[:, 0]}
    check(set(hist) <= classes, f"labels are forest classes: {hist}")
    print(f"main path: launches {launches}; class histogram {hist}")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main_path()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    batch_ms = statistics.median(walls[1:])
    print(f"main path: median {batch_ms:.3f} ms/batch, "
          f"{batch_ms / BATCH:.3f} ms/scene, "
          f"{BATCH * HEIGHT * WIDTH / batch_ms / 1e3:.3f} MP/s "
          f"(inputs resident on the card; runs {[round(w, 3) for w in walls]})")
    t0 = time.perf_counter()
    cpu0 = turbo.classify_scenes_turbo(scenes[:1], luts[:1], gf_cpu, cfg,
                                       stretch_hists=hists[:1], device="cpu")
    agreement = float((cpu0[0] == labels[0].cpu()).double().mean())
    check(agreement >= 0.999, f"card vs CPU agreement {agreement}")
    print(f"scene 0 on the CPU in {time.perf_counter() - t0:.1f} s: "
          f"agreement with the card {agreement:.6f}")

    # ---- 6. kernel numbers at the main path's shapes
    planes = BATCH * BANDS
    n = HEIGHT * WIDTH
    lut_bytes = planes * n * (1 + 4) + planes * 256
    lut_plain_ms = cuda_time_ms(lambda: kernels.lut_hist_plain(
        scenes_d, luts_d, skip_hist=True), 10)
    lut_ms = cuda_time_ms(lambda: kernels.lut_hist(
        scenes_d, luts_d, skip_hist=True), 50)
    lut_f32 = luts_d.reshape(planes, 256).float()
    idx64 = scenes_d.reshape(planes, n).long()
    lut_lib_ms = cuda_time_ms(lambda: torch.gather(lut_f32, 1, idx64), 20)
    decisions = fired_decisions(gf, x_cm)
    forest_ops = decisions + BATCH * n * (N_TREES * n_classes + n_classes)
    forest_bytes = x_cm.numel() * 4 + BATCH * n * 4
    forest_ms = cuda_time_ms(lambda: kernels.forest_labels(gf, x_cm), 5, 1)
    # cold L2 and alone in a trace, rows 1 and 2
    flush = l2_flusher(dev)
    lut_nums = kernel_numbers(lambda: kernels.lut_hist(
        scenes_d, luts_d, skip_hist=True), flush)
    lut_launch = launch_numbers(lambda: kernels.lut_hist(
        scenes_d, luts_d, skip_hist=True))
    lut_hist_launch = launch_numbers(lambda: kernels.lut_hist(
        scenes_d[0], luts_d[0]))
    check(len(lut_launch["kernels_a_call_launches"]) == 1
          and "lut_hist_kernel" in lut_launch["kernels_a_call_launches"][0]
          and not lut_launch["htod_memcpy"],
          f"a skip_hist call of lut_hist launches its kernel and nothing "
          f"else: {lut_launch}")
    check(len(lut_hist_launch["kernels_a_call_launches"]) == 1
          and "lut_hist_cluster_kernel" in lut_hist_launch[
              "kernels_a_call_launches"][0],
          f"a call of lut_hist with the histogram (scene 0) launches the "
          f"cluster instance and no zero fill: {lut_hist_launch}")
    print(f"a lut_hist call launches {lut_launch['kernels_a_call_launches']}"
          f" (skip_hist), {lut_hist_launch['kernels_a_call_launches']} "
          f"(with the histogram)", flush=True)
    forest_nums = kernel_numbers(lambda: kernels.forest_labels(gf, x_cm),
                                 flush, 5, 10, 5)
    big_nums = kernel_numbers(lambda: kernels.forest_labels(gf_big, x_cm),
                              flush, 3, 5, 3)
    big_decisions = fired_decisions(gf_big, x_cm)
    print(f"forest_labels, device ms per batch (back to back / L2 flushed "
          f"/ alone): path's forest {forest_nums['ms']:.4f} / "
          f"{forest_nums['cold_ms']:.4f} / {forest_nums['alone_ms']}; large "
          f"forest ({big_leaves} leaves) {big_nums['ms']:.4f} / "
          f"{big_nums['cold_ms']:.4f} / {big_nums['alone_ms']}")
    parts = turbo._preamble(scenes_d, luts_d, hists_d)
    stack_ms = cuda_time_ms(lambda: turbo._stack_cm_from_parts(*parts, cfg),
                            5, 1)
    print(f"stages, device ms per batch: preamble {lut_ms:.4f}, "
          f"stack {stack_ms:.4f}, forest {forest_ms:.4f}; "
          f"sum {lut_ms + stack_ms + forest_ms:.4f} vs main path wall "
          f"{batch_ms:.4f}")
    forest_plain_ms = cuda_time_ms(lambda: kernels.gemm_labels_cm(gf, x_cm), 2, 1)

    rows = []
    for kname, ms, plain, lib, lib_note, (bms, by), line, extra in (
            ("lut_hist", lut_ms, lut_plain_ms, lut_lib_ms,
             "torch.gather over (planes, 256) f32 tables with int64 indices "
             "widened beforehand (no histogram)",
             bound(lut_bytes, planes * n), 395,
             {"bytes": lut_bytes, "ops": planes * n,
              **timing_keys(lut_nums), **lut_launch,
              "kernels_a_histogram_call_launches": lut_hist_launch[
                  "kernels_a_call_launches"]}),
            ("forest_labels", forest_ms, forest_plain_ms, None,
             "no single PyTorch call computes a forest's labels",
             bound(forest_bytes, forest_ops), 647,
             {"bytes": forest_bytes, "ops": forest_ops,
              "fired_decisions": decisions, **timing_keys(forest_nums),
              "large_forest": {
                  "leaves": big_leaves,
                  "instance": kernels.forest_instance(gf_big),
                  "bound_ms": bound(forest_bytes, big_decisions + BATCH * n
                                    * (N_TREES * n_classes + n_classes))[0],
                  **timing_keys(big_nums)}})):
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"{CSRC}/{kname}.cu", "replaces": f"{PALLAS}:{line}",
            "launches": launches[kname], "max_abs_err": errs[kname],
            "max_diff": errs[kname], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_us": bms * 1e3,
            "bound_by": by, "library_ms": lib, "library_note": lib_note,
            **extra})

    rows[1]["deep_forest"], gf_deep = deep_forest_phase(
        dev, cfg, scenes_d, luts_d, hists_d, stack0, flush)
    rows[0]["stack_graphs"] = graph_phase(
        dev, cfg, scenes, luts, scenes_d, luts_d, hists_d,
        {"path's": gf, "deep": gf_deep})
    rows += rule_phases(dev, cfg, scenes, luts, hists, scenes_d, luts_d,
                        hists_d, rows[0])
    rows.append(single_scene_phases(dev, cfg, scenes, luts, scenes_d,
                                    luts_d))
    rows += stage_phases(dev, cfg, scenes, luts, scenes_d, luts_d)
    rows[0]["kmeans_launches"] = kmeans_phases(
        dev, cfg, scenes, luts, hists, scenes_d, luts_d, hists_d)
    rows.append(lloyd_phase(dev, cfg, scenes_d, luts_d, hists_d, flush,
                            rows[0]["kmeans_launches"]))
    rows[1]["forest_predict_launches"] = forest_predict_phase(
        dev, stack0, flat_forest, depth, labels[0])
    large = large_scene_phases(dev, cfg, scenes, luts, gf, gf_cpu, rows)
    print(json.dumps({"large_scene": large}))
    serving = serving_phases(dev, cfg, scenes, flat_forest, depth, gf,
                             stack0, smi, rows)
    print(json.dumps({"serving": serving}))
    files = file_pipeline_phase(scenes[0], dev, smi, rows)
    print(json.dumps({"file_pipeline": files}))
    tools = tools_cli_phase(dev, cfg, scenes, flat_forest, depth, gf, stack0,
                            smi, rows)
    print(json.dumps({"tools_cli": {**tools, "card": smi}}))
    par = parallel_phase(dev, cfg, scenes, luts, gf, gf_cpu, flat_forest,
                         depth, stack0, labels, smi, rows)
    print(json.dumps({"parallel": par}))
    print(f"chip_smoke: every check passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(sys.argv[2:]))
    sys.exit(main())
