"""The turbo programs: over a written-out batch dimension the supervised
path (raw uint8 scenes -> 19-channel channel-major stack -> forest labels),
the KMeans program (the same stack -> MinMax -> k-means fit -> cluster
maps) and the batched rule program; and the single-scene rule and KMeans
programs.

Counterpart of ``rs_image_segmentation_tpu.pipeline.turbo``
(``classify_scenes_turbo``, ``kmeans_scenes_turbo``,
``kmeans_scenes_turbo_batch``, ``rule_based_scenes_turbo_batch``,
``rule_based_scenes_turbo`` and the functions they run). Every percentile
comes from a 256-bin int32 histogram (no sort), imagery stays (B, C, H, W)
channel-major, and every reduction of the JAX program's per-scene ``vmap``
(percentiles, the PCA Gram, the Sobel maximum) stays per scene. Two CUDA
kernels carry the path: ``ops.kernels.lut_hist`` (the preamble) and
``ops.kernels.forest_labels`` (the forest); on CPU tensors each runs its
plain PyTorch version. The KMeans programs share the preamble; their
fit (``models.kmeans``) and assignment are matmuls. The batched rule
program shares the preamble and removes small components through
``ops.components.remove_small_components_batch`` (CUDA kernels
``ccmin_prop``, ``hist_dense`` and ``keep_lut``); the single-scene one
through ``pipeline.classify.rule_based_classify`` (CUDA kernel
``cc_labels``).

Numerics follow the JAX program op for op in f32, so on the CPU features
match it to ~1e-6 and class maps to > 99.9 %; only summation orders
(matmuls, reductions) differ.
"""

from __future__ import annotations

import math
import threading
from typing import Sequence

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, resolve_device
from ..core.config import FeatureStageConfig, RuleBasedConfig
from ..models.forest import GemmForest
from ..models.kmeans import fit_centroids, minmax_scale_features
from ..ops.components import remove_small_components_batch
from ..ops.indices import mndwi, ndbi, ndvi, ndwi, spectral_indices
from ..ops.kernels import (apply_u8_lut, forest_labels, gemm_labels_cm,
                           histogram256, lut_hist)
from ..ops.morphology import closing, gradient, opening
from ..ops.stencil import box_filter, sobel_magnitude
from ..ops.texture import glcm_feature_maps
from ..ops.threshold import threshold_binary
from ..utils.timing import span
from .classify import rule_based_classify

__all__ = ["apply_u8_lut", "histogram256", "percentiles_from_counts",
           "hierarchical_stack_turbo_cm", "gemm_labels_cm",
           "classify_scenes_turbo", "kmeans_scenes_turbo",
           "kmeans_scenes_turbo_batch", "rule_based_scenes_turbo_batch",
           "rule_based_scenes_turbo"]


# ------------------------------------------------------------ primitives

def percentiles_from_counts(counts: torch.Tensor, values: torch.Tensor,
                            qs: Sequence[float], n: int) -> torch.Tensor:
    """np.percentile(method='linear') over per-band value multisets.

    counts: (..., 256) integer counts; values: (..., 256) ASCENDING f32
    values; qs: percentiles; n: total count per row. Returns (len(qs),
    ...). Interpolation form v_lo*(1-frac) + v_hi*frac in f32; ranks
    compare as exact int32."""
    cum = torch.cumsum(counts.to(torch.int32), dim=-1, dtype=torch.int32)
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = math.floor(pos)
        hi = math.ceil(pos)
        frac = np.float32(pos - lo)
        idx_lo = torch.sum((cum < lo + 1).to(torch.int32), dim=-1)
        idx_hi = torch.sum((cum < hi + 1).to(torch.int32), dim=-1)
        v_lo = torch.gather(values, -1, idx_lo[..., None])[..., 0]
        v_hi = torch.gather(values, -1, idx_hi[..., None])[..., 0]
        out.append(v_lo * float(np.float32(1.0) - frac) + v_hi * float(frac))
    return torch.stack(out)


# ------------------------------------------------------- feature stack

def _preamble(scene_u8: torch.Tensor, stretch_lut_u8: torch.Tensor,
              hist=None, out=None, hist_out=None):
    """Stretch LUT + histogram through kernel 1 (``ops.kernels.lut_hist``).
    With a host histogram ``hist`` (exact int32 counts of the stretched
    scene) the kernel skips its own count. ``out`` and ``hist_out``:
    optional tensors the stretched scene and its histogram are written to
    (a given ``hist`` is copied into ``hist_out``)."""
    if hist is not None:
        st = lut_hist(scene_u8, stretch_lut_u8, skip_hist=True, out=out)
        return st, (hist if hist_out is None else hist_out.copy_(hist))
    return lut_hist(scene_u8, stretch_lut_u8, out=out, hist_out=hist_out)


def _stack_front(stretched_f32: torch.Tensor, hist: torch.Tensor,
                 cfg: FeatureStageConfig) -> dict:
    """The stack up to ``eigh``: normalised bands, spectral indices and
    the PCA's centred bands and their (B, 7, 7) covariance ``cov``."""
    b, c, h, w = stretched_f32.shape
    n = h * w
    eps = cfg.normalize.epsilon
    dev = stretched_f32.device
    vals = torch.arange(256, dtype=torch.float32, device=dev).expand(b, c, 256)
    p = percentiles_from_counts(hist, vals,
                                (cfg.normalize.lower_percentile,
                                 cfg.normalize.upper_percentile), n)
    lo, hi = p[0][..., None, None], p[1][..., None, None]
    x = stretched_f32
    bands01 = (torch.clamp(x, lo, hi) - lo) / (hi - lo + eps)
    # per-level normalized values (for histogram-space stats downstream)
    norm_vals = ((torch.clamp(vals, p[0][..., None], p[1][..., None])
                  - p[0][..., None])
                 / (p[1][..., None] - p[0][..., None] + eps))  # (B, 7, 256)

    idx = spectral_indices(bands01)

    # --- PCA: RobustScaler stats from the histogram, f32 Gram, eigh ------
    q = percentiles_from_counts(hist, norm_vals, (25.0, 50.0, 75.0), n)
    iqr = q[2] - q[0]
    scale = torch.where(iqr > 0, iqr, 1.0)
    xs = (bands01 - q[1][..., None, None]) / scale[..., None, None]
    xs_vals = (norm_vals - q[1][..., None]) / scale[..., None]
    # the mean and the Gram one scene at a time, so a scene's PC1 does not
    # depend on its batch: on an H100 the reduction kernel splits a row by
    # how many rows the call holds (one sum over the (B, 7, 256) products
    # moved the mean by an ulp between B = 8 and B = 1), and cuBLAS picks
    # a batched product's reduction split by the batch size
    prod = hist.to(torch.float32) * xs_vals
    mean = torch.stack([torch.sum(p_s, dim=-1) for p_s in prod]) / n  # (B, 7)
    xc = xs - mean[..., None, None]
    flat = xc.reshape(b, c, n)
    cov = torch.stack([f @ f.T for f in flat]) / (n - 1)
    return {"hist": hist, "bands01": bands01, "norm_vals": norm_vals,
            "idx": idx, "xc": xc, "cov": cov}


def _stack_back(front: dict, eigvals: torch.Tensor, eigvecs: torch.Tensor,
                cfg: FeatureStageConfig) -> torch.Tensor:
    """The stack from ``eigh``'s (B, 7) values and (B, 7, 7) vectors of
    ``front["cov"]`` on: PC1, the texture branch and the context planes."""
    hist, bands01, norm_vals = front["hist"], front["bands01"], \
        front["norm_vals"]
    idx, xc = front["idx"], front["xc"]
    b, c, h, w = xc.shape
    n = h * w
    eps = cfg.normalize.epsilon
    top = torch.argmax(eigvals, dim=-1)                      # (B,)
    comp0 = torch.gather(eigvecs, 2, top[:, None, None].expand(b, c, 1))[..., 0]
    peak = torch.argmax(torch.abs(comp0), dim=-1, keepdim=True)
    sign = torch.sign(torch.gather(comp0, 1, peak))          # svd_flip
    comp0 = comp0 * torch.where(sign == 0, 1.0, sign)
    pc1 = torch.einsum("bc,bchw->bhw", comp0, xc)

    # --- texture branch (NIR by default) ---------------------------------
    tb = cfg.texture_band_index
    tq = percentiles_from_counts(hist[:, tb], norm_vals[:, tb],
                                 (cfg.normalize.lower_percentile,
                                  cfg.normalize.upper_percentile), n)
    tlo, thi = tq[0][:, None, None], tq[1][:, None, None]    # (B, 1, 1)
    tex01 = (torch.clamp(bands01[:, tb], tlo, thi) - tlo) / (thi - tlo + eps)

    glcm = glcm_feature_maps(tex01, cfg.glcm.levels, cfg.glcm.window_size,
                             cfg.glcm.step_size, cfg.glcm.distances,
                             cfg.glcm.angles)
    u8t = (tex01 * 255.0).to(torch.uint8)
    # x * (1/255): XLA compiles the JAX package's x / 255.0 so, and a
    # forest threshold can sit exactly on a level k / 255
    grad5 = gradient(u8t, 5).to(torch.float32) * (1.0 / 255.0)
    mean5 = box_filter(tex01, 5)
    std5 = torch.sqrt(torch.clamp_min(box_filter(tex01 * tex01, 5)
                                      - mean5 * mean5, 0.0))
    smag = sobel_magnitude(u8t.to(torch.float32)) * (1.0 / 255.0)
    smag = smag / (torch.amax(smag, dim=(-2, -1), keepdim=True) + 1e-10)

    level_1 = torch.stack([idx["ndwi"], idx["mndwi"], idx["ndvi"],
                           idx["evi"], idx["ndbi"], idx["bsi"], pc1],
                          dim=1)                             # (B, 7, H, W)
    ctx = box_filter(level_1, cfg.context.window_size, border="reflect")
    level_2 = torch.stack([glcm["contrast"], glcm["homogeneity"], grad5,
                           std5, smag], dim=1)               # (B, 5, H, W)
    return torch.cat([level_1, ctx, level_2], dim=1)         # (B, 19, H, W)


def _eigh(cov: torch.Tensor):
    # on a CUDA device eigh reads its error flags back, so the host waits
    # here for the device to catch up
    with span("turbo.fetch"):
        return torch.linalg.eigh(cov)


def _stack_cm_from_parts(stretched_f32: torch.Tensor, hist: torch.Tensor,
                         cfg: FeatureStageConfig) -> torch.Tensor:
    """(B, 7, H, W) stretched scenes (f32 holding exact uint8 levels) and
    their (B, 7, 256) histograms -> (B, 19, H, W) stacks. Channel order: 7
    level-1 (ndwi, mndwi, ndvi, evi, ndbi, bsi, pc1), their 7 box-filter
    context planes, then 5 level-2 (GLCM contrast, homogeneity, grad5,
    std5, Sobel magnitude)."""
    front = _stack_front(stretched_f32, hist, cfg)
    return _stack_back(front, *_eigh(front["cov"]), cfg)


def hierarchical_stack_turbo_cm(scene_u8, stretch_lut_u8,
                                cfg: FeatureStageConfig = FeatureStageConfig(),
                                device: DeviceLike = None) -> torch.Tensor:
    """(7, H, W) or (B, 7, H, W) RAW uint8 scene(s) + matching (..., 7,
    256) exact stretch LUTs (``pipeline.preprocess.build_stretch_lut``) ->
    (..., 19, H, W) f32 stack on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    scene = as_tensor(scene_u8, dev, torch.uint8)
    lut = as_tensor(stretch_lut_u8, dev, torch.uint8)
    single = scene.dim() == 3
    if single:
        scene, lut = scene[None], lut[None]
    stack = _stack_cm_from_parts(*_preamble(scene, lut), cfg)
    return stack[0] if single else stack


# ---------------------------------------------------------- full program

def _batch_inputs(scenes_u8, stretch_luts_u8, stretch_hists,
                  device: DeviceLike):
    """A program's inputs on its device: scenes, LUTs and the optional host
    histograms. Marked ``turbo.inputs``, with the bytes copied from the
    host."""
    dev = resolve_device(device)
    with span("turbo.inputs") as rec:
        hh = (None if stretch_hists is None
              else as_tensor(stretch_hists, dev, torch.int32))
        out = (as_tensor(scenes_u8, dev, torch.uint8),
               as_tensor(stretch_luts_u8, dev, torch.uint8), hh)
        if rec is not None:
            given = (scenes_u8, stretch_luts_u8, stretch_hists)
            rec.counts["bytes"] = sum(
                t.nbytes for g, t in zip(given, out) if t is not None
                and not (isinstance(g, torch.Tensor) and g.device == dev))
    return out


def _labels_eager(scenes: torch.Tensor, luts: torch.Tensor, hh,
                  gf: GemmForest, cfg: FeatureStageConfig) -> torch.Tensor:
    """(B, H * W) int32 forest labels of a batch on its device, every
    operation launched from Python: the preamble, the stack, the forest."""
    stacks = _stack_cm_from_parts(*_preamble(scenes, luts, hh), cfg)
    b, f, h, w = stacks.shape
    return forest_labels(gf, stacks.reshape(b, f, h * w))


class _StackGraphs:
    """The stack of one batch shape on one CUDA device as two captured
    CUDA graphs, split at ``eigh`` (whose error flags the host reads):
    graph A from the histogram percentiles to the PCA covariance, graph B
    from ``eigh``'s outputs to the (B, 19, H, W) stack. ``lut_hist`` writes
    straight into graph A's static inputs; ``eigh`` and ``forest_labels``
    run eagerly between and after the replays, as one launch each.

    The first :meth:`labels` runs the batch eagerly on a side stream, then
    captures both graphs into one private memory pool (about the eager
    stack's peak); later calls replay them. ``lock`` holds from the write
    into the static inputs to the forest's launch, and ``done`` (recorded
    after that launch) orders a caller on another stream behind the last
    one's use of the static buffers."""

    captures = 0         # graph pairs captured in this process

    def __init__(self, shape, cfg: FeatureStageConfig, dev: torch.device):
        self.cfg, self.dev = cfg, dev
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.graphs = None
        b, c, h, w = shape
        f32 = dict(dtype=torch.float32, device=dev)
        self.stretched = torch.empty(shape, **f32)
        self.hist = torch.empty((b, c, 256), dtype=torch.int32, device=dev)
        self.eigvals = torch.empty((b, c), **f32)
        self.eigvecs = torch.empty((b, c, c), **f32)

    def _capture(self, stream: torch.cuda.Stream) -> None:
        with span("turbo.capture"):
            graph_a, graph_b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            # thread_local: other threads (a server's) may call CUDA
            # while this one captures
            with torch.cuda.graph(graph_a, stream=stream,
                                  capture_error_mode="thread_local"):
                self.front = _stack_front(self.stretched, self.hist,
                                          self.cfg)
            with torch.cuda.graph(graph_b, pool=graph_a.pool(),
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                self.stack = _stack_back(self.front, self.eigvals,
                                         self.eigvecs, self.cfg)
            self.graphs = (graph_a, graph_b)
            _StackGraphs.captures += 1

    def labels(self, scenes, luts, hh, gf: GemmForest):
        """``(labels, replayed)``: the batch's (B, H * W) int32 forest
        labels, a new tensor, and whether the stack ran as replays."""
        with torch.cuda.device(self.dev), self.lock:
            stream = torch.cuda.current_stream(self.dev)
            if self.graphs is None:
                side = torch.cuda.Stream(self.dev)
                side.wait_stream(stream)
                with torch.cuda.stream(side):
                    labels = _labels_eager(scenes, luts, hh, gf, self.cfg)
                stream.wait_stream(side)
                labels.record_stream(stream)
                self._capture(side)
                return labels, False
            stream.wait_event(self.done)
            _preamble(scenes, luts, hh, out=self.stretched,
                      hist_out=self.hist)
            graph_a, graph_b = self.graphs
            graph_a.replay()
            eigvals, eigvecs = _eigh(self.front["cov"])
            self.eigvals.copy_(eigvals)
            self.eigvecs.copy_(eigvecs)
            graph_b.replay()
            b, f, h, w = self.stack.shape
            labels = forest_labels(gf, self.stack.reshape(b, f, h * w))
            self.done.record(stream)
            return labels, True


# (device, B, C, H, W, FeatureStageConfig) -> its _StackGraphs
_STACK_GRAPHS: "dict[tuple, _StackGraphs]" = {}
_STACK_GRAPHS_LOCK = threading.Lock()
# pixels (B * H * W) of the batch shapes whose graphs a device holds at
# most: each holds a private pool of about the eager stack's peak, some
# 0.7 GB a megapixel, until the process ends; 16 tiles of 600 x 600 take
# the serving engine's buckets 1, 2, 4 and 8 (about 4 GB)
STACK_GRAPH_PIXELS = 16 * 600 * 600


def _stack_graphs(shape, cfg: FeatureStageConfig, dev: torch.device
                  ) -> "_StackGraphs | None":
    """The graphs of a batch shape, made on its first call while the
    shapes whose graphs ``dev`` holds, this one with them, stay within
    ``STACK_GRAPH_PIXELS``; None past that (the batch runs eagerly: a
    large batch's launches are a small share of its device time)."""
    key = (dev, *shape, cfg)
    with _STACK_GRAPHS_LOCK:
        entry = _STACK_GRAPHS.get(key)
        if entry is None:
            held = sum(k[1] * k[3] * k[4] for k in _STACK_GRAPHS
                       if k[0] == dev)
            if held + shape[0] * shape[2] * shape[3] > STACK_GRAPH_PIXELS:
                return None
            entry = _STACK_GRAPHS[key] = _StackGraphs(shape, cfg, dev)
    return entry


def classify_scenes_turbo(scenes_u8, stretch_luts_u8, gf: GemmForest,
                          cfg: FeatureStageConfig = FeatureStageConfig(),
                          stretch_params=None, stretch_hists=None,
                          device: DeviceLike = None) -> torch.Tensor:
    """(B, 7, H, W) raw uint8 scenes + (B, 7, 256) stretch LUTs -> (B, H, W)
    uint8 class maps on ``device`` (CUDA unless named): preamble, 19-channel
    stack and forest labels over the whole batch (one launch of each
    kernel). ``stretch_hists``: optional (B, 7, 256) int32 host
    stretched-value histograms (``stretch_tables_from_counts``); with
    them the preamble skips its own count. ``stretch_params`` is accepted
    for the JAX package's signature and not read: every band is served
    from the LUT.

    On a CUDA device the stack replays the batch shape's captured graphs
    (:class:`_StackGraphs`; the first call of a shape runs eagerly and
    captures them) while the shapes with graphs stay within
    ``STACK_GRAPH_PIXELS``; other batches, and every batch on the CPU, run
    each operation eagerly. The maps are a new tensor either way. Marked ``turbo.batch``, with count
    ``stack_graph``: 1 when the stack ran as replays, else 0."""
    with span("turbo.batch") as rec:
        scenes, luts, hh = _batch_inputs(scenes_u8, stretch_luts_u8,
                                         stretch_hists, device)
        b, _, h, w = scenes.shape
        graphs = (_stack_graphs(scenes.shape, cfg, scenes.device)
                  if scenes.device.type == "cuda" else None)
        if graphs is None:
            labels, replayed = _labels_eager(scenes, luts, hh, gf,
                                             cfg), False
        else:
            labels, replayed = graphs.labels(scenes, luts, hh, gf)
        if rec is not None:
            rec.counts["stack_graph"] = int(replayed)
        return labels.reshape(b, h, w).to(torch.uint8)


# ------------------------------------------------------- KMeans programs

def kmeans_features(scenes_u8: torch.Tensor, stretch_luts_u8: torch.Tensor,
                    cfg: FeatureStageConfig, hist_in=None
                    ) -> torch.Tensor:
    """(B, 7, H, W) raw scenes -> (B, 19, H * W) stacks, each feature of
    each scene MinMax-scaled over its pixels (sklearn's MinMaxScaler; a
    constant feature to 0)."""
    stacks = _stack_cm_from_parts(*_preamble(scenes_u8, stretch_luts_u8,
                                             hist_in), cfg)
    b, f, h, w = stacks.shape
    return minmax_scale_features(stacks.reshape(b, f, h * w), dim=2)


def kmeans_fit(xs_cm: torch.Tensor, n_clusters: int, seed: int,
               fit_stride: int, shared_fit: bool, init_cents=None):
    """The fit of the KMeans program on scaled (B, F, N) features:
    ``(centroids of each scene (B, K, F), the fitted centroids ((K, F)
    with ``shared_fit``, else (B, K, F)), Lloyd iterations (1,) or
    (B,))``.

    Per scene, Lloyd runs on every ``fit_stride``-th pixel (a strided
    slice); with ``shared_fit``, one fit runs on every ``fit_stride * B``-th
    pixel of each scene, scene after scene, from ``init_cents`` when
    given."""
    b, f, _ = xs_cm.shape
    if shared_fit:
        xfit = xs_cm[:, :, ::fit_stride * b].transpose(1, 2).reshape(1, -1, f)
        cents, n_iter, _ = fit_centroids(xfit, n_clusters, seed,
                                         init_centroids=init_cents)
        return cents.expand(b, -1, -1), cents[0], n_iter
    xfit = xs_cm[:, :, ::fit_stride].transpose(1, 2).contiguous()
    cents, n_iter, _ = fit_centroids(xfit, n_clusters, seed)
    return cents, cents, n_iter


def assign_clusters(xs_cm: torch.Tensor, cents: torch.Tensor
                    ) -> torch.Tensor:
    """Every pixel's nearest centroid: (B, F, N) features and (B, K, F)
    centroids -> (B, N) int64, ``argmin_k (|c_k|^2 - 2 c_k . x)`` (first
    index on ties). Marked ``kmeans.assign``."""
    with span("kmeans.assign"):
        cross = torch.bmm(cents, xs_cm)                      # (B, K, N)
        cn = torch.sum(cents * cents, dim=2)
        return torch.argmin(cn[:, :, None] - 2.0 * cross, dim=1)


def kmeans_scenes_turbo_batch(scenes_u8, stretch_luts_u8,
                              n_clusters: int = 7,
                              cfg: FeatureStageConfig = FeatureStageConfig(),
                              seed: int = 42, fit_stride: int = 8,
                              stretch_params=None, stretch_hists=None,
                              shared_fit: bool = False, init_cents=None,
                              return_cents: bool = False,
                              device: DeviceLike = None):
    """Unsupervised classification of a batch: (B, 7, H, W) raw uint8
    scenes + (B, 7, 256) stretch LUTs -> (B, H, W) uint8 cluster maps
    (1-based) on ``device`` (CUDA unless named).

    Per scene: the 19-channel stack, MinMax scaling, a k-means++ and Lloyd
    fit on every ``fit_stride``-th pixel, then one assignment of every
    pixel to the converged centroids (:func:`kmeans_fit`,
    :func:`assign_clusters`). Each scene fits on its own and stops when it
    converges; cluster ids depend on the seed, which every scene shares.

    ``shared_fit=True``: one model fitted on pixels drawn evenly from all
    scenes, and every scene assigned to it, so cluster ids agree across
    the batch. ``init_cents`` (only with ``shared_fit``, else
    ``ValueError``): a (K, F) warm start for that fit. ``return_cents``:
    also return the fitted centroids, (K, F) with ``shared_fit``, else
    (B, K, F). ``stretch_params`` and ``stretch_hists`` are as in
    :func:`classify_scenes_turbo`. Marked ``turbo.batch``; the fit's
    spans are ``models.kmeans``'s."""
    if init_cents is not None and not shared_fit:
        raise ValueError("init_cents warm start requires shared_fit=True")
    with span("turbo.batch"):
        scenes, luts, hh = _batch_inputs(scenes_u8, stretch_luts_u8,
                                         stretch_hists, device)
        b, _, h, w = scenes.shape
        xs_cm = kmeans_features(scenes, luts, cfg, hh)
        cents, fit_cents, _ = kmeans_fit(xs_cm, n_clusters, seed,
                                         fit_stride, shared_fit, init_cents)
        maps = (assign_clusters(xs_cm, cents).reshape(b, h, w) + 1).to(
            torch.uint8)
    return (maps, fit_cents) if return_cents else maps


def kmeans_scenes_turbo(scene_u8, stretch_lut_u8, n_clusters: int = 7,
                        cfg: FeatureStageConfig = FeatureStageConfig(),
                        seed: int = 42,
                        device: DeviceLike = None) -> torch.Tensor:
    """ONE (7, H, W) raw uint8 scene + its (7, 256) stretch LUT -> (H, W)
    uint8 cluster map (1-based) on ``device`` (CUDA unless named): the
    batched program on a batch of one, fitted on every pixel."""
    dev = resolve_device(device)
    return kmeans_scenes_turbo_batch(
        as_tensor(scene_u8, dev, torch.uint8)[None],
        as_tensor(stretch_lut_u8, dev, torch.uint8)[None], n_clusters, cfg,
        seed, fit_stride=1, device=dev)[0]


# ------------------------------------------------------ batched rule program

def rule_indices(stretched: torch.Tensor, hist: torch.Tensor,
                 cfg: FeatureStageConfig):
    """Robust normalisation and the four rule indices of stretched
    (B, 7, H, W) scenes (exact uint8 levels, any dtype) with their
    (B, 7, 256) histograms: ``(ndvi, ndwi, mndwi, ndbi)``, each (B, H, W)
    f32. The rule programs never build the PCA or texture channels."""
    b, c, h, w = stretched.shape
    vals = torch.arange(256, dtype=torch.float32,
                        device=stretched.device).expand(b, c, 256)
    p = percentiles_from_counts(hist, vals,
                                (cfg.normalize.lower_percentile,
                                 cfg.normalize.upper_percentile), h * w)
    lo, hi = p[0][..., None, None], p[1][..., None, None]
    x = ((torch.clamp(stretched.to(torch.float32), lo, hi) - lo)
         / (hi - lo + cfg.normalize.epsilon))
    return (ndvi(x[:, 3], x[:, 2]), ndwi(x[:, 1], x[:, 3]),
            mndwi(x[:, 1], x[:, 4]), ndbi(x[:, 4], x[:, 3]))


def _rule_front(scenes_u8: torch.Tensor, stretch_luts_u8: torch.Tensor,
                cfg: FeatureStageConfig, hist_in=None):
    """Preamble, then :func:`rule_indices`, of a (B, 7, H, W) batch."""
    return rule_indices(*_preamble(scenes_u8, stretch_luts_u8, hist_in), cfg)


def _rule_first_stage(ndvi_b: torch.Tensor, ndwi_b: torch.Tensor,
                      mndwi_b: torch.Tensor, ndbi_b: torch.Tensor,
                      rc: RuleBasedConfig):
    """The thresholded and closed vegetation, water and built-up masks of
    a batch, stacked (3B, H, W) uint8 in that order, and their (3B,)
    int32 minimum areas."""
    b, h, w = ndvi_b.shape
    area = h * w
    veg = threshold_binary(ndvi_b, rc.ndvi_threshold)
    if rc.use_mndwi_if_available:
        water = threshold_binary(mndwi_b, rc.mndwi_threshold)
    else:
        water = threshold_binary(ndwi_b, rc.ndwi_threshold)
    built = (threshold_binary(ndbi_b, rc.ndbi_threshold).bool()
             & threshold_binary(ndvi_b, rc.ndvi_threshold_for_builtup,
                                above=False).bool()).to(torch.uint8)
    stack3 = torch.cat([closing(veg, 3, shape="ellipse"),
                        closing(water, 3, shape="ellipse"),
                        closing(built, 5, shape="ellipse")])
    min_areas = torch.tensor(
        [int(area * rc.veg_min_area_frac)] * b
        + [int(area * rc.water_min_area_frac)] * b
        + [int(area * rc.builtup_min_area_frac)] * b,
        dtype=torch.int32, device=ndvi_b.device)
    return stack3, min_areas


def rule_based_scenes_turbo_batch(scenes_u8, stretch_luts_u8,
                                  cfg: FeatureStageConfig = FeatureStageConfig(),
                                  rule_cfg: "RuleBasedConfig | None" = None,
                                  stretch_params=None, stretch_hists=None,
                                  return_overflow: bool = False,
                                  device: DeviceLike = None):
    """Batched rule-based classification: (B, 7, H, W) raw uint8 scenes +
    (B, 7, 256) stretch LUTs -> (B, H, W) uint8 labels on ``device`` (CUDA
    unless named): 0 unclassified, 1 vegetation, 2 water, 3 built-up,
    4 bare land.

    Thresholds give the vegetation, water and built-up masks. Each is
    closed, cleared of small components in one batched pass over all 3B
    masks, and opened; they paint built-up, then vegetation, then water.
    Bare land comes from the unclassified remainder the same way, in a
    second pass over B masks. ``stretch_params`` and ``stretch_hists`` are
    as in :func:`classify_scenes_turbo`.

    Component ids are capped at 32768 per mask
    (``ops.components.remove_small_components_batch``). With
    ``return_overflow=True`` it also returns a (B,) bool marking the scenes
    where any of their four masks hit the cap, whose output may have
    dropped a large component; callers reroute those scenes to a path
    without the cap. Marked ``turbo.batch``."""
    with span("turbo.batch"):
        scenes, luts, hh = _batch_inputs(scenes_u8, stretch_luts_u8,
                                         stretch_hists, device)
        out, overflow = _rule_labels(*_rule_front(scenes, luts, cfg, hh),
                                     rule_cfg if rule_cfg is not None
                                     else RuleBasedConfig())
    return (out, overflow) if return_overflow else out


def _rule_labels(ndvi_b: torch.Tensor, ndwi_b: torch.Tensor,
                 mndwi_b: torch.Tensor, ndbi_b: torch.Tensor,
                 rc: RuleBasedConfig):
    """The rule program after its index planes: (B, H, W) uint8 labels and
    the (B,) overflow flags."""
    b, h, w = ndvi_b.shape
    stack3, min3 = _rule_first_stage(ndvi_b, ndwi_b, mndwi_b, ndbi_b, rc)
    kept, ov3 = remove_small_components_batch(stack3, min3,
                                              return_overflow=True)
    veg = opening(kept[:b], 3, shape="ellipse")
    water = opening(kept[b:2 * b], 3, shape="ellipse")
    built = opening(kept[2 * b:], 5, shape="ellipse")

    out = torch.zeros((b, h, w), dtype=torch.uint8, device=ndvi_b.device)
    out = torch.where(built == 1, 3, out)   # priority paint: built-up,
    out = torch.where(veg == 1, 1, out)     # then vegetation,
    out = torch.where(water == 1, 2, out)   # and water wins

    nd_v = torch.nan_to_num(ndvi_b)
    nd_b = torch.nan_to_num(ndbi_b)
    bare = ((out == 0)
            & (nd_v > rc.bareland_ndvi_low) & (nd_v < rc.bareland_ndvi_high)
            & (nd_b > rc.bareland_ndbi_low) & (nd_b < rc.bareland_ndbi_high)
            ).to(torch.uint8)
    bare = closing(bare, 3, shape="ellipse")
    bare_areas = torch.full((b,), int(h * w * rc.bareland_min_area_frac),
                            dtype=torch.int32, device=ndvi_b.device)
    bare, ov_bare = remove_small_components_batch(bare, bare_areas,
                                                  return_overflow=True)
    bare = opening(bare, 3, shape="ellipse")
    out = torch.where((bare == 1) & (out == 0), 4, out)
    return out, ov3[:b] | ov3[b:2 * b] | ov3[2 * b:] | ov_bare


# ------------------------------------------------- single-scene rule program

def rule_based_scenes_turbo(scene_u8, stretch_lut_u8,
                            cfg: FeatureStageConfig = FeatureStageConfig(),
                            rule_cfg: "RuleBasedConfig | None" = None,
                            cc_impl: str = "auto",
                            device: DeviceLike = None) -> torch.Tensor:
    """Rule-based classification of ONE scene: a (7, H, W) raw uint8 scene
    + its (7, 256) stretch LUT -> (H, W) uint8 labels on ``device`` (CUDA
    unless named), 0 unclassified, 1 vegetation, 2 water, 3 built-up,
    4 bare land.

    The preamble (``lut_hist``, with its histogram) and the four index
    planes are the batched program's; the rest is
    ``pipeline.classify.rule_based_classify``, whose four min-area stages
    label whole masks with ``ops.kernels.cc_labels`` and have no id cap.
    ``cc_impl`` picks the connected-components route
    (``ops.components.connected_components_best``)."""
    dev = resolve_device(device)
    scene = as_tensor(scene_u8, dev, torch.uint8)[None]
    lut = as_tensor(stretch_lut_u8, dev, torch.uint8)[None]
    planes = [p[0] for p in _rule_front(scene, lut, cfg)]
    return rule_based_classify(*planes, rule_cfg if rule_cfg is not None
                               else RuleBasedConfig(), cc_impl=cc_impl)
