"""Memory-bounded large-scene classification with global semantics.

Counterpart of ``rs_image_segmentation_tpu.pipeline.large_scene``. The
monolithic programs hold a whole scene and its 19-channel stack on the
device; this module streams row tiles through it while every global
statistic stays exact, so a scene of any size classifies (near-)identically
to the monolithic programs. It consumes the stage-1 output, a (7, H, W)
scene of stretched uint8 levels, so every global percentile is an exact
function of per-band 256-bin histograms:

  pass A (host)   : per-band histograms -> robust-normalise p2/p98,
                    RobustScaler median/IQR, texture bounds;
  pass B/C (card) : one program a tile: the PCA sums of the RobustScaler'd
                    bands (f32, added in f64 on the host in tile order,
                    then ``eigh`` with sklearn's ``svd_flip`` sign), the
                    GLCM window grid (tile heights are multiples of the
                    window step, so no window straddles two tiles) and the
                    tile's Sobel maximum;
  pass D (card)   : per tile with an 8-row halo, the 19-channel stack
                    (indices, PC1, stencils, rows of the globally resized
                    GLCM maps) and the forest (CUDA kernel
                    ``ops.kernels.forest_labels``), or the KMeans
                    assignment.

``preprocess_large`` stretches a raw scene of any size with the exact LUT
(CUDA kernel ``ops.kernels.lut_hist``, uint8 out, with the stretched
histogram). ``classify_large_scene_streamed`` takes the raw scene from the
host: its row chunks are copied once on the host into pinned memory, then
to the device on a side stream (``io.stream.HostToDevice``), and counted as
they land (CUDA kernel ``ops.kernels.raw_counts``); the stretch tables come
from those counts. The rule route (``rule_based_large_scene``) runs over
the whole scene (CUDA kernel ``ops.kernels.cc_labels``). The
``*_resumable`` drivers checkpoint per tile or per mask and resume bit for
bit.

Every entry point takes ``device=``: CUDA unless the caller names the CPU
(``backend.resolve_device``). A scene of at most
``DEVICE_RESIDENT_MAX_BYTES`` is copied to the device once and tiles are
slices of it; a larger one is shipped tile by tile on every pass.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, resolve_device
from ..core.config import (CalibrationConfig, FeatureStageConfig,
                           RuleBasedConfig)
from ..io.stream import HostToDevice
from ..models.forest import GemmForest
from ..models.kmeans import kmeans_fit_predict, lloyd_step
from ..ops.indices import spectral_indices
from ..ops.kernels import forest_labels, histogram256, lut_hist, raw_counts
from ..ops.morphology import gradient
from ..ops.stencil import box_filter, sobel_magnitude
from ..ops.texture import _extract_windows, glcm_matrices, glcm_properties
from ..utils.timing import span
from .classify import (bare_rule_mask, paint_rule_masks, rule_based_classify,
                       rule_mask)
from .preprocess import build_stretch_lut, stretch_tables_from_counts
from .turbo import rule_indices


# -------------------------------------------------- histogram percentiles

def band_histograms_u8(arr: np.ndarray) -> np.ndarray:
    """(C, H, W) uint8-valued array -> (C, 256) int64 counts (host)."""
    return np.stack([np.bincount(band.reshape(-1).astype(np.uint8),
                                 minlength=256) for band in arr])


def percentile_from_hist(hist: np.ndarray, values: np.ndarray, q: float
                         ) -> float:
    """np.percentile(method='linear') over a value multiset given counts.

    ``values`` are the sorted distinct values of the histogram's bins."""
    n = int(hist.sum())
    pos = q / 100.0 * (n - 1)
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    cum = np.cumsum(hist)
    v_lo = values[np.searchsorted(cum, lo + 1)]
    v_hi = values[np.searchsorted(cum, hi + 1)]
    frac = pos - lo
    return float(v_lo * (1 - frac) + v_hi * frac)


class GlobalStats:
    """Per-band global statistics driving the tile programs."""

    def __init__(self, c: int):
        self.p_lo = np.zeros(c, np.float32)
        self.p_hi = np.zeros(c, np.float32)
        self.median = np.zeros(c, np.float32)
        self.iqr = np.zeros(c, np.float32)
        self.tex_lo = None
        self.tex_hi = None
        self.pca_mean = None       # (C,) mean of RobustScaler'd bands
        self.pca_comp1 = None      # (C,) first principal axis
        self.sobel_max = None


def compute_global_stats(arr: np.ndarray,
                         cfg: FeatureStageConfig = FeatureStageConfig(),
                         hists: Optional[np.ndarray] = None) -> GlobalStats:
    """Pass A over a preprocessed (uint8-valued) scene, on the host."""
    if hists is None:
        hists = band_histograms_u8(arr)
    c = hists.shape[0]
    stats = GlobalStats(c)
    lo_q = cfg.normalize.lower_percentile
    hi_q = cfg.normalize.upper_percentile
    levels = np.arange(256, dtype=np.float64)
    tb = cfg.texture_band_index
    for i in range(c):
        stats.p_lo[i] = np.float32(percentile_from_hist(hists[i], levels,
                                                        lo_q))
        stats.p_hi[i] = np.float32(percentile_from_hist(hists[i], levels,
                                                        hi_q))
    # each level's normalised value with the tile programs' f32 arithmetic
    # (the denominators formed in host f32), so the median, IQR and
    # texture bounds are those of the normalised pixels
    denom = stats.p_hi - stats.p_lo + np.float32(cfg.normalize.epsilon)
    lo_t = torch.from_numpy(stats.p_lo)[:, None]
    hi_t = torch.from_numpy(stats.p_hi)[:, None]
    lv = torch.arange(256, dtype=torch.float32)[None, :]
    norm = ((torch.clamp(lv, lo_t, hi_t) - lo_t)
            / torch.from_numpy(denom)[:, None]).numpy().astype(np.float64)
    for i in range(c):
        stats.median[i] = np.float32(percentile_from_hist(hists[i], norm[i],
                                                          50.0))
        q1 = percentile_from_hist(hists[i], norm[i], 25.0)
        q3 = percentile_from_hist(hists[i], norm[i], 75.0)
        stats.iqr[i] = np.float32((q3 - q1) if (q3 - q1) > 0 else 1.0)
        if i == tb:
            stats.tex_lo = np.float32(percentile_from_hist(hists[i], norm[i],
                                                           lo_q))
            stats.tex_hi = np.float32(percentile_from_hist(hists[i], norm[i],
                                                           hi_q))
    return stats


# -------------------------------------------------- tile sources

HALO = 8  # >= max stencil reach in the stack (7x7 context -> 3,
#            grad5/std5 -> 2, sobel -> 1; 8 rounds up)

DEVICE_RESIDENT_MAX_BYTES = 2 << 30


class _HostScene(NamedTuple):
    """A scene past ``DEVICE_RESIDENT_MAX_BYTES``: tiles are copied from
    the host on every pass."""
    arr: np.ndarray
    up: HostToDevice


def _tile_src(arr_np: np.ndarray, device: torch.device):
    """The whole scene on ``device`` when it is at most
    ``DEVICE_RESIDENT_MAX_BYTES`` (one copy from pinned host memory; tiles
    are then slices of it), else a :class:`_HostScene`."""
    if arr_np.nbytes <= DEVICE_RESIDENT_MAX_BYTES:
        return HostToDevice(device, depth=1).put(arr_np)
    return _HostScene(arr_np, HostToDevice(device))


def _get_tile(src, ys: int, ye: int) -> torch.Tensor:
    if isinstance(src, torch.Tensor):
        return src[:, ys:ye, :]
    return src.up.put(src.arr[:, ys:ye, :])


def _halo_tiles(h: int, tile_rows: int, halo: int = HALO
                ) -> Iterator[Tuple[int, int, int, int]]:
    """``(y0, rows, ys, ye)`` of each row tile: its rows ``[y0, y0 +
    rows)`` and its read window ``[ys, ye)`` with ``halo`` rows each side,
    cut at the scene's edges."""
    for y0 in range(0, h, tile_rows):
        rows = min(tile_rows, h - y0)
        yield y0, rows, max(0, y0 - halo), min(h, y0 + rows + halo)


def _label_transfer_dtype(gf: GemmForest) -> torch.dtype:
    """uint8 labels (a quarter of the transfer) when every class id fits;
    other class ids (e.g. land-cover codes > 255) keep int32."""
    classes = gf.classes.cpu().numpy()
    if classes.min() >= 0 and classes.max() <= 255:
        return torch.uint8
    return torch.int32


# -------------------------------------------------- tiled preprocessing

def preprocess_large(arr: np.ndarray,
                     cal: CalibrationConfig = CalibrationConfig(),
                     tile_rows: int = 2048,
                     return_device: bool = False,
                     return_hist: bool = False,
                     device: DeviceLike = None):
    """Stage 1 for a uint8 scene of any size: calibration and the global
    min/max stretch as the exact f64 per-DN LUT
    (``pipeline.preprocess.build_stretch_lut``; bit-equal to
    ``preprocess_bands`` and the reference's numpy math), applied by
    ``ops.kernels.lut_hist`` with uint8 out on ``device`` (CUDA unless
    named; on a CPU tensor its plain version).

    A scene of at most ``DEVICE_RESIDENT_MAX_BYTES`` takes one launch; a
    larger one is stretched tile by tile with a host writeback and one
    tile of lookahead, so device memory stays bounded.
    ``return_device=True`` keeps a resident result on the device (a
    tensor). ``return_hist=True`` returns ``(out, hists)``, ``hists`` the
    (C, 256) int64 histogram of the stretched scene, which
    :func:`classify_large_scene` takes to skip its histogram pass (the
    JAX package's TPU contract; both versions of the kernel count it)."""
    dev = resolve_device(device)
    c, h, w = arr.shape
    # calibration is affine per band: the LUT needs only the DN min/max
    lut = torch.from_numpy(build_stretch_lut(arr, cal.gains, cal.biases)
                           .astype(np.uint8)).to(dev)

    def apply(tile):
        return lut_hist(tile, lut, out_u8=True)

    src = _tile_src(arr, dev)
    if isinstance(src, torch.Tensor):
        out, hist = apply(src)
        if not return_device:
            out = out.cpu().numpy()
        if return_hist:
            return out, hist.cpu().numpy().astype(np.int64)
        return out
    out = np.zeros((c, h, w), np.uint8)
    hsum = None

    def drain(item):
        nonlocal hsum
        p0, pe, p_out, p_hist = item
        out[:, p0:pe, :] = p_out.cpu().numpy()
        p_hist = p_hist.cpu().numpy().astype(np.int64)
        hsum = p_hist if hsum is None else hsum + p_hist

    prev = None
    for y0 in range(0, h, tile_rows):
        ye = min(h, y0 + tile_rows)
        cur = (y0, ye, *apply(_get_tile(src, y0, ye)))
        if prev is not None:          # tile i + 1 is enqueued before
            drain(prev)               # tile i is fetched
        prev = cur
    drain(prev)
    return (out, hsum) if return_hist else out


# -------------------------------------------------- per-tile programs

def _normalize_tile(tile: torch.Tensor, p_lo: torch.Tensor,
                    p_hi: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Stretched-u8 tile -> globally robust-normalised [0, 1] bands."""
    x = tile.to(torch.float32)
    lo = p_lo[:, None, None]
    hi = p_hi[:, None, None]
    return (torch.clamp(x, lo, hi) - lo) / (hi - lo + eps)


def _tex01(nir01: torch.Tensor, tex_lo: torch.Tensor,
           tex_hi: torch.Tensor) -> torch.Tensor:
    """The texture band renormalised between its global percentiles."""
    return (torch.clamp(nir01, tex_lo, tex_hi) - tex_lo) / (
        tex_hi - tex_lo + 1e-10)


def _pca_sums(norm: torch.Tensor, med: torch.Tensor, iqr: torch.Tensor):
    """(C,) sums and (C, C) f32 Gram of the RobustScaler'd bands."""
    xs = (norm - med[:, None, None]) / iqr[:, None, None]
    flat = xs.reshape(xs.shape[0], -1)
    return torch.sum(flat, dim=1), flat @ flat.T


def _pca_from_sums(s1: np.ndarray, s2: np.ndarray, n: int):
    """The f64 mean and first principal axis (sklearn's ``svd_flip``
    sign) from the f64 sums, as f32."""
    mean = s1 / n
    cov = (s2 - n * np.outer(mean, mean)) / (n - 1)
    eigvals, eigvecs = np.linalg.eigh(cov)
    comp1 = eigvecs[:, np.argsort(-eigvals)[0]]
    if comp1[np.argmax(np.abs(comp1))] < 0:
        comp1 = -comp1
    return mean.astype(np.float32), comp1.astype(np.float32)


def _add_sums(results, c: int, s1: np.ndarray, s2: np.ndarray) -> None:
    """Add per-tile f32 (s1, s2) results into the f64 sums, tile by tile
    in order, after one host fetch."""
    flat = torch.stack([torch.cat([r[0], r[1].reshape(-1)])
                        for r in results])
    with span("large.fetch", bytes=flat.nbytes):
        flat = flat.cpu().numpy()
    for row in flat.astype(np.float64):
        s1 += row[:c]
        s2 += row[c:].reshape(c, c)


def _device_stats(stats: GlobalStats, device: torch.device):
    return tuple(torch.from_numpy(v).to(device) for v in
                 (stats.p_lo, stats.p_hi, stats.median, stats.iqr))


def _fit_global_pca(arr: np.ndarray, stats: GlobalStats,
                    tile_rows: int, src=None,
                    device: DeviceLike = None) -> None:
    """The global PCA over RobustScaler'd bands, tile by tile (fills
    ``stats.pca_mean`` and ``stats.pca_comp1``). The tiled classify
    pipeline folds this into its merged pass B/C (:func:`_global_passes`),
    which gives the same values."""
    dev = resolve_device(device)
    src = _tile_src(arr, dev) if src is None else src
    c, h, w = arr.shape
    p_lo, p_hi, med, iqr = _device_stats(stats, dev)
    s1 = np.zeros(c, np.float64)
    s2 = np.zeros((c, c), np.float64)
    pending = []
    for y0 in range(0, h, tile_rows):
        ye = min(h, y0 + tile_rows)
        res = _pca_sums(_normalize_tile(_get_tile(src, y0, ye), p_lo, p_hi),
                        med, iqr)
        if isinstance(src, torch.Tensor):
            pending.append(res)
        else:       # streaming: fetch per tile, in-flight buffers bounded
            _add_sums([res], c, s1, s2)
    if pending:     # one fetch; f64 accumulation still per tile in order
        _add_sums(pending, c, s1, s2)
    stats.pca_mean, stats.pca_comp1 = _pca_from_sums(s1, s2, h * w)


def _tile_glcm_grid(tex01_tile: torch.Tensor, levels: int, window: int,
                    step: int, angles) -> Tuple[torch.Tensor, torch.Tensor]:
    """GLCM contrast and homogeneity of each window of a tile (distance 1,
    mean over angles): the XLA route, as the monolithic stack takes it."""
    q = (tex01_tile * (levels - 1)).to(torch.uint8).to(torch.int64)
    props = glcm_properties(glcm_matrices(_extract_windows(q, window, step),
                                          levels, (1,), angles))
    n_i = (tex01_tile.shape[0] - window) // step + 1
    n_j = (tex01_tile.shape[1] - window) // step + 1
    return (torch.mean(props["contrast"], dim=(1, 2)).reshape(n_i, n_j),
            torch.mean(props["homogeneity"], dim=(1, 2)).reshape(n_i, n_j))


def _tile_globals(tile: torch.Tensor, p_lo, p_hi, med, iqr, tex_lo, tex_hi,
                  *, lo: int, rows: int, glcm_rows: int, levels: int,
                  window: int, step: int, angles, tb: int, n_j: int):
    """The merged pass-B/C program of one tile: ``(s1, s2, contrast grid,
    homogeneity grid, Sobel max)``. The tile spans ``[max(0, y0 - 1),
    min(h, y0 + rows + 1))``: its interior rows ``[lo, lo + rows)`` give
    the PCA sums and the GLCM grid rows, the whole slice the Sobel
    maximum."""
    s1, s2 = _pca_sums(_normalize_tile(tile[:, lo:lo + rows, :], p_lo, p_hi),
                       med, iqr)
    nir = _normalize_tile(tile[tb:tb + 1], p_lo[tb:tb + 1],
                          p_hi[tb:tb + 1])[0]
    tex = _tex01(nir, tex_lo, tex_hi)
    u8 = (tex * 255.0).to(torch.uint8)
    # x * (1/255): XLA compiles the JAX package's x / 255.0 so, and a
    # forest threshold can sit exactly on a level k / 255
    smax = torch.amax(sobel_magnitude(u8.to(torch.float32)) * (1.0 / 255.0))
    if glcm_rows > 0:
        con, hom = _tile_glcm_grid(tex[lo:lo + rows], levels, window, step,
                                   angles)
    else:
        con = hom = torch.zeros((0, n_j), dtype=torch.float32,
                                device=tile.device)
    return s1, s2, con, hom, smax


def _resize_rows(grid: torch.Tensor, out_hw: Tuple[int, int], row0: int,
                 rows: int) -> torch.Tensor:
    """Rows ``[row0, row0 + rows)`` of ``resize_bilinear(grid, out_hw)``
    without the full map."""
    h, w = grid.shape
    oh, ow = out_hw
    sy, sx = h / oh, w / ow
    f32 = dict(dtype=torch.float32, device=grid.device)
    ry = (torch.arange(rows, **f32) + row0 + 0.5) * sy - 0.5
    rx = (torch.arange(ow, **f32) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(ry), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(rx), 0, w - 1).to(torch.int64)
    fy = torch.clamp(ry - y0.to(torch.float32), 0.0, 1.0)[:, None]
    fx = torch.clamp(rx - x0.to(torch.float32), 0.0, 1.0)[None, :]
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    a = grid[y0][:, x0]
    b = grid[y0][:, x1]
    c = grid[y1][:, x0]
    d = grid[y1][:, x1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def _scene_hists(arr: np.ndarray, src, tile_rows: int) -> np.ndarray:
    """Pass A's (C, 256) int64 histograms: a resident scene counted on the
    device (``ops.kernels.histogram256`` a tile, summed), a streamed one on
    the host."""
    if not isinstance(src, torch.Tensor):
        return band_histograms_u8(arr)
    h = arr.shape[1]
    counts = torch.sum(torch.stack([
        histogram256(_get_tile(src, y0, min(h, y0 + tile_rows)))
        for y0 in range(0, h, tile_rows)]), dim=0)
    return counts.cpu().numpy().astype(np.int64)


def _global_passes(arr: np.ndarray, cfg: FeatureStageConfig,
                   tile_rows: int, src=None,
                   hists: Optional[np.ndarray] = None,
                   device: DeviceLike = None) -> dict:
    """Passes A-C as a dict of numpy arrays (checkpointable, so a resumed
    run skips them).

    ``hists``: precomputed (C, 256) histograms of ``arr``
    (``preprocess_large(return_hist=True)``), which skip pass A's
    histogram sweep (:func:`_scene_hists`). Passes B and C run as one
    program a tile (:func:`_tile_globals`). Every tile is enqueued before
    the results are fetched, in one transfer; a streamed scene fetches
    per tile with one tile of lookahead."""
    step = cfg.glcm.step_size
    if tile_rows % step:
        raise ValueError(f"tile_rows must be a multiple of {step}")
    dev = resolve_device(device)
    c, h, w = arr.shape
    src = _tile_src(arr, dev) if src is None else src
    resident = isinstance(src, torch.Tensor)
    if hists is None:
        hists = _scene_hists(arr, src, tile_rows)
    acc = _PassBC(compute_global_stats(arr, cfg, hists=hists), cfg, h, w,
                  dev)
    for y0, rows, ys, ye in _halo_tiles(h, tile_rows, halo=1):
        acc.dispatch(_get_tile(src, ys, ye), y0, rows, y0 - ys)
        if not resident and len(acc.pending) == 2:
            # streaming: tile i + 1 is enqueued before tile i's small
            # results are fetched, so two tiles at most are in flight
            acc.drain(acc.pending[:1])
            del acc.pending[0]
    acc.drain(acc.pending)
    return acc.globals_dict()


class _PassBC:
    """Pass B/C over the pass-A statistics ``stats``: the tile programs
    (:meth:`dispatch`), and on the host the f64 PCA sums, the GLCM grids
    and the Sobel maximum, drained from their results in tile order."""

    def __init__(self, stats: GlobalStats, cfg: FeatureStageConfig, h: int,
                 w: int, device: torch.device):
        c = stats.p_lo.shape[0]
        self.stats, self.cfg, self.h, self.w = stats, cfg, h, w
        self.window, self.step = cfg.glcm.window_size, cfg.glcm.step_size
        self.dstats = _device_stats(stats, device) + tuple(
            torch.tensor(v, dtype=torch.float32, device=device)
            for v in (stats.tex_lo, stats.tex_hi))
        self.s1 = np.zeros(c, np.float64)
        self.s2 = np.zeros((c, c), np.float64)
        self.sobel_max = 0.0
        self.con = np.zeros(((h - self.window) // self.step + 1,
                             (w - self.window) // self.step + 1), np.float32)
        self.hom = np.zeros_like(self.con)
        self.pending: list = []

    def dispatch(self, tile: torch.Tensor, y0: int, rows: int,
                 lo: int) -> None:
        """Enqueue the program of the tile whose rows ``[y0, y0 + rows)``
        start at row ``lo`` of ``tile`` (a row of halo each side, cut at
        the scene's edges)."""
        g = self.cfg.glcm
        glcm_rows = (0 if y0 > self.h - self.window
                     else max(0, (rows - self.window) // self.step + 1))
        self.pending.append((y0, glcm_rows, _tile_globals(
            tile, *self.dstats, lo=lo, rows=rows, glcm_rows=glcm_rows,
            levels=g.levels, window=self.window, step=self.step,
            angles=g.angles, tb=self.cfg.texture_band_index,
            n_j=self.con.shape[1])))

    def drain(self, items) -> None:
        """Fetch ``(y0, glcm_rows, result)`` items (tile order) in one
        transfer and fold them in."""
        if not items:
            return
        c = self.s1.shape[0]
        _add_sums([r for _, _, r in items], c, self.s1, self.s2)
        smax = torch.stack([r[4] for _, _, r in items])
        grids = torch.cat([torch.cat([r[2][:g].reshape(-1),
                                      r[3][:g].reshape(-1)])
                           for _, g, r in items])
        with span("large.fetch", bytes=smax.nbytes + grids.nbytes):
            smax, grids = smax.cpu().numpy(), grids.cpu().numpy()
        self.sobel_max = max(self.sobel_max, float(smax.max()))
        k = 0
        n_j = self.con.shape[1]
        for y0, g, _ in items:
            gi = y0 // self.step
            self.con[gi:gi + g] = grids[k:k + g * n_j].reshape(g, n_j)
            k += g * n_j
            self.hom[gi:gi + g] = grids[k:k + g * n_j].reshape(g, n_j)
            k += g * n_j

    def globals_dict(self) -> dict:
        st = self.stats
        st.pca_mean, st.pca_comp1 = _pca_from_sums(self.s1, self.s2,
                                                   self.h * self.w)
        return {"p_lo": st.p_lo, "p_hi": st.p_hi, "median": st.median,
                "iqr": st.iqr, "tex_lo": np.float32(st.tex_lo),
                "tex_hi": np.float32(st.tex_hi), "pca_mean": st.pca_mean,
                "pca_comp1": st.pca_comp1,
                "sobel_max": np.float32(self.sobel_max),
                "contrast_grid": self.con, "homog_grid": self.hom}


def _globals_device(g: dict, device: torch.device) -> dict:
    """The pass A-C statistics as tensors on ``device``."""
    def t(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(device)

    return {
        "p_lo": t(g["p_lo"]), "p_hi": t(g["p_hi"]),
        "median": t(g["median"]), "iqr": t(g["iqr"]),
        "pca_mean": t(g["pca_mean"]), "pca_comp1": t(g["pca_comp1"]),
        "tex_lo": t(g["tex_lo"]), "tex_hi": t(g["tex_hi"]),
        # the JAX package's host arithmetic for the Sobel normaliser
        "smax": t(np.float32(float(g["sobel_max"]) + 1e-10)),
        "con": t(g["contrast_grid"]), "hom": t(g["homog_grid"]),
    }


def _stack_tile_cm(tile: torch.Tensor, row0: int, gd: dict, *, lo: int,
                   rows: int, out_hw: Tuple[int, int], tb: int
                   ) -> torch.Tensor:
    """(7, rows + halo, W) stretched tile -> (19, rows, W) channel-major
    stack of its rows ``[lo, lo + rows)``."""
    bands01 = _normalize_tile(tile, gd["p_lo"], gd["p_hi"])
    idx = spectral_indices(bands01)
    xs = (bands01 - gd["median"][:, None, None]) / gd["iqr"][:, None, None]
    pc1 = torch.einsum("chw,c->hw", xs - gd["pca_mean"][:, None, None],
                       gd["pca_comp1"])
    tex = _tex01(bands01[tb], gd["tex_lo"], gd["tex_hi"])
    u8 = (tex * 255.0).to(torch.uint8)
    grad5 = gradient(u8, 5).to(torch.float32) * (1.0 / 255.0)
    mean5 = box_filter(tex, 5)
    std5 = torch.sqrt(torch.clamp_min(box_filter(tex * tex, 5)
                                      - mean5 * mean5, 0.0))
    smag = sobel_magnitude(u8.to(torch.float32)) * (1.0 / 255.0) / gd["smax"]
    level_1 = torch.stack([idx["ndwi"], idx["mndwi"], idx["ndvi"],
                           idx["evi"], idx["ndbi"], idx["bsi"], pc1])
    ctx = box_filter(level_1, 7, border="reflect")
    con = _resize_rows(gd["con"], out_hw, row0, rows)
    hom = _resize_rows(gd["hom"], out_hw, row0, rows)
    inner = slice(lo, lo + rows)
    return torch.cat([level_1[:, inner], ctx[:, inner],
                      torch.stack([con, hom, grad5[inner], std5[inner],
                                   smag[inner]])])


def _make_stack_fn(arr: np.ndarray, cfg: FeatureStageConfig,
                   tile_rows: int, globals_dict: Optional[dict] = None,
                   src=None, hists: Optional[np.ndarray] = None,
                   device: DeviceLike = None):
    """``(stack_tile, globals)``: the per-tile 19-channel stack function
    ``(tile, row0, lo, rows) -> (19, rows, W)`` over the pass A-C
    statistics (computed here unless a checkpointed dict is given)."""
    dev = resolve_device(device)
    c, h, w = arr.shape
    g = globals_dict if globals_dict is not None else _global_passes(
        arr, cfg, tile_rows, src=src, hists=hists, device=dev)
    gd = _globals_device(g, dev)
    tb = cfg.texture_band_index

    def stack_tile(tile, row0, lo, rows: int):
        return _stack_tile_cm(tile, row0, gd, lo=int(lo), rows=rows,
                              out_hw=(h, w), tb=tb)

    return stack_tile, g


def _classify_tile_cm(tile: torch.Tensor, row0: int, gd: dict,
                      gf: GemmForest, *, lo: int, rows: int,
                      out_hw: Tuple[int, int], tb: int,
                      out_dt: torch.dtype) -> torch.Tensor:
    """One tile's stack and forest labels (``ops.kernels.forest_labels``
    on its (19, rows * W) stack) -> (rows, W) ``out_dt`` labels."""
    stack = _stack_tile_cm(tile, row0, gd, lo=lo, rows=rows, out_hw=out_hw,
                           tb=tb)
    pred = forest_labels(gf, stack.reshape(stack.shape[0], -1))
    return pred.reshape(rows, out_hw[1]).to(out_dt)


def _tile_classifier(g: dict, gf: GemmForest, cfg: FeatureStageConfig,
                     out_hw: Tuple[int, int], device: torch.device):
    """Pass D over the globals ``g``: ``(tile, row0, lo, rows) -> (rows,
    W)`` labels on the device."""
    gd = _globals_device(g, device)
    out_dt = _label_transfer_dtype(gf)
    tb = cfg.texture_band_index

    def classify_tile(tile, row0, lo, rows: int):
        return _classify_tile_cm(tile, row0, gd, gf, lo=int(lo), rows=rows,
                                 out_hw=out_hw, tb=tb, out_dt=out_dt)

    return classify_tile


def _drain_labels(pending, out: np.ndarray, writer) -> None:
    """Copy ``(y0, rows, labels)`` tiles into ``out`` in order, handing
    each to ``writer.write_rows`` as it lands."""
    for y0, rows, dev in pending:
        with span("large.fetch", bytes=dev.nbytes):
            labels = dev.cpu().numpy()
        out[y0:y0 + rows] = labels
        if writer is not None:
            writer.write_rows(out[y0:y0 + rows])


def classify_large_scene(arr: np.ndarray, gf: GemmForest,
                         cfg: FeatureStageConfig = FeatureStageConfig(),
                         tile_rows: int = 504,
                         hists: Optional[np.ndarray] = None,
                         writer=None, device: DeviceLike = None
                         ) -> np.ndarray:
    """Classify a PREPROCESSED (7, H, W) uint8-valued scene of any size in
    row tiles on ``device`` (CUDA unless named) -> (H, W) int32 labels.
    ``tile_rows`` must be a multiple of the GLCM step, so texture windows
    align with the global window grid. ``hists``: precomputed per-band
    histograms of ``arr`` (``preprocess_large(return_hist=True)``), which
    skip the pass-A histogram sweep.

    ``writer``: an object with ``write_rows(rows)``; completed label rows
    are handed to it in order as tiles drain (a resident scene's tiles are
    all enqueued first), so host work on them overlaps the device
    computing later tiles. The caller still gets the full map, and closes
    the writer."""
    dev = resolve_device(device)
    c, h, w = arr.shape
    src = _tile_src(arr, dev)
    g = _global_passes(arr, cfg, tile_rows, src=src, hists=hists, device=dev)
    classify_tile = _tile_classifier(g, gf, cfg, (h, w), dev)
    out = np.zeros((h, w), np.int32)
    pending = []
    for y0, rows, ys, ye in _halo_tiles(h, tile_rows):
        pending.append((y0, rows, classify_tile(_get_tile(src, ys, ye), y0,
                                                y0 - ys, rows)))
        if not isinstance(src, torch.Tensor) and len(pending) == 2:
            # streaming: tile i + 1 is enqueued before tile i is fetched,
            # so device memory stays bounded at two tiles
            _drain_labels(pending[:1], out, writer)
            del pending[0]
    _drain_labels(pending, out, writer)
    return out


def classify_large_scene_streamed(
        arr: np.ndarray, gf: GemmForest,
        cal: CalibrationConfig = CalibrationConfig(),
        cfg: FeatureStageConfig = FeatureStageConfig(),
        tile_rows: int = 504, writer=None,
        device: DeviceLike = None) -> np.ndarray:
    """RAW (7, H, W) uint8 HOST scene -> (H, W) int32 labels on ``device``
    (CUDA unless named), with the scene's copy to the device streamed
    under its counting:

      * raw row chunks are copied once on the host, straight from the
        scene's strided rows into pinned memory, then to the device on a
        side stream (``io.stream.HostToDevice``; span ``stretch.hist``
        carries the bytes copied on the host, ``host_copy_bytes``, one
        scene's worth), each counted on the device as it lands
        (``ops.kernels.raw_counts``, one accumulator for the scene); the
        host fetches the (7, 256) raw-DN counts once and derives the LUT
        and the stretched histogram from them
        (``stretch_tables_from_counts``, bit-equal to
        ``build_stretch_stats``'s);
      * each resident raw chunk is stretched by ``ops.kernels.lut_hist``
        (uint8 out, no histogram) and freed, and
        the merged pass-B/C program runs one chunk behind, with no host
        sync until pass B/C drains;
      * pass D classifies from the stretched chunks left on the device
        (tiles assembled from edge rows, never copied again).

    Labels are bit-equal to ``classify_large_scene(preprocess_large(arr),
    hists=...)``: the same LUT, histograms and per-tile programs on the
    same values. ``writer``: as in :func:`classify_large_scene`."""
    dev = resolve_device(device)
    c, h, w = arr.shape
    step = cfg.glcm.step_size
    if tile_rows % step:
        raise ValueError(f"tile_rows must be a multiple of {step}")
    with span("large.streamed"):
        y0s = list(range(0, h, tile_rows))
        n_chunks = len(y0s)
        up = HostToDevice(dev, depth=2)

        def put(i):
            return up.put(arr[:, y0s[i]:min(h, y0s[i] + tile_rows), :])

        # every raw chunk to the device, counted there as it lands; the
        # tables from the counts on the host
        with span("large.host_stats", bytes=arr.nbytes):
            counts_d = torch.zeros((c, 256), dtype=torch.int32, device=dev)
            raw = {}
            with span("stretch.hist") as rec:
                for i in range(n_chunks):
                    raw[i] = put(i)
                    raw_counts(raw[i], counts_d)
                if rec is not None:
                    rec.counts["host_copy_bytes"] = up.host_copy_bytes
            with span("large.fetch", bytes=counts_d.nbytes):
                counts = counts_d.cpu().numpy()
            lut, hists = stretch_tables_from_counts(counts, cal.gains,
                                                    cal.biases)
            lut_d = torch.from_numpy(lut.astype(np.uint8)).to(dev)
            acc = _PassBC(compute_global_stats(arr, cfg,
                                               hists=hists.astype(np.int64)),
                          cfg, h, w, dev)
        st = []                           # the stretched chunks, on the device

        def rows_of(i, lo, hi):
            """Rows [lo, hi) of the scene from the stretched chunks i - 1, i,
            i + 1 (lo and hi within them)."""
            y0 = y0s[i]
            parts = []
            if lo < y0:
                parts.append(st[i - 1][:, lo - y0:, :])
            parts.append(st[i])
            if hi > y0 + st[i].shape[1]:
                parts.append(st[i + 1][:, :hi - y0 - st[i].shape[1], :])
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

        def dispatch_bc(i):
            y0 = y0s[i]
            rows = min(tile_rows, h - y0)
            ys = max(0, y0 - 1)
            acc.dispatch(rows_of(i, ys, min(h, y0 + rows + 1)), y0, rows,
                         y0 - ys)

        with span("large.pass_bc"):
            for i in range(n_chunks):
                st.append(lut_hist(raw.pop(i), lut_d, out_u8=True,
                                   skip_hist=True))
                if i >= 1:
                    dispatch_bc(i - 1)
            dispatch_bc(n_chunks - 1)
            acc.drain(acc.pending)        # one fetch, f64 sums in tile order
        with span("large.pass_d"):
            classify_tile = _tile_classifier(acc.globals_dict(), gf, cfg,
                                             (h, w), dev)
            pending = []
            for i, (y0, rows, ys, ye) in enumerate(_halo_tiles(h, tile_rows)):
                pending.append((y0, rows, classify_tile(rows_of(i, ys, ye), y0,
                                                        y0 - ys, rows)))
            out = np.zeros((h, w), np.int32)
            _drain_labels(pending, out, writer)
        return out


# -------------------------------------------------- KMeans

def _fit_sample_plan(h: int, w: int, tile_rows: int, fit_fraction: float,
                     max_fit_pixels: int) -> list:
    """Per-tile sample counts for the KMeans fit subsample.

    The total is snapped DOWN to a power of two, so fits of different
    scene sizes share a few sample shapes. Counts sum to the snapped
    total exactly and never exceed a tile's pixel count."""
    n_fit = min(max_fit_pixels, int(h * w * fit_fraction) or h * w, h * w)
    if n_fit >= 2:
        n_fit = 1 << (n_fit.bit_length() - 1)
    tile_px = [min(tile_rows, h - y0) * w for y0 in range(0, h, tile_rows)]
    counts = []
    remaining = n_fit
    for i, npx in enumerate(tile_px):
        want = -(-remaining // (len(tile_px) - i))  # ceil of an even share
        take = min(npx, want, remaining)
        counts.append(take)
        remaining -= take
    for i, npx in enumerate(tile_px):  # capacity-starved early tiles
        if not remaining:
            break
        add = min(npx - counts[i], remaining)
        counts[i] += add
        remaining -= add
    if remaining:
        raise AssertionError((h, w, tile_rows, n_fit))
    return counts


def _kmeans_tiles(arr: np.ndarray, cfg: FeatureStageConfig, tile_rows: int,
                  src, stack_tile):
    """``(y0, rows, (19, rows, W) stack)`` of each tile, computed anew."""
    for y0, rows, ys, ye in _halo_tiles(arr.shape[1], tile_rows):
        yield y0, rows, stack_tile(_get_tile(src, ys, ye), y0, y0 - ys, rows)


def _kmeans_fit_large(arr: np.ndarray, n_clusters: int,
                      cfg: FeatureStageConfig, tile_rows: int, seed: int,
                      fit_fraction: float, max_fit_pixels: int,
                      src, stack_tile):
    """Pass 1 of the out-of-core KMeans, on the device: the global MinMax
    bounds, a systematic subsample (every n-th pixel of each tile, a
    strided slice) and the centroid fit (``models.kmeans``). Returns the
    fit state ``(mins, rng, centroids)`` as device tensors."""
    counts = _fit_sample_plan(arr.shape[1], arr.shape[2], tile_rows,
                              fit_fraction, max_fit_pixels)
    mins, maxs, samples = [], [], []
    for (y0, rows, stack), count in zip(
            _kmeans_tiles(arr, cfg, tile_rows, src, stack_tile), counts):
        flat = stack.reshape(stack.shape[0], -1)              # (F, N)
        stride = max(1, flat.shape[1] // max(1, count))
        mins.append(torch.amin(flat, dim=1))
        maxs.append(torch.amax(flat, dim=1))
        # a copy, so the tile's stack is freed
        samples.append(flat[:, :count * stride:stride].T.contiguous())
    mins_d = torch.amin(torch.stack(mins), dim=0)
    maxs_d = torch.amax(torch.stack(maxs), dim=0)
    rng_d = torch.where(maxs_d - mins_d <= 0, 1.0, maxs_d - mins_d)
    fit = ((torch.cat(samples) - mins_d) / rng_d).to(torch.float32)
    _, state = kmeans_fit_predict(fit, n_clusters, seed=seed)
    return mins_d, rng_d, state.centroids


def _kmeans_assign_fn(mins_d: torch.Tensor, rng_d: torch.Tensor,
                      cents: torch.Tensor, n_clusters: int):
    """``(19, rows, W) stack -> (rows * W,)`` 1-based cluster labels
    (``models.kmeans.lloyd_step``), uint8 when every label fits."""
    out_dt = torch.uint8 if n_clusters < 255 else torch.int32

    def assign(stack):
        flat = stack.reshape(stack.shape[0], -1).T
        _, labels, _ = lloyd_step((flat - mins_d) / rng_d, cents)
        return (labels + 1).to(out_dt)

    return assign


def kmeans_large_scene(arr: np.ndarray, n_clusters: int = 7,
                       cfg: FeatureStageConfig = FeatureStageConfig(),
                       tile_rows: int = 504, seed: int = 42,
                       fit_fraction: float = 0.1,
                       max_fit_pixels: int = 2_000_000,
                       device: DeviceLike = None) -> np.ndarray:
    """Unsupervised classification of a preprocessed scene of any size on
    ``device`` (CUDA unless named) -> (H, W) int32 labels from 1: global
    MinMax bounds and centroids from a systematic pixel subsample
    (:func:`_kmeans_fit_large`), then every tile assigned to the fixed
    centroids. Tiles are computed again for the assignment rather than
    kept."""
    dev = resolve_device(device)
    c, h, w = arr.shape
    src = _tile_src(arr, dev)
    stack_tile, _ = _make_stack_fn(arr, cfg, tile_rows, src=src, device=dev)
    mins_d, rng_d, cents = _kmeans_fit_large(
        arr, n_clusters, cfg, tile_rows, seed, fit_fraction, max_fit_pixels,
        src, stack_tile)
    assign = _kmeans_assign_fn(mins_d, rng_d, cents, n_clusters)
    parts = [assign(stack).reshape(rows, w)
             for _, rows, stack in _kmeans_tiles(arr, cfg, tile_rows, src,
                                                 stack_tile)]
    return torch.cat(parts).cpu().numpy().astype(np.int32)


# -------------------------------------------------- the rule route

def _rule_indices(stretched_u8: torch.Tensor, hist: torch.Tensor,
                  cfg: FeatureStageConfig):
    """A (7, H, W) stretched scene and its (7, 256) histograms -> the four
    rule index planes (ndvi, ndwi, mndwi, ndbi), each (H, W) f32, with
    exact global percentile normalisation: the turbo rule front's math
    after its preamble."""
    return tuple(p[0] for p in rule_indices(stretched_u8[None], hist[None],
                                            cfg))


def _rule_from_stretched(stretched_u8: torch.Tensor, hist: torch.Tensor,
                         cfg: FeatureStageConfig, rule_cfg: RuleBasedConfig,
                         cc_impl: str) -> torch.Tensor:
    """The single-scene rule program from its preamble's outputs onward:
    the stretched scene and its histograms in place of raw DNs and a
    LUT."""
    return rule_based_classify(*_rule_indices(stretched_u8, hist, cfg),
                               rule_cfg, cc_impl=cc_impl)


def _rule_inputs(arr: np.ndarray, hists: Optional[np.ndarray],
                 device: torch.device):
    if hists is None:
        hists = band_histograms_u8(arr)
    return (as_tensor(arr, device, torch.uint8),
            torch.from_numpy(np.asarray(hists).astype(np.int32)).to(device))


def rule_based_large_scene(arr: np.ndarray,
                           cfg: FeatureStageConfig = FeatureStageConfig(),
                           rule_cfg: Optional[RuleBasedConfig] = None,
                           hists: Optional[np.ndarray] = None,
                           cc_impl: str = "auto",
                           device: DeviceLike = None) -> np.ndarray:
    """Rule-based classification of a PREPROCESSED (7, H, W) scene of
    stretched uint8 levels, of any size the device holds -> (H, W) uint8
    numpy labels, as the JAX function returns them (its callers write rows
    of a host map). Runs on ``device`` (CUDA unless named).

    ``hists``: optional (7, 256) stretched-value histograms (int64, as the
    serving engine passes them); computed on the host when absent.
    Bit-equal to ``pipeline.turbo.rule_based_scenes_turbo`` on the raw
    scene whose stretch gave ``arr``."""
    out = _rule_from_stretched(*_rule_inputs(arr, hists,
                                             resolve_device(device)), cfg,
                               rule_cfg if rule_cfg is not None
                               else RuleBasedConfig(), cc_impl)
    return out.cpu().numpy()


# -------------------------------------------------- resumable runs

class TileInterrupt(RuntimeError):
    """Raised by the fault-injection hook (``interrupt_after``) after N
    tiles or masks, to test crash-resume paths."""


def _scene_fingerprint(arr: np.ndarray, extra) -> str:
    """Checkpoint binding: a content hash (whole up to 64 MB, a strided
    sample and the shape beyond) and the run parameters that change the
    output."""
    hsh = hashlib.sha1()
    hsh.update(repr((arr.shape, str(arr.dtype)) + tuple(extra)).encode())
    if arr.nbytes <= (64 << 20):
        hsh.update(np.ascontiguousarray(arr).tobytes())
    else:
        step = max(1, arr.nbytes // (16 << 20))
        hsh.update(np.ascontiguousarray(arr.reshape(-1)[::step]).tobytes())
    return hsh.hexdigest()


def _open_manifest(checkpoint_dir: str, fingerprint: str, fresh: dict,
                   data_files) -> dict:
    """Load the manifest if it matches ``fingerprint``; otherwise discard
    any stale checkpoint files and return ``fresh`` (with the fingerprint
    stamped in). A partial checkpoint without a manifest is unverifiable
    and also discarded."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    mpath = os.path.join(checkpoint_dir, "manifest.json")
    fresh = dict(fresh, fingerprint=fingerprint)
    if os.path.exists(mpath):
        with open(mpath) as f:
            saved = json.load(f)
        if saved.get("fingerprint") == fingerprint:
            return saved
    for p in data_files:
        full = os.path.join(checkpoint_dir, p)
        if os.path.exists(full):
            os.remove(full)
    return fresh


def _save_manifest(checkpoint_dir: str, manifest: dict) -> None:
    """Write the manifest atomically (a temporary file, then a rename)."""
    mpath = os.path.join(checkpoint_dir, "manifest.json")
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)


def _open_partial(path: str, h: int, w: int) -> np.ndarray:
    """The checkpointed (h, w) int32 label map, memory-mapped."""
    if os.path.exists(path):
        return np.lib.format.open_memmap(path, mode="r+")
    return np.lib.format.open_memmap(path, mode="w+", dtype=np.int32,
                                     shape=(h, w))


def _resume_tiles(arr: np.ndarray, tile_rows: int, checkpoint_dir: str,
                  manifest: dict, out: np.ndarray,
                  interrupt_after: Optional[int], src, label_tile) -> None:
    """Label every tile not in ``manifest["done"]`` with ``label_tile(tile,
    y0, lo, rows) -> (rows, W)``, flushing ``out`` and the manifest after
    each; raise :class:`TileInterrupt` after ``interrupt_after`` fresh
    tiles."""
    done = set(manifest["done"])
    fresh = 0
    for y0, rows, ys, ye in _halo_tiles(arr.shape[1], tile_rows):
        if y0 in done:
            continue
        if interrupt_after is not None and fresh >= interrupt_after:
            raise TileInterrupt(f"injected fault after {fresh} tiles")
        labels = label_tile(_get_tile(src, ys, ye), y0, y0 - ys, rows)
        out[y0:y0 + rows] = labels.cpu().numpy()
        out.flush()
        done.add(y0)
        manifest["done"] = sorted(done)
        _save_manifest(checkpoint_dir, manifest)
        fresh += 1


def kmeans_large_scene_resumable(
        arr: np.ndarray, checkpoint_dir: str, n_clusters: int = 7,
        cfg: FeatureStageConfig = FeatureStageConfig(),
        tile_rows: int = 504, seed: int = 42, fit_fraction: float = 0.1,
        max_fit_pixels: int = 2_000_000,
        interrupt_after: Optional[int] = None,
        device: DeviceLike = None) -> np.ndarray:
    """:func:`kmeans_large_scene` with a resumable cursor, on ``device``
    (CUDA unless named).

    Checkpoints to ``checkpoint_dir``: ``kmeans_fit.npz`` (the fit state:
    global MinMax bounds and centroids, computed once), ``partial.npy``
    (the label map, flushed per tile) and ``manifest.json`` (fingerprint
    and completed tile rows, written atomically after every tile). A
    restarted run skips the fit and every completed tile and is bit-equal
    to an uninterrupted one; a checkpoint of another scene or other
    parameters is discarded."""
    dev = resolve_device(device)
    c, h, w = arr.shape
    fingerprint = _scene_fingerprint(
        arr, (tile_rows, cfg, "kmeans", n_clusters, seed, fit_fraction,
              max_fit_pixels))
    fpath = os.path.join(checkpoint_dir, "kmeans_fit.npz")
    manifest = _open_manifest(
        checkpoint_dir, fingerprint,
        {"shape": [h, w], "tile_rows": tile_rows, "done": []},
        ("kmeans_fit.npz", "partial.npy"))
    src = _tile_src(arr, dev)
    stack_tile, _ = _make_stack_fn(arr, cfg, tile_rows, src=src, device=dev)
    if os.path.exists(fpath):
        with np.load(fpath) as z:
            mins_d, rng_d, cents = (as_tensor(z[k], dev) for k in
                                    ("mins", "rng", "centroids"))
    else:
        mins_d, rng_d, cents = _kmeans_fit_large(
            arr, n_clusters, cfg, tile_rows, seed, fit_fraction,
            max_fit_pixels, src, stack_tile)
        tmp = fpath + ".tmp.npz"
        np.savez(tmp, mins=mins_d.cpu().numpy(), rng=rng_d.cpu().numpy(),
                 centroids=cents.cpu().numpy())
        os.replace(tmp, fpath)
    out = _open_partial(os.path.join(checkpoint_dir, "partial.npy"), h, w)
    assign = _kmeans_assign_fn(mins_d, rng_d, cents, n_clusters)
    _resume_tiles(arr, tile_rows, checkpoint_dir, manifest, out,
                  interrupt_after, src,
                  lambda tile, y0, lo, rows: assign(
                      stack_tile(tile, y0, lo, rows)).reshape(rows, w))
    return np.asarray(out)


def rule_based_large_scene_resumable(
        arr: np.ndarray, checkpoint_dir: str,
        cfg: FeatureStageConfig = FeatureStageConfig(),
        rule_cfg: Optional[RuleBasedConfig] = None,
        hists: Optional[np.ndarray] = None,
        interrupt_after: Optional[int] = None,
        cc_impl: str = "auto", device: DeviceLike = None) -> np.ndarray:
    """:func:`rule_based_large_scene` with a resumable per-mask cursor, on
    ``device`` (CUDA unless named).

    The rule route is one device program per mask, so the checkpoint unit
    is the post-processed mask: ``mask_vegetation/water/builtup/
    bareland.npy`` (uint8) are saved as each completes, with the
    fingerprint-bound manifest recording completion. A resumed run
    recomputes only the missing masks and paints the same map bit for bit
    (bare land depends only on the three painted masks, which come from
    the checkpoint). ``interrupt_after=N`` raises :class:`TileInterrupt`
    after N freshly computed masks."""
    dev = resolve_device(device)
    rule_cfg = rule_cfg if rule_cfg is not None else RuleBasedConfig()
    c, h, w = arr.shape
    fingerprint = _scene_fingerprint(arr, (cfg, "rule_based", rule_cfg))
    stages = ("vegetation", "water", "builtup", "bareland")
    manifest = _open_manifest(checkpoint_dir, fingerprint,
                              {"shape": [h, w], "done": []},
                              tuple(f"mask_{s}.npy" for s in stages))
    nd = None   # the four index planes, computed once a run if needed
    masks = {}
    done = set(manifest["done"])
    fresh = 0

    def painted():
        return paint_rule_masks(*(torch.from_numpy(masks[s]).to(dev)
                                  for s in stages[:3]))

    for stage in stages:
        path = os.path.join(checkpoint_dir, f"mask_{stage}.npy")
        if stage in done and os.path.exists(path):
            masks[stage] = np.load(path)
            continue
        if interrupt_after is not None and fresh >= interrupt_after:
            raise TileInterrupt(f"injected fault after {fresh} masks")
        if nd is None:
            nd = _rule_indices(*_rule_inputs(arr, hists, dev), cfg)
        if stage == "bareland":
            m = bare_rule_mask(painted(), nd[0], nd[3], rule_cfg,
                               cc_impl=cc_impl)
        else:
            m = rule_mask(stage, *nd, rule_cfg, cc_impl=cc_impl)
        masks[stage] = m.to(torch.uint8).cpu().numpy()
        tmp = path + ".tmp.npy"
        np.save(tmp, masks[stage])
        os.replace(tmp, path)
        done.add(stage)
        manifest["done"] = sorted(done)
        _save_manifest(checkpoint_dir, manifest)
        fresh += 1
    out = painted()
    bare = torch.from_numpy(masks["bareland"]).to(dev)
    return torch.where((bare == 1) & (out == 0), 4, out).to(
        torch.uint8).cpu().numpy()


def classify_large_scene_resumable(
        arr: np.ndarray, gf: GemmForest, checkpoint_dir: str,
        cfg: FeatureStageConfig = FeatureStageConfig(),
        tile_rows: int = 504,
        interrupt_after: Optional[int] = None,
        hists: Optional[np.ndarray] = None,
        device: DeviceLike = None) -> np.ndarray:
    """:func:`classify_large_scene` with a resumable tile cursor, on
    ``device`` (CUDA unless named).

    Checkpoints to ``checkpoint_dir``: ``globals.npz`` (the pass A-C
    statistics, computed once), ``partial.npy`` (the label map, flushed
    per tile, memory-mapped) and ``manifest.json`` (tile geometry, the
    fingerprint of the scene, ``tile_rows`` and ``cfg``, and the
    completed tile rows, written atomically after every tile). A
    restarted run skips the global passes and every completed tile and is
    bit-equal to an uninterrupted one; a mismatched fingerprint discards
    the checkpoint. ``interrupt_after=N`` raises :class:`TileInterrupt`
    after N freshly computed tiles."""
    dev = resolve_device(device)
    c, h, w = arr.shape
    gpath = os.path.join(checkpoint_dir, "globals.npz")
    manifest = _open_manifest(
        checkpoint_dir, _scene_fingerprint(arr, (tile_rows, cfg)),
        {"shape": [h, w], "tile_rows": tile_rows, "done": []},
        ("globals.npz", "partial.npy"))
    src = _tile_src(arr, dev)
    if os.path.exists(gpath):
        with np.load(gpath) as z:
            g = {k: z[k] for k in z.files}
    else:
        g = _global_passes(arr, cfg, tile_rows, src=src, hists=hists,
                           device=dev)
        tmp = gpath + ".tmp.npz"
        np.savez(tmp, **g)
        os.replace(tmp, gpath)
    out = _open_partial(os.path.join(checkpoint_dir, "partial.npy"), h, w)
    _resume_tiles(arr, tile_rows, checkpoint_dir, manifest, out,
                  interrupt_after, src,
                  _tile_classifier(g, gf, cfg, (h, w), dev))
    return np.asarray(out)
