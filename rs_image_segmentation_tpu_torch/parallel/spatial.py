"""Spatially-sharded scene classification: one SPMD program a rank.

Counterpart of ``rs_image_segmentation_tpu.parallel.spatial``. The scene's
rows are sharded over a ``tile`` mesh axis; each rank computes the
19-channel stack and the forest labels of its rows, over the port's own
large-scene helpers (``pipeline.large_scene``), and the only cross-rank
traffic is the JAX program's:

  * a ring exchange of ``HALO`` rows each way (reflect-101 at the global
    top and bottom): the stencils' context;
  * the ``window - 1`` texture rows from the rank below, for the GLCM
    windows whose start is this rank's but which run into the next one;
  * an all-gather of the per-rank GLCM window-grid slots, copied into the
    global grid by index (exact);
  * the maximum of the Sobel magnitude over every rank (``pmax``).

GLCM windows live on the GLOBAL window grid (starts at multiples of the
step from image row 0), which rank boundaries need not respect: each rank
computes the grid rows whose window start falls in its rows, into a fixed
number of slots (masked where it owns fewer starts, none at all on a rank
below the last start), so every rank joins every collective. A rank's
rows need not be a multiple of the step (600 / 8 = 75 against window 21).

Global statistics (percentiles and the PCA axis) are computed on the host
from histograms and tile sums (``compute_global_stats``,
``_fit_global_pca``) by every rank, over the whole scene in
``stats_tile_rows`` tiles; the JAX ``sharded_classify_scene`` tiles its
PCA by shard rows, which ties its sums to the shard count. Here the tiling
is the same at every world size, so the maps are bit-invariant across
world sizes by construction. Against the monolithic programs they differ
only in the documented statistics-implementation class (>= 99.9 % label
agreement): the Sobel maximum here is over exact rows, and the 7 x 7
context at the global edges reads reflect-101 halo rows.

The forest is ``ops.kernels.forest_labels`` on each rank's stack; the
texture takes the plain route of the monolithic large scene
(``_tile_glcm_grid``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backend import as_tensor
from ..core.config import FeatureStageConfig
from ..models.forest import GemmForest
from ..ops.stencil import sobel_magnitude
from ..pipeline.large_scene import (HALO, _classify_tile_cm, _fit_global_pca,
                                    _globals_device, _label_transfer_dtype,
                                    _normalize_tile, _tex01,
                                    _tile_glcm_grid, compute_global_stats)
from .collectives import all_gather, axis_index, axis_size, pmax, \
    ppermute_ring
from .mesh import mesh_device
from .sharded import halo_pad

STATS_TILE_ROWS = 2016


def _check_geometry(shape, n: int, cfg: FeatureStageConfig) -> int:
    c, h, w = shape
    rows = h // n
    if h % n:
        raise ValueError(f"H={h} must split evenly into {n} shards")
    if rows < cfg.glcm.window_size:
        raise ValueError(f"shard height {rows} below the GLCM window "
                         f"({cfg.glcm.window_size})")
    return rows


def _glcm_starts(h: int, rows: int, idx: int, cfg: FeatureStageConfig):
    """``(first, count)``: the global grid rows whose window starts fall in
    rank ``idx``'s rows."""
    step, window = cfg.glcm.step_size, cfg.glcm.window_size
    n_i = (h - window) // step + 1
    row0 = idx * rows
    first = -(-row0 // step)
    return first, max(0, min(n_i, -(-(row0 + rows) // step)) - first)


def _tex_rows(tile: torch.Tensor, gd: dict, tb: int) -> torch.Tensor:
    nir = _normalize_tile(tile[tb:tb + 1], gd["p_lo"][tb:tb + 1],
                          gd["p_hi"][tb:tb + 1])[0]
    return _tex01(nir, gd["tex_lo"], gd["tex_hi"])


def _sharded_classify(pre: np.ndarray, g: dict, gf: GemmForest, group,
                      dev: torch.device, cfg: FeatureStageConfig
                      ) -> torch.Tensor:
    """The SPMD program of one rank: its (rows, W) labels of the global
    (7, H, W) stretched scene ``pre`` over the pass-A/B statistics ``g``."""
    n, idx = axis_size(group), axis_index(group)
    c, h, w = pre.shape
    rows = h // n
    row0 = idx * rows
    tb = cfg.texture_band_index
    glcm = cfg.glcm
    step, window = glcm.step_size, glcm.window_size
    n_i = (h - window) // step + 1
    n_j = (w - window) // step + 1
    gmax = rows // step + 1                      # most starts a rank owns
    gd = _globals_device({**g, "sobel_max": 0.0,
                          "contrast_grid": np.zeros((n_i, n_j), np.float32),
                          "homog_grid": np.zeros((n_i, n_j), np.float32)},
                         dev)
    shard = as_tensor(pre[:, row0:row0 + rows], dev, torch.uint8)

    # ---- this rank's GLCM grid rows -> the global grid
    tex = _tex_rows(shard, gd, tb)
    tex_ext = torch.cat([tex, ppermute_ring(tex[:window - 1], group, -1)])
    first, count = _glcm_starts(h, rows, idx, cfg)
    slots = torch.zeros((2, gmax, n_j), dtype=torch.float32, device=dev)
    for k in range(count):
        # one grid row a call, as the JAX program's slots: every call sees
        # the same n_j windows, whatever the world size
        off = (first + k) * step - row0
        con, hom = _tile_glcm_grid(tex_ext[off:off + window], glcm.levels,
                                   window, step, glcm.angles)
        slots[0, k], slots[1, k] = con[0], hom[0]
    gathered = all_gather(slots, group)          # (n, 2, gmax, n_j)
    for q in range(n):
        fq, cq = _glcm_starts(h, rows, q, cfg)
        gd["con"][fq:fq + cq] = gathered[q, 0, :cq]
        gd["hom"][fq:fq + cq] = gathered[q, 1, :cq]

    # ---- the halo'd tile, the global Sobel normaliser, stack and forest
    tile = halo_pad(shard, HALO, group)
    u8 = (_tex_rows(tile, gd, tb) * 255.0).to(torch.uint8)
    smag = sobel_magnitude(u8.to(torch.float32)) * (1.0 / 255.0)
    smax = pmax(torch.amax(smag[HALO:HALO + rows]), group)
    # the monolithic pipeline's host arithmetic for the normaliser
    gd["smax"] = torch.tensor(np.float32(float(smax) + 1e-10), device=dev)
    return _classify_tile_cm(tile, row0, gd, gf, lo=HALO, rows=rows,
                             out_hw=(h, w), tb=tb,
                             out_dt=_label_transfer_dtype(gf))


def _classify(pre: np.ndarray, gf: GemmForest, mesh, cfg, axis_name: str,
              hists, stats_tile_rows: int) -> torch.Tensor:
    group = mesh.get_group(axis_name)
    _check_geometry(pre.shape, axis_size(group), cfg)
    dev = mesh_device(mesh)
    stats = compute_global_stats(pre, cfg, hists=hists)
    _fit_global_pca(pre, stats, tile_rows=stats_tile_rows, device=dev)
    g = {"p_lo": stats.p_lo, "p_hi": stats.p_hi, "median": stats.median,
         "iqr": stats.iqr, "tex_lo": stats.tex_lo, "tex_hi": stats.tex_hi,
         "pca_mean": stats.pca_mean, "pca_comp1": stats.pca_comp1}
    return _sharded_classify(np.asarray(pre), g, gf, group, dev, cfg)


def sharded_classify_scene(pre: np.ndarray, gf: GemmForest, mesh,
                           cfg: FeatureStageConfig = FeatureStageConfig(),
                           axis_name: str = "tile") -> torch.Tensor:
    """Classify a preprocessed (7, H, W) uint8-valued scene with rows
    sharded across the mesh. Returns this rank's rows of the (H, W) label
    map (the forest's class dtype), on its device."""
    out = _classify(pre, gf, mesh, cfg, axis_name, None, STATS_TILE_ROWS)
    return out.to(gf.classes.dtype)


def classify_large_scene_sharded(
        arr: np.ndarray, gf: GemmForest, mesh,
        cfg: FeatureStageConfig = FeatureStageConfig(),
        axis_name: str = "tile", hists: Optional[np.ndarray] = None,
        stats_tile_rows: int = STATS_TILE_ROWS) -> np.ndarray:
    """Multi-rank form of ``pipeline.large_scene.classify_large_scene``:
    classify a PREPROCESSED (7, H, W) uint8-valued scene of any size with
    rows sharded over the mesh's ``axis_name`` -> the whole (H, W) int32
    map on every rank.

    * Pass A (per-band percentiles, RobustScaler statistics) is exact from
      256-bin histograms, computed on the host or passed in as ``hists``
      (``preprocess_large(return_hist=True)``).
    * Pass B (the global PCA axis) adds per-tile sums of
      ``stats_tile_rows`` rows in f64, tile by tile, on the rank's device.
    * Passes C and D (GLCM window grid, 19-channel stack, forest) run
      SPMD with the traffic of the module docstring; a rank's device holds
      O(H * W / n) of the stack.

    Bit-invariant across world sizes; >= 99.9 % label-identical to the
    monolithic ``classify_large_scene`` (module docstring)."""
    local = _classify(arr, gf, mesh, cfg, axis_name, hists,
                      stats_tile_rows)
    full = all_gather(local, mesh.get_group(axis_name))
    return full.reshape(arr.shape[1], arr.shape[2]).cpu().numpy().astype(
        np.int32)
