"""Sharded execution: multi-scene data parallelism, spatial halo exchange,
distributed KMeans and forest.

Counterpart of ``rs_image_segmentation_tpu.parallel.sharded``, in the
``shard_map`` style over a ``torch.distributed`` mesh (``parallel.mesh``):
every rank calls each function with the same GLOBAL arguments (the JAX
caller's arrays), moves only its own block (``Sharding.block``) to its
device, and meets the other ranks in the explicit collectives of
``parallel.collectives``. Blocks split as ``np.array_split`` does, so a
world size need not divide the rows (the JAX shardings need it to).

  * DP     : scenes over ``data``; the stage graphs are per scene, so
             each rank stacks its scenes with no collective.
  * halo   : image rows over ``tile``; ``halo`` boundary rows from each
             ring neighbour, reflect-101 at the global top and bottom.
  * KMeans : pixels over ``data``; Lloyd's counts, sums and inertia and
             the k-means++ picks ride all-reduces (``models.kmeans``'s
             ``group``).
  * Forest : pixels over ``data``; per pixel, gathered at the end.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..backend import as_tensor
from ..core.config import FeatureStageConfig
from ..models.forest import FlatForest, forest_predict
from ..models.kmeans import kmeans_fit_predict
from ..pipeline.features import hierarchical_stack
from ..pipeline.turbo import (kmeans_scenes_turbo_batch,
                              rule_based_scenes_turbo_batch)
from .collectives import all_gather, axis_index, axis_size, ppermute_ring
from .mesh import data_sharding, mesh_device


# ------------------------------------------------------ multi-scene DP

def sharded_hierarchical_stack(scenes, mesh,
                               cfg: FeatureStageConfig = FeatureStageConfig(),
                               include_entropy: bool = True,
                               axis_name: str = "data") -> torch.Tensor:
    """(S, 7, H, W) scene batch -> this rank's block of the (S, H, W, 19)
    feature stacks, scenes sharded over ``axis_name``: each scene through
    ``pipeline.features.hierarchical_stack`` on the rank's device, with no
    collective (per-scene percentiles and PCA stay local).
    ``include_entropy`` is accepted for the JAX signature; no channel of
    the stack reads entropy."""
    dev = mesh_device(mesh)
    local = data_sharding(mesh, 4, 0, axis_name).block(scenes)
    return torch.stack([hierarchical_stack(s, cfg, device=dev)
                        for s in local])


# ------------------------------------------------------ halo exchange

def halo_pad(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """(..., rows, W) block of a row-sharded image -> (..., rows + 2 halo,
    W): ``halo`` rows from each ring neighbour, reflect-101 rows of its
    own at the global top and bottom (every rank joins both exchanges)."""
    n, idx = axis_size(group), axis_index(group)
    from_above = ppermute_ring(x[..., -halo:, :], group, 1)
    from_below = ppermute_ring(x[..., :halo, :], group, -1)
    top = (torch.flip(x[..., 1:halo + 1, :], dims=(-2,)) if idx == 0
           else from_above)
    bot = (torch.flip(x[..., -halo - 1:-1, :], dims=(-2,)) if idx == n - 1
           else from_below)
    return torch.cat([top, x, bot], dim=-2)


def halo_map(fn: Callable[[torch.Tensor], torch.Tensor], x, halo: int,
             mesh, axis_name: str = "tile") -> torch.Tensor:
    """Apply a same-shape spatial op to a row-sharded image with halo
    exchange: ``x`` is the global (..., H, W) image, rows sharded over
    ``axis_name``; returns this rank's rows of the result, equal to the
    monolithic op for any stencil of reach <= ``halo`` with reflect-101
    borders."""
    dev = mesh_device(mesh)
    group = mesh.get_group(axis_name)
    ndim = len(x.shape)
    local = as_tensor(data_sharding(mesh, ndim, ndim - 2, axis_name
                                    ).block(x), dev)
    return fn(halo_pad(local, halo, group))[..., halo:-halo, :]


# ------------------------------------------------------ distributed models

def sharded_kmeans_fit_predict(x, k: int, mesh, seed: int = 42,
                               max_iter: int = 300, tol: float = 1e-4,
                               axis_name: str = "data",
                               init_centroids=None):
    """KMeans over the global (N, F) pixels, rows sharded over
    ``axis_name``: ``(this rank's labels, the global (K, F) centroids)``.
    Lloyd's statistics and the k-means++ picks ride all-reduces.
    ``init_centroids``: an optional (K, F) warm start, as
    ``models.kmeans.kmeans_fit_predict`` takes it."""
    dev = mesh_device(mesh)
    local = as_tensor(data_sharding(mesh, 2, 0, axis_name).block(x), dev,
                      torch.float32)
    labels, state = kmeans_fit_predict(local, k, seed, max_iter, tol,
                                       init_centroids,
                                       group=mesh.get_group(axis_name))
    return labels, state.centroids


def sharded_forest_predict(forest: FlatForest, x, depth: int, mesh,
                           axis_name: str = "data",
                           chunk: int = 65536) -> torch.Tensor:
    """Forest labels of the global (N, F) rows: the rows padded to a
    multiple of the axis size, each rank predicting its block
    (``models.forest.forest_predict``), the blocks gathered -> (N,) on
    every rank."""
    dev = mesh_device(mesh)
    group = mesh.get_group(axis_name)
    n, d = len(x), axis_size(group)
    rows = -(-n // d)
    lo = axis_index(group) * rows
    local = as_tensor(x[lo:min(n, lo + rows)], dev, torch.float32)
    local = torch.nn.functional.pad(local, (0, 0, 0, rows - len(local)))
    pred = forest_predict(forest, local, depth, chunk)
    return all_gather(pred, group).reshape(-1)[:n]


# ------------------------------------- DP for the batch-coupled programs

def sharded_method_batch(scenes, luts, mesh, method: str = "rule_based",
                         cfg: FeatureStageConfig = FeatureStageConfig(),
                         axis_name: str = "data", **kw) -> torch.Tensor:
    """Scene-parallel execution of the BATCH-COUPLED programs
    (``rule_based_scenes_turbo_batch``, ``kmeans_scenes_turbo_batch``):
    each rank runs the whole batch program on its sub-batch, with no
    collective, and returns its block of the (S, H, W) maps. A scene's map
    equals its map in the single-rank batch run: the rule program is exact
    by construction, and the KMeans program fits each scene on its own.

    scenes: (S, 7, H, W) uint8 with S divisible by the axis size; luts:
    (S, 7, 256) uint8. ``kw`` forwards to the method's program (e.g.
    n_clusters / fit_stride for kmeans)."""
    n = axis_size(mesh.get_group(axis_name))
    if len(scenes) % n:
        raise ValueError(f"scene count {len(scenes)} must divide evenly "
                         f"into {n} shards")
    if method == "rule_based":
        def fn(s, lt):
            return rule_based_scenes_turbo_batch(s, lt, cfg, device=dev,
                                                 **kw)
    elif method == "kmeans":
        def fn(s, lt):
            return kmeans_scenes_turbo_batch(s, lt, cfg=cfg, device=dev,
                                             **kw)
    else:
        raise ValueError(f"unsupported method {method!r}")
    dev = mesh_device(mesh)
    shard = data_sharding(mesh, 4, 0, axis_name)
    return fn(shard.block(scenes), shard.block(luts))
