"""Tensor parallelism for the GEMM forest: leaves sharded over the mesh.

Counterpart of ``rs_image_segmentation_tpu.parallel.forest_tp``. The
forest's leaf axis, the large dimension of the GEMM form
(``models.forest.GemmForest``: path (M, L), path_len (L,), leaf_dist
(L, C)), is split over a ``model`` mesh axis. Every rank holds the whole
(small) selector and thresholds, scores its own leaf block, and the class
sums meet in ONE all-reduce:

    proba = psum_over_model(leaf_dist_local^T @ fired_local) / n_trees

The three products are plain matmuls, as the JAX package's ``jnp.dot``s
are (no kernel of their own). The leaf-distribution sum is taken in f64
(``ops.kernels.gemm_leaf_sums_cm``) and all-reduced in f64 before its one
rounding to f32: f64 holds these sums exactly in any order, so the totals,
and the labels, do not depend on the leaf split and equal the one-rank
forest's bit for bit. Composes with data parallelism: rows shard over
``data`` while leaves shard over ``model`` on a 2-D mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..backend import as_tensor
from ..models.forest import GemmForest, _gemm_chunk, dense_path
from ..ops.kernels import gemm_leaf_sums_cm
from .collectives import axis_index, axis_size, psum
from .mesh import block_bounds, data_sharding, mesh_device


class LeafShard(GemmForest):
    """A GemmForest whose path, path_len and leaf_dist are only this rank's
    block of the padded leaf axis (:func:`shard_gemm_forest`)."""
    __slots__ = ()


def pad_gemm_leaves(gf: GemmForest, n_shards: int) -> GemmForest:
    """Pad the leaf axis to a multiple of ``n_shards``.

    Pad columns have an all-zero path and path_len = -1, so their vote sum
    (0) never equals their path length: they can never fire. Slicing the
    leaf axis takes the dense path: a forest past ``GEMM_MAX_LEAVES``
    raises ValueError (``models.forest.dense_path``)."""
    path = dense_path(gf)
    pad = (-path.shape[1]) % n_shards
    if pad == 0:
        return gf
    pad_last = torch.nn.functional.pad
    return gf._replace(
        path=pad_last(path, (0, pad)),
        path_len=pad_last(gf.path_len, (0, pad), value=-1.0),
        leaf_dist=pad_last(gf.leaf_dist, (0, 0, 0, pad)))


def _leaf_block(gf: GemmForest, group) -> GemmForest:
    """This rank's block of the padded leaf axis of ``gf``."""
    gf = pad_gemm_leaves(gf, axis_size(group))
    lo, hi = block_bounds(gf.path.shape[1], axis_size(group),
                          axis_index(group))
    return gf._replace(path=gf.path[:, lo:hi], path_len=gf.path_len[lo:hi],
                       leaf_dist=gf.leaf_dist[lo:hi])


def shard_gemm_forest(gf: GemmForest, mesh,
                      model_axis: str = "model") -> LeafShard:
    """Keep only this rank's block of the forest's leaf-axis tensors
    (``ceil(L / n)`` leaves), on its device, so a very large forest never
    materializes whole on one device. The result feeds
    :func:`tp_forest_predict`."""
    dev = mesh_device(mesh)
    local = _leaf_block(gf, mesh.get_group(model_axis))
    return LeafShard(*(t.to(dev).contiguous() for t in local))


def tp_forest_proba(gf: GemmForest, x, mesh, model_axis: str = "model",
                    data_axis: Optional[str] = None) -> torch.Tensor:
    """Mean forest proba for (N, F) rows with leaves sharded over
    ``model_axis`` (and rows over ``data_axis`` if given, then this rank's
    rows of the result). ``gf``: the whole forest, or this rank's
    :class:`LeafShard`."""
    dev = mesh_device(mesh)
    group = mesh.get_group(model_axis)
    if not isinstance(gf, LeafShard):
        gf = _leaf_block(gf, group)
    if data_axis is not None:
        x = data_sharding(mesh, 2, 0, data_axis).block(x)
    x_cm = as_tensor(x, dev, torch.float32).T
    sums = gemm_leaf_sums_cm(gf, x_cm,
                             _gemm_chunk(gf.path.shape[1]))     # (C, N) f64
    total = psum(sums, group)
    return (total.to(torch.float32) * gf.inv_trees.to(dev)).T.contiguous()


def tp_forest_predict(gf: GemmForest, x, mesh, model_axis: str = "model",
                      data_axis: Optional[str] = None) -> torch.Tensor:
    """sklearn ``.predict`` parity with the forest sharded across the mesh
    (ties to the lowest class)."""
    proba = tp_forest_proba(gf, x, mesh, model_axis, data_axis)
    return gf.classes.to(proba.device)[torch.argmax(proba, dim=1)]
