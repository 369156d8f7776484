"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version.

* ``lut_hist`` (``csrc/lut_hist.cu``) replaces ``lut_hist_pallas``: a
  per-band uint8 table over a uint8 scene, with an optional int32
  histogram of the stretched values.
* ``raw_counts`` (``csrc/lut_hist.cu``) replaces no TPU kernel: the
  per-band 256-bin counts of a raw uint8 chunk, added into an accumulator
  (the streamed large scene's stretch statistics).
* ``forest_labels`` (``csrc/forest_labels.cu``) replaces
  ``forest_labels_pallas``: GemmForest labels over channel-major features.
* ``ccmin_prop`` (``csrc/ccmin_prop.cu``) replaces ``ccmin_prop_pallas``:
  the per-component minimum of int32 values over the connected components
  of each mask of a stack.
* ``cc_labels`` (``csrc/ccmin_prop.cu``, the same union-find) replaces
  ``cc_pallas``: connected-component labels, each component's minimum
  mask-relative linear index.
* ``hist_dense`` and ``keep_lut`` (``csrc/hist_keep.cu``) replace
  ``hist_dense_pallas`` and ``keep_lut_pallas``: per-mask counts of dense
  ids, and the keep bit of each pixel's id.
* ``fused_calibrate_stretch`` and ``fused_spectral_indices``
  (``csrc/stretch_indices.cu``) replace the Pallas functions of the same
  names: stage 1's calibrate + min-max stretch, and the seven spectral
  indices in one pass.
* ``glcm_grid`` (``csrc/glcm.cu``) replaces ``glcm_grid_pallas``: the five
  GLCM properties of each non-overlapping window, averaged over offsets.
* ``lloyd_pass`` (``csrc/kmeans_lloyd.cu``) replaces no TPU kernel: one
  iteration of ``models.kmeans.fit_centroids``' Lloyd loop, in place.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel on the current stream or raises; nothing
falls back. ``lloyd_pass`` takes CUDA tensors only: its plain version is
``models.kmeans._lloyd``'s loop, which ``fit_centroids`` runs itself on
CPU tensors. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..backend import as_tensor
from ..utils.timing import span
from . import _build
from .indices import spectral_indices
from .normalize import minmax_stretch_f32

_P = ctypes.c_void_p


_FNS: Dict[Tuple[str, str], object] = {}


def _call(lib_name: str, fn_name: str, argtypes, *args) -> None:
    fn = _FNS.get((lib_name, fn_name))
    if fn is None:          # bind once: ctypes lookups cost host time
        fn = getattr(_build.load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(lib_name, fn_name)] = fn
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError_t {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


# ---------------------------------------------------------------- lut_hist

def apply_u8_lut(planes_u8: torch.Tensor, lut_u8: torch.Tensor
                 ) -> torch.Tensor:
    """Exact (..., C, H, W) uint8 -> uint8 per-band table lookup with
    (..., C, 256) tables: a plain gather."""
    *lead, h, w = planes_u8.shape
    idx = planes_u8.reshape(-1, h * w).long()
    return torch.gather(lut_u8.reshape(-1, 256), 1, idx).reshape(
        planes_u8.shape)


def histogram256(planes_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., 256) int32 counts (exact integers: the
    percentile ranks compare them as integers)."""
    *lead, h, w = planes_u8.shape
    idx = planes_u8.reshape(-1, h * w).long()
    hist = torch.zeros(idx.shape[0], 256, dtype=torch.int32,
                       device=planes_u8.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return hist.reshape(*lead, 256)


def lut_hist_plain(scene_u8: torch.Tensor, lut_u8: torch.Tensor,
                   out_u8: bool = False, skip_hist: bool = False):
    """Plain version of :func:`lut_hist`: :func:`apply_u8_lut`, then
    :func:`histogram256` of the stretched scene."""
    st = apply_u8_lut(scene_u8, lut_u8)
    out = st if out_u8 else st.to(torch.float32)
    return out if skip_hist else (out, histogram256(st))


LUT_THREADS = 256        # threads a block (kThreads, csrc/lut_hist.cu)
LUT_UNROLL = 8           # loads in flight a thread (kUnroll)
LUT_MAX_TABLES = 32      # tables a block stages at most (kMaxTables)
LUT_BLOCKS_PER_SM = 4
LUT_CLUSTER = 16         # blocks a plane of the histogram's cluster instance


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lut_hist_plan(planes: int, n: int, unit: int, blocks: int
                  ) -> Tuple[int, int]:
    """The kernel's partition of a flat ``(planes, n)`` scene into units of
    ``unit`` pixels (16, 4 or 1, :func:`lut_hist_unit`): ``(grid, span)``,
    block ``k`` taking units ``[k * span, (k + 1) * span)``. ``blocks``
    blocks at most (``LUT_BLOCKS_PER_SM`` an SM); ``span`` is capped so
    that a range touches at most ``LUT_MAX_TABLES`` planes, whose tables
    the block stages."""
    units = -(-planes * n // unit)
    span = min(-(-units // blocks), (LUT_MAX_TABLES - 1) * n // unit)
    return -(-units // span), span


def lut_hist_unit(scene_u8: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> int:
    """Pixels a thread of the kernel moves at a time: 16 for uint8 out
    (one 16-byte load, one 16-byte store) when both bases are 16-byte
    aligned; else 4 (a 32-bit word of DNs in, one float4 or one word of
    bytes out) when the scene's base is 4-byte aligned and the output's
    takes the store; else 1 (the scalar instance). Planes shorter than the
    unit take a smaller one. With no ``out`` (:func:`raw_counts`, which
    stores nothing) the scene's base alone decides, as for uint8 out."""
    n = scene_u8.shape[-1] * scene_u8.shape[-2]
    sc = scene_u8.data_ptr()
    ot = sc if out is None else out.data_ptr()
    u8 = out is None or out.dtype == torch.uint8
    if u8 and n >= 16 and sc % 16 == 0 and ot % 16 == 0:
        return 16
    if n >= 4 and sc % 4 == 0 and ot % (4 if u8 else 16) == 0:
        return 4
    return 1


def lut_hist_instance(planes: int, n: int, unit: int, skip_hist: bool
                      ) -> str:
    """Which instance of the kernel takes a call: ``"cluster"`` for the
    histogram of planes that split into whole units (``n % unit == 0``,
    ``unit`` 4 or 16, at most 65 535 planes): one cluster of
    ``LUT_CLUSTER`` blocks a plane, every bin written once; else
    ``"ranges"``: the blocks of :func:`lut_hist_plan`, adding their counts
    into a zeroed histogram."""
    if (not skip_hist and unit > 1 and n % unit == 0
            and planes <= 65535):
        return "cluster"
    return "ranges"


def lut_hist(scene_u8: torch.Tensor, lut_u8: torch.Tensor,
             out_u8: bool = False, skip_hist: bool = False,
             out: "torch.Tensor | None" = None,
             hist_out: "torch.Tensor | None" = None):
    """``(..., C, H, W)`` uint8 scene + ``(..., C, 256)`` uint8 LUT ->
    (stretched scene holding exact uint8 levels, f32 or uint8 with
    ``out_u8``; stretched-value histogram ``(..., C, 256)`` int32).

    Every band is served from the table. ``skip_hist=True`` returns the
    stretched scene only, for a caller that holds the histogram.
    ``out`` and ``hist_out``: optional contiguous tensors of the results'
    shapes and dtypes on the scene's device, written and returned in place
    of new ones (``hist_out`` not with ``skip_hist``)."""
    _require(scene_u8.dtype == torch.uint8 and scene_u8.dim() in (3, 4),
             "scene_u8 must be a (C, H, W) or (B, C, H, W) uint8 tensor")
    _require(lut_u8.dtype == torch.uint8
             and tuple(lut_u8.shape) == (*scene_u8.shape[:-2], 256),
             "lut_u8 must be uint8 of shape (..., C, 256)")
    dev = scene_u8.device
    hist_shape = (*scene_u8.shape[:-2], 256)
    for t, shape, dtype in ((out, scene_u8.shape,
                             torch.uint8 if out_u8 else torch.float32),
                            (hist_out, hist_shape, torch.int32)):
        if t is not None:
            _require(t.shape == shape and t.dtype == dtype
                     and t.device == dev and t.is_contiguous(),
                     f"a destination must be a contiguous {dtype} tensor "
                     f"of shape {tuple(shape)} on {dev}")
    _require(hist_out is None or not skip_hist,
             "skip_hist computes no histogram for hist_out")
    if dev.type == "cpu":
        res = lut_hist_plain(scene_u8, lut_u8, out_u8, skip_hist)
        res = res if isinstance(res, tuple) else (res,)
        res = tuple(r if d is None else d.copy_(r)
                    for r, d in zip(res, (out, hist_out)))
        return res[0] if skip_hist else res
    _require_cuda(scene_u8, lut_u8)
    h, w = scene_u8.shape[-2:]
    if out is None:
        out = torch.empty(scene_u8.shape, device=dev,
                          dtype=torch.uint8 if out_u8 else torch.float32)
    planes, n = scene_u8.numel() // (h * w), h * w
    unit = lut_hist_unit(scene_u8, out)
    instance = lut_hist_instance(planes, n, unit, skip_hist)
    if instance == "cluster":      # every bin written once, by its owner
        span = -(-n // unit // LUT_CLUSTER)
        hist = (torch.empty(hist_shape, dtype=torch.int32, device=dev)
                if hist_out is None else hist_out)
    else:
        _, span = lut_hist_plan(planes, n, unit,
                                LUT_BLOCKS_PER_SM * _sm_count(dev.index))
        # an accumulator: blocks add their counts into it with atomics
        hist = (None if skip_hist else
                torch.zeros(hist_shape, dtype=torch.int32, device=dev)
                if hist_out is None else hist_out.zero_())
    _call("lut_hist", "lut_hist_launch",
          [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           _P],
          scene_u8.data_ptr(), lut_u8.data_ptr(), out.data_ptr(),
          None if hist is None else hist.data_ptr(), int(out_u8), planes,
          n, unit, span, int(instance == "cluster"), _stream(dev))
    lut_hist.launches += 1
    return out if skip_hist else (out, hist)


lut_hist.launches = 0


def raw_counts_plain(chunk_u8: torch.Tensor, counts: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of :func:`raw_counts`: :func:`histogram256` of the
    chunk, added into ``counts``."""
    counts += histogram256(chunk_u8)
    return counts


def raw_counts(chunk_u8: torch.Tensor, counts: torch.Tensor
               ) -> torch.Tensor:
    """Add the 256-bin counts of each plane of a ``(C, H, W)`` uint8 chunk
    into the caller's ``(C, 256)`` int32 accumulator ``counts``, in place,
    and return it. Calls over a scene's row chunks into one zeroed
    accumulator count the scene; the counts are exact while every bin
    stays below 2**31. The kernel (``csrc/lut_hist.cu``,
    ``raw_counts_kernel``) is lut_hist's ranges instance with no table and
    no output plane, over the blocks of :func:`lut_hist_plan`."""
    _require(chunk_u8.dtype == torch.uint8 and chunk_u8.dim() == 3
             and chunk_u8.numel() > 0,
             "chunk_u8 must be a non-empty (C, H, W) uint8 tensor")
    _require(counts.dtype == torch.int32
             and tuple(counts.shape) == (chunk_u8.shape[0], 256),
             "counts must be int32 of shape (C, 256)")
    if chunk_u8.device.type == "cpu" and counts.device.type == "cpu":
        return raw_counts_plain(chunk_u8, counts)
    _require_cuda(chunk_u8, counts)
    c, h, w = chunk_u8.shape
    dev = chunk_u8.device
    unit = lut_hist_unit(chunk_u8)
    _, span = lut_hist_plan(c, h * w, unit,
                            LUT_BLOCKS_PER_SM * _sm_count(dev.index))
    _call("lut_hist", "raw_counts_launch",
          [_P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_longlong, _P],
          chunk_u8.data_ptr(), counts.data_ptr(), c, h * w, unit, span,
          _stream(dev))
    raw_counts.launches += 1
    return counts


raw_counts.launches = 0


# ----------------------------------------------------------- forest_labels

_CHUNK = 32768      # pixels per matmul block of the plain forest


def gemm_leaf_sums_cm(gf, x_cm: torch.Tensor, chunk: int = _CHUNK,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fired leaves' distributions of each pixel of (F, N) f32
    features, summed in f64 -> (C, N) f64, by matmuls over ``chunk``-pixel
    blocks: the feature pick and the votes in f32 (exact: one-hot and +-1
    operands), the leaf-distribution sum in f64, exact for these
    per-tree distributions in any order. With ``scale`` (f32), each
    block's sums are rounded once to f32 and scaled as they come -> (C, N)
    f32, so no f64 buffer of the whole output is held. The blocks are cut
    to keep each (L, chunk) product near 64 MB; ``path`` may be dense or
    sparse (past ``models.forest.GEMM_MAX_LEAVES``)."""
    dev = x_cm.device
    sel_t = gf.selector.to(dev).T                       # (M, F)
    thr = gf.thresholds.to(dev)[:, None]
    path_t = gf.path.to(dev).T                          # (L, M)
    chunk = min(chunk, max(512, (64 << 20) // (4 * path_t.shape[0])))
    plen = gf.path_len.to(dev)[:, None]
    dist_t = gf.leaf_dist.to(dev, torch.float64).T      # (C, L)
    out = torch.empty((dist_t.shape[0], x_cm.shape[1]), device=dev,
                      dtype=torch.float64 if scale is None else torch.float32)
    for s in range(0, x_cm.shape[1], chunk):
        sgn = torch.where(sel_t @ x_cm[:, s:s + chunk] <= thr, 1.0, -1.0)
        fired = (path_t @ sgn == plen).to(torch.float64)
        sums = dist_t @ fired
        out[:, s:s + chunk] = (sums if scale is None
                               else sums.to(torch.float32) * scale)
    return out


def gemm_totals_cm(gf, x_cm: torch.Tensor, chunk: int = _CHUNK
                   ) -> torch.Tensor:
    """Mean leaf distribution of each pixel of (F, N) f32 features ->
    (C, N) f32: :func:`gemm_leaf_sums_cm` rounded once to f32 a block, so
    the totals do not depend on the summation order (see
    ``csrc/forest_labels.cu``)."""
    return gemm_leaf_sums_cm(gf, x_cm, chunk,
                             scale=gf.inv_trees.to(x_cm.device))


def gemm_labels_cm(gf, x_cm: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`forest_labels` (the JAX package's
    ``pipeline.turbo.gemm_labels_cm``): the argmax of
    :func:`gemm_totals_cm`. ``x_cm``: (F, N) or (B, F, N) f32 -> (N,) or
    (B, N) int32."""
    classes = gf.classes.to(x_cm.device)
    x3 = x_cm if x_cm.dim() == 3 else x_cm[None]
    # torch.argmax returns the first maximal index: ties go to the lowest
    # class, as in sklearn and the JAX package
    out = torch.stack([classes[torch.argmax(gemm_totals_cm(gf, xb), dim=0)]
                       for xb in x3])
    return out if x_cm.dim() == 3 else out[0]


_UNSET = np.iinfo(np.int32).max
FOREST_GROUP = 4        # trees walked together (kGroup, csrc/forest_labels.cu)
FOREST_SHARED_BYTES = 96 * 1024   # records + leaf table kept in shared memory
_FEATURE_BITS = 10      # a record's low bits: its feature; the rest: its kids


def _tree_links(gf) -> Tuple[np.ndarray, list]:
    """The GemmForest's leaf paths as child links, checked against the
    kernel's contract: ``(child, roots)``. ``child[m, 0]`` is taken on
    ``x <= thr`` (path sign +1), ``child[m, 1]`` on ``x > thr``; a child
    ``>= 0`` is a node, a child ``< 0`` the leaf ``~child``. ``roots`` has
    one entry per tree, in order of its first leaf; a root ``< 0`` is a
    one-leaf tree.

    The links come from the leaves' paths
    (``models.forest.path_entries``), each read root first: each entry
    links to the next of its leaf's path, the last to the leaf.
    O(entries), about L x depth. Raises when a selector column on a leaf
    path is not one-hot, a path_len is not its path's length, or the paths
    do not form binary trees."""
    from ..models.forest import path_entries    # models.forest imports us

    sel = gf.selector.cpu().numpy()
    path_len = gf.path_len.cpu().numpy()
    leaf, node, sign = path_entries(gf)
    m, n_leaves = gf.path.shape
    counts = np.bincount(leaf, minlength=n_leaves)
    _require(np.array_equal(counts.astype(np.float32), path_len),
             "path_len must equal each leaf's path length")
    used = np.unique(node)
    onehot = sel[:, used]
    _require(bool(np.isin(onehot, (0.0, 1.0)).all()
                  and (onehot.sum(axis=0) == 1).all()),
             "selector columns on a leaf path must be one-hot")
    starts = np.concatenate([[0], np.cumsum(counts)])
    to = np.empty_like(node)
    to[:-1] = node[1:]
    has_path = counts > 0
    to[starts[1:][has_path] - 1] = ~np.flatnonzero(has_path)
    # every (node, side) must link to one target
    slot = node * 2 + (sign < 0)            # side 1: sign -1 (x > thr)
    order = np.argsort(slot, kind="stable")
    slot, to = slot[order], to[order]
    first = np.ones(slot.size, bool)
    first[1:] = slot[1:] != slot[:-1]
    _require(bool(np.array_equal(to, np.repeat(
        to[first], np.diff(np.append(np.flatnonzero(first), slot.size))))),
             "the leaf paths do not form binary trees")
    child = np.full((m, 2), _UNSET, np.int64)
    child.reshape(-1)[slot[first]] = to[first]
    head = np.where(has_path, node[np.minimum(starts[:-1], node.size - 1)]
                    if node.size else 0, ~np.arange(n_leaves))
    _, at = np.unique(head, return_index=True)
    roots = [int(r) for r in head[np.sort(at)]]     # in first-leaf order
    inner = child[used]
    targets = inner[inner >= 0]
    _require(bool((inner != _UNSET).all())
             and np.unique(targets).size == targets.size
             and not np.isin(roots, targets).any(),
             "the leaf paths do not form binary trees")
    return child, roots


def _heights(child: np.ndarray, roots: list) -> Dict[int, int]:
    """Levels below each node reachable from ``roots`` (a node's own
    decision counts one; a leaf has none), by an explicit stack, so no
    depth limit applies."""
    height: Dict[int, int] = {}
    stack = [(r, False) for r in roots if r >= 0]
    while stack:
        ref, closed = stack.pop()
        if closed:
            height[ref] = 1 + max(height.get(int(c), 0) for c in child[ref])
            continue
        stack.append((ref, True))
        stack.extend((int(c), False) for c in child[ref] if c >= 0)
    return height


def pack_forest(gf) -> Dict[str, np.ndarray]:
    """The kernel's form of a GemmForest (host numpy): fixed-depth walks of
    ``FOREST_GROUP`` trees at a time (see ``csrc/forest_labels.cu``).

    The trees go in groups of ``FOREST_GROUP`` in tree order; a short last
    group is filled with trees whose one leaf is an all-zero row. Each
    group has a depth, its deepest tree's, and every tree of the group is
    padded to it, so a walk takes exactly that many steps:

    * ``records``: (R, 2) int32 ``{feature | kids << 10, threshold
      bits}``. A record's children are the adjacent slots ``kids`` (taken
      on ``x <= thr``) and ``kids + 1``: records while steps remain, rows
      of the leaf table after the group's last step. A padding record
      (under a leaf that is shallower than its group) has feature 0,
      threshold 0 and two equal children.
    * ``leaf_table``: (C', rows) f64, class major: row r of the walk is
      column r, one leaf's distribution (a padded leaf has two equal
      columns; the filler trees' column is zero). C' pads the C classes
      with zeros to the kernel's chunk: 4 up to 4 classes, 8 up to 8, else
      a multiple of 16.
    * ``roots``: (groups * FOREST_GROUP,) int32, each tree's first slot (a
      record, or a row in a group of depth 0); ``depths``: (groups,)
      int32.
    * ``classes``; and, for checks, ``record_node`` (R,) (the GemmForest
      column of each record, -1 for padding) and ``row_leaf`` (rows,) (the
      leaf of each row, ``L`` for the zero row).

    Within a group the slots are laid out level by level, so the records a
    warp reads at one step lie close together. Raises when the GemmForest
    is outside the kernel's contract (see :func:`_tree_links`) or has
    more than 1024 features."""
    child, roots = _tree_links(gf)
    n_features = gf.selector.shape[0]
    _require(n_features <= 1 << _FEATURE_BITS,
             f"the kernel takes at most {1 << _FEATURE_BITS} features")
    feature = gf.selector.cpu().numpy().argmax(axis=0)
    thr_bits = gf.thresholds.cpu().numpy().astype(np.float32).view(np.int32)
    n_leaves = gf.path.shape[1]
    zero_leaf = ~n_leaves                # the filler trees' leaf

    height = _heights(child, roots)
    trees = roots + [zero_leaf] * (-len(roots) % FOREST_GROUP)
    records: list = []        # [word0, threshold bits, GemmForest column]
    rows: list = []           # leaf of each row of the leaf table
    slot_roots, depths = [], []
    for g in range(0, len(trees), FOREST_GROUP):
        group = trees[g:g + FOREST_GROUP]
        d = max(height.get(r, 0) for r in group)
        depths.append(d)
        # (slots, ref, steps left): every slot in `slots` gets one content
        queue = []
        for ref in group:
            space = records if d > 0 else rows
            slot_roots.append(len(space))
            space.append(None)
            queue.append(((slot_roots[-1],), ref, d))
        for slots, ref, left in queue:      # grows while it is read: BFS
            if left == 0:                   # a leaf: the group's depth
                for s in slots:
                    rows[s] = ~ref
                continue
            space = records if left > 1 else rows
            kids = len(space)
            space.extend([None, None])
            if ref >= 0:
                rec = [int(feature[ref]) | kids << _FEATURE_BITS,
                       int(thr_bits[ref]), ref]
                queue.append(((kids,), int(child[ref, 0]), left - 1))
                queue.append(((kids + 1,), int(child[ref, 1]), left - 1))
            else:
                rec = [kids << _FEATURE_BITS, 0, -1]
                queue.append(((kids, kids + 1), ref, left - 1))
            for s in slots:
                records[s] = rec
    _require(max(len(records), len(rows)) < 1 << (32 - _FEATURE_BITS),
             "the forest has too many slots for the kernel's records")
    rec = np.asarray(records, np.int64).reshape(-1, 3)
    n_classes = gf.leaf_dist.shape[1]
    width = (4 if n_classes <= 4 else 8 if n_classes <= 8
             else -(-n_classes // 16) * 16)
    dist = np.zeros((n_leaves + 1, width))      # the last row: the zero leaf
    dist[:n_leaves, :n_classes] = gf.leaf_dist.cpu().numpy()
    row_leaf = np.asarray(rows, np.int64)
    return {
        "records": np.ascontiguousarray(
            rec[:, :2].astype(np.uint32).view(np.int32)),
        "leaf_table": np.ascontiguousarray(dist[row_leaf].T),
        "roots": np.asarray(slot_roots, np.int32),
        "depths": np.asarray(depths, np.int32),
        "classes": gf.classes.cpu().numpy().astype(np.int32),
        "record_node": rec[:, 2].astype(np.int32),
        "row_leaf": row_leaf.astype(np.int32),
    }


_KERNEL_FOREST = ("records", "leaf_table", "roots", "depths", "classes")
_PACKED: Dict[Tuple[int, str], tuple] = {}
_PACKED_LOCK = threading.Lock()


def _packed_on(gf, device: torch.device) -> Tuple[Dict[str, torch.Tensor],
                                                  float, Dict[str, int]]:
    """The arrays of ``pack_forest(gf)`` that the kernel reads, on
    ``device``, ``inv_trees`` as a host float and the packing's host facts
    (:func:`_pack_facts`), cached by buffer identity. The packing is
    marked ``forest.pack``, with counts ``leaves`` and ``records``."""
    key = (id(gf.path), str(device))
    hit = _PACKED.get(key)
    if hit is None:
        with _PACKED_LOCK:      # a dispatch thread and a warm-up may race
            hit = _PACKED.get(key)
            if hit is None:
                with span("forest.pack") as rec:
                    packed = pack_forest(gf)
                    if rec is not None:
                        rec.counts.update(
                            leaves=int(gf.path.shape[1]),
                            records=int(packed["records"].shape[0]))
                facts = _pack_facts(packed)
                packed = {k: torch.from_numpy(packed[k]).to(device)
                          for k in _KERNEL_FOREST}
                # a strong reference to the keyed buffer: a recycled id()
                # of a collected tensor would otherwise serve the wrong
                # forest
                hit = _PACKED[key] = (gf.path, packed, float(gf.inv_trees),
                                      facts)
    return hit[1], hit[2], hit[3]


def _pack_facts(packed: Dict[str, np.ndarray]) -> Dict[str, int]:
    """``table_bytes`` (records and leaf table), ``walk_depth`` (steps a
    pixel takes: ``FOREST_GROUP`` walks of each group's depth) and
    ``global_instance`` (1 when the tables pass ``FOREST_SHARED_BYTES``)
    of a packing."""
    nbytes = packed["records"].nbytes + packed["leaf_table"].nbytes
    return {"table_bytes": int(nbytes),
            "walk_depth": FOREST_GROUP * int(packed["depths"].sum()),
            "global_instance": int(nbytes > FOREST_SHARED_BYTES)}


def forest_instance(gf) -> str:
    """Which instance of the forest kernel ``gf`` takes: ``"shared"`` when
    its records and leaf table take at most ``FOREST_SHARED_BYTES`` (they
    are then staged in shared memory), else ``"global"``."""
    facts = _packed_on(gf, torch.device("cpu"))[2]
    return "global" if facts["global_instance"] else "shared"


def forest_labels(gf, x_cm: torch.Tensor) -> torch.Tensor:
    """GemmForest labels over channel-major features: (F, N) or (B, F, N)
    f32 -> (N,) or (B, N) int32, bit-equal to :func:`gemm_labels_cm`
    (first-index argmax on ties), for a forest of any size. Marked
    ``forest.labels``, with counts ``pixels``, ``walk_steps`` (the
    pixel-steps of the fixed-depth walks), ``table_bytes`` and
    ``global_instance`` (:func:`_pack_facts`)."""
    _require(x_cm.dtype == torch.float32 and x_cm.dim() in (2, 3),
             "x_cm must be a (F, N) or (B, F, N) f32 tensor")
    n_features = gf.selector.shape[0]
    _require(x_cm.shape[-2] == n_features,
             f"x_cm has {x_cm.shape[-2]} features, the forest {n_features}")
    with span("forest.labels") as rec:
        if rec is not None:
            facts = _packed_on(gf, x_cm.device)[2]
            pixels = x_cm.numel() // n_features
            rec.counts.update(pixels=pixels,
                              walk_steps=pixels * facts["walk_depth"],
                              table_bytes=facts["table_bytes"],
                              global_instance=facts["global_instance"])
        if x_cm.device.type == "cpu":
            return gemm_labels_cm(gf, x_cm)
        return _forest_labels_launch(gf, x_cm)


def _forest_labels_launch(gf, x_cm: torch.Tensor) -> torch.Tensor:
    _require_cuda(x_cm)
    n_features = gf.selector.shape[0]
    fp, inv_trees, facts = _packed_on(gf, x_cm.device)
    n_cols, n_rows = fp["leaf_table"].shape
    x3 = x_cm if x_cm.dim() == 3 else x_cm[None]
    batch, _, n = x3.shape
    out = torch.empty((batch, n), dtype=torch.int32, device=x_cm.device)
    _call("forest_labels", "forest_labels_launch",
          [_P, _P, ctypes.c_int, _P, ctypes.c_int, _P, _P, ctypes.c_int,
           ctypes.c_int, _P, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
           _P],
          x3.data_ptr(), fp["records"].data_ptr(), fp["records"].shape[0],
          fp["leaf_table"].data_ptr(), n_rows, fp["roots"].data_ptr(),
          fp["depths"].data_ptr(), fp["depths"].numel(), FOREST_GROUP,
          fp["classes"].data_ptr(), inv_trees, fp["classes"].numel(), n_cols,
          n_features, n, batch, 1 - facts["global_instance"],
          out.data_ptr(), _stream(x_cm.device))
    forest_labels.launches += 1
    return out if x_cm.dim() == 3 else out[0]


forest_labels.launches = 0


# --------------------------------------------------- ccmin_prop, cc_labels

_I32_MAX = torch.iinfo(torch.int32).max


def _stack3(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x[None]


def _cc_buffers(mask: torch.Tensor, connectivity: int):
    """``(m, h, w, out, scratch, device)`` of a union-find launch: the int32
    output of the mask's shape, and the int32 scratch, a parent and a
    minimum per node, where a node is a 2 x 2 pixel block for
    8-connectivity and a pixel for 4 (``csrc/ccmin_prop.cu``)."""
    shape = mask.shape
    m, h, w = shape if len(shape) == 3 else (1, *shape)
    tile_rows = 64 if connectivity == 8 else 32     # pixel rows per tile
    _require(m * h * w < 2 ** 31 and m <= 65535
             and -(-h // tile_rows) <= 65535,
             "the kernel takes fewer than 2**31 pixels, 65535 masks and "
             "65535 rows of tiles")
    dev = mask.device
    b = 2 if connectivity == 8 else 1
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * m * -(-h // b) * -(-w // b),
                          dtype=torch.int32, device=dev)
    return m, h, w, out, scratch, dev


def _check_mask(mask: torch.Tensor, connectivity: int) -> None:
    _require(mask.dim() in (2, 3) and mask.dtype in (torch.uint8, torch.bool),
             "mask must be a (H, W) or (M, H, W) uint8 or bool tensor")
    _require(connectivity in (8, 4), "connectivity must be 8 or 4")


def _seg_min(lab: torch.Tensor, fg: torch.Tensor, run_id: torch.Tensor,
             n_runs: int, big: int) -> torch.Tensor:
    """Min of ``lab`` over each foreground run, given every pixel's run id
    (flat); background reads and gets ``big``."""
    run_min = torch.full((n_runs,), big, dtype=lab.dtype, device=lab.device)
    run_min.scatter_reduce_(0, run_id, torch.where(fg, lab, big).reshape(-1),
                            "amin")
    return torch.where(fg, run_min[run_id].reshape(lab.shape), big)


def _run_ids(fg: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Flat id of the foreground run along the last dim that holds each
    pixel (background pixels share their row's preceding id), and the
    number of ids."""
    starts = fg & ~F.pad(fg[..., :-1], (1, 0))
    ids = torch.cumsum(starts.reshape(-1), 0)
    return ids, int(ids[-1]) + 1


def _cc_labels_plain(fg: torch.Tensor, connectivity: int = 8
                    ) -> torch.Tensor:
    """(M, H, W) bool -> int64 labels: each foreground pixel carries the
    minimum flat index of its component, background carries M*H*W. The
    JAX package's XLA scheme (``ops.components.connected_components``),
    batched over M with no adjacency across masks: per round, a neighbour
    min, a min over each row run and each column run, and one pointer
    jump, until nothing changes."""
    m, h, w = fg.shape
    n = m * h * w
    big = n
    row_id, n_row = _run_ids(fg)
    col_id, n_col = _run_ids(fg.transpose(1, 2).contiguous())
    col_id = col_id.reshape(m, w, h).transpose(1, 2).reshape(-1)
    idx = torch.arange(n, device=fg.device).reshape(m, h, w)
    lab = torch.where(fg, idx, big)
    while True:
        p = F.pad(lab, (1, 1, 1, 1), value=big)
        nm = torch.minimum(lab, p[:, :h, 1:1 + w])
        for dy, dx in ((2, 1), (1, 0), (1, 2)):
            nm = torch.minimum(nm, p[:, dy:dy + h, dx:dx + w])
        if connectivity == 8:
            for dy, dx in ((0, 0), (0, 2), (2, 0), (2, 2)):
                nm = torch.minimum(nm, p[:, dy:dy + h, dx:dx + w])
        nm = _seg_min(nm, fg, col_id, n_col, big)
        nm = _seg_min(nm, fg, row_id, n_row, big)
        flat = nm.reshape(-1)
        jumped = torch.cat([flat, flat.new_full((1,), big)])[flat]
        new = torch.minimum(nm, jumped.reshape(m, h, w))
        if torch.equal(new, lab):
            return lab
        lab = new


def ccmin_prop_plain(mask: torch.Tensor, values: torch.Tensor,
                     connectivity: int = 8) -> torch.Tensor:
    """Plain version of :func:`ccmin_prop`: the labels of
    :func:`_cc_labels_plain`, then a per-label ``scatter_reduce`` min of
    ``values`` and a gather."""
    fg = _stack3(mask) != 0
    lab = _cc_labels_plain(fg, connectivity).reshape(-1)
    vmin = torch.full((fg.numel() + 1,), _I32_MAX, dtype=torch.int32,
                      device=fg.device)
    vmin.scatter_reduce_(0, lab, _stack3(values).reshape(-1), "amin")
    out = torch.where(fg, vmin[lab].reshape(fg.shape), -1)
    return out if mask.dim() == 3 else out[0]


def ccmin_prop(mask: torch.Tensor, values: torch.Tensor,
               connectivity: int = 8) -> torch.Tensor:
    """Per-component minimum of ``values`` over the ``connectivity`` (8 or
    4) connected components of each mask: ``(M, H, W)`` or ``(H, W)`` uint8
    or bool ``mask`` (nonzero = foreground) and int32 ``values`` of the
    same shape -> int32, each foreground pixel holding min(values over its
    component) and background -1. Components never cross masks.

    The kernel is union-find and always runs to the exact result, so the
    JAX function's round bounds ``max_outer`` and ``n_inner`` have no
    counterpart. Its ``dtype``, ``coarse``, ``cache_masks`` and ``sweep``
    only chose a TPU schedule (label width, seeding, VMEM use, sweep
    order) with the same result, so they are left out too."""
    _check_mask(mask, connectivity)
    _require(values.dtype == torch.int32 and values.shape == mask.shape,
             "values must be int32 of the mask's shape")
    if mask.device.type == "cpu":
        return ccmin_prop_plain(mask, values, connectivity)
    _require_cuda(mask, values)
    m, h, w, out, scratch, dev = _cc_buffers(mask, connectivity)
    _call("ccmin_prop", "ccmin_prop_launch",
          [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, _P],
          mask.data_ptr(), values.data_ptr(), out.data_ptr(),
          scratch.data_ptr(), m, h, w, connectivity, _stream(dev))
    ccmin_prop.launches += 1
    return out


ccmin_prop.launches = 0


def cc_labels_plain(mask: torch.Tensor, connectivity: int = 8
                    ) -> torch.Tensor:
    """Plain version of :func:`cc_labels`: the labels of
    :func:`_cc_labels_plain`, made mask-relative, int32, background -1."""
    _check_mask(mask, connectivity)
    fg = _stack3(mask) != 0
    m, h, w = fg.shape
    lab = _cc_labels_plain(fg, connectivity)
    base = torch.arange(m, device=fg.device)[:, None, None] * (h * w)
    out = torch.where(fg, lab - base, -1).to(torch.int32)
    return out if mask.dim() == 3 else out[0]


def cc_labels(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Connected-component labels of each mask: ``(H, W)`` or ``(M, H,
    W)`` uint8 or bool (nonzero = foreground) -> int32 of the same shape,
    each foreground pixel holding the minimum mask-relative linear index
    ``y * W + x`` of its ``connectivity`` (8 or 4) component, background
    -1. Components never cross masks.

    The kernel is union-find and always runs to the exact labels, so the
    JAX function's round bounds ``max_outer`` and ``n_inner`` have no
    counterpart, nor has ``interpret``."""
    _check_mask(mask, connectivity)
    if mask.device.type == "cpu":
        return cc_labels_plain(mask, connectivity)
    _require_cuda(mask)
    m, h, w, out, scratch, dev = _cc_buffers(mask, connectivity)
    _call("ccmin_prop", "cc_labels_launch",
          [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, _P],
          mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, h, w,
          connectivity, _stream(dev))
    cc_labels.launches += 1
    return out


cc_labels.launches = 0


# ------------------------------------------------------ hist_dense, keep_lut

HIST_LO = 128       # an id splits as (id // 128, id % 128) in the layouts


def _ids_2d(ids: torch.Tensor) -> torch.Tensor:
    _require(ids.dtype == torch.int32 and ids.dim() >= 2,
             "ids must be an int32 tensor of shape (M, ...)")
    return ids.reshape(ids.shape[0], -1)


def hist_dense_plain(ids: torch.Tensor, bins_hi: int) -> torch.Tensor:
    """Plain version of :func:`hist_dense`: a masked ``bincount`` per
    mask."""
    flat = _ids_2d(ids)
    bins = bins_hi * HIST_LO
    rows = [torch.bincount(r[(r >= 0) & (r < bins)], minlength=bins)
            for r in flat]
    return torch.stack(rows).to(torch.int32).reshape(-1, bins_hi, HIST_LO)


HIST_CLUSTER = 8        # blocks per mask of the cluster instance (kCluster)
HIST_THREADS = 512      # its threads per block (kClusterThreads)
HIST_UNROLL = 4         # 16-byte loads in flight per thread (kUnroll)
HIST_CLUSTER_MAX_BINS = HIST_CLUSTER * 12288     # 48 KB of bins a block


def hist_cluster_plan(n: int, bins: int) -> Tuple[int, int]:
    """The cluster instance's partition of one mask (``csrc/hist_keep.cu``):
    ``(span4, bpb)``, the 16-byte words of ids each of the ``HIST_CLUSTER``
    blocks reads (block r: words ``[r * span4, (r + 1) * span4)``), and the
    bins each block holds in its shared memory, a multiple of 128 (block r
    owns the granules of 128 bins ``r, r + HIST_CLUSTER, ...``)."""
    span4 = -(-(n // 4) // HIST_CLUSTER)
    per = HIST_CLUSTER * HIST_LO
    return span4, -(-bins // per) * HIST_LO


def hist_dense_instance(flat: torch.Tensor, bins: int) -> str:
    """Which instance of the kernel counts ``(M, N)`` ids into ``bins``:
    ``"cluster"`` (one thread-block cluster per mask, every bin written
    once) or ``"global"`` (global atomics into a zeroed output) for the
    shapes the cluster instance does not take: one mask, ``N % 4 != 0``,
    ids not 16-byte aligned, or more than ``HIST_CLUSTER_MAX_BINS``."""
    m, n = flat.shape
    if (m >= 2 and n % 4 == 0 and flat.data_ptr() % 16 == 0
            and bins <= HIST_CLUSTER_MAX_BINS):
        return "cluster"
    return "global"


def hist_dense(ids: torch.Tensor, bins_hi: int) -> torch.Tensor:
    """``(M, ...)`` int32 ids -> ``(M, bins_hi, 128)`` int32 exact counts
    per mask of each id in ``[0, bins_hi * 128)``; other ids are not
    counted. The JAX kernel returns f32 counts (MXU sums); int32 keeps them
    exact integers for the ``counts >= min_areas`` comparison they feed."""
    flat = _ids_2d(ids)
    _require(bins_hi >= 1, "bins_hi must be positive")
    if ids.device.type == "cpu":
        return hist_dense_plain(ids, bins_hi)
    _require_cuda(ids)
    m, n = flat.shape
    bins = bins_hi * HIST_LO
    if hist_dense_instance(flat, bins) == "cluster":
        span4, bpb = hist_cluster_plan(n, bins)
        counts = torch.empty((m, bins_hi, HIST_LO), dtype=torch.int32,
                             device=ids.device)
    else:       # the global instance adds into the output
        span4, bpb = 0, 0
        counts = torch.zeros((m, bins_hi, HIST_LO), dtype=torch.int32,
                             device=ids.device)
    _call("hist_keep", "hist_dense_launch",
          [_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_longlong, ctypes.c_int, _P],
          flat.data_ptr(), counts.data_ptr(), m, n, bins, span4, bpb,
          _stream(ids.device))
    hist_dense.launches += 1
    return counts


hist_dense.launches = 0


def _check_table(ids: torch.Tensor, keep: torch.Tensor) -> None:
    _require(keep.dtype == torch.bool and keep.dim() == 3
             and keep.shape[0] == ids.shape[0] and keep.shape[2] == HIST_LO,
             "keep must be a bool (M, bins_hi, 128) table")


def keep_lut_plain(ids: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`keep_lut`: a masked gather."""
    flat = _ids_2d(ids)
    _check_table(ids, keep)
    table = keep.reshape(keep.shape[0], -1)
    bins = table.shape[1]
    valid = (flat >= 0) & (flat < bins)
    bit = torch.gather(table, 1, torch.where(valid, flat, 0).long())
    return (bit & valid).to(torch.int32).reshape(ids.shape)


def keep_lut(ids: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``(M, ...)`` int32 ids + ``(M, bins_hi, 128)`` bool keep table ->
    int32 keep bits of the ids' shape; ids outside ``[0, bins_hi * 128)``
    read 0. The table is indexed ``[id // 128, id % 128]``: the JAX kernel
    took its transpose, an MXU layout."""
    flat = _ids_2d(ids)
    _check_table(ids, keep)
    if ids.device.type == "cpu":
        return keep_lut_plain(ids, keep)
    _require_cuda(ids, keep)
    m, n = flat.shape
    out = torch.empty(ids.shape, dtype=torch.int32, device=ids.device)
    _call("hist_keep", "keep_lut_launch",
          [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P],
          flat.data_ptr(), keep.data_ptr(), out.data_ptr(), m, n,
          keep.shape[1] * HIST_LO, _stream(ids.device))
    keep_lut.launches += 1
    return out


keep_lut.launches = 0


# ------------------------------------- fused_calibrate_stretch, fused_indices

_DN_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


def _dn_planes(bands: torch.Tensor) -> torch.Tensor:
    """(C, H, W) DNs in a dtype the kernel reads (uint8, uint16, f32);
    any other dtype goes to f32, as the JAX function's ``astype``."""
    _require(bands.dim() == 3, "bands must be a (C, H, W) tensor")
    return bands if bands.dtype in _DN_CODES else bands.to(torch.float32)


def _per_band(v, bands: torch.Tensor) -> torch.Tensor:
    t = as_tensor(v, bands.device, torch.float32).reshape(-1)
    _require(t.numel() == bands.shape[0], "one gain and bias per band")
    return t


def fused_calibrate_stretch_plain(bands: torch.Tensor, gains, biases
                                  ) -> torch.Tensor:
    """Plain version of :func:`fused_calibrate_stretch`: ``cal = DN * gain
    + bias`` in f32, then ``ops.normalize.minmax_stretch_f32`` per band,
    ``(cal - min) * 255 / (max - min)``."""
    x = _dn_planes(bands)
    g = _per_band(gains, x)[:, None, None]
    b = _per_band(biases, x)[:, None, None]
    return minmax_stretch_f32(x.to(torch.float32) * g + b)


STRETCH_CLUSTER = 16             # blocks a band (kStretchCluster)
STRETCH_STAGE_BYTES = 100 * 1024  # a staged slice at most (kStretchStageBytes)
STRETCH_MAX_HOST_BANDS = 128      # bands with host gains (kStretchMaxHostBands)


def calibrate_stretch_plan(hw: int, itemsize: int) -> Tuple[int, str]:
    """The kernel's partition of a band of ``hw`` DNs of ``itemsize`` bytes
    (``csrc/stretch_indices.cu``): ``(span, instance)``. Block ``r`` of
    the band's cluster of ``STRETCH_CLUSTER`` takes pixels ``[r * span,
    (r + 1) * span)``, ``span`` a multiple of 4; the ``"staged"`` instance
    keeps that slice in shared memory (at most ``STRETCH_STAGE_BYTES``),
    the ``"streamed"`` one reads it again for the stretch."""
    per_block = -(-hw // STRETCH_CLUSTER)
    span = -(-per_block // 4) * 4
    return span, ("staged" if span * itemsize <= STRETCH_STAGE_BYTES
                  else "streamed")


def _band_values(v, x: torch.Tensor):
    """One f32 per band of ``x``: a tensor on the card stays there (the
    kernel reads it); values on the host (a sequence, an array or a CPU
    tensor) become an f32 array, which the kernel takes by value."""
    if isinstance(v, torch.Tensor) and v.device.type != "cpu":
        t = v.to(x.device, torch.float32).contiguous().reshape(-1)
        _require(t.numel() == x.shape[0], "one gain and bias per band")
        return t
    a = np.ascontiguousarray(
        (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)),
        dtype=np.float32).reshape(-1)
    _require(a.size == x.shape[0], "one gain and bias per band")
    _require(a.size <= STRETCH_MAX_HOST_BANDS,
             f"at most {STRETCH_MAX_HOST_BANDS} bands with gains and biases "
             f"on the host; pass them as tensors on the card")
    return a


def fused_calibrate_stretch(bands: torch.Tensor, gains, biases
                            ) -> torch.Tensor:
    """Stage 1 with the identity warp: ``(C, H, W)`` DNs (uint8, uint16 or
    f32; other dtypes go to f32) and ``(C,)`` gains and biases -> ``(C, H,
    W)`` f32 in [0, 255]; the caller truncates to uint8. Per band ``cal =
    DN * gain + bias``, then ``(cal - mn) * 255 / (mx - mn)`` with ``mn``
    and ``mx`` the band's calibrated extremes, right for negative gains
    too; a NaN among the DNs makes the band NaN, as ``torch.aminmax``
    does. A flat band divides by zero, as the JAX path does. Bit-equal to
    :func:`fused_calibrate_stretch_plain`.

    Gains and biases on the host (the configuration's values) go to the
    kernel by value, with no copy to the card; tensors on the card are
    read there. One launch a call."""
    x = _dn_planes(bands)
    if x.device.type == "cpu":
        return fused_calibrate_stretch_plain(x, gains, biases)
    x = x.contiguous()
    _require_cuda(x)
    vals = (_band_values(gains, x), _band_values(biases, x))
    _require_cuda(x, *(v for v in vals if isinstance(v, torch.Tensor)))
    host = [v.ctypes.data if isinstance(v, np.ndarray) else None
            for v in vals]
    card = [v.data_ptr() if isinstance(v, torch.Tensor) else None
            for v in vals]
    c, h, w = x.shape
    span, instance = calibrate_stretch_plan(h * w, x.element_size())
    out = torch.empty((c, h, w), dtype=torch.float32, device=x.device)
    _call("stretch_indices", "calibrate_stretch_launch",
          [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_longlong, ctypes.c_int, _P, _P],
          x.data_ptr(), _DN_CODES[x.dtype], *host, *card, c, h * w, span,
          int(instance == "staged"), out.data_ptr(), _stream(x.device))
    fused_calibrate_stretch.launches += 1
    return out


fused_calibrate_stretch.launches = 0

INDEX_ORDER = ("ndvi", "evi", "msavi", "ndwi", "mndwi", "ndbi", "bsi")


def _index_bands(bands: torch.Tensor) -> torch.Tensor:
    _require(bands.dim() in (3, 4) and bands.shape[-3] >= 5,
             "bands must be a (C >= 5, H, W) or (B, C >= 5, H, W) tensor")
    return bands.to(torch.float32)


def fused_spectral_indices_plain(bands: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_spectral_indices`:
    ``ops.indices.spectral_indices`` stacked in the kernel's order."""
    idx = spectral_indices(_index_bands(bands))
    return torch.stack([idx[k] for k in INDEX_ORDER], dim=-3)


def fused_spectral_indices(bands: torch.Tensor) -> torch.Tensor:
    """``(C >= 5, H, W)`` or ``(B, C >= 5, H, W)`` normalised bands -> ``(...,
    7, H, W)`` f32 [ndvi, evi, msavi, ndwi, mndwi, ndbi, bsi] in one pass;
    the semantics of ``ops.indices.spectral_indices`` (guarded divide at
    den > 1e-3, clip to [-1, 1]), bit-equal to
    :func:`fused_spectral_indices_plain`."""
    x = _index_bands(bands)
    if x.device.type == "cpu":
        return fused_spectral_indices_plain(x)
    x = x.contiguous()
    _require_cuda(x)
    x4 = x if x.dim() == 4 else x[None]
    batch, n_bands, h, w = x4.shape
    out = torch.empty((batch, 7, h, w), dtype=torch.float32, device=x.device)
    _call("stretch_indices", "spectral_indices_launch",
          [_P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P, _P],
          x4.data_ptr(), n_bands, batch, h * w, out.data_ptr(),
          _stream(x.device))
    fused_spectral_indices.launches += 1
    return out if x.dim() == 4 else out[0]


fused_spectral_indices.launches = 0


# --------------------------------------------------------------- glcm_grid

_GLCM_BLOCKS_GLOBAL = 264       # blocks of the global-count route (2 per SM)
_MAX_OFFSETS = 16


def _check_glcm(q: torch.Tensor, levels: int, window: int, step: int,
                offsets) -> Tuple[Tuple[int, int], ...]:
    _require(q.dtype == torch.int32 and q.dim() in (2, 3),
             "q must be a (H, W) or (B, H, W) int32 tensor")
    if step != window:
        raise ValueError("the GLCM kernel supports the reference's "
                         "non-overlapping grid (step == window) only")
    offs = tuple((int(dr), int(dc)) for dr, dc in offsets)
    _require(levels >= 1 and 1 <= window <= min(q.shape[-2:]),
             "levels >= 1 and a window that fits the band")
    _require(1 <= len(offs) <= _MAX_OFFSETS
             and all(abs(dr) < window and abs(dc) < window
                     for dr, dc in offs),
             f"1 to {_MAX_OFFSETS} offsets, each inside the window")
    return offs


def _glcm_props(mom: torch.Tensor, hd: torch.Tensor) -> torch.Tensor:
    """The five properties in f64 from one offset's integer moments: ``mom``
    (N, 7) int64 [n, S1 .. S6] and ``hd`` (N, levels) counts per |i - j|
    (``csrc/glcm.cu`` states the formulas). Operation for operation what
    the kernel does, every divisor a tensor (a CUDA division by a host
    scalar multiplies by its reciprocal instead)."""
    n, s1, s2, s3, s4, s5, s6 = mom.unbind(1)
    levels = hd.shape[1]
    ok = n > 0
    nd = torch.where(ok, n, 1).to(torch.float64)
    d = torch.arange(levels, dtype=torch.int64, device=hd.device)
    terms = hd.to(torch.float64) / (1 + d * d).to(torch.float64)
    h = torch.zeros_like(nd)
    for k in range(levels):             # d ascending, as the kernel sums
        h = h + terms[:, k]
    var_num = 2 * n * s4 - s3 * s3
    cov_num = 4 * n * s5 - s3 * s3
    flat = var_num == 0
    corr = torch.where(flat, 1.0, cov_num.to(torch.float64)
                       / torch.where(flat, 1, var_num).to(torch.float64))
    energy = (torch.sqrt((2 * s6).to(torch.float64))
              / torch.where(ok, 2 * n, 1).to(torch.float64))
    zero = torch.zeros_like(nd)
    return torch.stack([torch.where(ok, s1.to(torch.float64) / nd, zero),
                        torch.where(ok, s2.to(torch.float64) / nd, zero),
                        torch.where(ok, h / nd, zero),
                        torch.where(ok, energy, zero),
                        torch.where(ok, corr, 1.0)], dim=1)


def glcm_grid_plain(q: torch.Tensor, levels: int, window: int, step: int,
                    offsets) -> torch.Tensor:
    """Plain version of :func:`glcm_grid`: the integer moments of each
    window's pairs with torch ops (``scatter_add`` counts), then
    :func:`_glcm_props` and the mean over offsets in f64, rounded once."""
    offs = _check_glcm(q, levels, window, step, offsets)
    q3 = _stack3(q).to(torch.int64)
    batch, h, w = q3.shape
    win = q3.unfold(1, window, step).unfold(2, window, step)
    n_i, n_j = win.shape[1], win.shape[2]
    win = win.reshape(-1, window, window)
    n_win = win.shape[0]
    ll = levels * levels
    total = torch.zeros((n_win, 5), dtype=torch.float64, device=q.device)
    for dr, dc in offs:
        r0, r1 = max(0, -dr), min(window, window - dr)
        c0, c1 = max(0, -dc), min(window, window - dc)
        a = win[:, r0:r1, c0:c1].reshape(n_win, -1)
        b = win[:, r0 + dr:r1 + dr, c0 + dc:c1 + dc].reshape(n_win, -1)
        valid = (a >= 0) & (a < levels) & (b >= 0) & (b < levels)
        v = valid.to(torch.int64)
        diff = a - b
        ones = torch.ones_like(a, dtype=torch.int32)
        cell = torch.where(valid, a * levels + b, ll)
        cell_t = torch.where(valid, b * levels + a, ll)
        counts = torch.zeros((n_win, ll + 1), dtype=torch.int32,
                             device=q.device).scatter_add_(1, cell, ones)
        s6 = (torch.gather(counts, 1, cell).to(torch.int64)
              + torch.gather(counts, 1, cell_t).to(torch.int64)) * v
        hd = torch.zeros((n_win, levels + 1), dtype=torch.int64,
                         device=q.device).scatter_add_(
            1, torch.where(valid, diff.abs(), levels), v)[:, :levels]
        mom = torch.stack([v.sum(1), (diff * diff * v).sum(1),
                           (diff.abs() * v).sum(1), ((a + b) * v).sum(1),
                           ((a * a + b * b) * v).sum(1), (a * b * v).sum(1),
                           s6.sum(1)], dim=1)
        total = total + _glcm_props(mom, hd)
    n_off = torch.tensor(float(len(offs)), dtype=torch.float64,
                         device=q.device)
    out = (total / n_off).to(torch.float32).reshape(batch, n_i, n_j, 5)
    return out if q.dim() == 3 else out[0]


@functools.lru_cache(maxsize=None)
def _glcm_counts_in_smem(levels: int, window: int, n_offsets: int) -> bool:
    """Whether the counts of the shared instance's warps (one per offset,
    up to four) fit a block's shared memory beside the window at
    ``levels``; else the global instance takes the call, its counts in a
    global scratch."""
    lib = _build.load("glcm")
    lib.glcm_warps.restype = ctypes.c_int
    lib.glcm_warps.argtypes = [ctypes.c_int] * 3
    return lib.glcm_warps(levels, window, n_offsets) > 0


def glcm_grid(q: torch.Tensor, levels: int, window: int, step: int,
              offsets) -> torch.Tensor:
    """Per-window GLCM properties: ``(H, W)`` or ``(B, H, W)`` int32 levels
    -> ``(..., n_i, n_j, 5)`` f32 [contrast, dissimilarity, homogeneity,
    energy, correlation], each window's symmetric, normalised
    co-occurrence matrix per ``(dr, dc)`` offset, averaged over offsets.
    Pairs with a level outside ``[0, levels)`` are not counted. Windows
    must not overlap (``step == window``, as the JAX function requires).
    Bit-equal to :func:`glcm_grid_plain`; within f32 rounding of
    ``ops.texture``'s XLA route, except that a window of zero variance
    gives a correlation of exactly 1."""
    offs = _check_glcm(q, levels, window, step, offsets)
    if q.device.type == "cpu":
        return glcm_grid_plain(q, levels, window, step, offs)
    q = q.contiguous()
    _require_cuda(q)
    batch, h, w = _stack3(q).shape
    n_i = (h - window) // step + 1
    n_j = (w - window) // step + 1
    n_win = batch * n_i * n_j
    if _glcm_counts_in_smem(levels, window, len(offs)):
        scratch, grid = None, n_win
    else:       # counts too large for shared memory: a zeroed slot a block
        grid = min(n_win, _GLCM_BLOCKS_GLOBAL)
        scratch = torch.zeros((grid, levels * levels + levels),
                              dtype=torch.int32, device=q.device)
    flat_offs = (ctypes.c_int * (2 * len(offs)))(
        *[v for pair in offs for v in pair])
    out = torch.empty((batch, n_i, n_j, 5), dtype=torch.float32,
                      device=q.device)
    _call("glcm", "glcm_launch",
          [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
           ctypes.c_int, _P, ctypes.c_int, _P, _P],
          q.data_ptr(), batch, h, w, levels, window, step, flat_offs,
          len(offs), None if scratch is None else scratch.data_ptr(), grid,
          out.data_ptr(), _stream(q.device))
    glcm_grid.launches += 1
    return out if q.dim() == 3 else out[0]


glcm_grid.launches = 0


# ------------------------------------------------------------ kmeans_lloyd

LLOYD_POINTS_PER_BLOCK = 2048   # a partials block's points (kPointsPerBlock)
LLOYD_MAX_K = 32                # clusters the kernels take (kMaxK)
LLOYD_MAX_F = 64                # features the kernels take (kMaxF)
_I32_MAX = 2 ** 31 - 1


def lloyd_fits(b: int, n: int, k: int, f: int) -> bool:
    """Whether :func:`lloyd_pass` takes ``b`` problems of ``n`` points, ``k``
    clusters and ``f`` features."""
    return (1 <= b <= 65535 and 1 <= n <= _I32_MAX and 1 <= k <= LLOYD_MAX_K
            and 1 <= f <= LLOYD_MAX_F)


class LloydScratch(NamedTuple):
    """The partials of :func:`lloyd_pass`, one entry for each of the G
    blocks of ``LLOYD_POINTS_PER_BLOCK`` points of a problem, and its
    flag."""
    sums: torch.Tensor      # (B, K, F, G) f64, each cluster's feature sums
    counts: torch.Tensor    # (B, K, G) int32, each cluster's points
    far_d: torch.Tensor     # (B, G) f32, the block's farthest distance
    far_i: torch.Tensor     # (B, G) int32, and its point
    flag: torch.Tensor      # (1,) int32: 1 when a problem stays active


def lloyd_scratch(x: torch.Tensor, k: int) -> LloydScratch:
    """Zeroed partials for :func:`lloyd_pass` on (B, N, F) f32 points and
    ``k`` clusters (a skipped problem's entries stay valid indices).
    Raises ``ValueError`` for points the kernels do not take: another
    dtype, or a shape past ``lloyd_fits``."""
    b, n, f = x.shape
    _require(x.dtype == torch.float32, f"lloyd_pass takes f32 points, not "
             f"{x.dtype}")
    if not lloyd_fits(b, n, k, f):
        raise ValueError(f"no kernel for {b} problems of {n} points, {k} "
                         f"clusters, {f} features (lloyd_pass takes up to "
                         f"{LLOYD_MAX_K} clusters and {LLOYD_MAX_F} "
                         f"features)")
    g = -(-n // LLOYD_POINTS_PER_BLOCK)

    def new(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=x.device)
    return LloydScratch(new((b, k, f, g), torch.float64),
                        new((b, k, g), torch.int32),
                        new((b, g), torch.float32), new((b, g), torch.int32),
                        new((1,), torch.int32))


_LLOYD_ARGS = [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               _P, _P, _P, _P, _P, _P]


def lloyd_pass(x: torch.Tensor, cents: torch.Tensor, shift: torch.Tensor,
               n_iter: torch.Tensor, tol_abs: torch.Tensor, max_iter: int,
               scratch: LloydScratch, combine=None) -> torch.Tensor:
    """One iteration of ``models.kmeans.fit_centroids``' loop on (B, N, F)
    f32 points, in place, in two launches: for each problem still active
    (``shift > tol_abs`` and ``n_iter < max_iter``), ``cents`` (B, K, F)
    f32 become the means of their points (an empty cluster: the point
    farthest from its nearest centroid, the first on ties), ``shift`` (B,)
    f32 their squared shift, and ``n_iter`` (B,) int64 rises by one; the
    other problems are left as they are. Returns ``scratch.flag``, (1,)
    int32 on the card: 1 when any problem stays active. Distances by the
    plain version's formula (``models.kmeans._lloyd``), sums in f64 in a
    fixed order, so a rerun gives the same bits.

    ``combine``, on a process group: a function of ``scratch`` after the
    first kernel that returns every rank's partials as one block a problem,
    ``(sums (B, K, F, 1) f64, counts (B, K, 1) int32, the farthest point
    (B, 1, F) f32)``; the second kernel then reads those."""
    _require_cuda(x, cents, shift, n_iter, tol_abs, *scratch)
    b, n, f = x.shape
    k = cents.shape[1]
    _require(x.dtype == cents.dtype == shift.dtype == tol_abs.dtype
             == torch.float32 and n_iter.dtype == torch.int64,
             "x, cents, shift and tol_abs must be f32, n_iter int64")
    if not (cents.shape == (b, k, f) and shift.shape == (b,)
            == n_iter.shape == tol_abs.shape and lloyd_fits(b, n, k, f)):
        raise ValueError(f"no kernel for {b} problems of {n} points, {k} "
                         f"clusters, {f} features")
    _require(scratch.sums.shape == (b, k, f, -(-n // LLOYD_POINTS_PER_BLOCK)),
             "scratch does not match the points (lloyd_scratch)")
    state = (cents.data_ptr(), shift.data_ptr(), tol_abs.data_ptr(),
             n_iter.data_ptr(), max_iter)
    parts = (scratch.sums.data_ptr(), scratch.counts.data_ptr(),
             scratch.far_d.data_ptr(), scratch.far_i.data_ptr(),
             scratch.flag.data_ptr(), _stream(x.device))
    blocks = scratch.sums.shape[-1]
    if combine is None:
        _call("kmeans_lloyd", "lloyd_pass_launch", _LLOYD_ARGS,
              x.data_ptr(), *state, b, n, k, f, blocks, *parts)
    else:
        _call("kmeans_lloyd", "lloyd_partials_launch", _LLOYD_ARGS,
              x.data_ptr(), *state, b, n, k, f, blocks, *parts)
        sums, counts, far = combine(scratch)
        _require(sums.shape == (b, k, f, 1) and sums.dtype == torch.float64
                 and counts.shape == (b, k, 1) and counts.dtype == torch.int32
                 and far.shape == (b, 1, f) and far.dtype == torch.float32,
                 "combine returns (B, K, F, 1) f64 sums, (B, K, 1) int32 "
                 "counts and a (B, 1, F) f32 point")
        sums, counts, far = (t.contiguous() for t in (sums, counts, far))
        # one block a problem, its farthest point row 0 of `far`
        far_d = torch.zeros((b, 1), dtype=torch.float32, device=x.device)
        far_i = torch.zeros((b, 1), dtype=torch.int32, device=x.device)
        _require_cuda(x, sums, counts, far, far_d, far_i)
        _call("kmeans_lloyd", "lloyd_update_launch",
              [_P, ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               _P, _P, _P, _P, _P, _P],
              far.data_ptr(), 1, *state, b, k, f, 1, sums.data_ptr(),
              counts.data_ptr(), far_d.data_ptr(), far_i.data_ptr(),
              scratch.flag.data_ptr(), _stream(x.device))
    lloyd_pass.launches += 2
    return scratch.flag


lloyd_pass.launches = 0
