"""Device meshes over a ``torch.distributed`` process group, one rank a
device, and how a global array splits over them.

Counterpart of ``rs_image_segmentation_tpu.parallel.mesh``. The JAX
package is single-controller: one process drives a ``Mesh`` and
``shard_map`` hands each device its block. The port is multi-controller:
one process a rank, each holding its LOCAL block as a plain tensor on its
own device, with the explicit collectives of ``parallel.collectives`` in
place of the ``lax`` ones. A mesh is PyTorch's named-axis
``DeviceMesh`` (``init_device_mesh``); ``mesh.get_group(axis)`` is the
process group of an axis.

Axes convention (the JAX package's):
  data  : scenes / pixel blocks (data parallelism, all-reduces)
  tile  : image row blocks (halo exchange on a ring)
  model : forest leaf blocks (one all-reduce of the class sums)

Backends: NCCL on the card, one rank a card; gloo on the CPU. NCCL refuses
two ranks on one GPU ("Duplicate GPU detected"), so several ranks on one
card take gloo, chosen by the caller (``backend="gloo"``), every rank then
on card ``rank % cards``. A world of one rank is a first-class case:
:func:`make_mesh` starts a one-rank group when none exists, so a
single-process caller runs the same code.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..backend import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")
# a hung collective fails its run after this long instead of blocking it
TIMEOUT_S = 60.0


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def check_backend(backend: str, device: torch.device, world: int) -> None:
    """Raise unless ``backend`` can run ``world`` ranks on ``device``'s
    kind: NCCL needs a CUDA device a rank, one card each."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"the NCCL backend runs on CUDA devices, not "
                         f"{device}; use backend='gloo' on the CPU")
    cards = torch.cuda.device_count()
    if world > cards:
        raise RuntimeError(
            f"NCCL takes one CUDA device a rank: {world} ranks on {cards} "
            f"visible device(s), and NCCL refuses two ranks on one GPU "
            f"('Duplicate GPU detected'); use backend='gloo' to run several "
            f"ranks on one card")


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % cards``, made the
    process's current CUDA device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for rank {rank}")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_group(backend: Optional[str], device: DeviceLike, world: int,
               rank: int, init_method: Optional[str] = None,
               store=None, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join (or, at ``world == 1`` with neither ``init_method`` nor
    ``store``, start in memory) the default process group; returns this
    rank's device. ``init_method``: ``tcp://host:port``, ``file://path``
    or ``env://``."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    check_backend(backend, dev, world)
    dev = rank_device(dev, rank)
    if init_method is None and store is None:
        if world != 1:
            raise ValueError("a group of several ranks needs init_method "
                             "or store")
        store = dist.HashStore()
    dist.init_process_group(
        backend, init_method=init_method, store=store, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              device: DeviceLike = None,
              backend: Optional[str] = None) -> DeviceMesh:
    """A mesh over every rank of the default group, started as a one-rank
    group on ``device`` (CUDA unless named) when none exists. Default: a
    1-D ``data`` mesh over the whole world; ``shape`` must multiply to the
    world size."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_group(backend, dev, 1, 0)
    world, rank = dist.get_world_size(), dist.get_rank()
    check_backend(dist.get_backend(), dev, world)
    if shape is None:
        shape = (world,)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != world size {world}")
    rank_device(dev, rank)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def block_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of block ``index`` when ``n`` rows split into
    ``parts`` contiguous blocks, the first ``n % parts`` one row longer
    (``np.array_split``); equal blocks when ``parts`` divides ``n``."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


class Sharding(NamedTuple):
    """Placements of an array on a mesh, one a mesh axis (``Shard(dim)``
    or ``Replicate()``, PyTorch's DTensor types); :meth:`block` cuts this
    rank's block out of the global array."""
    mesh: DeviceMesh
    placements: Tuple

    def block(self, x):
        """This rank's block of the global ``x`` (an array, tensor or
        sequence; a view where ``x`` allows one)."""
        for i, p in enumerate(self.placements):
            if not isinstance(p, Shard):
                continue
            n = x.shape[p.dim] if p.dim else len(x)
            lo, hi = block_bounds(n, self.mesh.size(i),
                                  self.mesh.get_local_rank(i))
            x = (x[(slice(None),) * p.dim + (slice(lo, hi),)] if p.dim
                 else x[lo:hi])
        return x


def data_sharding(mesh: DeviceMesh, ndim: int, axis: int = 0,
                  mesh_axis: str = "data") -> Sharding:
    """Shard array dim ``axis`` over ``mesh_axis``, replicate the rest."""
    if not 0 <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim} dims")
    names = mesh.mesh_dim_names
    return Sharding(mesh, tuple(Shard(axis) if n == mesh_axis
                                else Replicate() for n in names))


def replicated(mesh: DeviceMesh, ndim: int = 0) -> Sharding:
    """Every rank holds the whole array."""
    return Sharding(mesh, tuple(Replicate() for _ in mesh.mesh_dim_names))
