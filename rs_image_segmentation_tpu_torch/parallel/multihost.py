"""Multi-process execution over ``torch.distributed``.

Counterpart of ``rs_image_segmentation_tpu.parallel.multihost``. The JAX
package forms one global mesh over every process's devices through the
jax distributed runtime; in PyTorch a rank is one device, so the world is
one rank a device (a process a rank) and the ``data`` mesh axis spans the
world:

* :func:`init_multihost` — process bootstrap, through
  ``dist.init_process_group`` with an explicit backend (NCCL on the card,
  one rank a card; gloo on the CPU or for several ranks on one card) and
  an explicit address (``tcp://``, ``file://``; ``env://`` with no
  arguments, as a launcher such as ``torchrun`` sets it).
* :func:`global_mesh` — a mesh over every rank.
* :func:`shard_local_batch` / :func:`local_shards` — a rank's own scenes
  on its device, and back on the host. Each rank's block of the global
  batch IS its local batch; the global batch is the concatenation over
  ranks.
* :func:`classify_batch_multihost` — the turbo classifier over a global
  scene batch; every rank feeds its local scenes and reads back exactly
  its own class maps.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import DeviceLike, as_tensor
from ..pipeline.turbo import classify_scenes_turbo
from .collectives import all_gather
from .mesh import TIMEOUT_S, init_group, make_mesh, mesh_device


def free_local_port() -> int:
    """An ephemeral 127.0.0.1 port for a rehearsal's TCP rendezvous.

    Inherently racy (the port is released before the group binds it):
    fine for a local rehearsal, where a collision fails the run visibly;
    concurrent runs on one host rendezvous through a ``file://`` store
    instead."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device: DeviceLike = None,
                   timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the default process group as rank ``process_id`` of
    ``num_processes``; returns this rank's device (``device``'s kind,
    CUDA unless named; card ``rank % cards``).

    ``coordinator_address``: ``host:port`` (a TCP rendezvous, rank 0
    binds it), or an init method URL (``tcp://``, ``file://``). With no
    arguments, ``env://``. ``backend``: ``nccl`` or ``gloo`` (default:
    NCCL on CUDA, gloo on the CPU); NCCL with more ranks than cards
    raises (``parallel.mesh.check_backend``)."""
    if coordinator_address is None:
        coordinator_address = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) \
            if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) \
            if process_id is None else process_id
    elif "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    return init_group(backend, device, num_processes, process_id,
                      coordinator_address, timeout_s=timeout_s)


def global_mesh(axis_names: Tuple[str, ...] = ("data",),
                shape: Optional[Tuple[int, ...]] = None,
                device: DeviceLike = None):
    """Mesh over every rank (row-major rank order). With the default shape
    the first axis spans the world and the others have size 1."""
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    return make_mesh(shape, axis_names, device)


def shard_local_batch(local_arrays, mesh, axis: str = "data"
                      ) -> torch.Tensor:
    """This rank's ``(B_local, ...)`` batch as its block of the global
    batch (the concatenation over ranks, in rank order along ``axis``): a
    tensor on the rank's device."""
    return as_tensor(local_arrays, mesh_device(mesh))


def local_shards(local_block: torch.Tensor) -> np.ndarray:
    """This rank's rows of a batch-sharded result, on the host (the
    inverse of :func:`shard_local_batch`)."""
    return local_block.cpu().numpy()


def classify_batch_multihost(scenes_local: np.ndarray,
                             luts_local: np.ndarray,
                             gf, cfg, mesh,
                             pad_to: Optional[int] = None) -> np.ndarray:
    """Turbo-classify a multi-process scene batch.

    Every rank passes its local ``(B_local, 7, H, W)`` uint8 scenes and
    ``(B_local, 7, 256)`` stretch LUTs; the global batch (their
    concatenation) shards over the mesh's ``data`` axis, a rank's block
    being its own scenes, the forest rides replicated, and each rank gets
    its own ``(B_local, H, W)`` class maps back. The global batch must
    divide the ``data`` axis, in equal blocks. The maps equal
    ``pipeline.turbo.classify_scenes_turbo``'s of the same scenes (the
    program runs on the rank's block, with no collective).

    UNEVEN local batches: ranks agree on ``pad_to`` (the largest local
    count); lighter ranks pad up by repeating their last scene and receive
    only their true scenes' maps back. Padding is exact: each scene's
    statistics are its own, so its map does not depend on the rest of the
    batch."""
    b_local = len(scenes_local)
    if pad_to is not None:
        if b_local > pad_to or b_local < 1:
            raise ValueError(f"local batch {b_local} must be in "
                             f"[1, pad_to={pad_to}]")
        reps = pad_to - b_local
        scenes_local = np.concatenate([scenes_local]
                                      + [scenes_local[-1:]] * reps)
        luts_local = np.concatenate([luts_local] + [luts_local[-1:]] * reps)
    scenes = shard_local_batch(scenes_local, mesh)
    luts = shard_local_batch(luts_local, mesh)
    sizes = all_gather(torch.tensor([len(scenes)], device=scenes.device),
                       mesh.get_group("data"))[:, 0].tolist()
    n_data = len(sizes)
    if sum(sizes) % n_data:
        raise ValueError(
            f"global batch {sum(sizes)} does not divide the 'data' axis "
            f"({n_data} ranks); pad the per-rank batches")
    if len(set(sizes)) != 1:
        raise ValueError(f"local batches {sizes} differ across ranks; "
                         f"pass pad_to")
    maps = classify_scenes_turbo(scenes, luts, gf, cfg,
                                 device=mesh_device(mesh))
    return local_shards(maps)[:b_local]
