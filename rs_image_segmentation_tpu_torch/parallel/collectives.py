"""The port's counterparts of the ``lax`` collectives, over a process
group: ``ppermute`` on a ring, ``all_gather``, ``psum`` and ``pmax``.

Every rank of the group calls each of them, in the same order, with
tensors of the same shape and dtype (as every device of a ``shard_map``
does). They run on the tensors' device: NCCL moves CUDA tensors card to
card, and gloo takes CUDA tensors for its all-reduce and all-gather
(checked on an H100). gloo's point-to-point ``send``/``recv`` take host
tensors only, so under gloo :func:`ppermute_ring` stages a CUDA tensor
through the host, and only there; ``ppermute_ring.staged_bytes`` counts
the bytes that staging copies (out and back). That moves bytes, not work:
every computation stays on the device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_index(group) -> int:
    """This rank's index on ``group`` (``lax.axis_index``)."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def ppermute_ring(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` on the ring of ``group``: rank ``r`` sends ``x`` to
    rank ``r + shift`` and returns what rank ``r - shift`` sent (indices
    mod the group size). On a ring of one rank, a copy of ``x`` (the JAX
    ``ppermute`` to self)."""
    n, r = axis_size(group), axis_index(group)
    if shift % n == 0:
        return x.clone()
    send = x.contiguous()
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        send = send.cpu()
        ppermute_ring.staged_bytes += 2 * send.numel() * send.element_size()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv


ppermute_ring.staged_bytes = 0


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``x``, stacked in rank order ->
    (group size, *x.shape)."""
    out = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum of every rank's ``x``, the same on each."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over every rank's ``x``."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
