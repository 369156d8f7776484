"""Double-buffered host-to-device tile streaming.

Counterpart of ``rs_image_segmentation_tpu.io.stream``. For scenes larger
than device memory (or multi-scene batches), tiles are cut on the host and
shipped to the device while the previous tile computes. On a CUDA device
each tile goes through :class:`HostToDevice`: one host copy of the array,
strided or not, into a pinned staging buffer, an asynchronous copy on a
side stream, and an event that the compute stream waits on, so the copy of
tile i + 1 overlaps the kernels of tile i. On the CPU the same calls are a
plain loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """A tile of a (C, H, W) raster with its halo-inclusive read window."""
    y0: int
    x0: int
    height: int
    width: int
    halo: int

    @property
    def read_window(self) -> Tuple[int, int, int, int]:
        return (self.y0 - self.halo, self.x0 - self.halo,
                self.height + 2 * self.halo, self.width + 2 * self.halo)


def tile_grid(height: int, width: int, tile: int,
              halo: int = 0) -> List[TileSpec]:
    """Cover (height, width) with tiles of side <= ``tile``."""
    specs = []
    for y0 in range(0, height, tile):
        for x0 in range(0, width, tile):
            specs.append(TileSpec(y0, x0, min(tile, height - y0),
                                  min(tile, width - x0), halo))
    return specs


def read_tile(arr: np.ndarray, spec: TileSpec,
              pad_mode: str = "reflect") -> np.ndarray:
    """Slice a halo-padded tile out of a (C, H, W) array, reflect-padding
    where the halo crosses the image border."""
    c, h, w = arr.shape if arr.ndim == 3 else (1, *arr.shape)
    y, x, th, tw = spec.read_window
    ys, xs = max(y, 0), max(x, 0)
    ye, xe = min(y + th, h), min(x + tw, w)
    tile = arr[..., ys:ye, xs:xe]
    pads = [(0, 0)] * (arr.ndim - 2) + [(ys - y, (y + th) - ye),
                                        (xs - x, (x + tw) - xe)]
    if any(p != (0, 0) for p in pads):
        tile = np.pad(tile, pads, mode=pad_mode)
    return tile


class HostToDevice:
    """Copies numpy arrays to ``device`` ahead of the compute stream.

    On CUDA, each :meth:`put` copies the array once on the host, as its
    strides lie (a row chunk, a band stride, a flip), into one of
    ``depth`` pinned host buffers, taken in turn, and copies that on a
    side stream into a tensor allocated there; the caller's current stream
    waits on the copy's event, so work enqueued after ``put`` sees the
    data and the host never blocks on the copy. A staging buffer is
    refilled only after its previous copy's event has completed (the host
    waits on it then), and the returned tensor is recorded on the compute
    stream, so the allocator does not hand its memory back to the copy
    stream while kernels still read it. On the CPU, ``put`` wraps a
    C-contiguous array without a copy and copies any other once.
    ``host_copy_bytes`` counts the bytes the host has copied in ``put``."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = device
        self.depth = depth
        self._bufs: list = [None] * depth    # the staging buffers
        self._done: list = [None] * depth    # each one's last copy event
        self._turn = 0
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self.host_copy_bytes = 0

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        """Copy ``arr`` once into this turn's staging buffer (pinned on
        CUDA; grown when too small) and return the buffer's front as a
        contiguous tensor of ``arr``'s shape and dtype. The caller has
        waited on the buffer's last copy."""
        buf, n = self._bufs[self._turn], arr.nbytes
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.uint8,
                              pin_memory=self._stream is not None)
            self._bufs[self._turn] = buf
        dst = buf[:n].numpy().view(arr.dtype).reshape(arr.shape)
        np.copyto(dst, arr)
        self.host_copy_bytes += n
        return buf[:n].view(torch.from_numpy(dst).dtype).view(arr.shape)

    def put(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.asarray(arr)
        if self._stream is None:
            if not arr.flags.c_contiguous:
                self.host_copy_bytes += arr.nbytes
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if self._done[self._turn] is not None:
            self._done[self._turn].synchronize()   # its last copy landed
        staged = self._stage(arr)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = torch.empty(staged.shape, dtype=staged.dtype,
                              device=self.device)
            out.copy_(staged, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        compute.wait_event(done)
        out.record_stream(compute)
        self._done[self._turn] = done
        self._turn = (self._turn + 1) % self.depth
        return out


def stream_tiles(arr: np.ndarray, specs: Iterable[TileSpec],
                 fn: Callable, device: DeviceLike = None,
                 pad_mode: str = "reflect"
                 ) -> Iterator[Tuple[TileSpec, torch.Tensor]]:
    """Run ``fn`` over tiles with double buffering on ``device`` (CUDA
    unless named): the next tile's host-to-device copy is issued before
    the current tile's result is handed on."""
    specs = list(specs)
    if not specs:
        return
    up = HostToDevice(resolve_device(device))
    pending: Optional[Tuple[TileSpec, torch.Tensor]] = None
    next_buf = up.put(read_tile(arr, specs[0], pad_mode))
    for i, spec in enumerate(specs):
        out = fn(next_buf)                   # enqueued, not awaited
        if i + 1 < len(specs):
            next_buf = up.put(read_tile(arr, specs[i + 1], pad_mode))
        if pending is not None:
            yield pending
        pending = (spec, out)
    yield pending


def assemble_tiles(results: Iterable[Tuple[TileSpec, object]],
                   out_shape: Tuple[int, ...],
                   dtype=np.float32) -> np.ndarray:
    """Stitch (spec, tile_result) pairs (halo already cropped by fn or
    crop here if result still carries it) into a full host array."""
    out = np.zeros(out_shape, dtype)
    for spec, res in results:
        r = (res.cpu().numpy() if isinstance(res, torch.Tensor)
             else np.asarray(res))
        eh = r.shape[-2] - spec.height
        ew = r.shape[-1] - spec.width
        if eh or ew:  # crop centered halo
            r = r[..., eh // 2: eh // 2 + spec.height,
                  ew // 2: ew // 2 + spec.width]
        out[..., spec.y0:spec.y0 + spec.height,
            spec.x0:spec.x0 + spec.width] = r
    return out
