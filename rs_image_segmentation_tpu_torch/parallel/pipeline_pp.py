"""Stage pipelining (PP): features on one device, classifier on another,
with scenes streaming through both.

Counterpart of ``rs_image_segmentation_tpu.parallel.pipeline_pp``. The two
compute stages of the scene pipeline are placed apart:

    devices[0] : stage-2 feature stack of scene i + 1
                 (``hierarchical_stack_fused``)
    devices[1] : stage-3 forest labels of scene i (``forest_labels``),
                 after the stack's hop from devices[0]

Each CUDA entry gets its own stream, so the two stages can overlap as
JAX's asynchronous dispatch over two devices overlaps them; ``[cuda:0,
cuda:0]`` puts them on two streams of one card. Each scene lands from a
pinned stage on a side stream (``io.stream.HostToDevice``), and each
forest waits on its own stack's event only. A stack made on the first
stream and read on the second is recorded on the second
(``Tensor.record_stream``), so the caching allocator does not hand its
memory back out before the forest has read it. The host drains once, at
the end.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..backend import as_tensor, resolve_device
from ..core.config import FeatureStageConfig
from ..io.stream import HostToDevice
from ..models.forest import GemmForest
from ..ops.kernels import forest_labels
from ..pipeline.features import hierarchical_stack_fused


def _default_devices() -> List[torch.device]:
    """The first two CUDA devices, or the one card twice; raises without
    CUDA (``backend.resolve_device``)."""
    dev = resolve_device(None)
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    return [dev, dev]


def _stream_of(dev: torch.device):
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def pp_classify_scenes(scenes: Sequence[np.ndarray], gf: GemmForest,
                       cfg: FeatureStageConfig = FeatureStageConfig(),
                       devices: Optional[Sequence] = None
                       ) -> List[np.ndarray]:
    """Classify (7, H, W) scenes with stage 2 on ``devices[0]`` and stage 3
    on ``devices[1]`` (default: the first two CUDA devices, or ``cuda:0``
    twice). Returns the per-scene (H, W) label maps (host)."""
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else _default_devices())
    if len(devices) < 2:
        raise ValueError("stage pipelining needs >= 2 devices")
    dev_a, dev_b = devices[0], devices[1]
    streams = [_stream_of(dev_a), _stream_of(dev_b)]
    gf_b = GemmForest(*(as_tensor(t, dev_b) for t in gf))
    for s, dev in zip(streams, (dev_a, dev_b)):
        if s is not None:       # the forest's copy, on the default stream
            s.wait_stream(torch.cuda.current_stream(dev))
    up = HostToDevice(dev_a)
    preds = []

    def event_on(stream):
        if stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def stage3(stack, ready):
        with _on(streams[1]):
            if streams[1] is not None:
                if ready is not None:
                    streams[1].wait_event(ready)
                stack.record_stream(streams[1])
            x_cm = stack.permute(2, 0, 1).reshape(stack.shape[-1], -1
                                                  ).contiguous()
            preds.append(forest_labels(gf_b, x_cm).reshape(stack.shape[:2]))

    pending = None      # the last stack and its event, its forest to come
    for arr in scenes:
        if pending is not None:
            stage3(*pending)
        with _on(streams[0]):
            bands = up.put(np.asarray(arr, np.float32))
            # the A -> B hop is enqueued on A, after the stack
            stack = hierarchical_stack_fused(bands, cfg, device=dev_a
                                             ).to(dev_b)
            pending = (stack, event_on(streams[0]))
    if pending is not None:
        stage3(*pending)
    for s in streams:           # the one drain
        if s is not None:
            s.synchronize()
    return [p.cpu().numpy() for p in preds]
