"""Tracing and timing: per-stage wall clocks, a ``torch.profiler`` trace,
and device timing on a CUDA card.

Counterpart of ``rs_image_segmentation_tpu.utils.timing``.
``StageTimer.stage(name, sync=...)`` waits for the CUDA devices of the
tensors in ``sync`` (the JAX ``block_until_ready``) before it reads the
clock; ``device_trace`` writes a chrome trace that ``utils.traceview``
reads.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_leaves


class StageTimer:
    """Wall-clock timings with device synchronization per stage."""

    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the block; ``sync`` is any tree of tensors (dicts, lists,
        tuples), whose CUDA devices are synchronised before the clock is
        read. CPU tensors need no wait."""
        t0 = time.perf_counter()
        yield
        for dev in {t.device for t in tree_leaves(sync)
                    if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(dev)
        self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.timings.values())
        lines = [f"{k:<28}{v * 1000:>10.1f} ms" for k, v in self.timings.items()]
        lines.append(f"{'total':<28}{total * 1000:>10.1f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block, CPU ops and CUDA kernels,
    written as a gzipped chrome trace ``<log_dir>/trace_<ns>.pt.trace.json.gz``
    (``utils.traceview`` reads it); no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.time_ns()}.pt.trace.json.gz"))


def cuda_time_ms(fn: Callable[[], object], reps: int, warmup: int = 2
                 ) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls on the current stream, timed with CUDA events after ``warmup``
    calls. Raises without a CUDA device: a CPU time is never reported
    under this name."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
