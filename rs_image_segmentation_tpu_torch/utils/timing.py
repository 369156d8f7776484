"""Device timing on a CUDA card."""

from __future__ import annotations

from typing import Callable

import torch


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
