"""Tracing and timing: per-stage wall clocks, a ``torch.profiler`` trace,
device timing on a CUDA card, and the program's own spans.

Counterpart of ``rs_image_segmentation_tpu.utils.timing``.
``StageTimer.stage(name, sync=...)`` waits for the CUDA devices of the
tensors in ``sync`` (the JAX ``block_until_ready``) before it reads the
clock; ``device_trace`` writes a chrome trace that ``utils.traceview``
reads.

``span(name, **counts)`` marks a phase of the program at a layer
boundary. It records only while a ``torch.profiler`` session records in
the calling thread (``torch.autograd._profiler_enabled()``); otherwise the
body runs after that one check. A recorded span opens
``record_function("rsseg.<name>")``, so it lands in the profiler's trace
on the kernels' clock, and keeps a :class:`SpanRecord` in memory: its id,
the enclosing span of its thread, the id of the outermost one (shared by
every span of one call), the thread, ``perf_counter`` start and end, and
integer ``counts`` such as ``bytes``. :func:`spans` returns the records of
the newest profiled session: the first span recorded after any span ran
unrecorded starts a new session and drops the old records.
:func:`self_time` is a span's duration less what its children cover.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._pytree import tree_leaves

from .traceview import _merge


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


# ------------------------------------------------------------------ spans

@dataclasses.dataclass
class SpanRecord:
    """One recorded span (times are ``time.perf_counter`` seconds; ``end``
    is None while the span is open)."""
    name: str
    id: int
    parent: Optional[int]       # the enclosing span of the same thread
    root: int                   # the outermost enclosing span (or its own id)
    thread: int
    counts: Dict[str, int]
    start: float = 0.0
    end: Optional[float] = None

    @property
    def duration(self) -> float:
        return self.end - self.start


class _Registry:
    """The records of the newest profiled session, shared by every thread
    of the process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: List[SpanRecord] = []
        self.ids = itertools.count(1)
        self.stale = True       # the next recorded span starts a session
        self.local = threading.local()

    def open(self, name: str, counts: Dict[str, int]) -> SpanRecord:
        stack = self.local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        with self.lock:
            if self.stale:
                self.records = []
                self.stale = False
            sid = next(self.ids)
            rec = SpanRecord(name, sid, parent.id if parent else None,
                             parent.root if parent else sid,
                             threading.get_ident(), counts)
            self.records.append(rec)
        stack.append(rec)
        return rec


_REGISTRY = _Registry()
_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "counts", "rec", "mark")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self) -> SpanRecord:
        self.rec = _REGISTRY.open(self.name, self.counts)
        self.mark = torch.profiler.record_function("rsseg." + self.name)
        self.mark.__enter__()
        self.rec.start = time.perf_counter()
        return self.rec

    def __exit__(self, *exc) -> None:
        self.rec.end = time.perf_counter()
        self.mark.__exit__(*exc)
        _REGISTRY.local.stack.pop()


def span(name: str, **counts: int):
    """Context manager marking the phase ``name`` (module docstring); it
    gives the :class:`SpanRecord` when recording, else None, so a count
    known only inside the body can be set on ``record.counts``."""
    if not _profiling():
        _REGISTRY.stale = True
        return _OFF
    return _Span(name, counts)


def spans() -> List[SpanRecord]:
    """The closed spans of the newest profiled session, in opening order."""
    with _REGISTRY.lock:
        return [r for r in _REGISTRY.records if r.end is not None]


def self_time(rec: SpanRecord, records: List[SpanRecord]) -> float:
    """Seconds of ``rec`` that none of its children in ``records`` cover."""
    kids = [(max(r.start, rec.start), min(r.end, rec.end)) for r in records
            if r.parent == rec.id and r.end is not None]
    return rec.duration - sum(b - a for a, b in _merge(kids) if b > a)
