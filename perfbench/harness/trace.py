"""Spans around the benchmark's calls, and the device trace of a fixed
span of the window.

:class:`Tracer` keeps host-clock totals for every span name the loops
open (always; a ``perf_counter`` pair each), and with tracing on it runs
``torch.profiler`` from ``TRACE_START`` of the window for ``TRACE_SPAN_S``
seconds, marking each span with ``record_function("perfbench.<name>")``.
The trace is written under ``TMPDIR``, reduced, and deleted.

:func:`reduce_trace` turns a chrome trace into what the metrics read:
kernel time and launches by kernel name, the busy time of the device (the
union of every kernel, copy and fill interval on every stream, clipped to
the traced span: work on two streams at once counts once), and the
breakdown of device operations and idle gaps. The interval merge is a
frozen copy of ``rs_image_segmentation_tpu_torch/utils/traceview.py::
_merge`` at commit 3b8722c442acffa7c4dd38665a58daa3434fcab6.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import os
import re
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

TRACE_START = 1.0 / 3.0      # share of the window before the trace starts
TRACE_SPAN_S = 3.0           # seconds traced, at most half the window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACED = "perfbench.traced"

Interval = Tuple[float, float]


def merge(ivs: List[Interval]) -> List[Interval]:
    """Sorted, merged copy of ``ivs`` (touching intervals join)."""
    out: List[Interval] = []
    for a0, a1 in sorted(ivs):
        if out and a0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], a1))
        else:
            out.append((a0, a1))
    return out


def short_name(name: str) -> str:
    """A kernel's name without ``void ``, anonymous namespaces, template
    arguments and parameters: ``(anonymous namespace)::cc_tile<1,
    true>(...)`` -> ``cc_tile``."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                   "")
    return re.split(r"[<(]", name, 1)[0].strip() or name


def reduce_trace(events: list) -> dict:
    """What the metrics read from a chrome trace's events (times in
    seconds): ``window_s`` (the traced span), ``busy_s`` (kernels, copies
    and fills), ``kernels`` {short name: {"total_s", "count"}} (kernels
    only) and ``breakdown``."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    traced = [e for e in spans if e.get("name") == TRACED]
    if not traced:
        raise ValueError(f"the trace has no {TRACED} span")
    lo = float(traced[0]["ts"])
    hi = lo + float(traced[0]["dur"])
    dev: List[Tuple[float, float, str, str]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b > lo and a < hi:
            dev.append((max(a, lo), min(b, hi), e.get("name", ""), e["cat"]))
    by_cat: Dict[str, Dict[str, dict]] = {
        c: collections.defaultdict(lambda: {"total_s": 0.0, "count": 0})
        for c in DEVICE_CATS}
    for a, b, name, cat in dev:
        k = by_cat[cat][short_name(name)]
        k["total_s"] += (b - a) * 1e-6
        k["count"] += 1
    kernels = by_cat["kernel"]
    busy = merge([(a, b) for a, b, _, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # idle gaps, each named by the innermost benchmark span covering it
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in spans if e["name"] != TRACED)
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        label, width = "outside any span", None
        for a, b, name in marks:
            if a <= mid <= b and (width is None or b - a < width):
                label, width = name, b - a
        gaps[label] += (g1 - g0) * 1e-6
    ops = sorted(((n, v["total_s"]) for c in DEVICE_CATS
                  for n, v in by_cat[c].items()), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_s,
            "kernels": dict(kernels),
            "breakdown": {"device_ops": [list(x) for x in ops],
                          "idle_gaps": [list(x) for x in idle]}}


def read_chrome_trace(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


class Tracer:
    """Host-clock span totals, and with ``enabled`` the profiler over
    ``[TRACE_START * window, + min(TRACE_SPAN_S, window / 2)]``."""

    def __init__(self, enabled: bool, window_s: float):
        self.enabled = enabled
        self.start_at = TRACE_START * window_s
        self.span_s = min(TRACE_SPAN_S, 0.5 * window_s)
        self.totals: Dict[str, dict] = collections.defaultdict(
            lambda: {"total_s": 0.0, "count": 0})
        self._prof = None
        self._mark = None
        self._t0 = None
        self.state = "off"
        self.on_at = self.off_at = None   # host clock of its start and stop
        self.result: Optional[dict] = None

    def _profiler(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def warm(self, fn) -> None:
        """Profile one call of ``fn`` and drop the trace: the profiler's
        first start in a process is slow, and belongs to set-up."""
        if not self.enabled:
            return
        with self._profiler():
            fn()

    def begin(self, t0: float) -> None:
        self._t0 = t0
        self.totals.clear()

    def tick(self, now: float) -> None:
        """Start or stop the profiler when the window reaches its span."""
        if not self.enabled or self._t0 is None:
            return
        el = now - self._t0
        if self.state == "off" and el >= self.start_at:
            import torch
            self._prof = self._profiler()
            self._prof.__enter__()
            self._mark = torch.profiler.record_function(TRACED)
            self._mark.__enter__()
            self.state = "on"
            self.on_at = now
        elif self.state == "on" and el >= self.start_at + self.span_s:
            self.stop()

    def stop(self) -> None:
        if self.state != "on":
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.off_at = time.perf_counter()
        self.state = "done"

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the body on the host clock under ``name`` (and mark it in
        the trace while the profiler runs)."""
        mark = None
        if self.state == "on":
            import torch
            mark = torch.profiler.record_function(f"perfbench.{name}")
            mark.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            tot = self.totals[name]
            tot["total_s"] += time.perf_counter() - t
            tot["count"] += 1
            if mark is not None:
                mark.__exit__(None, None, None)

    def finish(self) -> Optional[dict]:
        """Stop the profiler if it runs, reduce its trace (written under
        ``TMPDIR`` and removed) and return the reduction."""
        self.stop()
        if self._prof is None:
            return None
        tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            self.result = reduce_trace(read_chrome_trace(path))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._prof = None
        return self.result
