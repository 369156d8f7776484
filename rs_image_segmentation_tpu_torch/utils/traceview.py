"""Device-timeline extraction from ``torch.profiler`` chrome traces.

Counterpart of ``rs_image_segmentation_tpu.utils.traceview``, over the
traces that ``utils.timing.device_trace`` writes
(``<dir>/trace_<ns>.pt.trace.json.gz``; a plain ``*.pt.trace.json``, as
``torch.profiler.tensorboard_trace_handler`` writes it, is read too).
It pulls out per-lane EXECUTION intervals so scheduling properties (which
kernels ran, whether lanes overlapped) can be asserted from recorded
timelines instead of wall clocks.

Lanes:

* CUDA — each kernel event (``"cat": "kernel"``) on the lane of its
  device and stream, ``cuda:<device>:stream <stream>``.
* CPU — each operator event (``"cat": "cpu_op"``) on the lane of its
  thread, ``cpu-exec:<tid>``, the counterpart of the JAX package's CPU
  executor lanes. Operators nest; :func:`total_cross_lane_overlap_us`
  merges a lane's own intervals before it counts.

The overlap arithmetic (:func:`count_cross_lane_overlaps`,
:func:`total_cross_lane_overlap_us`) is the JAX package's, pure Python.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Dict, List, Tuple

Interval = Tuple[float, float]
Event = Tuple[float, float, str]

_PATTERNS = ("*.pt.trace.json.gz", "*.pt.trace.json")


def latest_trace_file(trace_dir: str) -> str:
    """The newest trace under ``trace_dir`` (by modification time, then
    name)."""
    files = [f for pat in _PATTERNS for f in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json(.gz) under {trace_dir}")
    return max(files, key=lambda f: (os.path.getmtime(f), f))


def device_exec_events(trace_dir: str) -> Dict[str, List[Event]]:
    """Per-lane ``(start, end, name)`` execution events, microseconds,
    keyed by lane name (module docstring), from the newest trace in
    ``trace_dir``."""
    path = latest_trace_file(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    lanes: Dict[str, List[Event]] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat == "kernel":
            args = e.get("args", {})
            lane = (f"cuda:{args.get('device', e.get('pid'))}:stream "
                    f"{args.get('stream', e.get('tid'))}")
        elif cat == "cpu_op":
            lane = f"cpu-exec:{e.get('tid')}"
        else:
            continue
        ts = float(e["ts"])
        lanes[lane].append((ts, ts + float(e["dur"]), e.get("name", "")))
    return dict(lanes)


def device_exec_intervals(trace_dir: str) -> Dict[str, List[Interval]]:
    """Per-lane execution intervals (microsecond (start, end)), keyed by
    lane name, from the newest trace in ``trace_dir``."""
    return {lane: [(a, b) for a, b, _ in evs]
            for lane, evs in device_exec_events(trace_dir).items()}


def count_cross_lane_overlaps(lanes: Dict[str, List[Interval]]) -> int:
    """Number of (interval, interval) pairs from DIFFERENT lanes whose
    wall-clock spans intersect — the timeline evidence that two lanes
    were executing concurrently. 0 for a fully serialized schedule."""
    keys = sorted(lanes)
    n = 0
    for i, ka in enumerate(keys):
        for kb in keys[i + 1:]:
            for a0, a1 in lanes[ka]:
                for b0, b1 in lanes[kb]:
                    if min(a1, b1) - max(a0, b0) > 0:
                        n += 1
    return n


def total_cross_lane_overlap_us(lanes: Dict[str, List[Interval]]) -> float:
    """Total microseconds during which >= 2 lanes were executing
    simultaneously (union-of-lanes sweep, so long overlapping events are
    not double-counted). ~0 for a serialized schedule up to stray sliver
    events; a pipelined schedule accumulates real concurrent time."""
    marks = []
    for ivs in lanes.values():
        # merge a lane's own intervals first (self-overlap is not
        # cross-lane concurrency)
        for a0, a1 in _merge(ivs):
            marks.append((a0, 1))
            marks.append((a1, -1))
    marks.sort()
    depth = 0
    overlap = 0.0
    prev = None
    for t, d in marks:
        if prev is not None and depth >= 2:
            overlap += t - prev
        depth += d
        prev = t
    return overlap


def _merge(ivs: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a0, a1 in sorted(ivs):
        if out and a0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], a1))
        else:
            out.append((a0, a1))
    return out
