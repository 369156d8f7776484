"""Where a turbo path's device time goes, by ``torch.profiler``.

Runs ``classify_scenes_turbo`` (or, with ``--path rule``,
``rule_based_scenes_turbo_batch``; with ``--path kmeans``,
``kmeans_scenes_turbo_batch`` with per-scene fits, k = 7, fit stride 8) on
the ``chip_smoke.py`` inputs (8
synthetic scenes of 7 x 600 x 600 from seed 0, a 100-tree forest for the
supervised path) on one CUDA card, profiles one run after a warm-up, and
prints the card, the top kernels and the top PyTorch ops by device time,
the device busy share of the run (the union of kernel, copy and fill
intervals on every stream over the run's span in the exported trace, so
two streams at once count once), the program's spans
(``utils.timing.span``) with their self times, then one JSON line.

    python -m rs_image_segmentation_tpu_torch.tools.profile_turbo \
        [--path rule|kmeans]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from ..utils.timing import self_time, spans
from ..utils.traceview import _merge

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUN_MARK = "profile_turbo.run"


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise RuntimeError("this torch.profiler reports no device time")


def _total_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise RuntimeError("this torch.profiler reports no device time")


BATCH, SIZE, SEED, TOP = 8, 600, 0, 15


def busy_share(events: list, lo: float, hi: float) -> float:
    """Share of ``[lo, hi]`` (trace microseconds) in which the device ran
    anything: the union of the chrome trace ``events``' kernel, copy and
    fill intervals on every stream, clipped to the span."""
    ivs = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if min(b, hi) > max(a, lo):
            ivs.append((max(a, lo), min(b, hi)))
    return sum(b - a for a, b in _merge(ivs)) / (hi - lo)


def _run_span(events: list):
    """``(start, end)`` of the ``RUN_MARK`` annotation, microseconds."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == RUN_MARK:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise RuntimeError(f"the trace has no {RUN_MARK} span")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("supervised", "rule", "kmeans"),
                        default="supervised")
    path = parser.parse_args(argv).path
    if not torch.cuda.is_available():
        print("profile_turbo: no CUDA device", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from ..backend import resolve_device
    from ..core.config import FeatureStageConfig
    from ..models.forest import GemmForest
    from ..pipeline.turbo import (classify_scenes_turbo,
                                  hierarchical_stack_turbo_cm,
                                  kmeans_scenes_turbo_batch,
                                  rule_based_scenes_turbo_batch)
    from .fixtures import rule_forest, stretch_stats_batch, synthetic_scenes

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = resolve_device(None)
    cfg = FeatureStageConfig()
    scenes = synthetic_scenes(BATCH, SIZE, SIZE, SEED)
    luts, _, hists = stretch_stats_batch(scenes)
    scenes_d, luts_d, hists_d = (torch.from_numpy(a).to(dev)
                                 for a in (scenes, luts, hists))
    if path == "rule":
        def run():
            return rule_based_scenes_turbo_batch(
                scenes_d, luts_d, cfg, stretch_hists=hists_d, device=dev)
    elif path == "kmeans":
        def run():
            return kmeans_scenes_turbo_batch(
                scenes_d, luts_d, 7, cfg, fit_stride=8,
                stretch_hists=hists_d, device=dev)
    else:
        stack0 = hierarchical_stack_turbo_cm(scenes_d[0], luts_d[0], cfg,
                                             device=dev).cpu().numpy()
        gf_cpu = rule_forest(stack0)[0]
        gf = GemmForest(*(t.to(dev) for t in gf_cpu))

        def run():
            return classify_scenes_turbo(scenes_d, luts_d, gf, cfg,
                                         stretch_hists=hists_d, device=dev)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(RUN_MARK):
            run()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    program = spans()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            trace_events = json.load(f)["traceEvents"]
    share = busy_share(trace_events, *_run_span(trace_events))
    events = prof.key_averages()
    # the device side of each annotation is listed too; it is no kernel
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not (e.key.startswith("rsseg.") or e.key == RUN_MARK)]
    busy_us = sum(_device_us(e) for e in kern)
    aten_ops = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::") and _total_us(e) > 0]
    if busy_us <= 0:
        raise RuntimeError("the profile holds no device time")

    print(f"card: {smi}; path: {path}")
    print(f"one run: wall {wall_us / 1e3:.3f} ms, kernels {busy_us / 1e3:.3f} "
          f"ms, busy share {share:.3f}, "
          f"{len(kern)} distinct kernels, "
          f"{sum(e.count for e in kern)} launches")
    print("program spans (ms, self ms, counts):")
    depth = {}
    for r in program:
        depth[r.id] = depth.get(r.parent, -1) + 1
        print(f"  {'  ' * depth[r.id]}{r.name:<20} {r.duration * 1e3:9.3f} "
              f"{self_time(r, program) * 1e3:9.3f}  {r.counts or ''}")
    print("top kernels by device time (ms, launches):")
    for e in sorted(kern, key=_device_us, reverse=True)[:TOP]:
        print(f"  {_device_us(e) / 1e3:9.3f} {e.count:5d}  {e.key[:100]}")
    print("top PyTorch ops by device time incl. children (ms, calls):")
    for e in sorted(aten_ops, key=_total_us, reverse=True)[:TOP]:
        print(f"  {_total_us(e) / 1e3:9.3f} {e.count:5d}  {e.key}")
    print(json.dumps({
        "card": smi, "path": path, "wall_ms": wall_us / 1e3, "kernel_ms": busy_us / 1e3,
        "busy_share": share,
        "spans": [[r.name, r.duration * 1e3, self_time(r, program) * 1e3]
                  for r in program],
        "launches": sum(e.count for e in kern),
        "top_kernels": [[e.key[:100], _device_us(e) / 1e3, e.count]
                        for e in sorted(kern, key=_device_us,
                                        reverse=True)[:TOP]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
