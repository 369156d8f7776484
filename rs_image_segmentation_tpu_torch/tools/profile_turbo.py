"""Where a turbo path's device time goes, by ``torch.profiler``.

Runs ``classify_scenes_turbo`` (or, with ``--path rule``,
``rule_based_scenes_turbo_batch``; with ``--path kmeans``,
``kmeans_scenes_turbo_batch`` with per-scene fits, k = 7, fit stride 8) on
the ``chip_smoke.py`` inputs (8
synthetic scenes of 7 x 600 x 600 from seed 0, a 100-tree forest for the
supervised path) on one CUDA card, profiles one run after a warm-up, and
prints the card, the top kernels and the top PyTorch ops by device time,
the device busy share of the run (kernel time over wall time), then one
JSON line.

    python -m rs_image_segmentation_tpu_torch.tools.profile_turbo \
        [--path rule|kmeans]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


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
    scenes_d, luts_d, params_d, hists_d = (
        torch.from_numpy(a).to(dev)
        for a in (scenes, *stretch_stats_batch(scenes)))
    if path == "rule":
        def run():
            return rule_based_scenes_turbo_batch(
                scenes_d, luts_d, cfg, stretch_params=params_d,
                stretch_hists=hists_d, device=dev)
    elif path == "kmeans":
        def run():
            return kmeans_scenes_turbo_batch(
                scenes_d, luts_d, 7, cfg, fit_stride=8,
                stretch_params=params_d, stretch_hists=hists_d, device=dev)
    else:
        stack0 = hierarchical_stack_turbo_cm(scenes_d[0], luts_d[0], cfg,
                                             device=dev).cpu().numpy()
        gf_cpu = rule_forest(stack0)[0]
        gf = GemmForest(*(t.to(dev) for t in gf_cpu))

        def run():
            return classify_scenes_turbo(scenes_d, luts_d, gf, cfg,
                                         stretch_params=params_d,
                                         stretch_hists=hists_d, device=dev)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kern)
    aten_ops = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::") and _total_us(e) > 0]
    if busy_us <= 0:
        raise RuntimeError("the profile holds no device time")

    print(f"card: {smi}; path: {path}")
    print(f"one run: wall {wall_us / 1e3:.3f} ms, kernels {busy_us / 1e3:.3f} "
          f"ms, busy share {busy_us / wall_us:.3f}, "
          f"{len(kern)} distinct kernels, "
          f"{sum(e.count for e in kern)} launches")
    print("top kernels by device time (ms, launches):")
    for e in sorted(kern, key=_device_us, reverse=True)[:TOP]:
        print(f"  {_device_us(e) / 1e3:9.3f} {e.count:5d}  {e.key[:100]}")
    print("top PyTorch ops by device time incl. children (ms, calls):")
    for e in sorted(aten_ops, key=_total_us, reverse=True)[:TOP]:
        print(f"  {_total_us(e) / 1e3:9.3f} {e.count:5d}  {e.key}")
    print(json.dumps({
        "card": smi, "path": path, "wall_ms": wall_us / 1e3, "kernel_ms": busy_us / 1e3,
        "busy_share": busy_us / wall_us,
        "launches": sum(e.count for e in kern),
        "top_kernels": [[e.key[:100], _device_us(e) / 1e3, e.count]
                        for e in sorted(kern, key=_device_us,
                                        reverse=True)[:TOP]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
