"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. Everything the cell needs is found by the
names in ``BENCHMARK.json`` (``harness/manifest.py``). The run:

1. refuses without the CUDA cards the cell asks for (exit 3, no result);
2. pins the host's thread pools to ``HOST_THREADS``, imports the port,
   builds its kernels (``ops/_build.build``) and the
   native codec, then the cell's traffic loop makes the inputs from the seed,
   fits the forest, and warms every shape the traffic uses: set-up, whose
   parts it prints;
3. drives the traffic for ``--seconds`` (with ``--trace 1`` a fixed span of
   it under the profiler), sampling its own CPU use and the card's clocks
   beside it (``harness/hostload.py``, printed with the notes);
4. reads the peak device memory, frees the program's state and compares
   the answers with the configuration's plain reference
   (``harness/check.py``);
5. checks that no module of JAX or the JAX package is loaded (exit 4, no
   result), prints the numbers compared beside their limits as its last
   lines on standard error, and prints the result as the last line of
   standard output: the cell's end-to-end metrics (``--trace 0``) or its
   per-layer metrics (``--trace 1``).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import manifest, nojax  # noqa: E402

# The window's host work is single-threaded numpy and the launches of one
# thread; idle pool threads only compete with it for the machine's cores.
HOST_THREADS = 1


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="override a traffic key (rate sweeps, tests)")
    return p.parse_args(argv)


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its kernels into its own ``_build/``."""
    cache = ROOT / ".perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _pin_threads() -> None:
    """Every host thread pool to ``HOST_THREADS``, before numpy or torch
    is imported (the load generator child inherits it)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"


def _need_cards(n: int):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {n} CUDA card(s), found {have}",
              file=sys.stderr)
        sys.exit(3)
    return torch.device("cuda", 0)


def run(argv=None, device=None, emit=print) -> dict:
    """One run; returns the result dict it printed. ``device`` (tests only)
    skips the look for a card and runs on that device."""
    args = _parse(argv)
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    for kv in args.set:
        k, v = kv.split("=", 1)
        traffic[k] = json.loads(v)
    _cache_dirs()
    if device is None:
        _pin_threads()
    parts = {}
    t = time.perf_counter()
    import torch
    if device is None:
        torch.set_num_threads(HOST_THREADS)
    dev = device if device is not None else _need_cards(cell["chips"])
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        emit(f"perfbench: card {torch.cuda.get_device_name(0)}; "
             f"power limit {_power_limit()}", file=sys.stderr)
    from perfbench.harness import check, roofline, setup  # noqa: F401
    from perfbench.harness.hostload import HostLoad
    from perfbench.harness.trace import Tracer
    import rs_image_segmentation_tpu_torch  # noqa: F401
    parts["imports_cuda_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        from rs_image_segmentation_tpu_torch.ops import _build
        report = _build.build()
        parts["nvcc_build_s"] = max((r["seconds"] for r in report.values()),
                                    default=0.0)
    from rs_image_segmentation_tpu_torch.io import native
    native.available()
    parts["builds_s"] = time.perf_counter() - t

    drv = manifest.loop(traffic["loop"])
    tracer = Tracer(bool(args.trace), args.seconds)
    ctx = setup.Context(cell=cell, cfg=cfg, traffic=traffic, seed=args.seed,
                        seconds=args.seconds, dev=dev, tracer=tracer,
                        parts=parts)
    st = {}
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        st = drv.setup(ctx)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak_setup = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_PROCESS
        host = HostLoad(card=dev.type == "cuda")
        host.start()
        try:
            rec = drv.window(ctx, st)
        finally:
            host.stop()
        ctx.notes["host"] = host.summary()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak_window = torch.cuda.max_memory_allocated()
        else:
            peak_setup = peak_window = 0
        answers, inputs, missing = drv.answers(ctx, st)
    finally:
        if hasattr(drv, "teardown"):
            drv.teardown(ctx, st)
    st.pop("program", None)     # freed before the reference runs
    fields, depth = st.get("fields"), st.get("depth", 0)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    result_check = check.compare(ctx, answers, inputs, missing, fields, depth)
    ctx.notes["reference_s"] = time.perf_counter() - t
    del answers

    rec.update(spans=dict(tracer.totals), trace=tracer.result,
               peak_window_bytes=peak_window,
               work=drv.work(ctx, st, result_check["ops_per_pixel"]))
    metrics = {}
    if args.trace:
        for m in manifest.per_layer(bench, cell["name"]):
            v = manifest.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in manifest.end_to_end(bench, cell["name"]):
            v = (setup_s if m["name"] == "setup_s"
                 else rec["end_to_end"].get(m["name"]))
            if v is None:
                raise SystemExit(f"the traffic loop gave no {m['name']}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_key = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(0)
                           if dev.type == "cuda" else dev.type),
                  "count": cell["chips"],
                  "memory_peak_bytes": int(max(peak_setup, peak_window))}
    out = {"correct": bool(result_check["correct"]),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": device_key}
    if args.trace and rec["trace"]:
        device_key["busy_s"] = rec["trace"]["busy_s"]
        device_key["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = result_check["numbers"]

    emit("perfbench: setup_parts_s " + json.dumps(
        {**{k: round(v, 4) for k, v in parts.items()},
         "setup_s": round(setup_s, 4)}), file=sys.stderr)
    emit("perfbench: notes " + json.dumps(
        {**ctx.notes, "units": rec["units"], "window_s": rec["window_s"],
         "answers_compared": result_check["compared"],
         "ops_per_pixel": result_check["ops_per_pixel"]},
        default=float), file=sys.stderr)
    bad = nojax.forbidden_loaded()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        sys.exit(4)
    for name, v in result_check["numbers"].items():
        emit(f"perfbench: check {name} {v['value']!r} limit {v['limit']!r}",
             file=sys.stderr)
    emit(json.dumps(out))
    return out


def main() -> int:
    run()
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
