"""Serving clients: an open loop of Poisson arrivals against the HTTP server
over the batching engine.

Set-up starts ``serving.server.make_server`` on ``127.0.0.1:0`` over an
``InferenceEngine`` with the traffic's ``EngineConfig`` keys (defaults
otherwise), warms the engine for the tile shape in every bucket, and
starts the load generator (``loops/loadgen.py``) as a child process.
Every request is a ``method`` POST of one pool tile as an npy body.

Arrivals: ``round(rate_rps * seconds)`` requests, their gaps a fixed
multiset of exponential draws (the same for every seed, scaled to fill the
window) in an order the seed shuffles, so every seed offers the same load;
the seed also picks each request's tile. Latency is timed from the moment
a request was due until its response body is read; a failed or refused
request is a miss.

Traffic keys: ``method``, ``pool``, ``rate_rps``, ``connections``,
``warm`` (requests sent before the window), ``grace_s`` (how long after the
last due time the generator waits), ``engine`` (``EngineConfig`` keys).
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench.harness import setup as common
from perfbench.harness import window as win

LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "loadgen.py")


def schedule(rate: float, seconds: float, pool: int, seed: int):
    """``(offsets, picks)``: the due times (s from the start, ascending)
    and pool indices of the window's requests."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(0).exponential(1.0, n)
    gaps = gaps / gaps.sum() * seconds
    rng = np.random.default_rng([seed, 2])
    gaps = rng.permutation(gaps)
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return offsets.tolist(), rng.integers(0, pool, n).tolist()


def inputs(ctx) -> dict:
    """The seed's pool of tiles (every request body is a pool tile) and the
    forest's fields."""
    pool = common.make_pool(ctx)
    fields, depth = common.make_forest(ctx, pool[0])
    return {"pool": pool, "inputs": dict(enumerate(pool)), "fields": fields,
            "depth": depth}


def setup(ctx):
    from rs_image_segmentation_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine)
    from rs_image_segmentation_tpu_torch.serving.server import make_server
    t = ctx.traffic
    st = inputs(ctx)
    pool, fields, depth = st["pool"], st["fields"], st["depth"]
    feat, cal, _ = ctx.port_configs()
    ecfg = EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in t.get("engine", {}).items()})
    with ctx.timed("engine_start_s"):
        flat, _ = common.port_forest(fields, ctx.dev)
        eng = InferenceEngine(flat, depth, cal=cal, cfg=feat, engine_cfg=ecfg,
                              method=t["method"], device=ctx.dev)
        httpd = make_server(eng, "127.0.0.1", 0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        st["program"] = {"engine": eng, "httpd": httpd, "thread": th}
    h, w = pool.shape[2:]
    with ctx.timed("warmup_s"):
        eng.warmup([(h, w)], ecfg.buckets)
        ctx.tracer.warm(lambda: eng.classify(pool[0]))
    offsets, picks = schedule(t["rate_rps"], ctx.seconds, len(pool),
                              ctx.seed)
    tmp = tempfile.mkdtemp(prefix="perfbench-serve-")
    st["tmp"] = tmp
    np.save(os.path.join(tmp, "pool.npy"), pool)
    spec = {"port": httpd.server_address[1], "pool":
            os.path.join(tmp, "pool.npy"), "method": t["method"],
            "connections": t["connections"], "warm": t["warm"],
            "grace_s": t["grace_s"], "offsets": offsets, "picks": picks,
            "out": os.path.join(tmp, "result")}
    with open(os.path.join(tmp, "spec.json"), "w") as f:
        json.dump(spec, f)
    with ctx.timed("loadgen_start_s"):
        proc = subprocess.Popen(
            [sys.executable, LOADGEN, os.path.join(tmp, "spec.json")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        st["program"]["proc"] = proc
        line = proc.stdout.readline().strip()
        if line != "ready":
            raise RuntimeError(f"load generator did not start: {line!r}")
    if ctx.dev.type == "cuda":
        torch.cuda.synchronize()
    return st


def window(ctx, st):
    tr = ctx.tracer
    eng, proc = st["program"]["engine"], st["program"]["proc"]
    before = collections.Counter(eng.stats()["batch_sizes"])
    t0 = time.perf_counter()
    tr.begin(t0)
    proc.stdin.write("go\n")
    proc.stdin.flush()
    done = {}

    def wait_done():
        done["line"] = proc.stdout.readline().strip()

    reader = threading.Thread(target=wait_done, daemon=True)
    reader.start()
    pending, next_sample = [], t0
    while reader.is_alive():
        now = time.perf_counter()
        tr.tick(now)
        if next_sample <= now < t0 + ctx.seconds:
            # the engine's queue depth, for the sweep's backlog test; a
            # stats() call takes the engine's lock, so only 4 a second
            pending.append(eng.stats()["pending"])
            next_sample = now + 0.25
        reader.join(0.05)
    t_end = time.perf_counter()
    tr.finish()
    after = collections.Counter(eng.stats()["batch_sizes"])
    if done.get("line") != "done":
        raise RuntimeError("load generator failed")
    with open(os.path.join(st["tmp"], "result.json")) as f:
        res = json.load(f)
    reqs = res["requests"]
    lat = [r["done"] - r["due"] if r.get("status") == 200 else float("inf")
           for r in reqs]
    failed = sum(1 for r in reqs if r.get("status") != 200)
    st["requests"] = reqs
    third = max(1, len(pending) // 3)
    ctx.notes["loadgen_lateness_s"] = res["lateness_s"]
    ctx.notes["engine_pending_first_last_third"] = [
        float(np.mean(pending[:third])) if pending else 0.0,
        float(np.mean(pending[-third:])) if pending else 0.0]
    ctx.notes["latency_ms_first_last_third_p50"] = [
        1e3 * float(np.median(lat[:len(lat) // 3] or [0])),
        1e3 * float(np.median(lat[-(len(lat) // 3):] or [0]))]
    delta = {str(k): after[k] - before.get(k, 0) for k in after
             if after[k] - before.get(k, 0) > 0}
    p95 = win.percentile(lat, 95.0)
    p50 = win.percentile(lat, 50.0)
    if tr.on_at is not None:
        # the server's headers are read off the requests the profiler did
        # not slow: due after its stop, or done before its start
        on, off = tr.on_at - t0, tr.off_at - t0
        reqs = [r for r in reqs if r["due"] > off or r.get("done", on) < on]
    return {"end_to_end": {"latency_p95_ms": _ms(p95),
                           "latency_p50_ms": _ms(p50)},
            "units": len(st["requests"]) - failed, "window_s": t_end - t0,
            "attempted": len(st["requests"]), "failed": failed,
            "requests": reqs, "counters": {"batch_sizes": delta}}


def _ms(x: float) -> float:
    # a miss at the percentile: report a latency no client would accept
    return 1e3 * x if x != float("inf") else 1e9


def answers(ctx, st):
    """Every 200 response, through its (tile, digest) body; a request that
    failed is missing."""
    bodies = np.load(os.path.join(st["tmp"], "result.npz"))
    maps = {}
    for key in bodies.files:
        pick, digest = key.split("_", 1)
        maps[(int(pick), digest)] = bodies[key]
    out, missing = [], 0
    for r in st["requests"]:
        if r.get("status") == 200:
            out.append((r["pick"], maps[(r["pick"], r["digest"])]))
        else:
            missing += 1
    return out, st["inputs"], missing


def teardown(ctx, st):
    prog = st.get("program", {})
    proc = prog.get("proc")
    if proc is not None:
        if proc.poll() is None:
            proc.kill()
        proc.wait(30)
    if "httpd" in prog:
        prog["httpd"].shutdown()
        prog["httpd"].server_close()
        prog["thread"].join(30)
    if "engine" in prog:
        prog["engine"].shutdown()
    if "tmp" in st:
        import shutil
        shutil.rmtree(st["tmp"], ignore_errors=True)


def work(ctx, st, ops_per_pixel):
    return {}
