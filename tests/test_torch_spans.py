"""The port's own spans (``utils.timing.span``), on the CPU: off without a
profiler, the registry against the exported chrome trace, sessions, self
time, the spans of the streamed large-scene route and the turbo programs
(maps bit-equal with tracing on and off), the benchmark's readers of them,
the serving engine's queue-wait and host-statistics counters, and
``tools/profile_turbo.py``'s busy share."""

import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import manifest, program_spans
from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig,
                                                         GLCMConfig,
                                                         RuleBasedConfig)
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.pipeline import large_scene, turbo
from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
    build_stretch_lut, build_stretch_stats)
from rs_image_segmentation_tpu_torch.serving.engine import (EngineConfig,
                                                            InferenceEngine)
from rs_image_segmentation_tpu_torch.serving.server import make_server
from rs_image_segmentation_tpu_torch.tools import profile_turbo
from rs_image_segmentation_tpu_torch.tools.fixtures import (rule_labels,
                                                            synthetic_scenes)
from rs_image_segmentation_tpu_torch.utils import timing
from rs_image_segmentation_tpu_torch.utils.timing import (SpanRecord,
                                                          self_time, span,
                                                          spans)

CPU = "cpu"
CFG = FeatureStageConfig()
CAL = CalibrationConfig()
GAINS, BIASES = np.asarray(CAL.gains), np.asarray(CAL.biases)
TILE_ROWS = 42          # a multiple of the GLCM step (21)
WAIT = 120


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Small tensors gain nothing from eight intra-op threads; other test
    workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` session, after one span ran
    unrecorded (so the session is new): ``(result, spans, trace events)``."""
    with span("unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans(), prof


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


# ------------------------------------------------------------ mechanism

def test_off_without_a_profiler(monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    before = [r.id for r in spans()]
    with span("outer", bytes=3) as rec:
        with span("inner"):
            build_stretch_stats(synthetic_scenes(1, 32, 32)[0], GAINS,
                                BIASES)
    assert rec is None
    assert entered == []
    assert [r.id for r in spans()] == before


def test_registry_matches_the_chrome_trace(tmp_path):
    def work():
        for k in range(2):
            with span("root", k=k):
                with span("a"):
                    time.sleep(0.002)
                    with span("leaf", bytes=7 + k):
                        time.sleep(0.002)
                with span("b"):
                    time.sleep(0.002)

    _, recs, prof = _profiled(work)
    assert [r.name for r in recs] == ["root", "a", "leaf", "b"] * 2
    marks = sorted((e for e in _trace_events(prof, tmp_path)
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("rsseg.")),
                   key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in marks] == ["rsseg." + r.name for r in recs]

    def enclosing(i):
        """Index of the innermost trace mark holding mark i, or None."""
        a, b = marks[i]["ts"], marks[i]["ts"] + marks[i]["dur"]
        outer = [j for j, e in enumerate(marks) if j != i
                 and e["ts"] <= a and e["ts"] + e["dur"] >= b]
        return min(outer, key=lambda j: marks[j]["dur"]) if outer else None

    index = {r.id: i for i, r in enumerate(recs)}
    for i, r in enumerate(recs):
        assert (index[r.parent] if r.parent is not None else None) \
            == enclosing(i)
        j = i
        while enclosing(j) is not None:
            j = enclosing(j)
        assert index[r.root] == j
        assert r.thread == threading.get_ident()
        assert r.start <= r.end
    roots = _by_name(recs, "root")
    assert roots[0].id != roots[1].id
    assert [r.counts for r in roots] == [{"k": 0}, {"k": 1}]
    assert [r.counts for r in _by_name(recs, "leaf")] == [{"bytes": 7},
                                                           {"bytes": 8}]
    for r in recs:
        assert r.root == (roots[0].id if r.start < roots[1].start
                          else roots[1].id)


def test_a_session_after_unrecorded_spans_drops_the_older_one():
    def named(n):
        def fn():
            with span(n):
                pass
        return fn

    _profiled(named("first"))
    assert [r.name for r in spans()] == ["first"]
    with span("between"):
        pass
    assert [r.name for r in spans()] == ["first"]     # not yet dropped
    with profile(activities=[ProfilerActivity.CPU]):
        named("second")()
    assert [r.name for r in spans()] == ["second"]


def test_threads_record_into_one_session(monkeypatch):
    """Threads (the engine's dispatch thread among them) share the
    registry: each keeps its own parents, and no record is lost."""
    with span("unrecorded"):
        pass
    monkeypatch.setattr(timing, "_profiling", lambda: True)
    with span("first"):                 # a new session, this thread's
        pass
    n_threads, n_roots = 16, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_roots):
                with span("t.root"):
                    with span("t.child"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    recs = spans()
    assert len(recs) == 1 + 2 * n_threads * n_roots
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in _by_name(recs, "t.child"):
        parent = by_id[r.parent]
        assert parent.name == "t.root" and parent.thread == r.thread
        assert r.root == parent.id == parent.root
    assert len({r.thread for r in recs if r.name == "t.root"}) >= 2


def _rec(name, sid, parent, start, end):
    return SpanRecord(name, sid, parent, 1, 0, {}, start, end)


def test_self_time_is_duration_less_what_children_cover():
    recs = [_rec("p", 1, None, 0.0, 10.0), _rec("c", 2, 1, 1.0, 3.0),
            _rec("c", 3, 1, 2.0, 4.0), _rec("c", 4, 1, 8.0, 12.0),
            _rec("g", 5, 2, 1.0, 2.0), _rec("other", 6, None, 0.0, 5.0)]
    # children cover [1, 4] and [8, 10]; the grandchild is the child's
    assert self_time(recs[0], recs) == pytest.approx(5.0)
    assert self_time(recs[1], recs) == pytest.approx(1.0)
    assert self_time(recs[5], recs) == pytest.approx(5.0)
    for r in recs:
        assert program_spans.self_s(r, recs) == pytest.approx(
            self_time(r, recs))


# ------------------------------------------------------- program spans

@pytest.fixture(scope="module")
def small_scene():
    """A raw 7 x 104 x 96 scene and a five-tree GemmForest fitted on rule
    labels of 80 pixels of its stack."""
    raw = synthetic_scenes(1, 104, 96, seed=5)[0]
    lut = build_stretch_lut(raw, GAINS, BIASES).astype(np.uint8)
    stack = turbo.hierarchical_stack_turbo_cm(raw, lut, CFG,
                                              device=CPU).numpy()
    flat = stack.reshape(19, -1)
    pick = np.random.default_rng(1).choice(flat.shape[1], 80, replace=False)
    forest, _ = tforest.fit_random_forest(flat[:, pick].T,
                                          rule_labels(stack, pick),
                                          n_estimators=5, seed=0)
    return raw, tforest._gemm_for(forest, 19)


def _streamed(scene):
    raw, gf = scene
    return large_scene.classify_large_scene_streamed(
        raw, gf, CAL, CFG, tile_rows=TILE_ROWS, device=CPU)


def test_streamed_scene_spans(small_scene, monkeypatch):
    off = _streamed(small_scene)
    on, recs, _ = _profiled(lambda: _streamed(small_scene))
    np.testing.assert_array_equal(on, off)
    root, = _by_name(recs, "large.streamed")
    assert root.parent is None and all(r.root == root.id for r in recs)
    phases = {n: _by_name(recs, "large." + n)
              for n in ("host_stats", "pass_bc", "pass_d")}
    assert all(len(v) == 1 and v[0].parent == root.id
               for v in phases.values())
    (host,), (bc,), (d,) = phases.values()
    assert host.end <= bc.start and bc.end <= d.start
    for name in ("stretch.params", "stretch.hist"):
        assert [r.parent for r in _by_name(recs, name)] == [host.id]
    # the raw bytes counted on the device, each copied once on the host
    assert host.counts["bytes"] == small_scene[0].nbytes
    hist, = _by_name(recs, "stretch.hist")
    assert hist.counts["host_copy_bytes"] == small_scene[0].nbytes
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    assert manifest.metric_reader("stage_host_copies.large").read(
        {}) == pytest.approx(1.0)
    monkeypatch.undo()
    # one fetch a blocking copy: the (7, 256) int32 raw counts, pass B/C's
    # sums and its grids, then one label tile each of pass D's
    # ceil(104 / 42) = 3
    fetches = _by_name(recs, "large.fetch")
    assert [f.parent for f in fetches] == [host.id] + [bc.id] * 2 + [d.id] * 3
    assert fetches[0].counts["bytes"] == 7 * 256 * 4
    h, w = off.shape
    tiles = [min(TILE_ROWS, h - y) for y in range(0, h, TILE_ROWS)]
    item = torch.empty((), dtype=large_scene._label_transfer_dtype(
        small_scene[1])).element_size()
    assert [f.counts["bytes"] for f in fetches[3:]] == [
        r * w * item for r in tiles]
    assert all(f.counts["bytes"] > 0 for f in fetches[1:3])


@pytest.fixture(scope="module")
def batch():
    scenes = synthetic_scenes(2, 64, 64, seed=9)
    stats = [build_stretch_stats(s, GAINS, BIASES) for s in scenes]
    luts, sps, hists = (np.stack(p) for p in zip(*stats))
    return scenes, luts.astype(np.uint8), sps, hists


def test_turbo_programs_spans_and_maps(small_scene, batch):
    scenes, luts, sps, hists = batch
    gf = small_scene[1]
    small = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                               levels=8))

    def forest():
        return (turbo.classify_scenes_turbo(scenes, luts, gf, small,
                                            device=CPU).numpy(),)

    def rule():
        maps, ov = turbo.rule_based_scenes_turbo_batch(
            scenes, luts, small, RuleBasedConfig(), stretch_params=sps,
            stretch_hists=hists, return_overflow=True, device=CPU)
        return maps.numpy(), ov.numpy()

    for fn, given in ((forest, (scenes, luts)),
                      # the params the rule call is given stay on the host
                      (rule, (scenes, luts, hists))):
        off = fn()
        on, recs, _ = _profiled(fn)
        for a, b in zip(on, off):
            np.testing.assert_array_equal(a, b)
        root, = _by_name(recs, "turbo.batch")
        inputs, = _by_name(recs, "turbo.inputs")
        assert root.parent is None and inputs.parent == root.id
        assert inputs.counts["bytes"] == sum(a.nbytes for a in given)
        # the forest's stack waits in eigh; the rule program waits nowhere
        assert [r.parent for r in _by_name(recs, "turbo.fetch")] == (
            [root.id] if fn is forest else [])
        assert {r.root for r in recs} == {root.id}
    # inputs already on the device copy nothing
    _, recs, _ = _profiled(lambda: turbo.classify_scenes_turbo(
        torch.from_numpy(scenes), torch.from_numpy(luts), gf, small,
        device=CPU))
    assert _by_name(recs, "turbo.inputs")[0].counts["bytes"] == 0


def test_kmeans_batch_spans_and_maps(batch, monkeypatch):
    scenes, luts, _, _ = batch
    small = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                               levels=8))

    def fn():
        maps, cents = turbo.kmeans_scenes_turbo_batch(
            scenes, luts, 7, small, fit_stride=1, return_cents=True,
            device=CPU)
        return maps.numpy(), cents.numpy()

    before = [r.id for r in spans()]
    off = fn()
    assert [r.id for r in spans()] == before        # nothing recorded
    on, recs, _ = _profiled(fn)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    root, = _by_name(recs, "turbo.batch")
    assert root.parent is None and {r.root for r in recs} == {root.id}
    (inputs,), (init,), (lloyd,), (assign,) = (
        _by_name(recs, n) for n in ("turbo.inputs", "kmeans.init",
                                    "kmeans.lloyd", "kmeans.assign"))
    assert {r.parent for r in (inputs, init, lloyd, assign)} == {root.id}
    assert inputs.end <= init.start and init.end <= lloyd.start
    assert lloyd.end <= assign.start
    assert inputs.counts["bytes"] == scenes.nbytes + luts.nbytes
    assert init.counts == {"picks": 7}
    # the loop's iterations are the slowest problem's
    xs = turbo.kmeans_features(torch.from_numpy(scenes),
                               torch.from_numpy(luts), small)
    _, _, n_iter = turbo.kmeans_fit(xs, 7, 42, 1, False)
    assert lloyd.counts == {"problems": 2, "iters": int(n_iter.max()),
                            "fused": 0}
    # the benchmark's readers of them, one batch in the session
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    for name, want in KMEANS_READERS.items():
        assert manifest.metric_reader(name).read({}) == pytest.approx(
            want(init, lloyd))
    monkeypatch.setattr(timing, "spans", lambda: [
        r for r in recs if not r.name.startswith("kmeans.")])
    for name in KMEANS_READERS:
        assert manifest.metric_reader(name).read({}) is None


# the KMeans batch's readers, each from its session's spans
KMEANS_READERS = {
    "kmeans_init_ms.batch": lambda init, lloyd: 1e3 * init.duration,
    "kmeans_lloyd_ms.batch": lambda init, lloyd: 1e3 * lloyd.duration,
    "lloyd_iters.batch": lambda init, lloyd: lloyd.counts["iters"],
    # the CPU's fit runs the plain loop
    "lloyd_fused_share.batch": lambda init, lloyd: 0.0,
}


# ------------------------------------------------ the benchmark's readers

def _session():
    """Two streamed scenes and two batches, in seconds."""
    recs, ids = [], iter(range(1, 100))

    def add(name, parent, a, b):
        sid = next(ids)
        root = sid if parent is None else parent.root
        recs.append(SpanRecord(name, sid, parent and parent.id, root, 0, {},
                               a, b))
        return recs[-1]

    for t in (0.0, 1.0):
        s = add("large.streamed", None, t, t + 0.6)
        host = add("large.host_stats", s, t + 0.01, t + 0.31)
        add("stretch.params", host, t + 0.01, t + 0.11)
        add("stretch.hist", host, t + 0.11, t + 0.21)
        bc = add("large.pass_bc", s, t + 0.31, t + 0.45)
        add("large.fetch", bc, t + 0.40, t + 0.42)
        d = add("large.pass_d", s, t + 0.45, t + 0.59)
        add("large.fetch", d, t + 0.50, t + 0.51)
        add("large.fetch", d, t + 0.55, t + 0.56)
    for t in (2.0, 2.1):
        add("stretch.params", None, t, t + 0.004)
        add("stretch.hist", None, t + 0.004, t + 0.010)
        b = add("turbo.batch", None, t + 0.01, t + 0.03)
        add("turbo.inputs", b, t + 0.01, t + 0.014)
        add("turbo.fetch", b, t + 0.02, t + 0.021)
        f = add("forest.labels", b, t + 0.022, t + 0.0225)
        f.counts.update(pixels=1000, walk_steps=400_000)
    return recs


# the cell's unit of work, as the forest batch hands it to the readers:
# 250 node comparisons a pixel, against 400 steps a pixel walked above
REC = {"work": {"calls": {"forest_labels": [
    {"pixels": 2000, "comparisons": 500_000}]}}}


EXPECTED_MS = {
    "large_host_stats_ms.large": 300.0,
    "large_launch_ms.large": 140.0 - 20.0 + 140.0 - 20.0,
    "large_fetch_ms.large": 40.0,
    "inputs_ms.batch": 4.0,
    "launch_ms.batch": 14.5,            # the forest's launch left out
    "stretch_params_ms.batch": 100.0 + 4.0,
    "stretch_hist_ms.batch": 100.0 + 6.0,
    "forest_walk_efficiency": 100.0 * 250 / 400,
}


def test_readers_on_a_made_up_session(monkeypatch):
    bench = manifest.load_benchmark()
    new = [m for m in bench["per_layer"] if m["source"] == "program_span"]
    # the KMeans batch's span readers are read on a recorded batch above
    read_above = [n for n in KMEANS_READERS if n.endswith("_ms.batch")]
    assert sorted(m["name"] for m in new) == sorted([*EXPECTED_MS,
                                                     *read_above])
    recs = _session()
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    for name, ms in EXPECTED_MS.items():
        assert manifest.metric_reader(name).read(REC) == pytest.approx(ms)
    # the forest kernel's device time over its spans, from a trace
    trace = {"kernels": {"forest_labels_kernel": {"total_s": 0.006,
                                                  "count": 2}}}
    assert manifest.metric_reader("forest_device_ms.batch").read(
        {"trace": trace}) == pytest.approx(3.0)
    monkeypatch.setattr(timing, "spans", lambda: [])
    for name in EXPECTED_MS:
        assert manifest.metric_reader(name).read(REC) is None
    assert manifest.metric_reader("forest_device_ms.batch").read(
        {"trace": trace}) is None
    monkeypatch.setattr(timing, "spans", lambda: [
        r for r in recs if not r.name.startswith("turbo.")])
    assert manifest.metric_reader("launch_ms.batch").read({}) is None
    assert manifest.metric_reader("large_fetch_ms.large").read({}) == \
        pytest.approx(40.0)
    # a program without the forest's span reads nothing for it
    monkeypatch.setattr(timing, "spans", lambda: [
        r for r in recs if r.name != "forest.labels"])
    assert manifest.metric_reader("forest_walk_efficiency").read(REC) is None
    assert manifest.metric_reader("forest_device_ms.batch").read(
        {"trace": trace}) is None
    # a program without spans at all (an older checkout)
    monkeypatch.delattr(timing, "spans")
    for name in EXPECTED_MS:
        assert manifest.metric_reader(name).read(REC) is None


def _staged(*scenes):
    """A streamed scene's ``large.host_stats`` span of ``bytes`` raw bytes
    around a ``stretch.hist`` span with ``host_copy_bytes`` copied (no
    count where None) for each ``(bytes, host_copy_bytes)``."""
    recs = []
    for k, (raw, copied) in enumerate(scenes):
        host = SpanRecord("large.host_stats", 2 * k + 1, None, 2 * k + 1, 0,
                          {"bytes": raw}, float(k), k + 0.5)
        recs += [host, SpanRecord(
            "stretch.hist", 2 * k + 2, host.id, host.id, 0,
            {} if copied is None else {"host_copy_bytes": copied},
            k + 0.1, k + 0.2)]
    return recs


@pytest.mark.parametrize("scenes, copies", [
    (((100, 100), (100, 100)), 1.0), (((100, 200),), 2.0),
    (((100, 100), (300, 600)), 1.75), (((100, None),), None), ((), None)])
def test_stage_host_copies_reader(monkeypatch, scenes, copies):
    recs = _staged(*scenes)
    # a batch's stretch.hist, outside any scene, carries no count
    recs.append(SpanRecord("stretch.hist", 99, None, 99, 0, {}, 5.0, 5.1))
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    got = manifest.metric_reader("stage_host_copies.large").read({})
    assert got == copies if copies is None else got == pytest.approx(copies)
    monkeypatch.delattr(timing, "spans")        # an older checkout
    assert manifest.metric_reader("stage_host_copies.large").read({}) is None



# ------------------------------------------------------ engine counters

def test_engine_counters_and_serve_batch_span():
    scenes = [np.random.default_rng(k).integers(0, 256, (7, 32, 32))
              .astype(np.uint8) for k in range(5)]
    cfg = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                             levels=8))
    eng = InferenceEngine(method="rule_based", cfg=cfg,
                          engine_cfg=EngineConfig(max_batch=4,
                                                  batch_window_ms=50.0),
                          device=CPU)
    try:
        futs = [eng.submit(s) for s in scenes]
        for f in futs:
            f.result(timeout=WAIT)
        st = eng.stats()
        assert st["queue_wait_s"]["count"] == st["requests"] == 5
        assert st["host_stats_s"]["count"] == st["batches"] >= 2
        assert st["queue_wait_s"]["sum"] > 0 and st["host_stats_s"]["sum"] > 0
        httpd = make_server(eng, "127.0.0.1", 0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            host, port = httpd.server_address[:2]
            with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                        timeout=WAIT) as r:
                body = r.read().decode()
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=10)
        for key in ("queue_wait", "host_stats"):
            assert f"# TYPE rsseg_{key}_seconds_total counter" in body
            assert (f"rsseg_{key}_seconds_count "
                    f"{st[key + '_s']['count']}") in body
        # traced in the caller's thread: the stretch statistics and the
        # program nest under serve.batch
        _, recs, _ = _profiled(lambda: eng._run_batch(
            scenes[:2], method="rule_based", record_stats=False))
        root, = _by_name(recs, "serve.batch")
        assert {r.name for r in recs if r.parent == root.id} == {
            "stretch.params", "stretch.hist", "turbo.batch"}
        assert {r.root for r in recs} == {root.id}
        assert eng.stats()["batches"] == st["batches"]
    finally:
        eng.shutdown()
    assert not eng._thread.is_alive()


# ------------------------------------------------- profile_turbo's share

def test_busy_share_counts_two_streams_once():
    def ev(cat, ts, dur, stream):
        return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur,
                "args": {"stream": stream}}

    events = [
        ev("kernel", 100.0, 300.0, 7),        # 100-400
        ev("kernel", 300.0, 200.0, 13),       # 300-500, overlaps 100
        ev("gpu_memcpy", 800.0, 100.0, 7),    # 800-900
        ev("gpu_memset", 950.0, 100.0, 13),   # 950-1050, clipped at 1000
        ev("kernel", 1200.0, 50.0, 7),        # outside the span
        ev("cpu_op", 0.0, 1000.0, 0),         # not device work
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 500.0},
    ]
    # busy 100-500, 800-900, 950-1000 of the span 0-1000
    assert profile_turbo.busy_share(events, 0.0, 1000.0) == pytest.approx(
        0.55)
