"""PyTorch port of the serving layer, on the CPU: the dynamic-batching
engine (``serving.engine``) and the HTTP front-end (``serving.server``,
``serving.client``), mirroring ``tests/test_serving.py`` against the port's
engine on ``device="cpu"``; then the port against the JAX package
(supervised maps >= 99.9 % of JAX's direct program, rule maps bit for
bit), and a forest past ``GEMM_MAX_LEAVES`` on the batched program.

Exactness contract under test: a scene's class map from the engine is
bit-identical to the port's direct program on that scene alone, however
requests were coalesced or bucket-padded. Every ``result()`` and
``urlopen`` has a timeout, so a wedged dispatch thread fails a test
instead of hanging the suite.
"""

import concurrent.futures as cf
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import (
    FeatureStageConfig as JFeatureStageConfig)
from rs_image_segmentation_tpu.core.config import GLCMConfig as JGLCMConfig
from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.pipeline import features as jfeatures
from rs_image_segmentation_tpu.pipeline import turbo as jturbo
from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig,
                                                         GLCMConfig)
from rs_image_segmentation_tpu_torch.core.types import GeoMeta
from rs_image_segmentation_tpu_torch.io.tiff import read_tiff, write_tiff
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops.kernels import apply_u8_lut
from rs_image_segmentation_tpu_torch.pipeline import turbo
from rs_image_segmentation_tpu_torch.pipeline.features import (
    hierarchical_stack_fused)
from rs_image_segmentation_tpu_torch.pipeline.large_scene import (
    rule_based_large_scene)
from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
    build_stretch_lut, build_stretch_stats)
from rs_image_segmentation_tpu_torch.serving import client
from rs_image_segmentation_tpu_torch.serving.engine import (EngineConfig,
                                                            EngineSaturated,
                                                            InferenceEngine)
from rs_image_segmentation_tpu_torch.serving.server import make_server
from rs_image_segmentation_tpu_torch.tools.fixtures import deep_forest_fields
from tests.forest_walk_ref import walk_labels

SMALL_CFG = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                               levels=8))
JSMALL_CFG = JFeatureStageConfig(glcm=JGLCMConfig(window_size=8, step_size=8,
                                                  levels=8))
H = W = 32
DEV = "cpu"
WAIT = 120      # seconds any result() or urlopen waits at most
CAL = CalibrationConfig()
GAINS, BIASES = np.asarray(CAL.gains), np.asarray(CAL.biases)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """32 x 32 scenes gain nothing from eight intra-op threads; other test
    workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scenes(n, seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (7, h, w)).astype(np.uint8)
            for _ in range(n)]


def _lut(scene):
    return build_stretch_lut(scene, GAINS, BIASES).astype(np.uint8)


@pytest.fixture(scope="module")
def forest():
    """A 10-tree forest fitted by the JAX package's trainer, carried
    across as numpy: ``(port FlatForest, depth, JAX FlatForest)``."""
    rng = np.random.default_rng(0)
    x = rng.random((64, 19)).astype(np.float32)
    y = rng.integers(1, 4, 64)
    jflat, depth = jforest.fit_random_forest(x, y, n_estimators=10, seed=0)
    tflat = tforest.flat_forest_from_numpy(
        {k: np.asarray(v) for k, v in jflat._asdict().items()})
    return tflat, depth, jflat


@pytest.fixture(scope="module")
def engine(forest):
    f, depth, _ = forest
    eng = InferenceEngine(
        f, depth, cfg=SMALL_CFG,
        engine_cfg=EngineConfig(max_batch=4, batch_window_ms=300.0,
                                buckets=(1, 2, 4)), device=DEV)
    yield eng
    eng.shutdown()


def _direct(scene, forest):
    """The port's supervised program on the scene alone (B = 1)."""
    gf = tforest._gemm_for(forest[0], 19)
    return turbo.classify_scenes_turbo(scene[None], _lut(scene)[None], gf,
                                       SMALL_CFG, device=DEV)[0].numpy()


def _direct_kmeans(scene, n_clusters=4):
    # the engine serves the batched kmeans program (subsampled fit,
    # EngineConfig.kmeans_fit_stride); B = 1 is the per-scene reference
    return turbo.kmeans_scenes_turbo_batch(
        scene[None], _lut(scene)[None], n_clusters=n_clusters,
        cfg=SMALL_CFG, fit_stride=EngineConfig().kmeans_fit_stride,
        device=DEV)[0].numpy()


def _direct_rule(scene):
    return turbo.rule_based_scenes_turbo(scene, _lut(scene), cfg=SMALL_CFG,
                                         device=DEV).numpy()


def _stats_batch(scenes):
    st = [build_stretch_stats(s, GAINS, BIASES) for s in scenes]
    return (np.stack(scenes), np.stack([p[0] for p in st]).astype(np.uint8),
            np.stack([p[1] for p in st]), np.stack([p[2] for p in st]))


def _gated(eng, ev):
    """Swap ``eng._run_batch`` for one that waits on ``ev`` first; returns
    the original."""
    orig = eng._run_batch

    def gated(scenes, method=None, bucket=None, record_stats=True):
        ev.wait(timeout=60)
        return orig(scenes, method=method, bucket=bucket,
                    record_stats=record_stats)

    eng._run_batch = gated
    return orig


# ------------------------------------------------------------- the engine

def test_single_request_matches_direct(engine, forest):
    scene = _scenes(1, seed=1)[0]
    out = engine.classify(scene, timeout=WAIT)
    assert out.shape == (H, W) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, _direct(scene, forest))


def test_coalesced_batch_is_padded_and_exact(engine, forest):
    scenes = _scenes(3, seed=2)
    before = engine.stats()
    futs = [engine.submit(s) for s in scenes]
    outs = [f.result(timeout=WAIT) for f in futs]
    after = engine.stats()
    # 3 requests coalesce into one program (window is 300 ms), padded 3->4
    assert after["batches"] == before["batches"] + 1
    assert after["padded_scenes"] == before["padded_scenes"] + 1
    for s, o in zip(scenes, outs):
        np.testing.assert_array_equal(o, _direct(s, forest))


def test_validation_errors_surface_in_future(engine):
    bad_dtype = np.zeros((7, H, W), np.float32)
    with pytest.raises(ValueError, match="uint8"):
        engine.submit(bad_dtype).result(timeout=10)
    with pytest.raises(ValueError, match=r"\(7, H, W\)"):
        engine.submit(np.zeros((3, H, W), np.uint8)).result(timeout=10)
    with pytest.raises(ValueError, match="GLCM window"):
        engine.submit(np.zeros((7, 4, 4), np.uint8)).result(timeout=10)


def test_engine_config_validation():
    with pytest.raises(ValueError, match="sorted unique"):
        EngineConfig(buckets=(4, 2))
    with pytest.raises(ValueError, match="max_batch"):
        EngineConfig(max_batch=0)
    # buckets normalize against max_batch: oversize buckets drop, and
    # max_batch itself is always the top bucket
    assert EngineConfig(max_batch=4).buckets == (1, 2, 4)
    assert EngineConfig(max_batch=2, buckets=(1, 8)).buckets == (1, 2)
    assert EngineConfig(max_batch=16).buckets == (1, 2, 4, 8, 16)
    assert EngineConfig(max_batch=3, buckets=(1, 2, 4, 8)).buckets == (1, 2, 3)


def test_shutdown_rejects_new_work(forest):
    f, depth, _ = forest
    eng = InferenceEngine(f, depth, cfg=SMALL_CFG, device=DEV)
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(_scenes(1)[0]).result(timeout=10)


def test_engine_raises_without_cuda():
    """With no device named the engine runs on CUDA, and on a host
    without CUDA it raises instead of drifting to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(method="rule_based")


# --------------------------------------------------------------- HTTP layer

@pytest.fixture(scope="module")
def server(engine):
    httpd = make_server(engine, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def test_http_healthz_and_stats(server):
    hz = client.healthz(server, timeout=WAIT)
    assert hz["ok"] is True and hz["backend"] == "cpu"
    st = client.stats(server, timeout=WAIT)
    assert st["requests"] >= 1 and st["gemm_forest"] is True


def test_http_npy_roundtrip(server, forest):
    scene = _scenes(1, seed=3)[0]
    with client.ServingSession(server, timeout=WAIT) as sess:
        out = sess.classify_array(scene)
        assert set(sess.last_timing) == {"decode_ms", "engine_ms",
                                         "encode_ms"}
    np.testing.assert_array_equal(out, _direct(scene, forest))
    out = client.classify_array(server, scene, timeout=WAIT)
    np.testing.assert_array_equal(out, _direct(scene, forest))


def test_http_tiff_roundtrip(server, forest, tmp_path):
    scene = _scenes(1, seed=4)[0]
    src = tmp_path / "scene.tif"
    meta = GeoMeta(transform=(30.0, 0.0, 500000.0, 0.0, -30.0, 4000000.0),
                   crs="EPSG:32630")
    write_tiff(str(src), scene, meta)
    # GeoTIFF in -> GeoTIFF out, geo metadata preserved
    dst = tmp_path / "map.tif"
    client.classify_tiff(server, str(src), str(dst), timeout=WAIT)
    arr, info = read_tiff(str(dst))
    np.testing.assert_array_equal(arr[0], _direct(scene, forest))
    assert info.meta.crs == meta.crs
    assert np.allclose(info.meta.transform, meta.transform)
    # ?format=npy variant
    out = client.classify_tiff(server, str(src), timeout=WAIT)
    np.testing.assert_array_equal(out, _direct(scene, forest))


def _post_status(url, body, ctype):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=WAIT)
    return ei.value.code


def test_http_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{server}/nope", timeout=WAIT)
    assert ei.value.code == 404
    url = f"{server}/v1/classify"
    assert _post_status(url, b"junk", "text/plain") == 415
    assert _post_status(url, b"junk", "application/x-npy") == 400
    assert _post_status(url, b"", "application/x-npy") == 411
    # a declared body over MAX_BODY is refused before it is read
    host, port = server.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT)
    try:
        conn.putrequest("POST", "/v1/classify")
        conn.putheader("Content-Type", "application/x-npy")
        conn.putheader("Content-Length", str(2 << 30))
        conn.endheaders()
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def test_concurrent_load_all_exact(engine, forest):
    """Thread-safety under contention: many clients submitting
    concurrently across coalescing windows; every result must equal the
    single-scene reference regardless of how requests were batched."""
    scenes = _scenes(12, seed=9)
    refs = [_direct(s, forest) for s in scenes]
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        outs = list(pool.map(lambda s: engine.classify(s, timeout=WAIT),
                             scenes))
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    st = engine.stats()
    assert st["requests"] >= 12
    assert st["padded_scenes"] >= 0 and st["errors"] == 0


def test_kmeans_method_engine():
    """Unsupervised serving: engine results equal the direct batched
    program on each scene alone, including under batching."""
    scenes = _scenes(2, seed=21)
    with InferenceEngine(method="kmeans", n_clusters=4, cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=2,
                                                 batch_window_ms=200.0,
                                                 buckets=(1, 2)),
                         device=DEV) as eng:
        futs = [eng.submit(s) for s in scenes]
        outs = [f.result(timeout=WAIT) for f in futs]
    for s, o in zip(scenes, outs):
        np.testing.assert_array_equal(o, _direct_kmeans(s))
        assert set(np.unique(o)) <= set(range(1, 5))


def test_rule_based_method_engine():
    """Rule-based serving: engine results equal the single-scene program;
    no model required."""
    scene = _scenes(1, seed=22)[0]
    with InferenceEngine(method="rule_based", cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=1, buckets=(1,)),
                         device=DEV) as eng:
        out = eng.classify(scene, timeout=WAIT)
    np.testing.assert_array_equal(out, _direct_rule(scene))


def test_method_validation():
    with pytest.raises(ValueError, match="method must be one of"):
        InferenceEngine(method="svm", device=DEV)
    with pytest.raises(ValueError, match="needs a trained forest"):
        InferenceEngine(method="random_forest", device=DEV)
    with pytest.raises(ValueError, match="n_clusters >= 2"):
        InferenceEngine(method="kmeans", n_clusters=0, device=DEV)


# ------------------------------------------------- per-request method routing

def test_mixed_method_traffic_one_engine(forest):
    """ONE engine serves interleaved rf/kmeans/rule_based requests from
    multiple threads, every result exact per method."""
    f, depth, _ = forest
    scenes = _scenes(12, seed=40)
    methods = ["random_forest", "kmeans", "rule_based"] * 4
    direct = {"random_forest": lambda s: _direct(s, forest),
              "kmeans": _direct_kmeans, "rule_based": _direct_rule}
    refs = [direct[m](s) for s, m in zip(scenes, methods)]
    with InferenceEngine(f, depth, cfg=SMALL_CFG, n_clusters=4,
                         engine_cfg=EngineConfig(max_batch=4,
                                                 batch_window_ms=50.0,
                                                 buckets=(1, 2, 4)),
                         device=DEV) as eng:
        assert eng.available_methods() == (
            "random_forest", "kmeans", "rule_based")
        with cf.ThreadPoolExecutor(max_workers=6) as pool:
            outs = list(pool.map(
                lambda sm: eng.classify(sm[0], timeout=WAIT, method=sm[1]),
                zip(scenes, methods)))
        st = eng.stats()
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert st["errors"] == 0
    assert set(st["methods"]) == {"random_forest", "kmeans", "rule_based"}
    # programs for several methods ran through one engine's cache
    assert len({w[0] for w in st["warm_programs"]}) == 3


def test_per_request_method_without_forest_fails_fast():
    with InferenceEngine(method="rule_based", cfg=SMALL_CFG,
                         device=DEV) as eng:
        assert eng.available_methods() == ("kmeans", "rule_based")
        with pytest.raises(ValueError, match="trained forest"):
            eng.submit(_scenes(1)[0], method="random_forest"
                       ).result(timeout=10)
        with pytest.raises(ValueError, match="method must be one of"):
            eng.submit(_scenes(1)[0], method="svm").result(timeout=10)


# ------------------------------------------------------------- robustness

def test_cancelled_queued_future_does_not_poison_batch(forest):
    """A future cancelled while queued is skipped by the dispatch loop;
    coalesced neighbors still get their maps."""
    f, depth, _ = forest
    eng = InferenceEngine(f, depth, cfg=SMALL_CFG,
                          engine_cfg=EngineConfig(max_batch=4,
                                                  batch_window_ms=100.0,
                                                  buckets=(1, 2, 4)),
                          device=DEV)
    ev = threading.Event()
    orig = _gated(eng, ev)
    try:
        # block the dispatch thread on a first slow batch so subsequent
        # submissions stay queued long enough to cancel one
        blocker = eng.submit(_scenes(1, seed=50)[0])
        # wait past the 100 ms window so the blocker's group closes
        # (size 1) and wedges in gated before the next submissions
        time.sleep(0.4)
        scenes = _scenes(3, seed=51)
        futs = [eng.submit(s) for s in scenes]
        assert futs[1].cancel()              # cancel a queued request
        ev.set()
        outs = [futs[0].result(timeout=WAIT), futs[2].result(timeout=WAIT)]
        blocker.result(timeout=WAIT)
        np.testing.assert_array_equal(outs[0], _direct(scenes[0], forest))
        np.testing.assert_array_equal(outs[1], _direct(scenes[2], forest))
        assert eng.stats()["errors"] == 0
        assert eng.stats()["cancelled"] == 1
    finally:
        eng._run_batch = orig
        ev.set()
        eng.shutdown()


def test_pending_queue_bound(forest):
    """Beyond max_pending, submit fails fast with EngineSaturated."""
    f, depth, _ = forest
    eng = InferenceEngine(f, depth, cfg=SMALL_CFG,
                          engine_cfg=EngineConfig(max_batch=1, buckets=(1,),
                                                  max_pending=2),
                          device=DEV)
    ev = threading.Event()
    orig = _gated(eng, ev)
    try:
        first = eng.submit(_scenes(1, seed=60)[0])
        time.sleep(0.1)                      # dispatched (not pending)
        queued = [eng.submit(s) for s in _scenes(2, seed=61)]
        overflow = eng.submit(_scenes(1, seed=62)[0])
        with pytest.raises(EngineSaturated, match="saturated"):
            overflow.result(timeout=10)
        assert eng.stats()["rejected"] == 1
        ev.set()
        for fut in [first] + queued:        # bounded queue still drains
            assert fut.result(timeout=WAIT).shape == (H, W)
    finally:
        eng._run_batch = orig
        ev.set()
        eng.shutdown()


def test_warmup_validates_shapes(forest):
    f, depth, _ = forest
    with InferenceEngine(f, depth, cfg=SMALL_CFG, device=DEV) as eng:
        with pytest.raises(ValueError, match="GLCM window"):
            eng.warmup([(4, 4)])
        with pytest.raises(ValueError, match="method"):
            eng.warmup([(H, W)], methods=["svm"])


def test_scene_mutation_after_submit_is_safe(forest):
    """The engine copies at enqueue: a client scribbling on its array
    after submit must not change the result."""
    f, depth, _ = forest
    eng = InferenceEngine(f, depth, cfg=SMALL_CFG,
                          engine_cfg=EngineConfig(max_batch=1, buckets=(1,)),
                          device=DEV)
    ev = threading.Event()
    orig = _gated(eng, ev)
    try:
        scene = _scenes(1, seed=70)[0]
        ref = _direct(scene.copy(), forest)
        fut = eng.submit(scene)
        scene[:] = 0                         # mutate after submit
        ev.set()
        np.testing.assert_array_equal(fut.result(timeout=WAIT), ref)
    finally:
        eng._run_batch = orig
        ev.set()
        eng.shutdown()


def test_http_method_routing_and_timeouts(forest):
    """HTTP layer: ?method= routing, 504 on request timeout, 503 on
    saturation — all against one engine."""
    f, depth, _ = forest
    eng = InferenceEngine(f, depth, cfg=SMALL_CFG, n_clusters=4,
                          engine_cfg=EngineConfig(max_batch=2,
                                                  batch_window_ms=5.0,
                                                  buckets=(1, 2),
                                                  max_pending=1),
                          device=DEV)
    httpd = make_server(eng, "127.0.0.1", 0, request_timeout=2.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = "http://%s:%d" % httpd.server_address[:2]
    ev = threading.Event()
    orig = eng._run_batch
    try:
        # first calls build what the 2 s request timeout should not pay
        eng.warmup([(H, W)], buckets=(1,), methods=eng.available_methods())
        scene = _scenes(1, seed=80)[0]
        out = client.classify_array(base, scene, timeout=WAIT,
                                    method="rule_based")
        np.testing.assert_array_equal(out, _direct_rule(scene))
        out = client.classify_array(base, scene, timeout=WAIT,
                                    method="random_forest")
        np.testing.assert_array_equal(out, _direct(scene, forest))

        # wedge the engine -> timeout gives 504, saturation gives 503
        _gated(eng, ev)
        s1, s2 = _scenes(2, seed=81)
        with cf.ThreadPoolExecutor(max_workers=2) as pool:
            slow1 = pool.submit(client.classify_array, base, s1, WAIT)
            time.sleep(0.4)   # dispatched, wedged inside gated
            slow2 = pool.submit(client.classify_array, base, s2, WAIT)
            time.sleep(0.4)   # queued; pending == max_pending
            with pytest.raises(urllib.error.HTTPError) as ei:
                client.classify_array(base, scene, timeout=60)
            assert ei.value.code == 503
            for slow in (slow1, slow2):   # 2 s server timeout -> 504
                with pytest.raises(urllib.error.HTTPError) as ei:
                    slow.result(timeout=WAIT)
                assert ei.value.code == 504
        eng._run_batch = orig
        ev.set()
        # wait for the wedged batch + cancelled leftovers to drain
        # (max_pending=1: a still-queued scene would 503 the next submit)
        deadline = time.time() + 60
        while eng.stats()["pending"] and time.time() < deadline:
            time.sleep(0.05)
        # engine still serves after the wedge clears
        out = client.classify_array(base, scene, timeout=WAIT)
        np.testing.assert_array_equal(out, _direct(scene, forest))
    finally:
        eng._run_batch = orig
        ev.set()
        httpd.shutdown()
        httpd.server_close()
        eng.shutdown()
        t.join(timeout=10)


def test_engine_survives_batch_failure(forest):
    """A batch that fails in-flight surfaces per-request exceptions and
    leaves the engine serving (the dispatch thread must not die); over
    HTTP the failure is a 500."""
    f, depth, _ = forest
    with InferenceEngine(f, depth, cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=1, buckets=(1,)),
                         device=DEV) as eng:
        boom = {"left": 2}
        orig = eng._run_batch

        def flaky(scenes, method=None, bucket=None, record_stats=True):
            if boom["left"]:
                boom["left"] -= 1
                raise RuntimeError("injected device failure")
            return orig(scenes, method=method, bucket=bucket,
                        record_stats=record_stats)

        eng._run_batch = flaky
        scene = _scenes(1, seed=30)[0]
        with pytest.raises(RuntimeError, match="injected device failure"):
            eng.classify(scene, timeout=WAIT)
        assert eng.stats()["errors"] == 1
        httpd = make_server(eng, "127.0.0.1", 0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            base = "http://%s:%d" % httpd.server_address[:2]
            with pytest.raises(urllib.error.HTTPError) as ei:
                client.classify_array(base, scene, timeout=WAIT)
            assert ei.value.code == 500
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=10)
        # the next request succeeds on the same engine
        out = eng.classify(scene, timeout=WAIT)
        np.testing.assert_array_equal(out, _direct(scene, forest))


def test_http_metrics_endpoint(server, engine):
    """Prometheus exposition: counters present, parseable, consistent
    with /stats."""
    with urllib.request.urlopen(f"{server}/metrics", timeout=WAIT) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    st = engine.stats()
    assert f"rsseg_requests_total {st['requests']}" in body
    assert ("rsseg_pending" in body
            and "# TYPE rsseg_batches_total counter" in body)
    for m, n in st.get("methods", {}).items():
        assert f'rsseg_method_requests_total{{method="{m}"}} {n}' in body


def test_program_cache_lru_bounded():
    """A client cycling scene shapes cannot grow the program cache without
    bound: LRU eviction keeps it at EngineConfig.program_cache and counts
    evictions."""
    rng = np.random.default_rng(31)
    shapes = [(28 + 4 * i, 28 + 4 * i) for i in range(6)]
    with InferenceEngine(method="rule_based", cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=1, buckets=(1,),
                                                 program_cache=3),
                         device=DEV) as eng:
        for h, w in shapes:
            scene = rng.integers(0, 256, (7, h, w)).astype(np.uint8)
            out = eng.classify(scene, timeout=WAIT)
            assert out.shape == (h, w)
        st = eng.stats()
    assert st["program_cache_size"] <= 3
    assert st["program_cache_limit"] == 3
    assert st["program_evictions"] == len(shapes) - 3
    assert len(st["warm_programs"]) <= 3


def test_strict_shapes_allowlist():
    """strict_shapes rejects unlisted scene shapes up front and counts
    them; listed shapes still serve."""
    rng = np.random.default_rng(32)
    ok_scene = rng.integers(0, 256, (7, 28, 28)).astype(np.uint8)
    bad_scene = rng.integers(0, 256, (7, 32, 32)).astype(np.uint8)
    with InferenceEngine(method="rule_based", cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(
                             max_batch=1, buckets=(1,),
                             strict_shapes=((28, 28),)),
                         device=DEV) as eng:
        out = eng.classify(ok_scene, timeout=WAIT)
        assert out.shape == (28, 28)
        with pytest.raises(ValueError, match="strict-shapes"):
            eng.classify(bad_scene, timeout=WAIT)
        st = eng.stats()
    assert st["rejected_shape"] == 1
    assert st["strict_shapes"] == [[28, 28]]


# ------------------------------------------------------------------ KMeans

def test_kmeans_shared_fit_engine():
    """kmeans_shared_fit fits one model per batch: duplicated scenes
    batched together get bit-identical maps and valid cluster labels."""
    scenes = _scenes(1, seed=23)
    dup = [scenes[0], scenes[0].copy()]
    with InferenceEngine(method="kmeans", n_clusters=4, cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=2,
                                                 batch_window_ms=500.0,
                                                 buckets=(2,),
                                                 kmeans_shared_fit=True),
                         device=DEV) as eng:
        futs = [eng.submit(s) for s in dup]
        outs = [f.result(timeout=WAIT) for f in futs]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert set(np.unique(outs[0])) <= set(range(1, 5))


def test_kmeans_shared_fit_padding_exactness():
    """Shared fit disables bucket padding (b = n): n scenes whose bucket
    would pad get maps bit-identical to the unpadded direct shared-fit
    batch."""
    scenes = _scenes(3, seed=31)
    ecfg = EngineConfig(max_batch=3, batch_window_ms=2000.0, buckets=(4,),
                        kmeans_shared_fit=True)
    with InferenceEngine(method="kmeans", n_clusters=4, cfg=SMALL_CFG,
                         engine_cfg=ecfg, device=DEV) as eng:
        futs = [eng.submit(s) for s in scenes]
        outs = [f.result(timeout=WAIT) for f in futs]
        stats = eng.stats()
    assert stats["batches"] == 1            # all three coalesced
    assert stats["padded_scenes"] == 0      # padding disabled under shared fit
    batch, luts, sps, hists = _stats_batch(scenes)
    direct = turbo.kmeans_scenes_turbo_batch(
        batch, luts, n_clusters=4, cfg=SMALL_CFG,
        fit_stride=ecfg.kmeans_fit_stride, stretch_params=sps,
        stretch_hists=hists, shared_fit=True, device=DEV).numpy()
    for i in range(3):
        np.testing.assert_array_equal(outs[i], direct[i])


def test_rule_overflow_reroute(monkeypatch):
    """A rule-based scene whose min-area stage hits the 32768-id cap is
    rerouted to the uncapped whole-image path — the client gets the
    correct map (bit-equal to rule_based_large_scene), never the
    truncated batched one. A 32 x 32 scene cannot reach the cap, so the
    overflow flag is forced by wrapping the batched program; the reroute
    (stretched scene rebuilt from LUT + raw DNs, histogram pass-through,
    stats counter) is what is under test. ``chip_smoke.py`` phase 19
    sends a scene that reaches the cap."""
    real = turbo.rule_based_scenes_turbo_batch

    def fake(bd, ld, cfg=None, rule_cfg=None, stretch_params=None,
             stretch_hists=None, return_overflow=False, device=None):
        out = real(bd, ld, cfg, rule_cfg, stretch_params=stretch_params,
                   stretch_hists=stretch_hists, device=device)
        if return_overflow:
            # corrupt the batched output and flag every scene: a correct
            # reroute must discard this and recompute
            return (torch.zeros_like(out),
                    torch.ones((out.shape[0],), dtype=torch.bool))
        return out

    monkeypatch.setattr(turbo, "rule_based_scenes_turbo_batch", fake)
    scene = _scenes(1, seed=37)[0]
    with InferenceEngine(method="rule_based", cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=1, buckets=(1,)),
                         device=DEV) as eng:
        got = eng.classify(scene, timeout=WAIT)
        st = eng.stats()
    assert st["rule_overflow_reroutes"] == 1
    lut, _, hist = build_stretch_stats(scene, GAINS, BIASES)
    pre = lut.astype(np.uint8)[np.arange(7)[:, None, None], scene]
    want = rule_based_large_scene(pre, cfg=SMALL_CFG,
                                  hists=hist.astype(np.int64), device=DEV)
    np.testing.assert_array_equal(got, want)
    assert got.any()   # the corrupted all-zeros map did NOT leak through


def test_kmeans_warm_start_requires_shared_fit():
    with pytest.raises(ValueError, match="kmeans_shared_fit"):
        EngineConfig(kmeans_warm_start=True)


def test_kmeans_warm_start_engine():
    """kmeans_warm_start: the second dispatched batch's shared fit starts
    from the first batch's converged centroids — bit-matching a direct
    warm chain through kmeans_scenes_turbo_batch(init_cents=...)."""
    scenes = _scenes(2, seed=41)
    ecfg = EngineConfig(max_batch=2, batch_window_ms=2000.0, buckets=(2,),
                        kmeans_shared_fit=True, kmeans_warm_start=True)
    with InferenceEngine(method="kmeans", n_clusters=4, cfg=SMALL_CFG,
                         engine_cfg=ecfg, device=DEV) as eng:
        futs = [eng.submit(s) for s in scenes]
        outs1 = [f.result(timeout=WAIT) for f in futs]
        futs = [eng.submit(s) for s in scenes]      # same scenes again
        outs2 = [f.result(timeout=WAIT) for f in futs]
        st = eng.stats()
    assert st["batches"] == 2
    assert ["kmeans", 2, [7, H, W], "warm_start"] in st["warm_programs"]
    batch, luts, sps, hists = _stats_batch(scenes)
    kw = dict(n_clusters=4, cfg=SMALL_CFG, fit_stride=ecfg.kmeans_fit_stride,
              stretch_params=sps, stretch_hists=hists, shared_fit=True,
              return_cents=True, device=DEV)
    maps1, cents1 = turbo.kmeans_scenes_turbo_batch(batch, luts, **kw)
    maps2, _ = turbo.kmeans_scenes_turbo_batch(batch, luts, **kw,
                                               init_cents=cents1)
    for i in range(2):
        np.testing.assert_array_equal(outs1[i], maps1[i].numpy())
        np.testing.assert_array_equal(outs2[i], maps2[i].numpy())


def test_kmeans_per_scene_program_routing():
    """The default (per-scene-fit) kmeans route dispatches every scene
    through the single-scene program whatever the arrival batch size:
    (a) responses to a coalesced burst bit-match individually submitted
    ones; (b) only the bucket-1 kmeans program exists afterwards."""
    scenes = _scenes(3, seed=41)
    ecfg = EngineConfig(max_batch=4, batch_window_ms=2000.0, buckets=(4,))
    with InferenceEngine(method="kmeans", n_clusters=4, cfg=SMALL_CFG,
                         engine_cfg=ecfg, device=DEV) as eng:
        futs = [eng.submit(s) for s in scenes]
        outs = [f.result(timeout=WAIT) for f in futs]
        assert eng.stats()["batches"] == 1          # one coalesced flush
        singles = [eng.classify(s, timeout=WAIT) for s in scenes]
        progs = {(w[0], w[1]) for w in eng.stats()["warm_programs"]}
    for got, ref in zip(outs, singles):
        np.testing.assert_array_equal(got, ref)
    assert progs == {("kmeans", 1)}


# --------------------------------------------- padding, threads, fallback

@pytest.mark.parametrize("method", ["random_forest", "rule_based"])
def test_every_bucket_is_exact(forest, method):
    """Scene i's map is the same alone (bucket 1), in a padded bucket
    (3 -> 4) and in a full bucket (4), bit for bit."""
    f, depth, _ = forest
    scenes = _scenes(4, seed=90)
    with InferenceEngine(f, depth, cfg=SMALL_CFG, method=method,
                         engine_cfg=EngineConfig(max_batch=4,
                                                 batch_window_ms=500.0,
                                                 buckets=(1, 2, 4)),
                         device=DEV) as eng:
        alone = [eng.classify(s, timeout=WAIT) for s in scenes]
        padded = [fu.result(timeout=WAIT)
                  for fu in [eng.submit(s) for s in scenes[:3]]]
        full = [fu.result(timeout=WAIT)
                for fu in [eng.submit(s) for s in scenes]]
        st = eng.stats()
    assert st["batch_sizes"] == {1: 4, 3: 1, 4: 1}
    assert st["padded_scenes"] == 1
    for i in range(4):
        if i < 3:
            np.testing.assert_array_equal(padded[i], alone[i])
        np.testing.assert_array_equal(full[i], alone[i])


def test_warmup_while_serving(forest):
    """warmup runs batches in the caller's thread while the dispatch
    thread serves: both threads share the programs, the kernel libraries
    and the forest cache; every served map stays exact."""
    f, depth, _ = forest
    scenes = _scenes(6, seed=95)
    refs = [_direct(s, forest) for s in scenes]
    with InferenceEngine(f, depth, cfg=SMALL_CFG, n_clusters=4,
                         engine_cfg=EngineConfig(max_batch=2,
                                                 batch_window_ms=1.0,
                                                 buckets=(1, 2)),
                         device=DEV) as eng:
        with cf.ThreadPoolExecutor(max_workers=3) as pool:
            futs = [pool.submit(eng.classify, s, WAIT) for s in scenes]
            eng.warmup([(H, W)], methods=eng.available_methods())
            outs = [fu.result(timeout=WAIT) for fu in futs]
        st = eng.stats()
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert st["errors"] == 0 and st["requests"] == 6


@pytest.fixture(scope="module")
def deep_forest():
    """Five complete depth-12 trees (20 480 leaves, past GEMM_MAX_LEAVES)
    over a stretched scene's stack: ``(port FlatForest, depth, JAX
    FlatForest, fields)``, the same arrays in both packages."""
    scene = _scenes(1, seed=99)[0]
    pre = apply_u8_lut(torch.from_numpy(scene), torch.from_numpy(_lut(scene)))
    stack = hierarchical_stack_fused(pre.float(), SMALL_CFG, device=DEV)
    fields = deep_forest_fields(stack.permute(2, 0, 1).numpy())
    tflat = tforest.flat_forest_from_numpy(fields)
    assert tforest.n_leaves(tflat) > tforest.GEMM_MAX_LEAVES
    jflat = jforest.FlatForest(*(jnp.asarray(fields[k])
                                 for k in jforest.FlatForest._fields))
    return tflat, 12, jflat, fields


def _fallback_direct(scene, forest):
    """The port's supervised program on the scene alone (B = 1) with a
    forest past the cap, and the plain walk of ``tests/forest_walk_ref.py``
    over that program's own stack: ``(map, walked map)``."""
    got = _direct(scene, forest)
    stack = turbo.hierarchical_stack_turbo_cm(scene, _lut(scene), SMALL_CFG,
                                              device=DEV)
    walked = walk_labels(forest[3], stack.reshape(19, -1).T)
    return got, walked.reshape(H, W).numpy().astype(np.uint8)


@pytest.fixture(scope="module")
def fallback_maps(deep_forest):
    """Two scenes through an engine holding the deep forest, coalesced:
    ``(scenes, maps, stats)``."""
    f, depth, _, _ = deep_forest
    scenes = _scenes(2, seed=97)
    with InferenceEngine(f, depth, cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=4,
                                                 batch_window_ms=500.0,
                                                 buckets=(1, 2, 4)),
                         device=DEV) as eng:
        maps = [fu.result(timeout=WAIT)
                for fu in [eng.submit(s) for s in scenes]]
        st = eng.stats()
    return scenes, maps, st


def test_forest_fallback_past_leaf_cap_exact(deep_forest, fallback_maps):
    """Past GEMM_MAX_LEAVES the engine keeps the batched supervised
    program (its GEMM form's path sparse): each map bit-equal to the
    port's direct program at B = 1 and to the plain walk over that
    program's stack."""
    scenes, maps, st = fallback_maps
    assert st["gemm_forest"] is True
    assert tforest._gemm_for(deep_forest[0], 19).path.is_sparse
    assert st["batch_sizes"] == {2: 1} and st["padded_scenes"] == 0
    for s, m in zip(scenes, maps):
        got, walked = _fallback_direct(s, deep_forest)
        np.testing.assert_array_equal(m, got)
        np.testing.assert_array_equal(m, walked)
        assert len(np.unique(m)) > 1


def test_forest_fallback_matches_jax(deep_forest, fallback_maps):
    """The deep forest's maps against JAX's hierarchical_stack_fused +
    forest_predict on the same forest arrays: >= 99.9 % (the reference's
    map contract; the stacks agree to about 1e-6, and no threshold sits
    on a pixel's value). JAX's forest_predict takes the level traversal
    under jit, where the forest is traced, as it does past the cap."""
    scenes, maps, _ = fallback_maps
    _, depth, jflat, _ = deep_forest
    predict = jax.jit(lambda f, x: jforest.forest_predict(f, x, depth))
    for s, m in zip(scenes, maps):
        pre = _lut(s)[np.arange(7)[:, None, None], s]
        stack = jfeatures.hierarchical_stack_fused(
            jnp.asarray(pre, jnp.float32), JSMALL_CFG)
        want = np.asarray(predict(jflat, stack.reshape(-1, 19))).reshape(H, W)
        assert float(np.mean(m == want)) >= 0.999


# ------------------------------------------------- against the JAX package

def test_supervised_engine_matches_jax(engine, forest):
    """Engine maps (coalesced and padded 3 -> 4) against JAX's direct
    supervised program on each scene: >= 99.9 % (the reference's
    contract, ``turbo.py:32-35``)."""
    _, _, jflat = forest
    jgf = jforest._gemm_for(jflat, 19)
    scenes = _scenes(3, seed=5)
    maps = [fu.result(timeout=WAIT)
            for fu in [engine.submit(s) for s in scenes]]
    for s, m in zip(scenes, maps):
        want = np.asarray(jturbo.classify_scenes_turbo(
            jnp.asarray(s[None]), jnp.asarray(_lut(s)[None]), jgf,
            JSMALL_CFG)[0])
        assert float(np.mean(m == want)) >= 0.999


def test_rule_engine_matches_jax_bit_for_bit():
    """Engine rule maps (coalesced, padded 3 -> 4) equal JAX's
    single-scene rule program bit for bit."""
    scenes = _scenes(3, seed=6)
    with InferenceEngine(method="rule_based", cfg=SMALL_CFG,
                         engine_cfg=EngineConfig(max_batch=4,
                                                 batch_window_ms=500.0,
                                                 buckets=(1, 2, 4)),
                         device=DEV) as eng:
        maps = [fu.result(timeout=WAIT)
                for fu in [eng.submit(s) for s in scenes]]
        assert eng.stats()["padded_scenes"] == 1
    for s, m in zip(scenes, maps):
        want = np.asarray(jturbo.rule_based_scenes_turbo(
            jnp.asarray(s), jnp.asarray(_lut(s)), cfg=JSMALL_CFG))
        np.testing.assert_array_equal(m, want)


def test_warmup_over_http(server, engine):
    """POST /warmup builds the named programs in the handler's thread."""
    out = client.warmup(server, [(H, W)], buckets=[1], timeout=WAIT)
    assert out == {"warmed": [[H, W]]}
    assert ["random_forest", 1, [7, H, W]] in engine.stats()["warm_programs"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        client.warmup(server, [(4, 4)], timeout=WAIT)
    assert ei.value.code == 400
    assert json.loads(ei.value.read())["error"].startswith("scene 4x4")
