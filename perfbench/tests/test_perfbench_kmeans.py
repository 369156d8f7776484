"""``tile600-kmeans-batch`` on the CPU at a tiny pool (the ``small``
fixture's 96 x 96 tiles, two batches of four): a sound run is ``correct``
and a traced one reads the KMeans spans, one tile's map altered is not
``correct``, two run seeds make the same fixed scene, and the three
KMeans readers on a made-up session."""

import pytest

from perfbench.harness import manifest, setup
from perfbench.harness.trace import Tracer
from perfbench.tests.test_perfbench_run import CPU, _alter, run_cell

CELL = "tile600-kmeans-batch"
TINY = ("--set", "batch=4", "--set", "pool=8")


def test_sound_run_is_correct_and_reads_the_fit(small):
    out, _ = run_cell(CELL, trace=1, seconds=2.0, extra=TINY)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    m = out["metrics"]
    assert m["lloyd_iters.batch"]["value"] >= 1
    for name in ("kmeans_init_ms.batch", "kmeans_lloyd_ms.batch",
                 "inputs_ms.batch", "launch_ms.batch", "host_prep_ms.batch",
                 "step_mfu.batch"):
        assert m[name]["value"] > 0, name
    # no device kernel on the CPU: the device-trace readers read nothing
    assert "lut_hist_roofline" not in m


def test_one_tile_altered_is_not_correct(small, monkeypatch):
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    real = turbo.kmeans_scenes_turbo_batch
    monkeypatch.setattr(turbo, "kmeans_scenes_turbo_batch",
                        lambda *a, **k: _alter(real(*a, **k)))
    out, _ = run_cell(CELL, extra=TINY)
    assert out["correct"] is False
    worst = out["checks"]["worst_mismatch_share"]
    assert worst["value"] > worst["limit"]


def test_run_seeds_make_the_same_scene(small):
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, CELL)
    traffic = dict(manifest.traffic(cell["traffic"]), pool=4)
    pools = []
    for seed in (2 ** 31 + 7, 2 ** 33 + 5):
        ctx = setup.Context(cell=cell, cfg=manifest.config(bench,
                                                           cell["config"]),
                            traffic=traffic, seed=seed, seconds=0.0,
                            dev=CPU, tracer=Tracer(False, 1.0))
        pools.append(manifest.loop(traffic["loop"]).inputs(ctx)["pool"])
    assert pools[0].shape == (4, 7, 96, 96)
    assert pools[0].tobytes() == pools[1].tobytes()


def _session():
    """Two KMeans batches: k-means++ 5 and 7 ms, Lloyd 40 and 60 ms over
    30 and 50 iterations."""
    from rs_image_segmentation_tpu_torch.utils.timing import SpanRecord
    recs = []
    for k, (t, init, lloyd, iters) in enumerate(((0.0, 0.005, 0.040, 30),
                                                 (1.0, 0.007, 0.060, 50))):
        b = SpanRecord("turbo.batch", 10 * k + 1, None, 10 * k + 1, 0, {},
                       t, t + 0.5)
        recs += [b,
                 SpanRecord("kmeans.init", 10 * k + 2, b.id, b.id, 0,
                            {"picks": 7}, t + 0.1, t + 0.1 + init),
                 SpanRecord("kmeans.lloyd", 10 * k + 3, b.id, b.id, 0,
                            {"problems": 8, "iters": iters}, t + 0.2,
                            t + 0.2 + lloyd)]
    return recs


@pytest.mark.parametrize("name, want", [("kmeans_init_ms.batch", 6.0),
                                        ("kmeans_lloyd_ms.batch", 50.0),
                                        ("lloyd_iters.batch", 40.0)])
def test_readers_on_a_made_up_session(monkeypatch, name, want):
    from rs_image_segmentation_tpu_torch.utils import timing
    recs = _session()
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    reader = manifest.metric_reader(name)
    assert reader.read({}) == pytest.approx(want)
    # a program without the fit's spans (the forest batch) reads nothing
    monkeypatch.setattr(timing, "spans", lambda: [
        r for r in recs if not r.name.startswith("kmeans.")])
    assert reader.read({}) is None
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert reader.read({}) is None
    monkeypatch.delattr(timing, "spans")        # an older checkout
    assert reader.read({}) is None


def test_cell_declares_the_kmeans_metrics():
    bench = manifest.load_benchmark()
    names = {m["name"] for m in manifest.per_layer(bench, CELL)}
    assert {"kmeans_init_ms.batch", "kmeans_lloyd_ms.batch",
            "lloyd_iters.batch", "lut_hist_roofline", "step_mfu.batch",
            "device_idle_share.mp"} <= names
    assert [m["name"] for m in manifest.end_to_end(bench, CELL)] == [
        "mp_per_s", "setup_s"]
