"""Whole runs on the CPU at 96 x 96 (the ``small`` fixture), past the look
for a card: the result line's keys, and ``correct`` coming out false when
the timed path is broken underneath, once for each fault a cell can have
(a half batch left out, an answer altered where it is produced, a step
that hands back its previous output)."""

import json

import numpy as np
import pytest
import torch

from perfbench import run as runner

CPU = torch.device("cpu")


def run_cell(cell, trace=0, seconds=1.0, extra=()):
    lines = []

    def emit(msg, file=None):
        lines.append((file is not None, msg))

    out = runner.run(["--workload", cell, "--seed", str(2 ** 31 + 7),
                      "--seconds", str(seconds), "--trace", str(trace),
                      *extra], device=CPU, emit=emit)
    return out, lines


SERVE = ("--set", "rate_rps=12", "--set", "connections=4", "--set",
         "warm=4", "--set", "grace_s=30")

# The serving loop's cell, kept out of BENCHMARK.json until its tails hold
# a bound (PERF.md, open questions): its traffic file, loop and readers
# stay, and the tests run it as this entry.
SERVING_CELL = {"name": "tile600-rf-serve", "config": "tm-tile-600",
                "traffic": "rf-poisson", "chips": 1,
                "why": "open loop of Poisson forest requests over HTTP"}
SERVING_METRICS = [
    {"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": ["tile600-rf-serve"]}
    for n in ("latency_p95_ms", "latency_p50_ms")]


@pytest.fixture
def serving_cell(monkeypatch):
    from perfbench.harness import manifest
    orig = manifest.load_benchmark

    def load(root=manifest.ROOT):
        b = orig(root)
        b["workloads"].append(dict(SERVING_CELL))
        b["end_to_end"][:0] = [dict(m) for m in SERVING_METRICS]
        return b

    monkeypatch.setattr(manifest, "load_benchmark", load)


def test_result_line_keys(small):
    out, lines = run_cell("tile600-rf-batch")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"mp_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert json.loads(lines[-1][1]) == out and not lines[-1][0]
    # the numbers compared are the last lines on standard error
    err = [m for to_err, m in lines if to_err]
    assert err[-2].startswith("perfbench: check worst_mismatch_share")
    assert err[-1].startswith("perfbench: check missing_answers")
    assert any(m.startswith("perfbench: setup_parts_s") for m in err)


def test_traced_result_line(small):
    out, _ = run_cell("tile600-rule-batch", trace=1, seconds=2.0)
    assert out["correct"] is True
    assert "host_prep_ms.batch" in out["metrics"]
    assert "mp_per_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())


def _alter(maps):
    """Another class on every pixel of the first answer."""
    maps = maps.clone() if isinstance(maps, torch.Tensor) else maps.copy()
    maps[0] = maps[0] % 4 + 1
    return maps


def _half(maps):
    """The second half of the batch left out (no class written)."""
    maps = maps.clone()
    maps[maps.shape[0] // 2:] = 0
    return maps


def _stale(fn):
    """A step that hands back its first output ever after."""
    first = []

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    return wrapped


@pytest.mark.parametrize("fault", ["half", "alter", "stale"])
def test_forest_batch_faults_are_not_correct(small, monkeypatch, fault):
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    real = turbo.classify_scenes_turbo
    broken = {"half": lambda *a, **k: _half(real(*a, **k)),
              "alter": lambda *a, **k: _alter(real(*a, **k)),
              "stale": _stale(real)}[fault]
    monkeypatch.setattr(turbo, "classify_scenes_turbo", broken)
    out, _ = run_cell("tile600-rf-batch")
    assert out["correct"] is False
    assert out["checks"]["worst_mismatch_share"]["value"] > \
        out["checks"]["worst_mismatch_share"]["limit"]


@pytest.mark.parametrize("fault", ["half", "alter"])
def test_rule_batch_faults_are_not_correct(small, monkeypatch, fault):
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    real = turbo.rule_based_scenes_turbo_batch
    f = {"half": _half, "alter": _alter}[fault]

    def broken(*a, **k):
        maps, overflow = real(*a, **k)
        return f(maps), overflow

    monkeypatch.setattr(turbo, "rule_based_scenes_turbo_batch", broken)
    out, _ = run_cell("tile600-rule-batch")
    assert out["correct"] is False


def test_stream_fault_is_not_correct(small, monkeypatch):
    from rs_image_segmentation_tpu_torch.pipeline import large_scene
    real = large_scene.classify_large_scene_streamed

    def broken(*a, **k):
        out = real(*a, **k)
        out[:out.shape[0] // 2] = out[:out.shape[0] // 2] % 4 + 1
        return out

    monkeypatch.setattr(large_scene, "classify_large_scene_streamed", broken)
    out, _ = run_cell("scene6000-rf-stream")
    assert out["correct"] is False


def test_serving_sound_and_altered(small, serving_cell, monkeypatch):
    out, _ = run_cell("tile600-rf-serve", extra=SERVE)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"latency_p95_ms", "latency_p50_ms",
                                   "setup_s"}
    from rs_image_segmentation_tpu_torch.serving import engine
    real = engine.InferenceEngine._run_batch

    def broken(self, scenes, *a, **k):
        maps = real(self, scenes, *a, **k)
        return [m % 4 + 1 for m in maps]

    monkeypatch.setattr(engine.InferenceEngine, "_run_batch", broken)
    out, _ = run_cell("tile600-rf-serve", extra=SERVE)
    assert out["correct"] is False


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        runner.run(["--workload", "tile600-rf-batch", "--seed", "1",
                    "--seconds", "1", "--trace", "0"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""
