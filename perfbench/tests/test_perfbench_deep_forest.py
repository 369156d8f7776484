"""``tile600-rf-deep-forest``, and ``tile600-rf-batch`` with a forest past
the port's leaf cap, on the CPU at 96 x 96 (the ``small`` fixture): each
forest fitted on 4 000 pixels (a 96 x 96 tile has fewer than the deep
configuration's 20 000), the cap lowered to 1 024. ``correct`` on a sound
run and false on an altered one, and a traced line that reads the forest
kernel's walk."""

import json

import pytest

from perfbench.tests.test_perfbench_run import _alter, run_cell

CELLS = ["tile600-rf-deep-forest", "tile600-rf-batch"]


@pytest.fixture
def deep_small(small, monkeypatch):
    from perfbench.harness import manifest
    from rs_image_segmentation_tpu_torch.models import forest

    def config(bench, name, root=manifest.ROOT):
        c = small(bench, name, root)
        c["forest"]["samples"] = 4000
        return c

    monkeypatch.setattr(manifest, "config", config)
    monkeypatch.setattr(forest, "GEMM_MAX_LEAVES", 1024)


@pytest.mark.parametrize("cell", CELLS)
def test_past_the_cap_is_correct(deep_small, cell):
    out, lines = run_cell(cell, trace=1, seconds=2.0)
    assert out["correct"] is True and out["failed"] == 0
    notes, = [json.loads(m.split(" ", 2)[2]) for to_err, m in lines
              if to_err and m.startswith("perfbench: notes")]
    assert notes["forest_leaves"] > 1024
    walk = out["metrics"]["forest_walk_efficiency"]["value"]
    assert 0 < walk <= 100
    # no device kernel on the CPU: the device-trace readers read nothing
    assert "forest_device_ms.batch" not in out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_past_the_cap_altered_is_not_correct(deep_small, monkeypatch,
                                              cell):
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    inner = turbo.classify_scenes_turbo
    monkeypatch.setattr(turbo, "classify_scenes_turbo",
                        lambda *a, **k: _alter(inner(*a, **k)))
    out, _ = run_cell(cell)
    assert out["correct"] is False
    assert isinstance(out["metrics"]["mp_per_s"]["value"], float)
