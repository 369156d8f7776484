"""A method brought as files alone: a plain reference and a configuration
written outside ``perfbench/`` add the made-up method ``constant``, which
the comparison that decides ``correct`` (``harness/check.py``) and the
control (``perfbench/control.py``) decide on through the configuration's
``reference`` file, with no edit to any file under ``perfbench/``."""

import json

import numpy as np
import pytest
import torch

from perfbench import control
from perfbench.harness import check, manifest, setup
from perfbench.harness.trace import Tracer

CPU = torch.device("cpu")
SIDE = 48
CELL, CONFIG, MIX = "tile-constant", "tm-tile-constant", "constant-batch2"

# Every pixel class 1 at five operations a pixel; in the control's lower
# precision the first row turns to class 2 (1 / SIDE of a tile).
REFERENCE = '''
import numpy as np


def constant(scene, cfg, fields, depth, device, store_dtype=None):
    labels = np.ones(scene.shape[1:], np.int64)
    if store_dtype is not None:
        labels[0] = 2
    return labels, 5 * labels.size


METHODS = {"constant": constant}
'''

TRAFFIC = {"loop": "batch_loop", "method": "constant", "batch": 2,
           "pool": 4, "keep_share": 1.0,
           "limits": {"worst_mismatch_share": 0.01}}


@pytest.fixture
def constant_cell(tmp_path, monkeypatch):
    """The cell ``tile-constant``: a configuration naming the reference
    above by its absolute path, and a traffic mix of that method, both
    under ``tmp_path``, entered in the benchmark as it is loaded."""
    ref = tmp_path / "constant_reference.py"
    ref.write_text(REFERENCE)
    cfg = json.loads(
        (manifest.PERFBENCH / "configs" / "tm-tile-600.json").read_text())
    cfg.update(name=CONFIG, reference=str(ref),
               tile={"height": SIDE, "width": SIDE})
    cfg["scene"].update(height=SIDE, width=SIDE)
    cfg_file = tmp_path / f"{CONFIG}.json"
    cfg_file.write_text(json.dumps(cfg))
    orig_load, orig_traffic = manifest.load_benchmark, manifest.traffic

    def load(root=manifest.ROOT):
        b = orig_load(root)
        b["configs"].append({"name": CONFIG, "source": "a test",
                             "file": str(cfg_file), "reduced": [],
                             "why": "the made-up method constant"})
        b["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": MIX, "chips": 1,
                               "why": "the made-up method constant"})
        return b

    def traffic(name):
        return dict(TRAFFIC) if name == MIX else orig_traffic(name)

    monkeypatch.setattr(manifest, "load_benchmark", load)
    monkeypatch.setattr(manifest, "traffic", traffic)
    return ref


def _ctx(method="constant"):
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, CELL)
    traffic = dict(manifest.traffic(cell["traffic"]), method=method)
    return setup.Context(cell=cell, cfg=manifest.config(bench, CONFIG),
                         traffic=traffic, seed=2 ** 31 + 7, seconds=0.0,
                         dev=CPU, tracer=Tracer(False, 1.0))


def _inputs():
    rng = np.random.default_rng(3)
    return {k: rng.integers(0, 256, (7, SIDE, SIDE), dtype=np.uint8)
            for k in range(3)}


def test_equal_answers_are_correct(constant_cell):
    inputs = _inputs()
    answers = [(k, np.ones((SIDE, SIDE), np.uint8)) for k in inputs]
    r = check.compare(_ctx(), answers, inputs, 0, None, 0)
    assert r["correct"] is True and r["compared"] == 3
    assert r["ops_per_pixel"] == 5.0
    assert r["numbers"]["worst_mismatch_share"]["value"] == 0.0


def test_answers_altered_beyond_the_limit_are_not_correct(constant_cell):
    inputs = _inputs()
    answers = [(k, np.ones((SIDE, SIDE), np.uint8)) for k in inputs]
    answers[1][1][:2] = 3                 # two rows of one answer
    r = check.compare(_ctx(), answers, inputs, 0, None, 0)
    assert r["correct"] is False
    assert r["numbers"]["worst_mismatch_share"]["value"] == 2 / SIDE
    # the control: the reference in lower precision in the program's place
    c = control.readings(CELL, 2 ** 31 + 7, CPU)
    assert c["correct"] is False and c["compared"] == TRAFFIC["pool"], c
    worst = c["numbers"]["worst_mismatch_share"]
    assert worst["value"] == 1 / SIDE > worst["limit"], c


def test_unknown_method_names_the_reference_file(constant_cell):
    with pytest.raises(SystemExit, match=r"constant_reference\.py") as e:
        check.compare(_ctx("nonesuch"), [], {}, 0, None, 0)
    assert "'nonesuch'" in str(e.value) and "constant" in str(e.value)
