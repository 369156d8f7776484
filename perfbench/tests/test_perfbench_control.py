"""The control fails the comparison: the reference with its stack (or rule
indices) stored in bfloat16, in the program's place, comes out not
correct from the comparison that decides a run's ``correct``: on the card
at the cells' own sizes on three seeds, and on the CPU at 96 x 96."""

import pytest
import torch

from perfbench import control
from perfbench.harness import manifest

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load_benchmark()["workloads"]])
def test_control_fails_the_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = SEEDS[:1] if "6000" in cell else SEEDS
    for seed in seeds:
        r = control.readings(cell, seed, torch.device("cuda"))
        assert r["correct"] is False, r
        worst = r["numbers"]["worst_mismatch_share"]
        assert worst["value"] > worst["limit"], r


@pytest.mark.parametrize("cell", ["tile600-rf-batch", "tile600-rule-batch"])
def test_control_fails_the_comparison_on_the_cpu(small, cell):
    r = control.readings(cell, 2 ** 31 + 7, torch.device("cpu"))
    assert r["correct"] is False and r["compared"] == 16, r
    worst = r["numbers"]["worst_mismatch_share"]
    assert worst["value"] > worst["limit"], r
