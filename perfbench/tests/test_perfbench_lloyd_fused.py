"""``lloyd_fused_share.batch`` in ``tile600-kmeans-batch``: the cell declares
it, a traced CPU run reads 0 (the CPU's fit runs the plain loop), and its
reader on a made-up session, with and without the count ``fused``."""

import pytest

from perfbench.harness import manifest
from perfbench.tests.test_perfbench_kmeans import CELL, TINY, _session
from perfbench.tests.test_perfbench_run import run_cell

NAME = "lloyd_fused_share.batch"


def test_cell_declares_the_fused_share():
    bench = manifest.load_benchmark()
    metric = {m["name"]: m for m in manifest.per_layer(bench, CELL)}[NAME]
    assert (metric["unit"], metric["better"], metric["moves"]) == (
        "%", "higher", "mp_per_s")
    assert metric["layer"] == "KMeans fit"


def test_cpu_run_reads_the_plain_loop(small):
    out, _ = run_cell(CELL, trace=1, seconds=2.0, extra=TINY)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"][NAME]["value"] == 0


def _fused_session():
    """``_session``'s two batches, the first on the fused loop, the second
    not."""
    recs = _session()
    for r in recs:
        if r.name == "kmeans.lloyd":
            r.counts["fused"] = int(r.start < 1.0)
    return recs


def test_reader_on_a_made_up_session(monkeypatch):
    from rs_image_segmentation_tpu_torch.utils import timing
    recs = _fused_session()
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    reader = manifest.metric_reader(NAME)
    assert reader.read({}) == pytest.approx(50.0)
    # a program whose Lloyd span has no count ``fused`` reads nothing
    monkeypatch.setattr(timing, "spans", lambda: _session())
    assert reader.read({}) is None
    # nor does one without the fit's spans (the forest batch)
    monkeypatch.setattr(timing, "spans", lambda: [
        r for r in recs if not r.name.startswith("kmeans.")])
    assert reader.read({}) is None
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert reader.read({}) is None
    monkeypatch.delattr(timing, "spans")        # an older checkout
    assert reader.read({}) is None
