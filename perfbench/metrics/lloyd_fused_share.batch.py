"""The share of traced KMeans fits whose Lloyd loop ran the fused kernels,
in %: the ``kmeans.lloyd`` spans whose count ``fused`` is 1, over every
``kmeans.lloyd`` span of the traced span. None where no span carries the
count (a program without the kernels)."""

from perfbench.harness.program_spans import session


def read(rec):
    recs = session()
    if not recs:
        return None
    loops = [r for r in recs if r.name == "kmeans.lloyd"]
    if not any("fused" in r.counts for r in loops):
        return None
    fused = sum(r.counts.get("fused") == 1 for r in loops)
    return 100.0 * fused / len(loops)
