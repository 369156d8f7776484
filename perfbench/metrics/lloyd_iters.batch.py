"""Lloyd iterations per batch: the count ``iters`` of the program's
``kmeans.lloyd`` spans (the loop's iterations, each one host sync) per
``turbo.batch``, over the traced span. None where the program marks no
such span."""

from perfbench.harness.program_spans import session


def read(rec):
    recs = session()
    if not recs:
        return None
    units = sum(r.name == "turbo.batch" for r in recs)
    loops = [r for r in recs
             if r.name == "kmeans.lloyd" and "iters" in r.counts]
    if not units or not loops:
        return None
    return sum(r.counts["iters"] for r in loops) / units
