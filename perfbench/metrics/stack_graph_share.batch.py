"""The share of traced batches whose stack ran as CUDA graph replays, in %:
the ``turbo.batch`` spans whose count ``stack_graph`` is 1, over every
``turbo.batch`` span of the traced span. None where no span carries the
count (a program without the graphs)."""

from perfbench.harness.program_spans import session


def read(rec):
    recs = session()
    if not recs:
        return None
    batches = [r for r in recs if r.name == "turbo.batch"]
    if not any("stack_graph" in r.counts for r in batches):
        return None
    replayed = sum(r.counts.get("stack_graph") == 1 for r in batches)
    return 100.0 * replayed / len(batches)
