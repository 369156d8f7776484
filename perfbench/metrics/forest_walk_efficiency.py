"""The share of the forest kernel's walk that decides, in %: the node
comparisons the pixels need (one per level reached in each tree, counted
by the reference's walk: the cell's ``forest_labels`` calls in ``work``)
over the pixel-steps of the kernel's fixed-depth walk (count
``walk_steps`` of the program's ``forest.labels`` spans, each tree padded
to its group's depth). None where the program marks no such span."""

from perfbench.harness.program_spans import session


def read(rec):
    calls = rec.get("work", {}).get("calls", {}).get("forest_labels")
    recs = session()
    if not calls or not recs:
        return None
    marks = [r for r in recs
             if r.name == "forest.labels" and r.counts.get("walk_steps")]
    if not marks:
        return None
    per_pixel = (sum(c["comparisons"] for c in calls)
                 / sum(c["pixels"] for c in calls))
    pixels = sum(r.counts["pixels"] for r in marks)
    steps = sum(r.counts["walk_steps"] for r in marks)
    return 100.0 * per_pixel * pixels / steps
