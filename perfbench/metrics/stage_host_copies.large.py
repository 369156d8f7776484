"""Host copies of each raw byte a streamed scene stages for the card, in x:
the count ``host_copy_bytes`` of the program's ``stretch.hist`` spans (the
bytes its host-to-device stager copied on the host while the scene's raw
chunks went up) over the count ``bytes`` of the ``large.host_stats`` span
around each (the raw bytes counted on the card), summed over the traced
span. None where no span carries the count (a program that does not count
its staging)."""

from perfbench.harness.program_spans import session


def read(rec):
    recs = session()
    if not recs:
        return None
    by_id = {r.id: r for r in recs}
    pairs = [(r.counts["host_copy_bytes"], by_id[r.parent].counts["bytes"])
             for r in recs
             if r.name == "stretch.hist" and "host_copy_bytes" in r.counts
             and r.parent in by_id
             and by_id[r.parent].name == "large.host_stats"]
    scene_bytes = sum(b for _, b in pairs)
    if not scene_bytes:
        return None
    return sum(c for c, _ in pairs) / scene_bytes
