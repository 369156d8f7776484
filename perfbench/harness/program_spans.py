"""The program's own spans, read in-process after a traced run.

``rs_image_segmentation_tpu_torch.utils.timing.span`` records the phases of
the program while a ``torch.profiler`` session records, and ``spans()``
returns those of the newest session: with ``--trace 1``, the traced span
of the window (the set-up's warm profile is an older session). Each record
has ``name``, ``id``, ``parent``, ``root``, ``start``, ``end`` (host
``perf_counter`` seconds) and ``counts``. A program that has no spans, or
recorded none, reads as None, and so does every metric over it.

The arithmetic is the benchmark's own: a span's self time is its duration
less the union of its children's intervals (``trace.merge``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from perfbench.harness.trace import merge


def session() -> Optional[list]:
    """The newest profiled session's closed spans, or None."""
    try:
        from rs_image_segmentation_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "spans", None)
    recs = read() if read is not None else None
    return list(recs) if recs else None


def self_s(rec, recs: list) -> float:
    kids = [(max(r.start, rec.start), min(r.end, rec.end)) for r in recs
            if r.parent == rec.id]
    return (rec.end - rec.start) - sum(b - a for a, b in merge(kids)
                                       if b > a)


def ms_per(names: Iterable[str], unit: str, own: bool = False,
           recs: Optional[list] = None) -> Optional[float]:
    """Milliseconds of the spans named ``names`` per span named ``unit``
    (their self times with ``own``), or None when either is absent.
    ``recs``: the records (default: :func:`session`)."""
    recs = session() if recs is None else recs
    if not recs:
        return None
    names = set(names)
    units = sum(r.name == unit for r in recs)
    picked: List = [r for r in recs if r.name in names]
    if not units or not picked:
        return None
    total = sum(self_s(r, recs) if own else r.end - r.start for r in picked)
    return 1e3 * total / units
