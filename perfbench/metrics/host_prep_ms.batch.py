"""Host ms per batch to build the stretch tables (``build_stretch_lut`` for
the forest batch, ``build_stretch_stats`` for the rule batch): the
benchmark's host-clock span ``host_prep`` around those calls, mean over
the window."""


def read(rec):
    s = rec["spans"].get("host_prep")
    return 1e3 * s["total_s"] / s["count"] if s and s["count"] else None
