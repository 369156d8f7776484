"""Host ms per batch counting the stretched histograms: the program's span
``stretch.hist`` inside ``build_stretch_stats`` per ``turbo.batch``, over
the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["stretch.hist"], "turbo.batch")
