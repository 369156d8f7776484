"""Host ms per batch in the stretch's fixed-point parameter search (with
its per-band min and max): the program's span ``stretch.params`` inside
``build_stretch_stats`` per ``turbo.batch``, over the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["stretch.params"], "turbo.batch")
