"""Host ms per streamed scene building its statistics: the program's span
``large.host_stats`` (``build_stretch_stats``, the LUT and params to the
device, ``compute_global_stats``) per ``large.streamed``, over the traced
span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["large.host_stats"], "large.streamed")
