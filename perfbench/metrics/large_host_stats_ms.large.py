"""Host ms per streamed scene building its statistics: the program's span
``large.host_stats`` (the scene's 12 raw row chunks staged through pinned
memory and counted on the card, ``raw_counts``, under ``stretch.hist``;
one fetch of the counts; the stretch table (sent to the card), the
stretched histograms and the global statistics derived from them on the
host) per ``large.streamed``, over the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["large.host_stats"], "large.streamed")
