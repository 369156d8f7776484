"""Host ms per batch in the KMeans fits' Lloyd loop: the program's span
``kmeans.lloyd`` (one host sync an iteration, until the batch's slowest
tile converges) per ``turbo.batch``, over the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["kmeans.lloyd"], "turbo.batch")
