"""Host ms per batch seeding the KMeans fits: the program's span
``kmeans.init`` (k-means++ of every tile of the batch, its Gumbel noise
drawn on the CPU) per ``turbo.batch``, over the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["kmeans.init"], "turbo.batch")
