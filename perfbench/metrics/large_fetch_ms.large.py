"""Host ms per streamed scene blocked in device-to-host copies: the
program's ``large.fetch`` spans (pass B/C's sums and grids, pass D's
label tiles) per ``large.streamed``, over the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["large.fetch"], "large.streamed")
