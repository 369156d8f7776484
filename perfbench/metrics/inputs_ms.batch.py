"""Host ms per batch putting a turbo program's inputs on the card: the
program's span ``turbo.inputs`` per ``turbo.batch``, over the traced
span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["turbo.inputs"], "turbo.batch")
