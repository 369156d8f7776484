"""Host ms per batch launching a turbo program: the self time of the
program's span ``turbo.batch`` (its ``turbo.inputs`` and ``turbo.fetch``
children left out) per ``turbo.batch``, over the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["turbo.batch"], "turbo.batch", own=True)
