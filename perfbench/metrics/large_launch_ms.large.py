"""Host ms per streamed scene in passes B/C and D outside their blocking
fetches: the self time of the program's spans ``large.pass_bc`` and
``large.pass_d`` (their ``large.fetch`` children left out) per
``large.streamed``, over the traced span."""

from perfbench.harness.program_spans import ms_per


def read(rec):
    return ms_per(["large.pass_bc", "large.pass_d"], "large.streamed",
                  own=True)
