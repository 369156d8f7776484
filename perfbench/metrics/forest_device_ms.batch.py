"""Device ms of the forest kernel per call: the traced time of
``forest_labels``' kernels (``counts/forest_labels.py``) over the program's
``forest.labels`` spans in the traced span, one a batch. None where the
program marks no such span (an older checkout) or the trace holds no such
kernel."""

from perfbench.harness import manifest
from perfbench.harness.program_spans import session


def read(rec):
    tr = rec.get("trace")
    recs = session()
    if not tr or not recs:
        return None
    calls = sum(r.name == "forest.labels" for r in recs)
    names = manifest.counts("forest_labels").KERNELS
    t = sum(tr["kernels"][n]["total_s"] for n in names if n in tr["kernels"])
    if not calls or t <= 0:
        return None
    return 1e3 * t / calls
