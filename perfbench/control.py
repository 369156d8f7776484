"""Readings of the control that the comparison deciding ``correct`` has to
reject: the configuration's reference (its ``reference`` file's
``METHODS`` entry for the traffic's method) put in the program's place
with its stack (or its rule indices) stored in bfloat16, the precision
below the configuration's float32 that a later change would be tempted by.

    python3 perfbench/control.py --workload CELL --seeds N [N ...]

For each seed it makes the cell's inputs exactly as a run's set-up does
(the traffic loop's ``inputs``), hands the control's map of every input to
the comparison that decides a run's ``correct`` (``harness/check.py``), as
if the program had answered so, and prints its result as a JSON line: the
numbers compared beside their limits, and ``correct``, which has to be
false. The benchmark's own runs never run this; ``PERF.md`` gives its readings
beside each limit. Needs a CUDA card (``--device`` for tests).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench.harness import check, manifest, setup  # noqa: E402
from perfbench.harness.trace import Tracer  # noqa: E402


def readings(workload: str, seed: int, device, cfg=None) -> dict:
    """The comparison's result (``harness/check.py::compare``) with the
    control's maps as the answers, one for each of the seed's inputs:
    ``{"workload", "seed", "correct", "numbers", "compared"}``."""
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, workload)
    cfg = cfg if cfg is not None else manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    ctx = setup.Context(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
                        seconds=0.0, dev=device, tracer=Tracer(False, 1.0))
    st = manifest.loop(traffic["loop"]).inputs(ctx)
    answers = [(key, check.reference_answer(ctx, scene, st["fields"],
                                            st["depth"],
                                            store_dtype=torch.bfloat16)[0])
               for key, scene in st["inputs"].items()]
    r = check.compare(ctx, answers, st["inputs"], 0, st["fields"],
                      st["depth"])
    return {"workload": workload, "seed": seed, "correct": r["correct"],
            "numbers": r["numbers"], "compared": r["compared"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("control: no CUDA card", file=sys.stderr)
            return 3
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(args.workload, seed, dev)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
