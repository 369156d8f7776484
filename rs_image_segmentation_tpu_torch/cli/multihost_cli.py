"""``rs-seg-torch-multihost-rehearse``: run the multi-process path locally.

Counterpart of ``rs_image_segmentation_tpu.cli.multihost_cli``. Spawns N
real ranks (``parallel.multihost_worker``), one device each, forms the
N-rank global mesh, classifies a scene batch sharded across all of them
(two scenes a rank), and checks bit-equality with the one-process
program. ``--device``: the
CUDA card by default, ``cpu`` on request. ``--backend``: ``nccl`` (one
rank a card) or ``gloo`` (the CPU, or several ranks on one card); the
default is NCCL on CUDA and gloo on the CPU. The ranks meet through a
``file://`` store in a fresh temporary directory. Exit codes are the JAX
CLI's: 0 when every rank passed, the first failing rank's code (1 if it
was killed by a signal), 2 when the shared deadline passed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

SCENES_PER_RANK = 2     # each rank's local batch (uneven: 3 and 1)


def multihost_rehearse_cli(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Local multi-process rehearsal over torch.distributed")
    p.add_argument("--nproc", type=int, default=2,
                   help="ranks to spawn, one device each")
    p.add_argument("--mode", default="even", choices=("even", "uneven"),
                   help="uneven: rank 0 feeds one more scene, rank 1 one "
                        "fewer (the pad_to path)")
    p.add_argument("--device", default=None,
                   help="torch device kind (default: the CUDA card)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on CUDA, gloo on the CPU")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="overall wall-clock budget for the whole run")
    args = p.parse_args(argv)

    store_dir = tempfile.mkdtemp(prefix="rs_seg_rehearse_")
    extra = []
    if args.device:
        extra += ["--device", args.device]
    if args.backend:
        extra += ["--backend", args.backend]
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "rs_image_segmentation_tpu_torch.parallel.multihost_worker",
         str(pid), str(args.nproc),
         "file://" + os.path.join(store_dir, "store"),
         str(SCENES_PER_RANK), args.mode] + extra)
        for pid in range(args.nproc)]

    # one shared deadline; the moment any rank fails, kill the rest —
    # peers blocked in a collective would otherwise wait out its timeout
    deadline = time.monotonic() + args.timeout
    failed = None
    live = list(procs)
    try:
        while live and failed is None:
            if time.monotonic() > deadline:
                failed = ("timeout", None)
                break
            for pr in list(live):
                rc = pr.poll()
                if rc is None:
                    continue
                live.remove(pr)
                if rc != 0:
                    failed = (f"worker {procs.index(pr)}", rc)
                    break
            time.sleep(0.2)
    finally:
        for pr in live:
            pr.kill()
            pr.wait()
        shutil.rmtree(store_dir, ignore_errors=True)
    if failed:
        reason, rc = failed
        print(f"multihost rehearsal FAILED ({reason}"
              + (f", rc={rc}" if rc is not None else "") + ")",
              file=sys.stderr)
        return 2 if rc is None else (rc if rc > 0 else 1)
    print("multihost rehearsal OK")
    return 0


if __name__ == "__main__":
    sys.exit(multihost_rehearse_cli())
