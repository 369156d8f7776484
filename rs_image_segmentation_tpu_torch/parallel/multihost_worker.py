"""One rank of a multi-process rehearsal run.

Counterpart of ``rs_image_segmentation_tpu.parallel.multihost_worker``.
Runnable module: each rank executes ``python -m
rs_image_segmentation_tpu_torch.parallel.multihost_worker <rank> <nproc>
<address> [scenes_per_process] [mode] [--device D] [--backend B]``. It
joins the group (``address``: a TCP port on 127.0.0.1, or a ``file://`` or
``tcp://`` URL), builds the global mesh, classifies its local share of a
deterministic scene batch through :func:`multihost.classify_batch_multihost`,
and checks bit-equality with the one-process turbo program on the same
scenes.

``scenes_per_process`` is the JAX worker's ``devices_per_process`` (one
scene a virtual device there): in PyTorch a rank is one device, and the
number sets each rank's local batch.

Modes:
  ``even``   (default) — every rank feeds scenes_per_process scenes.
  ``uneven`` — rank 0 feeds one MORE scene and rank 1 one FEWER (same
  global batch), exercising the pad_to bucket-padding path.

Failure injection: if the env var ``RS_SEG_MULTIHOST_FAIL_PID`` equals
this rank, the worker exits 3 right after joining the group; its peers
then fail or block in a collective, and the spawning CLI's
kill-peers-on-first-failure path must end the run loudly.

Each rank prints ``MULTIHOST_OK <rank> mode=<mode> local=<n>`` and the
kernel launches of its classify call as a ``MULTIHOST_LAUNCHES`` JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def run(pid: int, nproc: int, address: str, scenes_per_process: int = 2,
        mode: str = "even", device=None, backend=None) -> None:
    import torch.distributed as dist

    from .multihost import (classify_batch_multihost, global_mesh,
                            init_multihost)
    if address.isdigit():
        address = f"127.0.0.1:{address}"
    dev = init_multihost(address, nproc, pid, backend=backend, device=device)

    if os.environ.get("RS_SEG_MULTIHOST_FAIL_PID") == str(pid):
        print(f"MULTIHOST_INJECTED_FAILURE {pid}", flush=True)
        raise SystemExit(3)

    from ..core.config import (CalibrationConfig, FeatureStageConfig,
                               GLCMConfig)
    from ..models.forest import _gemm_for, fit_random_forest
    from ..ops import kernels
    from ..pipeline.preprocess import build_stretch_lut
    from ..pipeline.turbo import classify_scenes_turbo

    # explicit raises, not assert: the rehearsal's pass/fail signal must
    # survive python -O
    if dist.get_world_size() != nproc:
        raise RuntimeError(f"[{pid}] expected {nproc} ranks, got "
                           f"{dist.get_world_size()}")

    cfg = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                             levels=8))
    cal = CalibrationConfig()
    rng = np.random.default_rng(0)          # same stream on every rank

    # per-rank true batch sizes (every rank derives the same table)
    counts = [scenes_per_process] * nproc
    pad_to = None
    if mode == "uneven":
        if nproc < 2 or scenes_per_process < 2:
            raise RuntimeError("uneven mode needs >= 2 processes and "
                               ">= 2 scenes a process")
        counts[0] += 1
        counts[1] -= 1
        # bucket: smallest multiple of scenes_per_process covering the
        # heaviest rank, so every padded local batch is the same size
        pad_to = (-(-max(counts) // scenes_per_process)
                  * scenes_per_process)
    elif mode != "even":
        raise RuntimeError(f"unknown mode {mode!r}")

    total = sum(counts)
    scenes = rng.integers(0, 256, (total, 7, 32, 32)).astype(np.uint8)
    xt = rng.random((64, 19)).astype(np.float32)
    yt = rng.integers(1, 4, 64)
    forest, _ = fit_random_forest(xt, yt, n_estimators=10, seed=0)
    gf = _gemm_for(forest, 19)

    luts = np.stack([build_stretch_lut(s, np.asarray(cal.gains),
                                       np.asarray(cal.biases))
                     for s in scenes]).astype(np.uint8)
    lo = sum(counts[:pid])
    hi = lo + counts[pid]

    mesh = global_mesh(("data",), device=dev)
    kern = (kernels.lut_hist, kernels.forest_labels)
    for k in kern:
        k.launches = 0
    maps_local = classify_batch_multihost(scenes[lo:hi], luts[lo:hi],
                                          gf, cfg, mesh, pad_to=pad_to)
    launches = {k.__name__: k.launches for k in kern}

    # reference: the same scenes through the one-process turbo program
    ref = classify_scenes_turbo(scenes[lo:hi], luts[lo:hi], gf, cfg,
                                device=dev).cpu().numpy()
    if maps_local.shape != ref.shape:
        raise RuntimeError(f"[{pid}] multihost shape mismatch: "
                           f"{maps_local.shape} vs {ref.shape}")
    if not np.array_equal(maps_local, ref):
        raise RuntimeError(f"[{pid}] multihost maps diverge: "
                           f"{(maps_local != ref).sum()} px")
    print(f"MULTIHOST_LAUNCHES {json.dumps({'rank': pid, **launches})}",
          flush=True)
    print(f"MULTIHOST_OK {pid} mode={mode} local={counts[pid]}", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="one rank of a multi-process "
                                            "rehearsal")
    p.add_argument("pid", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("address")
    p.add_argument("scenes_per_process", type=int, nargs="?", default=2)
    p.add_argument("mode", nargs="?", default="even")
    p.add_argument("--device", default=None,
                   help="torch device kind (default: the CUDA card)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on CUDA, gloo on the CPU")
    a = p.parse_args(argv)
    run(a.pid, a.nproc, a.address, a.scenes_per_process, a.mode, a.device,
        a.backend)


if __name__ == "__main__":
    main()
