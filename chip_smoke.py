"""GPU smoke run of the PyTorch port's main path: the supervised turbo
classifier on an 8-scene 7 x 600 x 600 batch, 19 channels, a 100-tree
forest, on one CUDA card.

Phases, in order; any failed check raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit); build every CUDA kernel
     from ``rs_image_segmentation_tpu_torch/csrc`` with nvcc (sm_90a);
  2. synthetic scenes from a fixed seed and their host stretch stats;
  3. a 100-tree forest fitted with the port's trainer on rule labels of
     scene 0's stack;
  4. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (bit-equal outputs required);
  5. the main path, ``classify_scenes_turbo``, with launch counts read
     around one run, then timed; scene 0 again on the CPU (>= 99.9 %
     label agreement with the card);
  6. one JSON line per the kernels' numbers, then the result line.

Run from the repository root: ``python3 chip_smoke.py``. It needs no
network and no arguments; the kernel build goes to
``rs_image_segmentation_tpu_torch/_build/``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH, BANDS, HEIGHT, WIDTH = 8, 7, 600, 600
N_TREES = 100
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_OPS_PER_S = 67e12              # H100 SXM, f32 outside the tensor cores


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def tie_and_fractional_forests():
    """The 2-tree tie forest and the fractional-leaf forest of the JAX
    package's kernel tests, with the pixels they are checked on."""
    from rs_image_segmentation_tpu_torch.models.forest import (
        _gemm_for, fit_random_forest)
    out = {}
    rng = np.random.default_rng(11)
    x = rng.random((32, 19)).astype(np.float32)
    forest, _ = fit_random_forest(x, rng.integers(1, 4, 32), n_estimators=2,
                                  seed=1)
    out["ties"] = (_gemm_for(forest, 19),
                   rng.random((19, 4096)).astype(np.float32))
    rng = np.random.default_rng(3)
    half = rng.random((24, 19)).astype(np.float32)
    x = np.concatenate([half, half])
    forest, _ = fit_random_forest(x, rng.integers(1, 4, 48),
                                  n_estimators=10, seed=2)
    gf = _gemm_for(forest, 19)
    check(not np.isin(gf.leaf_dist.numpy(), (0.0, 1.0)).all(),
          "the fractional-leaf forest has impure leaves")
    out["fractional"] = (gf, rng.random((19, 4096)).astype(np.float32))
    return out


def fired_decisions(gf, x: torch.Tensor, chunk: int = 32768) -> int:
    """Decisions this input needs: over all pixels, the path lengths of the
    leaves that fire (one per tree), computed with plain ops."""
    sel_t, thr = gf.selector.T, gf.thresholds[:, None]
    path_t, plen = gf.path.T, gf.path_len[:, None]
    total = 0
    for b in range(x.shape[0]):
        for s in range(0, x.shape[2], chunk):
            sgn = torch.where(sel_t @ x[b, :, s:s + chunk] <= thr, 1.0, -1.0)
            fired = (path_t @ sgn == plen).to(torch.float64)
            total += int((plen[:, 0].double() @ fired).sum().item())
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rs_image_segmentation_tpu_torch.backend import resolve_device
    from rs_image_segmentation_tpu_torch.core.config import FeatureStageConfig
    from rs_image_segmentation_tpu_torch.models.forest import GemmForest
    from rs_image_segmentation_tpu_torch.ops import _build, kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.tools.fixtures import (
        rule_forest, stretch_stats_batch, synthetic_scenes)
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    # ---- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report)}")
    for k, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {k}: {r['seconds']:.2f} s; " + " | ".join(regs))

    # ---- 2. data
    cfg = FeatureStageConfig()
    t0 = time.perf_counter()
    scenes = synthetic_scenes(BATCH, HEIGHT, WIDTH, seed=SEED)
    t1 = time.perf_counter()
    luts, params, hists = stretch_stats_batch(scenes)
    stats_ms = (time.perf_counter() - t1) * 1e3
    modes = params[:, :, 0]
    check(bool((modes == 0).any(axis=1).all() and (modes == 1).any(axis=1)
               .all()), f"every scene mixes mode-0 and mode-1 bands: {modes}")
    print(f"data: {scenes.shape} uint8 in {time.perf_counter() - t0:.2f} s, "
          f"host stretch stats {stats_ms:.1f} ms per batch; "
          f"stretch modes per band of scene 0: {modes[0].tolist()}")
    scenes_d = torch.from_numpy(scenes).to(dev)
    luts_d = torch.from_numpy(luts).to(dev)
    params_d = torch.from_numpy(params).to(dev)
    hists_d = torch.from_numpy(hists).to(dev)

    # ---- 3. forest
    t0 = time.perf_counter()
    stack0 = turbo.hierarchical_stack_turbo_cm(scenes_d[0], luts_d[0], cfg,
                                               device=dev).cpu().numpy()
    check(stack0.shape == (19, HEIGHT, WIDTH)
          and bool(np.isfinite(stack0).all()), "scene 0 stack is finite")
    gf_cpu, plan, n_samples, depth = rule_forest(stack0)
    gf = GemmForest(*(t.to(dev) for t in gf_cpu))
    m, n_leaves = gf.path.shape
    n_classes = gf.leaf_dist.shape[1]
    check(n_classes <= 8, "at most 8 classes")
    n_trees = round(1.0 / float(gf_cpu.inv_trees))
    check(n_trees == N_TREES, f"{N_TREES} trees")
    print(f"forest: {n_trees} trees on {n_samples} samples in "
          f"{time.perf_counter() - t0:.2f} s; M={m} L={n_leaves} "
          f"C={n_classes} depth={depth} plan groups={len(plan)}")

    # ---- 4. kernels against their plain versions on the card
    errs = {}
    shp = scenes_d.shape
    for label, kw in (("sp+skip_hist", dict(sp=params_d, skip_hist=True)),
                      ("sp+hist", dict(sp=params_d)),
                      ("table+out_u8", dict(out_u8=True))):
        got = kernels.lut_hist(scenes_d, luts_d, **kw)
        ref = kernels.lut_hist_plain(scenes_d, luts_d,
                                     out_u8=kw.get("out_u8", False),
                                     skip_hist=kw.get("skip_hist", False))
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            check(g.shape == r.shape and g.dtype == r.dtype,
                  f"lut_hist {label} shape/dtype")
            err = (g.double() - r.double()).abs().max().item()
            check(err == 0, f"lut_hist {label} bit-equal (max err {err})")
            errs["lut_hist"] = max(errs.get("lut_hist", 0.0), err)
        print(f"check lut_hist [{label}] at {tuple(shp)}: bit-equal")

    stacks = turbo.hierarchical_stack_turbo_cm(scenes_d, luts_d, cfg,
                                               device=dev)
    x_cm = stacks.reshape(BATCH, 19, HEIGHT * WIDTH)
    check(bool(torch.isfinite(x_cm).all()), "batch stacks are finite")
    cases = {"batch stacks": (gf, x_cm)}
    for key, (g, xc) in tie_and_fractional_forests().items():
        cases[key] = (GemmForest(*(t.to(dev) for t in g)),
                      torch.from_numpy(xc).to(dev))
    for label, (g, xc) in cases.items():
        got = kernels.forest_labels(g, xc)
        ref = kernels.gemm_labels_cm(g, xc)
        torch.cuda.synchronize()
        diff = int((got != ref).sum().item())
        err = float((got - ref).abs().max().item())
        check(diff == 0, f"forest_labels [{label}] bit-equal ({diff} differ)")
        errs["forest_labels"] = max(errs.get("forest_labels", 0.0), err)
        print(f"check forest_labels [{label}] at {tuple(xc.shape)}: "
              f"bit-equal")

    # ---- 5. the main path
    def main_path():
        return turbo.classify_scenes_turbo(
            scenes_d, luts_d, gf, cfg, stretch_params=params_d,
            stretch_hists=hists_d, device=dev)

    kernels.lut_hist.launches = 0
    kernels.forest_labels.launches = 0
    labels = main_path()
    torch.cuda.synchronize()
    launches = {"lut_hist": kernels.lut_hist.launches,
                "forest_labels": kernels.forest_labels.launches}
    check(all(v > 0 for v in launches.values()),
          f"both kernels ran on the main path: {launches}")
    check(labels.shape == (BATCH, HEIGHT, WIDTH)
          and labels.dtype == torch.uint8, "label maps (B, H, W) uint8")
    classes = set(gf_cpu.classes.tolist())
    counts = torch.bincount(labels.reshape(-1).long(), minlength=256)
    hist = {int(c): int(counts[c]) for c in torch.nonzero(counts)[:, 0]}
    check(set(hist) <= classes, f"labels are forest classes: {hist}")
    print(f"main path: launches {launches}; class histogram {hist}")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main_path()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    batch_ms = statistics.median(walls[1:])
    print(f"main path: median {batch_ms:.3f} ms/batch, "
          f"{batch_ms / BATCH:.3f} ms/scene, "
          f"{BATCH * HEIGHT * WIDTH / batch_ms / 1e3:.3f} MP/s "
          f"(inputs resident on the card; runs {[round(w, 3) for w in walls]})")
    t0 = time.perf_counter()
    cpu0 = turbo.classify_scenes_turbo(scenes[:1], luts[:1], gf_cpu, cfg,
                                       stretch_params=params[:1],
                                       stretch_hists=hists[:1], device="cpu")
    agreement = float((cpu0[0] == labels[0].cpu()).double().mean())
    check(agreement >= 0.999, f"card vs CPU agreement {agreement}")
    print(f"scene 0 on the CPU in {time.perf_counter() - t0:.1f} s: "
          f"agreement with the card {agreement:.6f}")

    # ---- 6. kernel numbers at the main path's shapes
    planes = BATCH * BANDS
    n = HEIGHT * WIDTH
    lut_bytes = planes * n * (1 + 4) + planes * 256
    lut_plain_ms = cuda_time_ms(lambda: kernels.lut_hist_plain(
        scenes_d, luts_d, skip_hist=True), 10)
    lut_ms = cuda_time_ms(lambda: kernels.lut_hist(
        scenes_d, luts_d, sp=params_d, skip_hist=True), 50)
    lut_f32 = luts_d.reshape(planes, 256).float()
    idx64 = scenes_d.reshape(planes, n).long()
    lut_lib_ms = cuda_time_ms(lambda: torch.gather(lut_f32, 1, idx64), 20)
    decisions = fired_decisions(gf, x_cm)
    forest_ops = decisions + BATCH * n * (N_TREES * n_classes + n_classes)
    forest_bytes = x_cm.numel() * 4 + BATCH * n * 4
    forest_ms = cuda_time_ms(lambda: kernels.forest_labels(gf, x_cm), 5, 1)
    parts = turbo._preamble(scenes_d, luts_d, params_d, hists_d)
    stack_ms = cuda_time_ms(lambda: turbo._stack_cm_from_parts(*parts, cfg),
                            5, 1)
    print(f"stages, device ms per batch: preamble {lut_ms:.4f}, "
          f"stack {stack_ms:.4f}, forest {forest_ms:.4f}; "
          f"sum {lut_ms + stack_ms + forest_ms:.4f} vs main path wall "
          f"{batch_ms:.4f}")
    forest_plain_ms = cuda_time_ms(lambda: kernels.gemm_labels_cm(gf, x_cm), 2, 1)

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = []
    for kname, ms, plain, lib, lib_note, (bms, by), line, extra in (
            ("lut_hist", lut_ms, lut_plain_ms, lut_lib_ms,
             "torch.gather over (planes, 256) f32 tables with int64 indices "
             "widened beforehand (no histogram)",
             bound(lut_bytes, planes * n), 395,
             {"bytes": lut_bytes, "ops": planes * n}),
            ("forest_labels", forest_ms, forest_plain_ms, None,
             "no single PyTorch call computes a forest's labels",
             bound(forest_bytes, forest_ops), 647,
             {"bytes": forest_bytes, "ops": forest_ops,
              "fired_decisions": decisions})):
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"rs_image_segmentation_tpu_torch/csrc/{kname}.cu",
            "replaces": f"rs_image_segmentation_tpu/ops/pallas_kernels.py:"
                        f"{line}",
            "launches": launches[kname], "max_abs_err": errs[kname],
            "max_diff": errs[kname], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_us": bms * 1e3,
            "bound_by": by, "library_ms": lib, "library_note": lib_note,
            **extra})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
