"""GPU smoke run of the PyTorch port's two paths on an 8-scene
7 x 600 x 600 batch, on one CUDA card: the supervised turbo classifier
(19 channels, a 100-tree forest) and the batched rule program.

Phases, in order; any failed check raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit); build every CUDA kernel
     from ``rs_image_segmentation_tpu_torch/csrc`` with nvcc (sm_90a);
  2. synthetic scenes from a fixed seed and their host stretch stats;
  3. a 100-tree forest fitted with the port's trainer on rule labels of
     scene 0's stack;
  4. the supervised path's kernels against their plain PyTorch versions
     on the card, at the path's shapes (bit-equal outputs required);
  5. the supervised path, ``classify_scenes_turbo``, with launch counts
     read around one run, then timed; scene 0 again on the CPU (>= 99.9 %
     label agreement with the card);
  6. the supervised kernels' numbers;
  7. the rule path's kernels against their plain versions on the card,
     bit-equal: the 24 first-stage masks of the batch with their run-rank
     seeds and ids, speckle masks and a serpentine mask (both
     connectivities), and ids out of range;
  8. the rule path, ``rule_based_scenes_turbo_batch``, with launch counts
     read around one run, class histogram and overflow flags, then timed
     by stage; scene 0 again on the CPU (>= 99.9 % agreement);
  9. the rule kernels' numbers; the card's line, the kernels' JSON line,
     then the result line.

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
INT32_OPS_PER_S = 33.5e12          # H100 SXM, int32 (half the f32 rate)
BINS = 32768                       # the rule path's component-id cap
PALLAS = "rs_image_segmentation_tpu/ops/pallas_kernels.py"
CSRC = "rs_image_segmentation_tpu_torch/csrc"


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


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate, in ms, and which of
    the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def serpentine(h: int, w: int) -> np.ndarray:
    """Every other row set, joined at alternate ends: one component that
    turns h / 2 times (the mask of the JAX package's structured-mask
    test)."""
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    m[1::4, -1] = True
    m[3::4, 0] = True
    return m


def ccmin_cases(stack3, seeds, dev):
    """The ccmin_prop checks: name -> (mask, values, connectivity)."""
    rng = np.random.default_rng(SEED)
    i32 = np.iinfo(np.int32)
    speckle = torch.from_numpy(rng.random((4, HEIGHT, WIDTH)) < 0.5).to(dev)
    speckle_v = torch.from_numpy(rng.integers(
        i32.min, i32.max, speckle.shape, dtype=np.int32)).to(dev)
    serp = torch.from_numpy(serpentine(300, 140)).to(dev)
    serp_v = torch.from_numpy(rng.integers(
        0, 1 << 20, serp.shape, dtype=np.int32)).to(dev)
    solid = torch.stack([torch.zeros((HEIGHT, WIDTH), dtype=torch.bool),
                         torch.ones((HEIGHT, WIDTH), dtype=torch.bool)]).to(dev)
    solid_v = speckle_v[:2].contiguous()
    cases = {}
    for conn in (8, 4):
        cases[f"first stage, conn {conn}"] = (stack3, seeds, conn)
        cases[f"speckle p=0.5, conn {conn}"] = (speckle, speckle_v, conn)
        cases[f"serpentine 300x140, conn {conn}"] = (serp, serp_v, conn)
        cases[f"empty and full, conn {conn}"] = (solid, solid_v, conn)
    return cases


def rule_phases(dev, cfg, scenes, luts, params, hists, scenes_d, luts_d,
                params_d, hists_d, lut_row) -> list:
    """Phases 7-9: the rule path's kernels against their plain versions,
    the rule path itself, and the rule kernels' rows of the JSON line."""
    from rs_image_segmentation_tpu_torch.core.config import RuleBasedConfig
    from rs_image_segmentation_tpu_torch.ops import components, kernels
    from rs_image_segmentation_tpu_torch.pipeline import turbo
    from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms

    rc = RuleBasedConfig()
    bins_hi = BINS // kernels.HIST_LO

    # ---- 7. kernels against their plain versions at the rule path's shapes
    nd = turbo._rule_front(scenes_d, luts_d, cfg, params_d, hists_d)
    stack3, min3 = turbo._rule_first_stage(*nd, rc)
    fg3 = stack3 != 0
    seeds = components.run_rank_seeds(fg3)
    m3 = stack3.shape[0]
    check(m3 == 3 * BATCH, "24 first-stage masks")
    errs = {}
    for label, (mask, values, conn) in ccmin_cases(fg3, seeds, dev).items():
        got = kernels.ccmin_prop(mask, values, conn)
        ref = kernels.ccmin_prop_plain(mask, values, conn)
        torch.cuda.synchronize()
        diff = int((got != ref).sum().item())
        err = float((got.long() - ref.long()).abs().max().item())
        check(diff == 0, f"ccmin_prop [{label}] bit-equal ({diff} differ)")
        errs["ccmin_prop"] = max(errs.get("ccmin_prop", 0.0), err)
        n_comp = int((ref[mask != 0] == values[mask != 0]).sum().item())
        print(f"check ccmin_prop [{label}] at {tuple(mask.shape)}: "
              f"bit-equal; {int((mask != 0).sum().item())} foreground "
              f"pixels, {n_comp} of them hold their component's minimum")
    ids, overflow = components.component_ids(stack3, 8, BINS)
    check(not bool(overflow.any()), f"first stage under the cap: {overflow}")
    runs = int(seeds.amax().item()) + 1
    rng = np.random.default_rng(SEED + 1)
    wild = torch.from_numpy(rng.integers(-300, BINS + 300, (4, 4096),
                                         dtype=np.int32)).to(dev)
    for label, x in (("first-stage ids", ids), ("ids out of range", wild)):
        counts = kernels.hist_dense(x, bins_hi)
        counts_ref = kernels.hist_dense_plain(x, bins_hi)
        torch.cuda.synchronize()
        err = float((counts - counts_ref).abs().max().item())
        check(err == 0, f"hist_dense [{label}] bit-equal (max err {err})")
        errs["hist_dense"] = max(errs.get("hist_dense", 0.0), err)
        areas = (min3 if x is ids else
                 torch.full((x.shape[0],), 2, dtype=torch.int32, device=dev))
        table = counts_ref >= areas.reshape(-1, 1, 1)
        keep = kernels.keep_lut(x, table)
        keep_ref = kernels.keep_lut_plain(x, table)
        torch.cuda.synchronize()
        err = float((keep - keep_ref).abs().max().item())
        check(err == 0, f"keep_lut [{label}] bit-equal (max err {err})")
        errs["keep_lut"] = max(errs.get("keep_lut", 0.0), err)
        print(f"check hist_dense, keep_lut [{label}] at {tuple(x.shape)}, "
              f"bins {BINS}: bit-equal")
    print(f"first stage: {m3} masks, at most {runs} row runs in a mask "
          f"(cap {BINS})")

    # ---- 8. the rule path
    def rule_path():
        return turbo.rule_based_scenes_turbo_batch(
            scenes_d, luts_d, cfg, stretch_params=params_d,
            stretch_hists=hists_d, return_overflow=True, device=dev)

    path_kernels = (kernels.lut_hist, kernels.ccmin_prop, kernels.hist_dense,
                    kernels.keep_lut)
    for k in path_kernels + (kernels.forest_labels,):
        k.launches = 0
    labels, overflow = rule_path()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in path_kernels}
    check(all(v > 0 for v in launches.values())
          and kernels.forest_labels.launches == 0,
          f"the rule path's kernels ran, and no forest: {launches}")
    check(labels.shape == (BATCH, HEIGHT, WIDTH)
          and labels.dtype == torch.uint8, "rule maps (B, H, W) uint8")
    counts = torch.bincount(labels.reshape(-1).long(), minlength=256)
    hist = {int(c): int(counts[c]) for c in torch.nonzero(counts)[:, 0]}
    check(set(hist) <= {0, 1, 2, 3, 4}, f"rule labels in 0..4: {hist}")
    check(overflow.shape == (BATCH,) and not bool(overflow.any()),
          f"no scene hit the id cap: {overflow.tolist()}")
    print(f"rule path: launches {launches}; class histogram {hist}; "
          f"overflow {overflow.tolist()}")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rule_path()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    batch_ms = statistics.median(walls[1:])
    print(f"rule path: median {batch_ms:.3f} ms/batch, "
          f"{batch_ms / BATCH:.3f} ms/scene, "
          f"{BATCH * HEIGHT * WIDTH / batch_ms / 1e3:.3f} MP/s "
          f"(inputs resident on the card; runs {[round(w, 3) for w in walls]})")
    stage = {
        "front (preamble, percentiles, indices)": cuda_time_ms(
            lambda: turbo._rule_front(scenes_d, luts_d, cfg, params_d,
                                      hists_d), 5),
        "thresholds and closings": cuda_time_ms(
            lambda: turbo._rule_first_stage(*nd, rc), 5),
        "min-area removal, first stage (24 masks)": cuda_time_ms(
            lambda: components.remove_small_components_batch(
                stack3, min3, return_overflow=True), 5),
    }
    whole = cuda_time_ms(rule_path, 5)
    stage["the rest (openings, paint, bare-land stage)"] = (
        whole - sum(stage.values()))
    print(f"rule path, device ms per batch (events): whole {whole:.4f}; "
          + "; ".join(f"{k} {v:.4f}" for k, v in stage.items()))
    t0 = time.perf_counter()
    cpu0 = turbo.rule_based_scenes_turbo_batch(
        scenes[:1], luts[:1], cfg, stretch_params=params[:1],
        stretch_hists=hists[:1], device="cpu")
    agreement = float((cpu0[0] == labels[0].cpu()).double().mean())
    check(agreement >= 0.999, f"rule path card vs CPU agreement {agreement}")
    print(f"rule path, scene 0 on the CPU in {time.perf_counter() - t0:.1f} "
          f"s: agreement with the card {agreement:.6f}")

    # ---- 9. rule kernel numbers at the first stage's shapes
    n = HEIGHT * WIDTH
    cc_ms = cuda_time_ms(lambda: kernels.ccmin_prop(fg3, seeds, 8), 20)
    cc_plain_ms = cuda_time_ms(
        lambda: kernels.ccmin_prop_plain(fg3, seeds, 8), 2, 1)
    table = kernels.hist_dense_plain(ids, bins_hi) >= min3.reshape(-1, 1, 1)
    hist_ms = cuda_time_ms(lambda: kernels.hist_dense(ids, bins_hi), 20)
    hist_plain_ms = cuda_time_ms(
        lambda: kernels.hist_dense_plain(ids, bins_hi), 3, 1)
    keep_ms = cuda_time_ms(lambda: kernels.keep_lut(ids, table), 20)
    keep_plain_ms = cuda_time_ms(
        lambda: kernels.keep_lut_plain(ids, table), 5)
    # the yardsticks: one PyTorch call each, over flat ids offset by mask
    # (one extra slot per mask takes the background id), int64 indices
    # built beforehand
    lib_idx = (ids.long() + torch.arange(m3, device=dev)[:, None, None]
               * (BINS + 1)).reshape(-1)
    hist_lib_ms = cuda_time_ms(
        lambda: torch.bincount(lib_idx, minlength=m3 * (BINS + 1)), 20)
    table_ext = torch.cat([table.reshape(m3, BINS),
                           table.new_zeros((m3, 1))], 1).to(torch.int32)
    flat_table = table_ext.reshape(-1)
    keep_lib_ms = cuda_time_ms(
        lambda: torch.gather(flat_table, 0, lib_idx), 20)
    print(f"rule kernels at {m3} x {HEIGHT} x {WIDTH}, device ms: ccmin_prop "
          f"{cc_ms:.4f} (plain {cc_plain_ms:.4f}), hist_dense {hist_ms:.4f} "
          f"(plain {hist_plain_ms:.4f}, bincount {hist_lib_ms:.4f}), "
          f"keep_lut {keep_ms:.4f} (plain {keep_plain_ms:.4f}, gather "
          f"{keep_lib_ms:.4f})")

    px = m3 * n
    cc_bytes = px * (1 + 4 + 4)
    hist_bytes = px * 4 + m3 * BINS * 4
    keep_bytes = px * 4 * 2 + m3 * BINS
    lut_row["launches_rule_path"] = launches["lut_hist"]
    rows = []
    for kname, src, line, ms, plain, lib, lib_note, nbytes in (
            ("ccmin_prop", "ccmin_prop.cu", 1328, cc_ms, cc_plain_ms, None,
             "no single PyTorch call computes connected components",
             cc_bytes),
            ("hist_dense", "hist_keep.cu", 1428, hist_ms, hist_plain_ms,
             hist_lib_ms, "torch.bincount over int64 ids + mask * (bins + 1),"
             " built beforehand", hist_bytes),
            ("keep_lut", "hist_keep.cu", 1471, keep_ms, keep_plain_ms,
             keep_lib_ms, "torch.gather over the flat (M, bins + 1) int32 "
             "table with int64 ids + mask * (bins + 1), built beforehand",
             keep_bytes)):
        bms, by = bound(nbytes, px, INT32_OPS_PER_S)
        rows.append({
            "name": kname, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": f"{PALLAS}:{line}", "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
            "library_ms": lib, "library_note": lib_note, "bytes": nbytes,
            "shape": [m3, HEIGHT, WIDTH], "rule_path_ms": batch_ms})
    return rows


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
            "source": f"{CSRC}/{kname}.cu", "replaces": f"{PALLAS}:{line}",
            "launches": launches[kname], "max_abs_err": errs[kname],
            "max_diff": errs[kname], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_us": bms * 1e3,
            "bound_by": by, "library_ms": lib, "library_note": lib_note,
            **extra})

    rows += rule_phases(dev, cfg, scenes, luts, params, hists, scenes_d,
                        luts_d, params_d, hists_d, rows[0])
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
