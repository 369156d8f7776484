"""Multi-scene batch workflow: classify N scenes on the card and emit a
GeoTIFF + accuracy report per scene (BASELINE config #5).

Counterpart of ``rs_image_segmentation_tpu.tools.batch``, with two
branches:

* turbo: uniform uint8 scenes and a forest of any size go through
  ``pipeline.turbo.classify_scenes_turbo`` in sub-batches of 8,
  one launch of each of the CUDA kernels ``lut_hist`` and
  ``forest_labels`` per sub-batch. The host inputs are the exact stretch
  LUTs of ``pipeline.preprocess.build_stretch_lut``, as the JAX package
  builds them (the preamble then counts the stretched histogram on the
  card; a host histogram, as serving passes it, gives the same maps).
* streamed: any other batch runs one scene at a time through
  ``preprocess_bands``, ``hierarchical_stack_fused`` and
  ``models.forest.forest_predict``, which takes ``forest_labels``.

Two departures from the JAX function:

* The JAX turbo branch pads a trailing partial sub-batch to 8 scenes so
  that it reuses the compiled TPU program. Eager PyTorch compiles nothing,
  and the stack is batch-invariant on the card, so the partial group runs
  at its real size.
* The JAX function sends a forest past ``GEMM_MAX_LEAVES`` to its
  streamed branch, which reads ``_gemm_for(forest).path`` and so raises
  ``AttributeError``; here such a forest takes the turbo branch like any
  other (its GEMM form keeps a sparse path, which the kernel's packing
  reads).

``mesh`` (a ``parallel.mesh`` mesh, every rank calling with the same
arguments): the scenes shard over its ``data`` axis. Each rank classifies
its share (of each turbo sub-batch of ``8 x world`` scenes, or of the
streamed list) and writes its own scenes' files, so the maps are those
of ``mesh=None``. The result dicts are all-gathered, so every rank
returns the whole list in scene order, as the JAX function returns it.
With ``mesh=None`` the workflow runs on ``device`` alone. One departure:
the JAX function sends a non-uint8 uniform batch through its
single-controller ``sharded_hierarchical_stack`` after stretching the
whole batch on the host; with one process a rank, each rank streams its
own share instead.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..backend import DeviceLike, resolve_device
from ..core.config import CalibrationConfig, FeatureStageConfig
from ..io.tiff import read_tiff, write_tiff
from ..models.forest import _gemm_for, forest_predict
from ..parallel.mesh import block_bounds, mesh_device
from ..pipeline.evaluate import evaluate_classification
from ..pipeline.features import hierarchical_stack_fused
from ..pipeline.preprocess import build_stretch_lut, preprocess_bands
from ..pipeline.turbo import classify_scenes_turbo

SUB_BATCH = 8   # scenes per turbo program: a (B, 19, H, W) f32 stack each


def run_batch_workflow(
    scene_paths: Sequence[str],
    forest,
    depth: int,
    output_dir: str,
    roi_paths: Optional[Sequence[Optional[str]]] = None,
    mesh=None,
    cal: CalibrationConfig = CalibrationConfig(),
    cfg: FeatureStageConfig = FeatureStageConfig(),
    device: DeviceLike = None,
) -> List[Dict]:
    """Classify every scene on ``device`` (CUDA unless named), or over
    ``mesh`` (module docstring); returns per-scene result dicts (path,
    class map path, metrics when a ROI was given)."""
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    group = mesh.get_group("data") if mesh is not None else None
    n_rank, rank = ((dist.get_world_size(group), dist.get_rank(group))
                    if group is not None else (1, 0))
    os.makedirs(output_dir, exist_ok=True)
    if roi_paths and len(roi_paths) != len(scene_paths):
        raise ValueError(f"{len(roi_paths)} roi_paths for "
                         f"{len(scene_paths)} scenes")
    roi_paths = roi_paths or [None] * len(scene_paths)
    gains = np.asarray(cal.gains)
    biases = np.asarray(cal.biases)

    scenes = []
    metas = []
    for p in scene_paths:
        arr, info = read_tiff(p)
        scenes.append(arr)
        metas.append(info.meta)

    shapes = {a.shape for a in scenes}
    gf = (_gemm_for(forest, 19)
          if len(shapes) == 1 and all(a.dtype == np.uint8 for a in scenes)
          else None)
    preds: Dict[int, np.ndarray] = {}      # this rank's scenes' maps
    pending = []
    if gf is not None:
        sub = SUB_BATCH * n_rank
        for i in range(0, len(scenes), sub):
            lo, hi = block_bounds(min(sub, len(scenes) - i), n_rank, rank)
            share = scenes[i + lo:i + hi]
            if not share:
                continue
            luts = np.stack([build_stretch_lut(a, gains, biases)
                             for a in share]).astype(np.uint8)
            pending.append((i + lo, classify_scenes_turbo(
                np.stack(share), luts, gf, cfg, device=dev)))
        # drain once: the sub-batches queue on the card back to back
        for first, maps in pending:
            for j, m in enumerate(maps.cpu().numpy()):
                preds[first + j] = m
    else:
        lo, hi = block_bounds(len(scenes), n_rank, rank)
        for i in range(lo, hi):
            pre = preprocess_bands(scenes[i], gains, biases, device=dev)
            stack = hierarchical_stack_fused(pre.to(torch.float32), cfg,
                                             device=dev)
            pred = forest_predict(forest, stack.reshape(-1, stack.shape[-1]),
                                  depth)
            pending.append((i, pred, stack.shape[:2]))
        preds = {i: p.cpu().numpy().reshape(shp) for i, p, shp in pending}

    results = []
    seen_stems: Dict[str, int] = {}
    for i, (path, meta) in enumerate(zip(scene_paths, metas)):
        stem = os.path.splitext(os.path.basename(path))[0]
        # disambiguate duplicate basenames (e.g. same-named scenes from
        # different directories) so outputs never overwrite each other
        n = seen_stems.get(stem, 0)
        seen_stems[stem] = n + 1
        if n:
            stem = f"{stem}_{n}"
        if i not in preds:              # another rank's scene
            continue
        pred = preds[i]
        out_tif = os.path.join(output_dir, f"{stem}_class_map.tif")
        write_tiff(out_tif, pred.astype(np.uint8)[None], meta,
                   compression="lzw", tiled=True)
        entry = {"scene": path, "class_map": out_tif}
        if roi_paths[i]:
            roi = (np.load(roi_paths[i]) if roi_paths[i].endswith(".npy")
                   else read_tiff(roi_paths[i])[0][0])
            m = evaluate_classification(pred, roi, device=dev)
            entry["overall_accuracy"] = m["overall_accuracy"]
            entry["kappa"] = m["kappa"]
            with open(os.path.join(output_dir, f"{stem}_report.txt"),
                      "w") as f:
                f.write(f"scene: {path}\nOA: {m['overall_accuracy']:.4f}\n"
                        f"Kappa: {m['kappa']:.4f}\n")
        results.append((i, entry))
    if group is not None:
        gathered = [None] * n_rank
        dist.all_gather_object(gathered, results, group=group)
        results = sorted((r for part in gathered for r in part),
                         key=lambda r: r[0])
    return [entry for _, entry in results]
