"""Full scenes back to back through the streamed large-scene route.

``pipeline.large_scene.classify_large_scene_streamed`` on raw host scenes
(7 x H x W uint8) with the configuration's ``tile_rows``; the int32 map
lands in host numpy. ``scenes`` seeded scenes alternate, so nothing carries
over from one call to the next; each is a mosaic of tiles from the seed's
pool (``inputs/scenes.py::mosaic``). Every map is kept and compared.

Traffic keys: ``method`` (``random_forest``), ``scenes``, ``pool``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import setup as common
from perfbench.harness import window as win
from perfbench.inputs import scenes as scene_gen


def inputs(ctx) -> dict:
    """The seed's scenes (mosaics of its pool's tiles) and the forest's
    fields."""
    pool = common.make_pool(ctx)
    tiles = ctx.cfg["scene"]["height"] // ctx.cfg["tile"]["height"]
    with ctx.timed("inputs_s"):
        scenes = [scene_gen.mosaic(pool, tiles, [ctx.seed, 3, k])
                  for k in range(ctx.traffic["scenes"])]
    fields, depth = common.make_forest(ctx, pool[0])
    return {"scenes": scenes, "inputs": dict(enumerate(scenes)),
            "fields": fields, "depth": depth}


def setup(ctx):
    from rs_image_segmentation_tpu_torch.pipeline import large_scene
    st = inputs(ctx)
    scenes, fields = st["scenes"], st["fields"]
    with ctx.timed("forest_to_port_s"):
        _, gf = common.port_forest(fields, ctx.dev)
    feat, cal, _ = ctx.port_configs()
    rows = ctx.cfg["tile_rows"]

    def run(scene):
        return large_scene.classify_large_scene_streamed(
            scene, gf, cal, feat, tile_rows=rows, device=ctx.dev)

    with ctx.timed("warmup_s"):
        for s in scenes:
            run(s)
        ctx.tracer.warm(lambda: run(scenes[0]))
        if ctx.dev.type == "cuda":
            torch.cuda.synchronize()
    st["program"] = {"run": run}
    return st


def window(ctx, st):
    tr = ctx.tracer
    scenes, run = st["scenes"], st["program"]["run"]
    answers, i, marks = [], 0, []
    t0 = time.perf_counter()
    tr.begin(t0)
    t_end = t0 + ctx.seconds
    t_last = t0
    while True:
        now = time.perf_counter()
        tr.tick(now)
        if now >= t_end and i > 0:
            break
        k = i % len(scenes)
        with tr.span("scene"):
            out = run(scenes[k])
        t_last = time.perf_counter()
        marks.append((t_last - t0, out.size))
        answers.append((k, out))
        i += 1
    tr.finish()
    ctx.notes["mp_by_second"] = common.per_second(marks)
    st["answers"] = answers
    window_s = t_last - t0
    mp_per_s = win.rate([px / 1e6 for _, px in marks], 0.0, window_s)
    return {"end_to_end": {"mp_per_s": mp_per_s},
            "units": i, "window_s": window_s, "attempted": i, "failed": 0}


def answers(ctx, st):
    return st["answers"], st["inputs"], 0


def work(ctx, st, ops_per_pixel):
    """The unit (a scene) of work: one ``lut_hist`` call and one
    ``forest_labels`` call a row chunk of ``tile_rows``."""
    c, h, w = st["scenes"][0].shape
    rows = ctx.cfg["tile_rows"]
    chunks = [min(rows, h - y) for y in range(0, h, rows)]
    fields = st["fields"]
    lut = [{"planes": c, "pixels": r * w, "out_bytes": 1, "hist": False}
           for r in chunks]
    forest = [{"pixels": r * w, "features": 19,
               "trees": fields["left"].shape[0],
               "classes": fields["leaf_proba"].shape[2],
               "comparisons": ops_per_pixel * r * w} for r in chunks]
    step = {"raw_bytes": c * h * w, "map_bytes": h * w,
            "table_bytes": common.forest_table_bytes(fields),
            "ops": ops_per_pixel * h * w}
    return {"calls": {"lut_hist": lut, "forest_labels": forest},
            "step": step}
