"""A closed loop over batches of raw tiles, the way an analyst's batch job
runs the turbo programs (``tools/batch.py``'s turbo branch).

For each batch of ``batch`` raw uint8 host tiles (the pool cycled batch by
batch) the host builds the stretch tables, and the program is called with
numpy in; the next batch is queued before the previous batch's maps are
fetched to host numpy. Methods:

* ``random_forest``: ``build_stretch_lut`` a tile, then
  ``pipeline.turbo.classify_scenes_turbo``;
* ``rule_based``: ``build_stretch_stats`` a tile (tables, fixed-point
  params, histograms, as ``serving/engine.py::_run_batch`` builds them),
  then ``pipeline.turbo.rule_based_scenes_turbo_batch`` with
  ``return_overflow=True``; a flagged tile is rerouted to
  ``pipeline.large_scene.rule_based_large_scene``, as the engine reroutes
  it.

Traffic keys: ``method``, ``batch``, ``pool`` (tiles, a multiple of
``batch``), ``keep_share`` (the share of batches, drawn from the seed,
whose maps are kept for the comparison; the first batch of each pool slice
and the last batch are always kept).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import setup as common
from perfbench.harness import window as win


def inputs(ctx) -> dict:
    """The seed's pool of tiles (every input is a pool tile) and, for the
    forest, its fields."""
    pool = common.make_pool(ctx)
    st = {"pool": pool, "inputs": dict(enumerate(pool)), "fields": None,
          "depth": 0}
    if ctx.traffic["method"] == "random_forest":
        st["fields"], st["depth"] = common.make_forest(ctx, pool[0])
    return st


def setup(ctx):
    from rs_image_segmentation_tpu_torch.pipeline import (large_scene,
                                                          preprocess, turbo)
    t = ctx.traffic
    st = inputs(ctx)
    pool = st["pool"]
    feat, cal, rules = ctx.port_configs()
    gains, biases = np.asarray(cal.gains), np.asarray(cal.biases)
    b = t["batch"]
    batches = [pool[i:i + b] for i in range(0, len(pool), b)]
    if t["method"] == "random_forest":
        with ctx.timed("forest_to_port_s"):
            _, gf = common.port_forest(st["fields"], ctx.dev)

        def prep(scenes):
            return np.stack([preprocess.build_stretch_lut(s, gains, biases)
                             for s in scenes]).astype(np.uint8)

        def launch(scenes, tables):
            return turbo.classify_scenes_turbo(scenes, tables, gf, feat,
                                               device=ctx.dev)

        def fetch(scenes, tables, out):
            return out.cpu().numpy()
    else:
        def prep(scenes):
            stats = [preprocess.build_stretch_stats(s, gains, biases)
                     for s in scenes]
            return tuple(np.stack(p) for p in zip(*stats))

        def launch(scenes, tables):
            luts, sps, hists = tables
            return turbo.rule_based_scenes_turbo_batch(
                scenes, luts.astype(np.uint8), feat, rules,
                stretch_params=sps, stretch_hists=hists,
                return_overflow=True, device=ctx.dev)

        def fetch(scenes, tables, out):
            maps, overflow = out[0].cpu().numpy(), out[1].cpu().numpy()
            for i in np.nonzero(overflow)[0]:
                luts, hists = tables[0], tables[2]
                pre = luts[i].astype(np.uint8)[
                    np.arange(luts.shape[1])[:, None, None], scenes[i]]
                maps[i] = large_scene.rule_based_large_scene(
                    pre, cfg=feat, rule_cfg=rules,
                    hists=hists[i].astype(np.int64), device=ctx.dev)
                ctx.notes["rule_reroutes"] = ctx.notes.get(
                    "rule_reroutes", 0) + 1
            return maps

    st["batches"] = batches
    st["program"] = {"prep": prep, "launch": launch, "fetch": fetch}
    with ctx.timed("warmup_s"):
        for scenes in batches:
            fetch(scenes, prep(scenes), launch(scenes, prep(scenes)))
        ctx.tracer.warm(lambda: fetch(batches[0], prep(batches[0]),
                                      launch(batches[0], prep(batches[0]))))
        if ctx.dev.type == "cuda":
            torch.cuda.synchronize()
    ctx.notes.pop("rule_reroutes", None)
    return st


def window(ctx, st):
    """The closed loop for ``ctx.seconds``: ``{"end_to_end": {"mp_per_s"},
    "units", "window_s", "attempted", "failed"}``; the kept maps are in
    ``st["answers"]``."""
    tr = ctx.tracer
    batches = st["batches"]
    prep, launch, fetch = (st["program"][k] for k in ("prep", "launch",
                                                      "fetch"))
    rng = np.random.default_rng([ctx.seed, 1])
    keep_share = ctx.traffic["keep_share"]
    answers, pending, marks = [], None, []
    done = 0
    t0 = time.perf_counter()
    tr.begin(t0)
    t_end = t0 + ctx.seconds
    i = 0
    t_last = t0
    while True:
        now = time.perf_counter()
        tr.tick(now)
        if now >= t_end and pending is not None:
            break
        k = i % len(batches)
        scenes = batches[k]
        with tr.span("host_prep"):
            tables = prep(scenes)
        with tr.span("launch"):
            out = launch(scenes, tables)
        if pending is not None:
            with tr.span("fetch"):
                maps = fetch(*pending[1:])
            t_last = time.perf_counter()
            marks.append((t_last - t0, maps.size))
            _keep(pending[0], maps, answers, rng,
                  keep_share if done >= len(batches) else 1.0)
            done += 1
        pending = (k, scenes, tables, out)
        i += 1
    with tr.span("fetch"):
        maps = fetch(*pending[1:])
    t_last = time.perf_counter()
    marks.append((t_last - t0, maps.size))
    _keep(pending[0], maps, answers, rng, 1.0)
    done += 1
    tr.finish()
    ctx.notes["mp_by_second"] = common.per_second(marks)
    st["answers"] = answers
    window_s = t_last - t0
    mp_per_s = win.rate([px / 1e6 for _, px in marks], 0.0, window_s)
    return {"end_to_end": {"mp_per_s": mp_per_s},
            "units": done, "window_s": window_s, "attempted": i,
            "failed": i - done}


def _keep(k, maps, answers, rng, keep_share):
    """Keep batch ``k``'s maps for the comparison with probability
    ``keep_share`` (a draw from the seed's stream)."""
    if rng.random() < keep_share:
        answers.append((k, maps))


def answers(ctx, st):
    """``(answers, inputs, missing)``: each kept tile's map keyed by its
    pool index."""
    b = ctx.traffic["batch"]
    out = [(k * b + j, maps[j]) for k, maps in st["answers"]
           for j in range(maps.shape[0])]
    return out, st["inputs"], 0


def work(ctx, st, ops_per_pixel):
    """The unit (a batch) of work, for the counts: the kernel calls it makes
    and the step every implementation must do."""
    b, c, h, w = st["batches"][0].shape
    n = h * w
    forest = ctx.traffic["method"] == "random_forest"
    # the forest batch's preamble counts its histogram; the rule batch
    # hands it the host histograms, and it skips them
    calls = {"lut_hist": [{"planes": b * c, "pixels": n, "out_bytes": 4,
                           "hist": forest}]}
    if forest:
        fields = st["fields"]
        calls["forest_labels"] = [{
            "pixels": b * n, "features": 19, "trees": fields["left"].shape[0],
            "classes": fields["leaf_proba"].shape[2],
            "comparisons": ops_per_pixel * b * n}]
    else:
        calls["ccmin_prop"] = [{"masks": 3 * b, "pixels": n},
                               {"masks": b, "pixels": n}]
        calls["hist_dense"] = [{"masks": 3 * b, "pixels": n, "bins": 32768},
                               {"masks": b, "pixels": n, "bins": 32768}]
        calls["keep_lut"] = [{"masks": 3 * b, "pixels": n, "bins": 32768},
                             {"masks": b, "pixels": n, "bins": 32768}]
    step = {"raw_bytes": b * c * n, "map_bytes": b * n,
            "table_bytes": common.forest_table_bytes(st["fields"])
            if forest else 0,
            "ops": ops_per_pixel * b * n}
    return {"calls": calls, "step": step}
