"""A closed loop over batches of raw tiles through the port's KMeans batch
program, as an analyst with no training ROI clusters a scene's tiles.

The pool is one fixed scene: ``pool`` tiles made from the configuration's
content seed (``content.seed``), whatever the run's ``--seed``, so every
run does the same fits with the same Lloyd iterations (a fit runs until
the slowest of its batch's tiles converges). The run's seed picks only
which batches are kept for the comparison. For each batch of ``batch``
tiles the host builds each tile's stretch table (``build_stretch_lut``)
and calls ``pipeline.turbo.kmeans_scenes_turbo_batch`` with numpy in: per
tile the 19-channel stack, MinMax, a k-means++ and Lloyd fit on every
``fit_stride``-th pixel and the assignment of every pixel. The next batch
is queued before the previous batch's maps are fetched to host numpy
(``batch_loop.window``).

Traffic keys: ``method`` (``kmeans``), ``batch``, ``pool`` (a multiple of
``batch``), ``keep_share`` (as ``batch_loop``'s).
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from perfbench.inputs import scenes as scene_gen
# the closed loop and the kept answers are batch_loop's
from perfbench.loops.batch_loop import answers, window  # noqa: F401


def inputs(ctx) -> dict:
    """The fixed scene's tiles (every input is a pool tile)."""
    tile = ctx.cfg["tile"]
    with ctx.timed("inputs_s"):
        pool = scene_gen.synthetic_pool(ctx.traffic["pool"], tile["height"],
                                        tile["width"],
                                        ctx.cfg["content"]["seed"], ctx.dev)
    return {"pool": pool, "inputs": dict(enumerate(pool)), "fields": None,
            "depth": 0}


def _feature_config(cfg: dict):
    """The port's ``FeatureStageConfig`` from the configuration file."""
    from rs_image_segmentation_tpu_torch.core import config as pc
    f = cfg["features"]
    return pc.FeatureStageConfig(
        normalize=pc.NormalizeConfig(**f["normalize"]),
        glcm=pc.GLCMConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in f["glcm"].items()}),
        context=pc.SpatialContextConfig(**f["context"]),
        texture_band_index=f["texture_band_index"])


def _check_fit_settings(km: dict) -> None:
    """The batch program fits with ``fit_centroids``' own ``tol`` and
    ``max_iter`` and one k-means++ start: stop where the configuration
    asks for others."""
    from rs_image_segmentation_tpu_torch.models.kmeans import fit_centroids
    params = inspect.signature(fit_centroids).parameters
    port = {"tol": params["tol"].default,
            "max_iter": params["max_iter"].default, "n_init": 1}
    if any(km[key] != v for key, v in port.items()):
        raise SystemExit(f"the KMeans program fits with {port}; the "
                         f"configuration asks for "
                         f"{ {key: km[key] for key in port} }")


def setup(ctx):
    from rs_image_segmentation_tpu_torch.pipeline import preprocess, turbo
    t, km = ctx.traffic, ctx.cfg["kmeans"]
    _check_fit_settings(km)
    st = inputs(ctx)
    pool = st["pool"]
    feat = _feature_config(ctx.cfg)
    cal = ctx.cfg["calibration"]
    gains, biases = np.asarray(cal["gains"]), np.asarray(cal["biases"])
    b = t["batch"]
    batches = [pool[i:i + b] for i in range(0, len(pool), b)]

    def prep(scenes):
        return np.stack([preprocess.build_stretch_lut(s, gains, biases)
                         for s in scenes]).astype(np.uint8)

    def launch(scenes, tables):
        return turbo.kmeans_scenes_turbo_batch(
            scenes, tables, km["n_clusters"], feat, seed=km["seed"],
            fit_stride=km["fit_stride"], device=ctx.dev)

    def fetch(scenes, tables, out):
        return out.cpu().numpy()

    st["batches"] = batches
    st["program"] = {"prep": prep, "launch": launch, "fetch": fetch}
    with ctx.timed("warmup_s"):
        for scenes in batches:
            fetch(scenes, None, launch(scenes, prep(scenes)))
        ctx.tracer.warm(lambda: fetch(batches[0], None,
                                      launch(batches[0], prep(batches[0]))))
        if ctx.dev.type == "cuda":
            torch.cuda.synchronize()
    return st


def work(ctx, st, ops_per_pixel):
    """The unit (a batch) of work, for the counts: the preamble's
    ``lut_hist`` call with its histogram, and the step every
    implementation must do, its operations the reference's."""
    b, c, h, w = st["batches"][0].shape
    n = h * w
    calls = {"lut_hist": [{"planes": b * c, "pixels": n, "out_bytes": 4,
                           "hist": True}]}
    step = {"raw_bytes": b * c * n, "map_bytes": b * n, "table_bytes": 0,
            "ops": ops_per_pixel * b * n}
    return {"calls": calls, "step": step}
