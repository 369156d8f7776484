"""What every traffic loop's set-up shares: the run's context, the port's
configuration objects built from the configuration file, the seeded pool of
scenes and the forest fitted on it."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from perfbench.harness.trace import Tracer
from perfbench.inputs import forest as forest_fit
from perfbench.inputs import scenes as scene_gen
from perfbench.reference import landcover


@dataclasses.dataclass
class Context:
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    dev: torch.device
    tracer: Tracer
    parts: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def timed(self, part: str):
        """Add the body's seconds to set-up part ``part``."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[part] = (self.parts.get(part, 0.0)
                                + time.perf_counter() - t)

    def port_configs(self):
        """``(FeatureStageConfig, CalibrationConfig, RuleBasedConfig)`` of
        the port, from the configuration file."""
        from rs_image_segmentation_tpu_torch.core import config as pc
        f = self.cfg["features"]
        feat = pc.FeatureStageConfig(
            normalize=pc.NormalizeConfig(**f["normalize"]),
            glcm=pc.GLCMConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in f["glcm"].items()}),
            context=pc.SpatialContextConfig(**f["context"]),
            texture_band_index=f["texture_band_index"])
        cal = pc.CalibrationConfig(**{k: tuple(v) for k, v in
                                      self.cfg["calibration"].items()})
        return feat, cal, pc.RuleBasedConfig(**self.cfg["rules"])


def make_pool(ctx: Context, n: Optional[int] = None) -> np.ndarray:
    """The seed's pool of tiles, (n, 7, h, w) uint8 on the host."""
    tile = ctx.cfg["tile"]
    n = n if n is not None else ctx.traffic["pool"]
    with ctx.timed("inputs_s"):
        pool = scene_gen.synthetic_pool(n, tile["height"], tile["width"],
                                        ctx.seed, ctx.dev)
    gains = ctx.cfg["calibration"]["gains"]
    biases = ctx.cfg["calibration"]["biases"]
    modes = np.stack([scene_gen.stretch_modes(s, gains, biases)
                      for s in pool])
    ctx.notes["stretch_bands_fixed_point"] = int(modes.sum())
    ctx.notes["stretch_bands_table"] = int(modes.size - modes.sum())
    return pool


def make_forest(ctx: Context, scene0: np.ndarray):
    """``(fields, depth)``: the configuration's forest, fitted on rule
    labels of pixels of the reference stack of ``scene0``."""
    f = ctx.cfg["forest"]
    with ctx.timed("forest_fit_s"):
        stack0 = landcover.stack(scene0, ctx.cfg, ctx.dev).cpu().numpy()
        fields, depth = forest_fit.rule_forest(stack0, f["samples"],
                                               f["n_estimators"], f["seed"])
    if ctx.dev.type == "cuda":      # the program's peak, not the fit's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    inner = int(np.sum(fields["left"] != np.arange(fields["left"].shape[1])))
    ctx.notes["forest_leaves"] = inner + fields["left"].shape[0]
    ctx.notes["forest_depth"] = depth
    return fields, depth


def forest_table_bytes(fields: dict) -> int:
    """Bytes of the forest's tables as fitted: per real node its feature,
    threshold and two children (4 bytes each), and per leaf its class
    distribution (f32)."""
    left = fields["left"]
    inner = int(np.sum(left != np.arange(left.shape[1])))
    leaves = inner + left.shape[0]          # a binary tree: inner + 1
    return (inner + leaves) * 16 + leaves * fields["leaf_proba"].shape[2] * 4


def port_forest(fields: dict, dev: torch.device):
    """``(FlatForest, GemmForest)`` of the port on ``dev``, built by the
    port's own set-up from the forest's fields."""
    from rs_image_segmentation_tpu_torch.models.forest import (
        GemmForest, _gemm_for, flat_forest_from_numpy)
    flat = flat_forest_from_numpy(fields)
    gf = _gemm_for(flat, 19)
    return flat, GemmForest(*(t.to(dev) for t in gf))


def per_second(marks) -> list:
    """Megapixels completed in each whole second of the window, from
    ``(seconds since the start, pixels)`` completions: how steady a run
    was, printed with the notes."""
    n = int(max((t for t, _ in marks), default=0.0)) + 1
    out = [0.0] * n
    for t, px in marks:
        out[int(t)] += px / 1e6
    return [round(x, 2) for x in out]
