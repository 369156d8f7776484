"""Synthetic 7-band uint8 scenes, and a forest fitted on them, for tests
and smoke runs (numpy only); and the stage-3 fixtures of the JAX
package's ``tools.fixtures`` (synthetic georeferencing, a dummy stage-2
pickle, a random class map), which give the same arrays for the same
seed.

Each band is a smoothed random field: a coarse field shared by all bands
of a scene (so bands correlate, as land cover makes them), plus a finer
field of the band's own, stretched to the band's DN range. Band
``FULL_RANGE_BAND`` spans exactly 0..255, so ``build_stretch_params``
gives it mode 0 (the JAX mixed kernel's table route); the other bands
span narrower ranges and take mode 1 (its fixed-point route), so the
parity tests cover both of the JAX kernel's routes.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from ..core.config import CalibrationConfig, ForestConfig
from ..core.types import GeoMeta
from ..models.forest import _gemm_for, fit_random_forest, forest_tree_plan
from ..pipeline.preprocess import build_stretch_params, build_stretch_stats

FULL_RANGE_BAND = 4


def _box(a: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Running mean of width ``k`` along ``axis`` with reflected borders."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (k // 2, k - 1 - k // 2)
    c = np.cumsum(np.pad(a, pad, mode="reflect"), axis=axis)
    c = np.concatenate([np.zeros_like(c.take([0], axis=axis)), c], axis=axis)
    n = a.shape[axis]
    return (c.take(np.arange(k, n + k), axis=axis)
            - c.take(np.arange(n), axis=axis)) / k


def _smooth(a: np.ndarray, k: int) -> np.ndarray:
    for _ in range(2):                      # two box passes ~ a Gaussian
        a = _box(_box(a, k, 0), k, 1)
    return a


def synthetic_scenes(batch: int, h: int, w: int, seed: int = 0
                     ) -> np.ndarray:
    """(batch, 7, h, w) uint8 scenes from ``seed``; the narrow bands' DN
    ranges are drawn until the default calibration sends them to mode 1."""
    calibration = CalibrationConfig()
    gains = np.asarray(calibration.gains)
    biases = np.asarray(calibration.biases)
    bands = len(gains)
    rng = np.random.default_rng(seed)
    out = np.empty((batch, bands, h, w), np.uint8)
    coarse_k = max(3, min(h, w) // 12)
    for b in range(batch):
        base = _smooth(rng.standard_normal((h, w)), coarse_k)
        base /= base.std() + 1e-12
        for c in range(bands):
            own = _smooth(rng.standard_normal((h, w)), 5)
            own /= own.std() + 1e-12
            f = ((1.0 - 0.1 * c) * base + (0.3 + 0.1 * c) * own
                 + 0.05 * rng.standard_normal((h, w)))
            f = (f - f.min()) / (f.max() - f.min())
            if c == FULL_RANGE_BAND:
                out[b, c] = np.round(f * 255.0).astype(np.uint8)
                continue
            # draw narrow ranges until the band takes the fixed-point route
            for _ in range(100):
                lo = int(rng.integers(10, 40))
                hi = int(rng.integers(150, 230))
                out[b, c] = np.round(lo + f * (hi - lo)).astype(np.uint8)
                _, sp = build_stretch_params(out[b, c:c + 1], gains[c:c + 1],
                                             biases[c:c + 1])
                if sp[0, 0] == 1:
                    break
    return out


def stretch_stats_batch(scenes: np.ndarray):
    """``build_stretch_stats`` of each scene of a (B, 7, H, W) uint8 batch
    under the default calibration, stacked: ``(luts (B, 7, 256) uint8,
    params (B, 7, 3 + 2K) int32, hists (B, 7, 256) int32)``."""
    calibration = CalibrationConfig()
    stats = [build_stretch_stats(s, np.asarray(calibration.gains),
                                 np.asarray(calibration.biases))
             for s in scenes]
    luts, params, hists = (np.stack(part) for part in zip(*stats))
    return luts.astype(np.uint8), params, hists


def rule_labels(stack: np.ndarray, pick: np.ndarray) -> np.ndarray:
    """Classes 1..4 of the sampled pixels ``pick`` of a (19, H, W) stack:
    above or below the samples' median NDVI (channel 2) and median NDWI
    (channel 0)."""
    flat = stack.reshape(stack.shape[0], -1)
    ndvi, ndwi = flat[2, pick], flat[0, pick]
    return 1 + (ndvi > np.median(ndvi)) + 2 * (ndwi > np.median(ndwi))


SAMPLE_COUNTS = (33, 48, 64, 96, 128, 192, 256, 384)


def spiral_mask(h: int, w: int) -> np.ndarray:
    """Concentric rings two pixels apart, each joined to the next: one
    component that turns at every ring (the JAX package's structured-mask
    test)."""
    m = np.zeros((h, w), bool)
    top, bot, lef, rig = 0, h - 1, 0, w - 1
    while top <= bot and lef <= rig:
        m[top, lef:rig + 1] = True
        m[top:bot + 1, rig] = True
        m[bot, lef:rig + 1] = True
        m[top:bot + 1, lef] = True
        top, bot, lef, rig = top + 2, bot - 2, lef + 2, rig - 2
    return m


def serpentine_mask(h: int, w: int) -> np.ndarray:
    """Every other row set, joined at alternate ends: one component that
    turns h / 2 times (the JAX package's structured-mask test)."""
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    m[1::4, -1] = True
    m[3::4, 0] = True
    return m


def rule_forest(stack: np.ndarray):
    """A forest of ``ForestConfig()`` (100 trees, seed 42) fitted by the
    port's trainer on :func:`rule_labels` of random pixels of ``stack``,
    with the fewest samples in SAMPLE_COUNTS (33 is the bundled sample
    set's size) whose GemmForest has a tree plan, i.e. the bundled model's
    scale. Returns ``(gemm_forest, plan, n_samples, max_depth,
    flat_forest)``."""
    cfg = ForestConfig()
    flat = stack.reshape(stack.shape[0], -1)
    rng = np.random.default_rng(cfg.seed)
    for n in SAMPLE_COUNTS:
        pick = rng.choice(flat.shape[1], n, replace=False)
        forest, depth = fit_random_forest(flat[:, pick].T,
                                          rule_labels(stack, pick),
                                          n_estimators=cfg.n_estimators,
                                          seed=cfg.seed)
        gf = _gemm_for(forest, flat.shape[0])
        plan = forest_tree_plan(gf)
        if plan is not None:
            return gf, plan, n, depth, forest
    raise RuntimeError("no sample count gave a forest with a tree plan")


def deep_forest_fields(stack: np.ndarray, depth: int = 12, n_trees: int = 5,
                       n_classes: int = 4, seed: int = 0) -> dict:
    """Numpy ``FlatForest`` fields (``flat_forest_from_numpy``) of
    ``n_trees`` complete trees of ``depth`` levels, 2**depth leaves each:
    at the defaults 20 480 leaves, past ``GEMM_MAX_LEAVES``, so its GEMM
    form keeps a sparse path. Each internal node splits a random feature
    at a uniform draw between that feature's 1st and 99th percentiles
    over the (F, H, W) ``stack`` (a continuous draw: no pixel's value sits
    on a threshold, so a rounding step of a feature flips no split); each
    leaf holds a random class distribution (classes 1..n_classes). The
    JAX package's ``FlatForest`` takes the same arrays."""
    rng = np.random.default_rng(seed)
    lo, hi = np.percentile(stack.reshape(stack.shape[0], -1), (1, 99),
                           axis=1)
    n_nodes = 2 ** (depth + 1) - 1
    node = np.arange(n_nodes, dtype=np.int32)
    inner = node < 2 ** depth - 1
    feature = np.where(inner, rng.integers(0, stack.shape[0],
                                           (n_trees, n_nodes)), 0)
    u = rng.random((n_trees, n_nodes))
    threshold = np.where(inner, lo[feature] + u * (hi - lo)[feature], np.inf)
    left = np.broadcast_to(np.where(inner, 2 * node + 1, node),
                           (n_trees, n_nodes))
    right = np.broadcast_to(np.where(inner, 2 * node + 2, node),
                            (n_trees, n_nodes))
    return {"feature": feature.astype(np.int32),
            "threshold": threshold.astype(np.float32),
            "left": left.astype(np.int32), "right": right.astype(np.int32),
            "leaf_proba": rng.dirichlet(np.ones(n_classes), (n_trees, n_nodes)
                                        ).astype(np.float32),
            "classes": np.arange(1, n_classes + 1, dtype=np.int32)}


def synthetic_geometa(shape: Tuple[int, int] = (256, 256)) -> GeoMeta:
    """EPSG:32630, 30 m pixels at a plausible UTM origin."""
    return GeoMeta(transform=(30.0, 0.0, 500000.0, 0.0, -30.0, 4000000.0),
                   crs="EPSG:32630")


def make_dummy_feature_pkl(path: Optional[str] = None,
                           shape: Tuple[int, int] = (256, 256),
                           seed: int = 0) -> dict:
    """Random index maps + hierarchical stacks with the stage-2 pickle
    layout; written to ``path`` when one is given."""
    rng = np.random.default_rng(seed)
    h, w = shape
    idx = {name: rng.uniform(-1, 1, (h, w)).astype(np.float32)
           for name in ["ndvi", "ndwi", "mndwi", "ndbi", "bsi", "evi",
                        "msavi"]}
    idx["texture_mean"] = rng.random((h, w)).astype(np.float32)
    level1 = rng.random((h, w, 14)).astype(np.float32)
    level2 = rng.random((h, w, 5)).astype(np.float32)
    meta = synthetic_geometa(shape)
    payload = {
        "all_extracted_features_dict": idx,
        "hierarchical_features": {
            "level_1": level1,
            "level_2": level2,
            "all": np.concatenate([level1, level2], axis=-1),
        },
        "dimensions": (h, w),
        "geo_transform": meta.to_gdal(),
        "crs": meta.crs,
    }
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    return payload


def make_random_classification_map(shape: Tuple[int, int] = (256, 256),
                                   n_classes: int = 4,
                                   seed: int = 0) -> np.ndarray:
    """Random uint8 label map, labels 0..n_classes."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_classes + 1, shape).astype(np.uint8)
