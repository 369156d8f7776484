"""Seeded synthetic Landsat TM scenes: the benchmark's inputs.

Frozen copy of the recipe of
``rs_image_segmentation_tpu_torch/tools/fixtures.py::synthetic_scenes`` at
commit 3b8722c442acffa7c4dd38665a58daa3434fcab6, made on the device from a
``torch.Generator`` in a few large calls. Each band is a smoothed random
field: a coarse field shared by the bands of a scene (so bands correlate,
as land cover makes them) plus a finer field of the band's own and a
little noise, stretched to the band's DN range. Band ``FULL_RANGE_BAND``
spans 0..255, so its stretch has no fixed-point form (mode 0); the other
bands span narrower ranges and mostly take the fixed-point route (mode 1).
The original draws ranges until every narrow band takes mode 1; this copy
draws once, and :func:`stretch_modes` (a copy of the mode test of
``pipeline/preprocess.py::build_stretch_params`` at the same commit)
counts the routes the pool takes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FULL_RANGE_BAND = 4
BANDS = 7


def _box(a: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Running mean of width ``k`` along ``dim`` (-2 or -1) of (N, C, H, W),
    reflected borders."""
    lo, hi = k // 2, k - 1 - k // 2
    if dim == -2:
        return F.avg_pool2d(F.pad(a, (0, 0, lo, hi), mode="reflect"),
                            (k, 1), stride=1)
    return F.avg_pool2d(F.pad(a, (lo, hi, 0, 0), mode="reflect"), (1, k),
                        stride=1)


def _smooth(a: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(2):                      # two box passes ~ a Gaussian
        a = _box(_box(a, k, -2), k, -1)
    return a


def _unit_std(a: torch.Tensor) -> torch.Tensor:
    return a / (a.std(dim=(-2, -1), keepdim=True) + 1e-12)


def synthetic_pool(n: int, h: int, w: int, seed: int,
                   device="cuda") -> np.ndarray:
    """(n, 7, h, w) uint8 host scenes from ``seed``, generated on
    ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    kw = dict(generator=g, device=device, dtype=torch.float32)
    coarse_k = max(3, min(h, w) // 12)
    base = _unit_std(_smooth(torch.randn((n, 1, h, w), **kw), coarse_k))
    own = _unit_std(_smooth(torch.randn((n, BANDS, h, w), **kw), 5))
    c = torch.arange(BANDS, device=device, dtype=torch.float32)[:, None,
                                                                 None]
    f = ((1.0 - 0.1 * c) * base + (0.3 + 0.1 * c) * own
         + 0.05 * torch.randn((n, BANDS, h, w), **kw))
    mn = f.amin(dim=(-2, -1), keepdim=True)
    mx = f.amax(dim=(-2, -1), keepdim=True)
    f = (f - mn) / (mx - mn)
    lo = torch.randint(10, 40, (n, BANDS, 1, 1), generator=g, device=device)
    hi = torch.randint(150, 230, (n, BANDS, 1, 1), generator=g,
                       device=device)
    full = (c == FULL_RANGE_BAND)
    lo = torch.where(full, 0, lo).to(torch.float32)
    hi = torch.where(full, 255, hi).to(torch.float32)
    out = torch.round(lo + f * (hi - lo)).to(torch.uint8)
    return out.cpu().numpy()


def mosaic(pool: np.ndarray, tiles: int, seed) -> np.ndarray:
    """A (7, tiles * h, tiles * w) scene of ``tiles`` x ``tiles`` tiles
    drawn from the (n, 7, h, w) ``pool``, each flipped or not, as ``seed``
    says."""
    n, c, h, w = pool.shape
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, n, (tiles, tiles))
    flip = rng.integers(0, 4, (tiles, tiles))
    out = np.empty((c, tiles * h, tiles * w), np.uint8)
    for i in range(tiles):
        for j in range(tiles):
            t = pool[pick[i, j]]
            if flip[i, j] & 1:
                t = t[:, ::-1, :]
            if flip[i, j] & 2:
                t = t[:, :, ::-1]
            out[:, i * h:(i + 1) * h, j * w:(j + 1) * w] = t
    return out


STRETCH_FIXUPS = 6
_SHIFT = 16


def stretch_modes(scene: np.ndarray, gains, biases) -> np.ndarray:
    """(C,) stretch route of each band of a (C, H, W) uint8 scene: 1 where
    the int32 fixed point (with at most ``STRETCH_FIXUPS`` corrections)
    reproduces the exact f64 table on the band's DN range, else 0."""
    g = np.asarray(gains, np.float64)
    b = np.asarray(biases, np.float64)
    modes = np.zeros(scene.shape[0], np.int32)
    dn = np.arange(256, dtype=np.float64)
    for i in range(scene.shape[0]):
        vmin, vmax = int(scene[i].min()), int(scene[i].max())
        cal_lo, cal_hi = g[i] * vmin + b[i], g[i] * vmax + b[i]
        mn, mx = min(cal_lo, cal_hi), max(cal_lo, cal_hi)
        if mx <= mn:
            continue
        cal = g[i] * dn + b[i]
        want = np.clip((cal - mn) * 255.0 / (mx - mn), 0, 255).astype(
            np.int64)[vmin:vmax + 1]
        a32 = int(round(255.0 * g[i] / (mx - mn) * (1 << _SHIFT)))
        if abs(a32) > (1 << 23):
            continue
        off = (b[i] - mn) * 255.0 / (mx - mn)
        v = np.arange(vmin, vmax + 1, dtype=np.int64)
        bad = min(int(np.count_nonzero(
            np.clip((a32 * v + int(round(off * (1 << _SHIFT))) + db)
                    >> _SHIFT, 0, 255) != want)) for db in range(-2, 3))
        modes[i] = int(bad <= STRETCH_FIXUPS)
    return modes
