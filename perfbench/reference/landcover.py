"""Plain reference of the land-cover programs the benchmark times.

Straightforward PyTorch and NumPy, independent of the code under test: it
imports neither ``jax`` nor either package of the repository, and takes
nothing the program made. From a raw (7, H, W) uint8 scene and a
configuration file's settings it computes again:

* the calibrate + min-max stretch table of each band (f64, per DN) and the
  stretched scene with its 256-bin histograms;
* the 19-channel stack over the WHOLE scene: percentile normalisation
  (the linear percentile of the exact histograms), the six spectral
  indices, PC1 of the RobustScaler'd bands (f64 moments), their 7 x 7
  context means, GLCM contrast and homogeneity of the texture band (as
  means over co-occurring pairs, the normalised symmetric matrix's
  weighted sums) resized back, the 5 x 5 morphological gradient, the
  5 x 5 local standard deviation and the scene-normalised Sobel magnitude;
* the forest's labels by walking each tree (the mean leaf distribution in
  f64, ties to the lowest class), and the node comparisons that walk makes;
* the rule classification: thresholds, elliptical closing, removal of
  8-connected components below their minimum area (``scipy.ndimage``, no
  id cap), opening, priority paint and the bare-land pass.

``store_dtype`` rounds the stack (or the rule indices) through a lower
precision: the control that a sound comparison has to reject.

``METHODS`` holds the traffic methods it serves, in the form
``perfbench/harness/check.py`` describes; the configurations name this
file as their ``reference``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage


def stretch_lut(scene: np.ndarray, gains, biases) -> np.ndarray:
    """(C, 256) uint8: per band ``(g * dn + b - mn) * 255 / (mx - mn)``
    truncated, ``mn`` and ``mx`` the calibrated values of the band's
    present extremes (DNs outside them never index the table)."""
    dn = np.arange(256, dtype=np.float64)
    out = np.zeros((scene.shape[0], 256), np.uint8)
    for i, band in enumerate(scene):
        cal = float(gains[i]) * dn + float(biases[i])
        ends = cal[int(band.min())], cal[int(band.max())]
        mn, mx = min(ends), max(ends)
        out[i] = np.clip((cal - mn) * 255.0 / (mx - mn), 0, 255).astype(
            np.uint8)
    return out


def stretched(scene: np.ndarray, gains, biases, device):
    """``(levels (C, H, W) uint8 tensor, hist (C, 256) int64 numpy)``."""
    lut = stretch_lut(scene, gains, biases)
    x = torch.from_numpy(scene).to(device).long()
    st = torch.gather(torch.from_numpy(lut).to(device), 1,
                      x.reshape(x.shape[0], -1)).reshape(x.shape)
    hist = np.stack([np.bincount(lut[i][scene[i].reshape(-1)],
                                 minlength=256) for i in range(len(lut))])
    return st, hist


def percentile(hist: np.ndarray, values: np.ndarray, q: float,
               dtype=np.float32) -> float:
    """The linear percentile (numpy's default method) of the multiset
    holding ``hist[k]`` copies of ``values[k]`` (ascending), interpolated
    as ``v_lo * (1 - frac) + v_hi * frac`` in ``dtype``: the precision the
    configuration states for its global statistics (``statistics_dtype``),
    so an index plane sits on the values the pipeline defines."""
    n = int(hist.sum())
    pos = q / 100.0 * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    cum = np.cumsum(hist)
    v_lo = dtype(values[np.searchsorted(cum, lo + 1)])
    v_hi = dtype(values[np.searchsorted(cum, hi + 1)])
    frac = dtype(pos - lo)
    return float(v_lo * (dtype(1.0) - frac) + v_hi * frac)


def _ratio(num, den):
    ok = den > 1e-3
    return torch.clamp(torch.where(ok, num / torch.where(ok, den, 1.0), 0.0),
                       -1.0, 1.0)


def indices(b: torch.Tensor) -> dict:
    """Spectral indices of (7, ...) normalised TM bands (blue, green, red,
    NIR, SWIR1, thermal, SWIR2)."""
    blue, green, red, nir, swir = b[0], b[1], b[2], b[3], b[4]
    return {"ndvi": _ratio(nir - red, nir + red),
            "ndwi": _ratio(green - nir, green + nir),
            "mndwi": _ratio(green - swir, green + swir),
            "ndbi": _ratio(swir - nir, swir + nir),
            "evi": _ratio(2.5 * (nir - red), nir + 6.0 * red - 7.5 * blue
                          + 1.0),
            "bsi": _ratio((swir + red) - (nir + blue),
                          (swir + red) + (nir + blue))}


def _normalise(st: torch.Tensor, hist: np.ndarray, norm: dict, dt):
    """Bands clipped to their lower/upper percentiles (interpolated in
    ``dt``) and scaled to [0, 1] in f32, with the normalised value of every
    level (the same f32 arithmetic)."""
    levels = np.arange(256, dtype=np.float64)
    lo = np.array([percentile(h, levels, norm["lower_percentile"], dt)
                   for h in hist], np.float32)
    hi = np.array([percentile(h, levels, norm["upper_percentile"], dt)
                   for h in hist], np.float32)
    lo_t = torch.from_numpy(lo).to(st.device)[:, None]
    hi_t = torch.from_numpy(hi).to(st.device)[:, None]
    den = hi_t - lo_t + norm["epsilon"]
    lv = torch.arange(256, dtype=torch.float32, device=st.device)[None]
    level01 = (torch.clamp(lv, lo_t, hi_t) - lo_t) / den
    c = st.shape[0]
    b01 = torch.gather(level01, 1, st.reshape(c, -1).long()).reshape(st.shape)
    return b01, level01.cpu().numpy()


def _box(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """k x k mean of (N, H, W) planes; ``mode`` 'reflect' (OpenCV's
    BORDER_REFLECT_101) or 'symmetric' (BORDER_REFLECT)."""
    a = k // 2
    if mode == "reflect":
        xp = F.pad(x[:, None], (a, a, a, a), mode="reflect")
    else:
        h, w = x.shape[-2:]
        ri = np.pad(np.arange(h), a, mode="symmetric")
        ci = np.pad(np.arange(w), a, mode="symmetric")
        xp = x[:, torch.from_numpy(ri).to(x.device)][
            :, :, torch.from_numpy(ci).to(x.device)][:, None]
    return F.avg_pool2d(xp.double(), k, stride=1)[:, 0].float()


def _minmax_rect(u8: torch.Tensor, k: int, fn) -> torch.Tensor:
    """k x k max (``fn=max``) or min of an (H, W) plane; out-of-image
    pixels never win."""
    a = k // 2
    x = u8.float()[None, None]
    if fn == "max":
        return F.max_pool2d(F.pad(x, (a, a, a, a), value=-1.0), k,
                            stride=1)[0, 0]
    return -F.max_pool2d(F.pad(-x, (a, a, a, a), value=-256.0), k,
                         stride=1)[0, 0]


def _sobel_mag(x: torch.Tensor) -> torch.Tensor:
    """Sobel magnitude of an (H, W) plane of integer levels: the gradients
    are exact integers, the root float32's."""
    xp = F.pad(x[None, None], (1, 1, 1, 1), mode="reflect").double()
    kx = torch.tensor([[-1., 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float64, device=x.device)
    gx = F.conv2d(xp, kx[None, None])[0, 0].float()
    gy = F.conv2d(xp, kx.T.contiguous()[None, None])[0, 0].float()
    return torch.sqrt(gx * gx + gy * gy)


def _glcm_maps(q: torch.Tensor, window: int, step: int, angles,
               out_hw) -> tuple:
    """Mean over angles of each window's GLCM contrast and homogeneity,
    resized bilinearly (half-pixel centres) to ``out_hw``. The symmetric
    normalised co-occurrence matrix weights every co-occurring pair
    equally, so its weighted sums are means over the pairs."""
    h, w = q.shape
    n_i, n_j = (h - window) // step + 1, (w - window) // step + 1
    con = torch.zeros((n_i, n_j), dtype=torch.float64, device=q.device)
    hom = torch.zeros_like(con)
    qd = q.double()
    for a in angles:
        dr, dc = int(round(math.sin(a))), int(round(math.cos(a)))
        r0, r1 = max(0, -dr), window - max(0, dr)
        c0, c1 = max(0, -dc), window - max(0, dc)
        src, dst = [], []
        for i in range(n_i):
            ys = i * step
            src.append(qd[ys + r0:ys + r1])
            dst.append(qd[ys + r0 + dr:ys + r1 + dr])
        src, dst = torch.stack(src), torch.stack(dst)   # (n_i, rows, W)
        d = []
        for j in range(n_j):
            xs = j * step
            d.append(src[:, :, xs + c0:xs + c1] - dst[:, :, xs + c0 + dc:
                                                      xs + c1 + dc])
        d2 = torch.stack(d, dim=1) ** 2                  # (n_i, n_j, r, c)
        con += d2.mean(dim=(-2, -1))
        hom += (1.0 / (1.0 + d2)).mean(dim=(-2, -1))
    grids = torch.stack([con, hom]).float() / len(angles)
    maps = F.interpolate(grids[None], size=tuple(out_hw), mode="bilinear",
                         align_corners=False)[0]
    return maps[0], maps[1]


def stack(scene: np.ndarray, cfg: dict, device, store_dtype=None
          ) -> torch.Tensor:
    """(19, H, W) f32 stack of a raw (7, H, W) uint8 scene on ``device``.
    Channels: ndwi, mndwi, ndvi, evi, ndbi, bsi, pc1; their 7 x 7 context
    means; GLCM contrast, homogeneity, grad5, std5, Sobel magnitude."""
    cal, feat = cfg["calibration"], cfg["features"]
    norm = feat["normalize"]
    dt = np.dtype(cfg["statistics_dtype"]).type
    st, hist = stretched(scene, cal["gains"], cal["biases"], device)
    b01, level01 = _normalise(st, hist, norm, dt)
    c, h, w = b01.shape
    n = h * w
    idx = indices(b01)

    # PC1 of the RobustScaler'd bands: median and IQR of the normalised
    # values, f64 moments, the leading eigenvector with svd_flip's sign
    med = np.array([percentile(hist[i], level01[i], 50.0, dt)
                    for i in range(c)])
    iqr = np.array([dt(percentile(hist[i], level01[i], 75.0, dt))
                    - dt(percentile(hist[i], level01[i], 25.0, dt))
                    for i in range(c)])
    iqr = np.where(iqr > 0, iqr, 1.0)
    xs = ((b01 - torch.from_numpy(med.astype(np.float32)).to(device)[:, None,
                                                                     None])
          / torch.from_numpy(iqr.astype(np.float32)).to(device)[:, None, None])
    flat = xs.reshape(c, n).double()
    mean = flat.mean(dim=1)
    cen = flat - mean[:, None]
    cov = (cen @ cen.T / (n - 1)).cpu().numpy()
    vals, vecs = np.linalg.eigh(cov)
    comp = vecs[:, int(np.argmax(vals))]
    if comp[np.argmax(np.abs(comp))] < 0:
        comp = -comp
    pc1 = (torch.from_numpy(comp).to(device) @ cen).reshape(h, w).float()
    del flat, cen

    # texture band: renormalised between its own percentiles
    tb = feat["texture_band_index"]
    tlo, thi = (torch.tensor(percentile(hist[tb], level01[tb], q, dt),
                             dtype=torch.float32, device=device)
                for q in (norm["lower_percentile"], norm["upper_percentile"]))
    # float32 throughout: a texture value on a level boundary truncates
    # alike only if its bounds' difference is rounded as the pipeline does
    tex = (torch.clamp(b01[tb], tlo, thi) - tlo) / (thi - tlo
                                                     + norm["epsilon"])
    g = feat["glcm"]
    con, hom = _glcm_maps((tex * (g["levels"] - 1)).to(torch.uint8),
                          g["window_size"], g["step_size"], g["angles"],
                          (h, w))
    u8 = (tex * 255.0).to(torch.uint8)
    grad5 = (_minmax_rect(u8, 5, "max") - _minmax_rect(u8, 5, "min")) * (
        1.0 / 255.0)
    mean5 = _box(tex[None], 5, "reflect")[0]
    var5 = _box((tex * tex)[None], 5, "reflect")[0] - mean5 * mean5
    std5 = torch.sqrt(torch.clamp_min(var5, 0.0))
    smag = _sobel_mag(u8.float()) * (1.0 / 255.0)
    smag = smag / (smag.max() + 1e-10)

    level_1 = torch.stack([idx["ndwi"], idx["mndwi"], idx["ndvi"],
                           idx["evi"], idx["ndbi"], idx["bsi"], pc1])
    ctx = _box(level_1, feat["context"]["window_size"], "symmetric")
    out = torch.cat([level_1, ctx, torch.stack([con, hom, grad5, std5,
                                                smag])]).float()
    if store_dtype is not None:
        out = out.to(store_dtype).float()
    return out


def forest_walk(fields: dict, x: torch.Tensor, depth: int,
                chunk: int = 1 << 17):
    """``(labels (N,) int64, comparisons)`` of (F, N) features: each tree
    walked from its root, one comparison ``x[f] <= t`` a level until its
    leaf; the class of the largest mean leaf distribution (f64), ties to
    the lowest."""
    dev = x.device
    feat = torch.from_numpy(fields["feature"]).to(dev).long()
    thr = torch.from_numpy(fields["threshold"]).to(dev)
    left = torch.from_numpy(fields["left"]).to(dev).long()
    right = torch.from_numpy(fields["right"]).to(dev).long()
    proba = torch.from_numpy(fields["leaf_proba"]).to(dev).double()
    classes = torch.from_numpy(fields["classes"]).to(dev).long()
    trees = torch.arange(feat.shape[0], device=dev)
    labels = torch.empty(x.shape[1], dtype=torch.int64, device=dev)
    comparisons = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, x.shape[1], chunk):
        xb = x[:, s:s + chunk].T                        # (n, F)
        node = torch.zeros((xb.shape[0], trees.numel()), dtype=torch.int64,
                           device=dev)
        for _ in range(depth):
            inner = left[trees, node] != node
            comparisons += inner.sum()
            xv = torch.gather(xb, 1, feat[trees, node])
            node = torch.where(xv <= thr[trees, node], left[trees, node],
                               right[trees, node])
        labels[s:s + chunk] = classes[torch.argmax(
            proba[trees, node].sum(dim=1), dim=1)]
    return labels, int(comparisons.item())


def forest_labels(scene: np.ndarray, cfg: dict, fields: dict, depth: int,
                  device, store_dtype=None):
    """``(labels (H, W) int64 numpy, comparisons)`` of a raw scene."""
    s = stack(scene, cfg, device, store_dtype)
    f, h, w = s.shape
    labels, comparisons = forest_walk(fields, s.reshape(f, h * w), depth)
    return labels.reshape(h, w).cpu().numpy(), comparisons


# ------------------------------------------------------------------ rules

def _ellipse(k: int) -> np.ndarray:
    """OpenCV's MORPH_ELLIPSE element of size k."""
    r = k // 2
    el = np.zeros((k, k), bool)
    for i in range(k):
        dx = r * math.sqrt(max((r * r - (i - r) ** 2) / (r * r), 0.0))
        el[i, max(int(round(r - dx)), 0):min(int(round(r + dx + 1)), k)] = 1
    return el


def _close(m: np.ndarray, k: int) -> np.ndarray:
    el = _ellipse(k)
    d = ndimage.binary_dilation(m, el, border_value=0)
    return ndimage.binary_erosion(d, el, border_value=1)


def _open(m: np.ndarray, k: int) -> np.ndarray:
    el = _ellipse(k)
    e = ndimage.binary_erosion(m, el, border_value=1)
    return ndimage.binary_dilation(e, el, border_value=0)


def _drop_small(m: np.ndarray, min_area: int) -> np.ndarray:
    lab, _ = ndimage.label(m, structure=np.ones((3, 3), int))
    area = np.bincount(lab.reshape(-1))
    keep = area >= min_area
    keep[0] = False
    return keep[lab]


def rule_labels(scene: np.ndarray, cfg: dict, device, store_dtype=None
                ) -> np.ndarray:
    """(H, W) uint8 rule classes of a raw scene: 0 unclassified, 1
    vegetation, 2 water, 3 built-up, 4 bare land."""
    cal, rc = cfg["calibration"], cfg["rules"]
    st, hist = stretched(scene, cal["gains"], cal["biases"], device)
    b01, _ = _normalise(st, hist, cfg["features"]["normalize"],
                        np.dtype(cfg["statistics_dtype"]).type)
    ind = indices(b01)
    planes = {k: torch.nan_to_num(ind[k], nan=0.0)
              for k in ("ndvi", "ndwi", "mndwi", "ndbi")}
    if store_dtype is not None:
        planes = {k: v.to(store_dtype).float() for k, v in planes.items()}
    p = {k: v.cpu().numpy() for k, v in planes.items()}
    h, w = p["ndvi"].shape
    area = h * w
    veg = p["ndvi"] > rc["ndvi_threshold"]
    water = (p["mndwi"] > rc["mndwi_threshold"]
             if rc["use_mndwi_if_available"]
             else p["ndwi"] > rc["ndwi_threshold"])
    built = ((p["ndbi"] > rc["ndbi_threshold"])
             & (p["ndvi"] < rc["ndvi_threshold_for_builtup"]))
    masks = []
    for m, k, frac in ((veg, 3, "veg"), (water, 3, "water"),
                       (built, 5, "builtup")):
        min_area = int(area * rc[f"{frac}_min_area_frac"])
        masks.append(_open(_drop_small(_close(m, k), min_area), k))
    veg, water, built = masks
    out = np.zeros((h, w), np.uint8)
    out[built] = 3
    out[veg] = 1
    out[water] = 2
    bare = ((out == 0)
            & (p["ndvi"] > rc["bareland_ndvi_low"])
            & (p["ndvi"] < rc["bareland_ndvi_high"])
            & (p["ndbi"] > rc["bareland_ndbi_low"])
            & (p["ndbi"] < rc["bareland_ndbi_high"]))
    bare = _open(_drop_small(_close(bare, 3),
                             int(area * rc["bareland_min_area_frac"])), 3)
    out[bare & (out == 0)] = 4
    return out


def _rules(scene: np.ndarray, cfg: dict, fields, depth, device,
           store_dtype=None):
    """``(rule_labels as int64, 0)``: the rule method fits nothing and runs
    no model, so it needs no operations the step counts."""
    return rule_labels(scene, cfg, device, store_dtype).astype(np.int64), 0


METHODS = {"random_forest": forest_labels, "rule_based": _rules}
