"""Plain reference of the source's unsupervised KMeans method.

The source (``modules/features/extract.py:508-581``, called by stage 3's
``kmeans`` method with k 7) scales each feature of a tile's 19-channel
stack to [0, 1] with ``MinMaxScaler``, fits
``sklearn.cluster.KMeans(n_clusters=7, random_state=42, n_init='auto')``
on every pixel and maps each pixel to its cluster, plus one. This module
computes the same from a raw (7, H, W) uint8 scene and a configuration's
``kmeans`` settings, one tile at a time, in float32, in plain PyTorch: it
imports neither ``jax`` nor either package of the repository, and takes
the stack from ``landcover.stack``.

Steps, and where they depart from sklearn:

* MinMax: ``(x - min) / (max - min)`` per feature over the tile's pixels,
  a constant feature to 0 (sklearn scales by ``1 / (max - min)`` and adds
  ``-min / (max - min)``: the same to float32 rounding).
* k-means++: the first centroid is the point of the largest Gumbel draw,
  each next one the point of the largest ``log(d2) + Gumbel``, ``d2`` the
  squared distance to the nearest centroid so far (``-inf`` at 0). That
  samples each pick with probability proportional to ``d2``, as
  k-means++ does; sklearn instead keeps the best of ``2 + ln k`` local
  trials a pick, from its own random stream. The noise is a frozen copy
  of the port's recipe (a CPU ``torch.Generator`` seeded with the
  configuration's seed, a (k, N) uniform draw clamped at the smallest
  normal float32, ``-log(-log(u))``), so the cluster ids of the two
  agree.
* Lloyd: each pixel to its nearest centroid by ``argmin_k |c_k|^2 - 2 x .
  c_k`` (sklearn's form; first index on ties), each centroid to the mean
  of its pixels (the sums accumulated in float64, then rounded to
  float32), an empty cluster to the pixel farthest from its nearest
  centroid (sklearn moves empty clusters to far points too, choosing
  them otherwise). It stops once the squared shift of the centroids is at
  most ``tol`` times the mean per-feature variance of the pixels, or
  after ``max_iter`` iterations: sklearn's rule (its strict test, the
  labels unchanged, gives a zero shift one step later here, which the
  same rule stops at).
* ``n_init`` 1: what ``'auto'`` gives with k-means++.
* The labels: every pixel to the converged centroids, plus one.

``store_dtype`` rounds the stack through a lower precision (the control).
``ops``: a pixel of the fit takes 2 K F operations for its distances and
F for its cluster sum each iteration, and 2 F for its distance to each
centroid k-means++ picks after the first; every pixel takes 2 K F for the
final assignment.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import landcover


def minmax(x: torch.Tensor) -> torch.Tensor:
    """(F, N) features, each scaled to [0, 1] over its N pixels."""
    mn = x.amin(dim=1, keepdim=True)
    rng = x.amax(dim=1, keepdim=True) - mn
    return (x - mn) / torch.where(rng > 0, rng, torch.ones_like(rng))


def gumbel(seed: int, k: int, n: int) -> torch.Tensor:
    """(k, n) float32 standard Gumbel draws on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    u = torch.rand((k, n), generator=g, dtype=torch.float32)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N,) squared distances of (N, F) points to one (F,) centroid."""
    return torch.sum((x - c) ** 2, dim=1)


def plus_plus(x: torch.Tensor, k: int, noise: torch.Tensor) -> torch.Tensor:
    """(k, F) k-means++ centroids of (N, F) points from (k, N) noise."""
    picks = [int(torch.argmax(noise[0]))]
    d2 = _sq_dist(x, x[picks[0]])
    for i in range(1, k):
        logits = torch.where(d2 > 0, torch.log(torch.clamp_min(d2, 1e-38)),
                             torch.full_like(d2, float("-inf")))
        picks.append(int(torch.argmax(logits + noise[i])))
        d2 = torch.minimum(d2, _sq_dist(x, x[picks[-1]]))
    return x[picks].clone()


def nearest(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N,) index of each (N, F) point's nearest of the (K, F) centroids."""
    return torch.argmin(torch.sum(c * c, dim=1)[None] - 2.0 * (x @ c.T),
                        dim=1)


def lloyd(x: torch.Tensor, c: torch.Tensor, tol: float, max_iter: int):
    """``(centroids, iterations)``: Lloyd from (K, F) ``c`` on (N, F)
    points until the squared shift is at most ``tol`` times the mean
    per-feature variance, or ``max_iter`` iterations."""
    k = c.shape[0]
    tol_abs = tol * float(torch.mean(torch.var(x.double(), dim=0,
                                               unbiased=False)))
    it = 0
    while it < max_iter:
        labels = nearest(x, c)
        counts = torch.bincount(labels, minlength=k)
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add_(0, labels, x.double())
        new = (sums / torch.clamp_min(counts, 1)[:, None]).float()
        if bool((counts == 0).any()):
            far = torch.min(torch.stack([_sq_dist(x, ci) for ci in c]),
                            dim=0).values
            new[counts == 0] = x[int(torch.argmax(far))]
        shift = float(torch.sum((new - c) ** 2))
        c = new
        it += 1
        if shift <= tol_abs:
            break
    return c, it


def fit(scene: np.ndarray, cfg: dict, device, store_dtype=None):
    """``(labels (H, W) int64 numpy, iterations, centroids (K, F),
    ops)`` of a raw scene under the configuration's ``kmeans`` settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    km = cfg["kmeans"]
    if km["n_init"] != 1:
        raise ValueError("the reference fits one k-means++ start")
    k = km["n_clusters"]
    s = landcover.stack(scene, cfg, device, store_dtype)
    f, h, w = s.shape
    x = minmax(s.reshape(f, h * w)).T.contiguous()          # (N, F)
    xfit = x[::km["fit_stride"]]
    noise = gumbel(km["seed"], k, xfit.shape[0]).to(device)
    cents, iters = lloyd(xfit, plus_plus(xfit, k, noise), km["tol"],
                         km["max_iter"])
    labels = (nearest(x, cents) + 1).reshape(h, w).cpu().numpy()
    n_fit, n = xfit.shape[0], h * w
    ops = (n_fit * (iters * (2 * k * f + f) + (k - 1) * 2 * f)
           + n * 2 * k * f)
    return labels, iters, cents, ops


def kmeans_labels(scene: np.ndarray, cfg: dict, fields, depth, device,
                  store_dtype=None):
    """``(labels, ops)``: the method fits on the scene itself, so it
    ignores the forest's ``fields`` and ``depth``."""
    labels, _, _, ops = fit(scene, cfg, device, store_dtype)
    return labels, ops


METHODS = {"kmeans": kmeans_labels}
