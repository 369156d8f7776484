"""KMeans: k-means++ seeding and Lloyd iterations by matmuls.

Counterpart of ``rs_image_segmentation_tpu.models.kmeans``. Distances
are ``|x|^2 - 2 x c^T + |c|^2``, one (N, F) @ (F, K) matmul an iteration;
the update sums the points of each cluster with a one-hot (K, N) @ (N, F)
matmul, whose result does not depend on the order of float atomics, so a
rerun on one device gives the same labels and inertia. An empty cluster moves to the
point farthest from its centroid (first index on ties). Convergence follows
sklearn: the squared centroid shift against ``tol`` times the mean
per-feature variance of the data.

``fit_centroids`` fits a batch of independent problems, ``x`` of shape
(B, N, F): each runs its own Lloyd loop, and a problem that has converged
keeps its centroids and iteration count while the others go on (the JAX
package's ``vmap`` of a ``while_loop``). The loop syncs with the host once
an iteration, to test whether any problem is still active. On a CUDA
batch an iteration is one ``ops.kernels.lloyd_pass`` (two kernels, one
pass over the points; f32 points, K and F within ``ops.kernels``'
``LLOYD_MAX_K`` and ``LLOYD_MAX_F``, or it raises); its sums are taken in
f64 in a fixed order, so a rerun gives the same bits. CPU tensors run the
matmul form, ``_lloyd``, which stays the plain version of the kernels.

The k-means++ picks are Gumbel-max draws. The noise comes from a CPU
``torch.Generator`` and is copied to the data's device once, so a run on
the card and one on the CPU draw the same noise; every problem of a batch
shares it, as every scene of the JAX program shares one key. The JAX and
torch random streams differ, so cluster ids differ from the JAX package's:
fits are compared by quality (inertia, mapped kappa), assignments exactly.

``group`` (a ``torch.distributed`` process group; the JAX ``axis_name``):
the points are sharded over its ranks, each holding its own rows, and the
fit is global. The collectives keep the JAX shape: the mean and variance
for ``tol``, the counts, sums and inertia by all-reduce; each k-means++
pick is the global maximum of the Gumbel scores, each rank drawing the
noise of its rows' global indices (its shard offset), so the picks are the
one-rank picks; an empty cluster moves to the globally farthest point,
averaged over the ranks that tie. The loop's convergence test reads only
all-reduced values, so every rank runs the same iterations. On the card
the ranks all-reduce the kernels' partials (f64 sums, counts, each rank's
farthest point) between its two launches. With ``group`` None every result
is what it was without it, bit for bit on the CPU; on the card the f64
sums are added in another order, which the f32 centroids show only where
the two sums round apart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..backend import as_tensor
from ..ops import kernels
from ..utils.timing import span


class KMeansState(NamedTuple):
    centroids: torch.Tensor  # (K, F)
    inertia: torch.Tensor    # ()
    n_iter: torch.Tensor     # () int64


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    from ..parallel.collectives import psum
    return psum(x, group)


def _pmax(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    from ..parallel.collectives import pmax
    return pmax(x, group)


def _shard_rows(n: int, group, device: torch.device):
    """(this rank's first global row, the global row count) of ``n`` local
    rows on ``group``; (0, n) without one."""
    if group is None:
        return 0, n
    from ..parallel.collectives import all_gather
    counts = all_gather(torch.tensor([n], device=device), group)[:, 0]
    rank = torch.distributed.get_rank(group)
    return int(counts[:rank].sum()), int(counts.sum())


def _global_pick(xb: torch.Tensor, scores: torch.Tensor, group
                 ) -> torch.Tensor:
    """The point of the largest score of each problem: (B, N) scores ->
    (B, F). On ``group`` the winning rank's point, averaged over the ranks
    whose maxima tie (with continuous scores, one)."""
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(xb.shape[0], device=xb.device)
    return _pick_across(xb[rows, best], scores[rows, best], group)


def _pick_across(pts: torch.Tensor, top: torch.Tensor, group
                 ) -> torch.Tensor:
    """This rank's (B, F) points of (B,) scores ``top`` -> the point of the
    largest score over the ranks of ``group``, averaged over the ranks
    whose maxima tie; ``pts`` itself without a group."""
    if group is None:
        return pts
    mine = top == _pmax(top, group)
    cand = torch.where(mine[:, None], pts, 0.0)
    ties = _psum(mine.to(pts.dtype), group)
    return _psum(cand, group) / torch.clamp_min(ties, 1.0)[:, None]


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1, keepdim=True)


def _sq_dists(x: torch.Tensor, c: torch.Tensor,
              xn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, F) points, (B, K, F) centroids -> (B, N, K) squared
    distances, clamped at 0 (the expansion can cancel below it)."""
    xn = _sq_norms(x) if xn is None else xn
    cn = torch.sum(c * c, dim=-1)[:, None, :]
    cross = torch.bmm(x, c.transpose(1, 2))
    return torch.clamp_min(xn - 2.0 * cross + cn, 0.0)


def gumbel_noise(generator: torch.Generator, k: int, n: int) -> torch.Tensor:
    """(k, n) standard Gumbel draws, f32 on the CPU: ``-log(-log(u))`` with
    ``u`` uniform in [tiny, 1), so every draw is finite."""
    u = torch.rand((k, n), generator=generator, dtype=torch.float32)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def kmeans_plus_plus_init(x: torch.Tensor, k: int,
                          generator: torch.Generator,
                          group=None) -> torch.Tensor:
    """k-means++ seeding of (N, F) or (B, N, F) points -> (K, F) or (B, K,
    F) centroids. Each pick is the argmax of ``log(weight) + Gumbel``
    (weight 0 reads as -inf), which draws an index with probability
    proportional to its weight; the first pick weighs every point 1, the
    next ones the squared distance to the nearest centroid so far. On
    ``group`` the argmax is global (module docstring)."""
    xb = x if x.dim() == 3 else x[None]
    b, n, f = xb.shape
    with span("kmeans.init", picks=k):
        off, total = _shard_rows(n, group, xb.device)
        noise = gumbel_noise(generator, k, total)[:, off:off + n].to(
            xb.device)
        cents = xb.new_zeros((b, k, f))
        cents[:, 0] = _global_pick(xb, noise[0].expand(b, n), group)
        d2 = torch.full((b, n), float("inf"), device=xb.device)
        for i in range(1, k):
            d2 = torch.minimum(d2, _sq_dists(xb, cents[:, i - 1:i])[..., 0])
            logits = torch.where(d2 > 0,
                                 torch.log(torch.where(d2 > 0, d2, 1.0)),
                                 float("-inf"))
            cents[:, i] = _global_pick(xb, logits + noise[i], group)
    return cents if x.dim() == 3 else cents[0]


def _lloyd(x: torch.Tensor, c: torch.Tensor,
           xn: Optional[torch.Tensor] = None, group=None):
    """One batched Lloyd step: (new centroids (B, K, F), labels (B, N),
    inertia (B,)); on ``group`` the centroids and inertia are global.
    ``xn``: the points' squared norms (B, N, 1), if the caller holds
    them."""
    k = c.shape[1]
    mind2, labels = torch.min(_sq_dists(x, c, xn), dim=2)   # first index
    inertia = _psum(torch.sum(mind2, dim=1), group)
    onehot = (labels[..., None] == torch.arange(k, device=x.device)
              ).to(x.dtype)                                  # (B, N, K)
    counts = _psum(torch.sum(onehot, dim=1), group)          # exact < 2^24
    # one (K, N) @ (N, F) matmul a problem: cuBLAS splits its long N
    # reduction across the card, which it does not for the batched
    # product of these shapes (ten times slower on an H100)
    sums = _psum(torch.stack([oh.T @ xb for oh, xb in zip(onehot, x)]),
                 group)
    new = sums / torch.where(counts > 0, counts, 1.0)[..., None]
    far = _global_pick(x, mind2, group)                      # (B, F)
    new = torch.where((counts > 0)[..., None], new, far[:, None, :])
    return new, labels, inertia


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor,
               xn: Optional[torch.Tensor] = None, group=None):
    """One Lloyd iteration of (N, F) points from (K, F) centroids:
    ``(new_centroids, labels, inertia)``. ``xn``: the points' squared
    norms (N, 1), if the caller holds them. On ``group``: this rank's
    labels, the global centroids and inertia."""
    out = _lloyd(x[None], centroids[None],
                 _sq_norms(x[None]) if xn is None else xn[None], group)
    return tuple(t[0] for t in out)


def _tol_abs(x: torch.Tensor, tol: float, group=None) -> torch.Tensor:
    """sklearn's tolerance of each problem of a (B, N, F) batch: ``tol``
    times the mean per-feature variance (over every rank's points on
    ``group``)."""
    n = x.shape[1] if group is None else _shard_rows(x.shape[1], group,
                                                     x.device)[1]
    mean = _psum(torch.sum(x, dim=1, keepdim=True), group) / n
    var = _psum(torch.sum((x - mean) ** 2, dim=1), group) / n
    return tol * torch.mean(var, dim=1)


def fit_centroids(x: torch.Tensor, k: int, seed: int = 42,
                  max_iter: int = 300, tol: float = 1e-4,
                  init_centroids=None, group=None):
    """Lloyd to convergence on a (B, N, F) f32 batch of problems:
    ``(centroids (B, K, F), n_iter (B,), squared norms (B, N, 1))``, the
    norms None on the card, whose kernels take them in their pass. A CUDA
    batch the kernels do not take raises ``ValueError``
    (``ops.kernels.lloyd_scratch``).

    Starts from ``init_centroids`` ((K, F) for every problem, or (B, K,
    F)) when given, else from k-means++ with the Gumbel noise of ``seed``.
    A problem stops once its squared centroid shift is at most its
    tolerance, or after ``max_iter`` iterations. On ``group`` each rank
    holds its own points of every problem and the fit is global.

    Marked ``kmeans.lloyd`` (k-means++ before it is ``kmeans.init``, count
    ``picks``), with counts ``problems`` (B), ``iters``, the loop's
    iterations: the largest ``n_iter``, each one host sync, and ``fused``:
    1 when the loop ran ``ops.kernels.lloyd_pass``, 0 on ``_lloyd``."""
    if init_centroids is not None:
        init = as_tensor(init_centroids, x.device, torch.float32)
        if init.shape[-2] != k:
            raise ValueError(f"init_centroids has {init.shape[-2]} rows, "
                             f"expected k={k}")
        cents = init.expand(x.shape[0], *init.shape[-2:])
    else:
        cents = kmeans_plus_plus_init(
            x, k, torch.Generator().manual_seed(seed), group)
    with span("kmeans.lloyd", problems=x.shape[0]) as rec:
        tol_abs = _tol_abs(x, tol, group)
        shift = torch.full((x.shape[0],), float("inf"), device=x.device)
        n_iter = torch.zeros((x.shape[0],), dtype=torch.int64,
                             device=x.device)
        fused = _fused(x)
        if fused:
            xn = None
            cents, n_iter, iters = _lloyd_loop_fused(
                x, cents, tol_abs, shift, n_iter, max_iter, group)
        else:
            xn = _sq_norms(x)
            cents, n_iter, iters = _lloyd_loop(x, cents, xn, tol_abs, shift,
                                               n_iter, max_iter, group)
        if rec is not None:
            rec.counts["iters"] = iters
            rec.counts["fused"] = int(fused)
    return cents, n_iter, xn


def _fused(x: torch.Tensor) -> bool:
    """Whether ``fit_centroids``' loop runs the kernels: for a CUDA batch,
    with or without a ``group``."""
    return x.device.type == "cuda"


def _lloyd_loop(x, cents, xn, tol_abs, shift, n_iter, max_iter, group):
    """``fit_centroids``' loop on ``_lloyd``: ``(centroids, n_iter,
    iterations)``."""
    iters = 0
    while True:
        active = (shift > tol_abs) & (n_iter < max_iter)
        if group is not None:
            # the shifts come from all-reduced centroids; the maximum over
            # the ranks makes the loop's exit one decision for them all
            active = _pmax(active.to(torch.int32), group) > 0
        if not bool(active.any()):      # the iteration's one host sync
            break
        new, _, _ = _lloyd(x, cents, xn, group)
        step = torch.sum((new - cents) ** 2, dim=(1, 2))
        cents = torch.where(active[:, None, None], new, cents)
        shift = torch.where(active, step, shift)
        n_iter = n_iter + active.to(torch.int64)
        iters += 1
    return cents, n_iter, iters


def _lloyd_loop_fused(x, cents, tol_abs, shift, n_iter, max_iter,
                      group=None):
    """``fit_centroids``' loop on the card: an iteration is one
    ``kernels.lloyd_pass``, which updates ``cents``, ``shift`` and
    ``n_iter`` in place, and one read of its flag (on ``group`` its
    maximum over the ranks, as the plain loop decides). ``cents`` is
    copied first (it may be the caller's warm start). Raises
    ``ValueError`` for points the kernels do not take
    (``kernels.lloyd_scratch``)."""
    x = x.contiguous()
    cents = cents.clone(memory_format=torch.contiguous_format)
    scratch = kernels.lloyd_scratch(x, cents.shape[1])
    combine = (None if group is None else
               lambda part: _global_partials(x, part, group))
    iters = 0
    active = ((shift > tol_abs) & (n_iter < max_iter)).any()
    more = bool(_pmax(active.to(torch.int32), group))
    while more:                         # the iteration's one host sync
        flag = kernels.lloyd_pass(x, cents, shift, n_iter, tol_abs,
                                  max_iter, scratch, combine)
        more = bool(_pmax(flag, group).item())
        iters += 1
    return cents, n_iter, iters


def _global_partials(x: torch.Tensor, part, group):
    """The partials of ``kernels.lloyd_pass`` on this rank's (B, N, F)
    points, ``part``, made global on ``group``, one block a problem: each
    cluster's f64 feature sums and int32 count over every rank, and the
    point farthest from its nearest centroid, (B, 1, F) (this rank's first
    among equals, picked over the ranks as ``_global_pick`` does)."""
    sums = _psum(part.sums.sum(dim=-1, keepdim=True), group)
    counts = _psum(part.counts.sum(dim=-1, keepdim=True, dtype=torch.int32),
                   group)
    top = part.far_d.amax(dim=1)
    first = torch.where(part.far_d == top[:, None], part.far_i,
                        torch.iinfo(torch.int32).max).amin(dim=1)
    rows = torch.arange(x.shape[0], device=x.device)
    far = _pick_across(x[rows, first.long()], top, group)
    return sums, counts, far[:, None, :]


def kmeans_fit_predict(x: torch.Tensor, k: int, seed: int = 42,
                       max_iter: int = 300, tol: float = 1e-4,
                       init_centroids=None, group=None):
    """Fit and predict on (N, F) points (pre-scaled by the caller):
    ``(labels, KMeansState)``, the labels and inertia from one last step on
    the converged centroids. ``init_centroids``: an optional (K, F) warm
    start in place of k-means++ (still gated by ``tol`` and
    ``max_iter``); a wrong K raises ``ValueError``. On ``group``: this
    rank's labels, the global centroids and inertia."""
    xb = x.to(torch.float32)[None]
    cents, n_iter, xn = fit_centroids(xb, k, seed, max_iter, tol,
                                      init_centroids, group)
    _, labels, inertia = _lloyd(xb, cents, xn, group)
    return labels[0], KMeansState(cents[0], inertia[0], n_iter[0])


def minmax_scale_features(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """sklearn's MinMaxScaler over dim ``dim`` of ``x`` (the samples; 0 for
    (N, F) rows): each feature to [0, 1], a constant feature to 0."""
    mn = torch.amin(x, dim=dim, keepdim=True)
    rng = torch.amax(x, dim=dim, keepdim=True) - mn
    return (x - mn) / torch.where(rng > 0, rng, 1.0)
