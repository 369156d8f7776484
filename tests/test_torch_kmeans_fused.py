"""The KMeans fit's fused Lloyd loop (``ops.kernels.lloyd_pass``,
``csrc/kmeans_lloyd.cu``) against its plain version, the loop over
``models.kmeans._lloyd``.

On the CPU: the rule that picks the route (every CUDA batch, with or
without a group), the plain route on the CPU, also with a group (count
``fused`` 0, no launch, the same bits as before), the wrapper's refusal of
CPU tensors, its scratch and its refusal of shapes and dtypes past the
caps, a process group's sum of the partials, and the benchmark's reader
of the count ``fused``. On a card (marker ``card``; each test skips
without CUDA): one pass and the whole loop against the plain loop for B
in {1, 3, 8}, N in {1, 37, 4 099, 360 000} and K in {1, 7} at F = 19, and
for K in {8, 9, 32} at F in {20, 64}; an empty cluster moved to the first
of two equally far points, exact distance ties, a bit-equal rerun, two
launches an iteration, a group's fit, and the route ``fit_centroids``
takes on the card."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import manifest
from rs_image_segmentation_tpu_torch.models import kmeans as tkm
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.utils import timing
from rs_image_segmentation_tpu_torch.utils.timing import SpanRecord, span, spans

F = 19
TOL = 1e-4


def _blobs(b, n, k, f=F, seed=0):
    """(b, n, f) f32 points in k well-separated blobs in [0, 1]^f (a point's
    blob drawn at random), and (b, k, f) starting centroids near the blob
    centres."""
    g = torch.Generator().manual_seed(seed)
    centres = torch.rand((b, k, f), generator=g) * 0.8 + 0.1
    which = torch.randint(0, k, (b, n), generator=g)
    x = (torch.gather(centres, 1, which[..., None].expand(b, n, f))
         + 0.01 * torch.randn((b, n, f), generator=g))
    start = centres + 0.02 * torch.randn((b, k, f), generator=g)
    return x.contiguous(), start.contiguous()


def _state(x):
    """A fit's starting loop state, as ``fit_centroids`` makes it: ``(xn,
    tol_abs, shift, n_iter)``."""
    b = x.shape[0]
    return (tkm._sq_norms(x), tkm._tol_abs(x, TOL),
            torch.full((b,), float("inf"), device=x.device),
            torch.zeros((b,), dtype=torch.int64, device=x.device))


def _profiled_fit(x, k, **kw):
    """``fit_centroids`` under a CPU profiler session: its result and its
    ``kmeans.lloyd`` span."""
    with span("unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = tkm.fit_centroids(x, k, **kw)
    loop, = [r for r in spans() if r.name == "kmeans.lloyd"]
    return out, loop


def _one_rank_group(monkeypatch):
    """A stand-in for a one-rank process group: the fit's collectives are
    identities, as they are over one rank."""
    monkeypatch.setattr(tkm, "_psum", lambda v, group: v)
    monkeypatch.setattr(tkm, "_pmax", lambda v, group: v)
    monkeypatch.setattr(tkm, "_shard_rows",
                        lambda n, group, device: (0, n))
    return object()


def _two_rank_group(monkeypatch):
    """A stand-in for two ranks that hold the same points: a sum over the
    ranks is twice this rank's, a maximum is this rank's."""
    monkeypatch.setattr(tkm, "_psum", lambda v, group: 2 * v)
    monkeypatch.setattr(tkm, "_pmax", lambda v, group: v)
    monkeypatch.setattr(tkm, "_shard_rows",
                        lambda n, group, device: (0, 2 * n))
    return object()


# ------------------------------------------------------------------ the CPU

def _batch(device="cuda", shape=(8, 360_000, F), dtype=torch.float32):
    """What the route rule reads of a batch, without allocating it."""
    return SimpleNamespace(device=torch.device(device), shape=shape,
                           dtype=dtype)


@pytest.mark.parametrize("x, fused", [
    (_batch(), True),
    (_batch(shape=(1, 1, F)), True),
    (_batch(shape=(3, 4099, kernels.LLOYD_MAX_F + 1)), True),
    (_batch(dtype=torch.float64), True),
    (_batch(device="cpu"), False),
    (_batch(device="cpu", shape=(3, 4099, kernels.LLOYD_MAX_F)), False),
])
def test_route_rule(x, fused):
    # a CUDA batch takes the kernels whatever its shape: one they do not
    # take raises there (test_lloyd_scratch_refuses_...), nothing falls back
    assert tkm._fused(x) is fused


def test_cpu_fit_runs_the_plain_loop():
    x, start = _blobs(3, 500, 7)
    before = kernels.lloyd_pass.launches
    (cents, n_iter, _), loop = _profiled_fit(x, 7, init_centroids=start)
    assert loop.counts == {"problems": 3, "iters": int(n_iter.max()),
                           "fused": 0}
    assert kernels.lloyd_pass.launches == before
    want = tkm._lloyd_loop(x, start, *_state(x), 300, None)
    assert torch.equal(cents, want[0]) and torch.equal(n_iter, want[1])


def test_a_group_fit_runs_the_plain_loop(monkeypatch):
    x, start = _blobs(2, 400, 7, seed=1)
    (alone, n_alone, _), _ = _profiled_fit(x, 7, init_centroids=start)
    group = _one_rank_group(monkeypatch)
    before = kernels.lloyd_pass.launches
    (cents, n_iter, _), loop = _profiled_fit(x, 7, init_centroids=start,
                                             group=group)
    assert loop.counts["fused"] == 0
    assert kernels.lloyd_pass.launches == before
    assert torch.equal(cents, alone) and torch.equal(n_iter, n_alone)


def test_lloyd_pass_takes_cuda_tensors_only():
    x, start = _blobs(2, 50, 3)
    _, tol_abs, shift, n_iter = _state(x)
    scratch = kernels.lloyd_scratch(x, 3)
    before = kernels.lloyd_pass.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        kernels.lloyd_pass(x, start, shift, n_iter, tol_abs, 300, scratch)
    assert kernels.lloyd_pass.launches == before


@pytest.mark.parametrize("n, blocks", [(1, 1), (2048, 1), (2049, 2),
                                       (360_000, 176)])
def test_lloyd_scratch_has_an_entry_a_block(n, blocks):
    x = torch.empty((3, n, 5))
    s = kernels.lloyd_scratch(x, 4)
    assert s.sums.shape == (3, 4, 5, blocks) and s.sums.dtype == torch.float64
    assert s.counts.shape == (3, 4, blocks) and s.counts.dtype == torch.int32
    assert s.far_d.shape == s.far_i.shape == (3, blocks)
    assert s.flag.shape == (1,) and s.flag.dtype == torch.int32
    assert not any(bool(t.any()) for t in s)


@pytest.mark.parametrize("shape, k, dtype, ok", [
    ((3, 4099, kernels.LLOYD_MAX_F), kernels.LLOYD_MAX_K, torch.float32,
     True),
    ((65535, 1, 1), 1, torch.float32, True),
    ((8, 360_000, F), kernels.LLOYD_MAX_K + 1, torch.float32, False),
    ((8, 360_000, kernels.LLOYD_MAX_F + 1), 7, torch.float32, False),
    ((8, 360_000, F), 7, torch.float64, False),
    ((8, 0, F), 7, torch.float32, False),
    ((65536, 1, F), 7, torch.float32, False),
])
def test_lloyd_scratch_refuses_what_the_kernels_do_not_take(shape, k, dtype,
                                                            ok):
    x = torch.empty(shape, dtype=dtype, device="meta")
    if ok:
        assert kernels.lloyd_scratch(x, k).sums.shape[:3] == (shape[0], k,
                                                               shape[2])
    else:
        with pytest.raises(ValueError):
            kernels.lloyd_scratch(x, k)


def test_global_partials_add_the_blocks_and_the_ranks(monkeypatch):
    b, n, k, f, g = 2, 9, 3, 4, 5
    gen = torch.Generator().manual_seed(4)
    x = torch.rand((b, n, f), generator=gen)
    part = kernels.LloydScratch(
        torch.rand((b, k, f, g), generator=gen, dtype=torch.float64),
        torch.randint(0, 100, (b, k, g), generator=gen, dtype=torch.int32),
        torch.tensor([[0.5, 2.0, 1.0, 2.0, 0.1], [3.0, 0.0, 0.0, 0.0, 0.0]]),
        torch.tensor([[0, 6, 2, 3, 8], [4, 1, 5, 7, 0]], dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32))
    group = _two_rank_group(monkeypatch)
    sums, counts, far = tkm._global_partials(x, part, group)
    assert sums.shape == (b, k, f, 1) and sums.dtype == torch.float64
    assert torch.equal(sums[..., 0], 2 * part.sums.sum(dim=-1))
    assert counts.shape == (b, k, 1) and counts.dtype == torch.int32
    assert torch.equal(counts[..., 0], 2 * part.counts.sum(dim=-1,
                                                         dtype=torch.int32))
    # problem 0: blocks 1 and 3 tie at 2.0, the first point is 3 (block 3);
    # both ranks hold it, so their average is the point itself
    assert far.shape == (b, 1, f)
    assert torch.equal(far[:, 0], torch.stack([x[0, 3], x[1, 4]]))


# ----------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plain_pass(x, cents, xn):
    """The plain version's new centroids, per-cluster counts and labels."""
    new, labels, _ = tkm._lloyd(x, cents, xn)
    k = cents.shape[1]
    counts = torch.stack([torch.bincount(lab, minlength=k) for lab in labels])
    return new, counts, labels


def _nearest(x, cents):
    return torch.argmin(torch.cdist(x.double(), cents.double()), dim=2)


def _assert_means(got, plain, x, labels):
    """``got`` holds each non-empty cluster's mean of ``x`` under
    ``labels``, summed in f64 and rounded once (to 1e-6), and parts from
    the plain version's f32 means by at most the plain version's own
    rounding of them; an empty cluster is the plain version's point."""
    b, _, f = x.shape
    k = got.shape[1]
    sums = torch.zeros((b, k, f), dtype=torch.float64, device=x.device)
    for i in range(b):
        sums[i].index_add_(0, labels[i], x[i].double())
    counts = torch.stack([torch.bincount(lab, minlength=k) for lab in labels])
    full = (counts > 0)[..., None].expand_as(got)
    mean = sums / counts.clamp_min(1)[..., None]
    torch.testing.assert_close(got[full].double(), mean[full], rtol=1e-6,
                               atol=0)
    err = (plain.double() - mean).abs() + 1e-6 * mean.abs()
    assert bool(((got.double() - plain.double()).abs() <= err)[full].all())
    assert torch.equal(got[~full], plain[~full])


def _check_pass_and_loop(x, start):
    """One pass and the whole fused loop from ``start`` against the plain
    loop's."""
    k = start.shape[1]
    xn, tol_abs, shift, n_iter = _state(x)
    # one pass from the same centroids: counts exact, means rounded once
    want, counts, labels = _plain_pass(x, start, xn)
    cents = start.clone()
    scratch = kernels.lloyd_scratch(x, k)
    kernels.lloyd_pass(x, cents, shift, n_iter, tol_abs, 300, scratch)
    torch.cuda.synchronize()
    assert torch.equal(scratch.counts.sum(dim=-1).long(), counts)
    _assert_means(cents, want, x, labels)
    assert torch.equal(n_iter, torch.ones_like(n_iter))
    # the whole loop: the same iterations, the same clusters
    plain = tkm._lloyd_loop(x, start, *_state(x), 300, None)
    fused = tkm._lloyd_loop_fused(x, start, *_state(x)[1:], 300)
    assert torch.equal(fused[1], plain[1]) and fused[2] == plain[2]
    _assert_means(fused[0], plain[0], x, _nearest(x, plain[0]))


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("n", [1, 37, 4099, 360_000])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_fused_pass_and_loop_match_the_plain_loop(card, b, n, k):
    _check_pass_and_loop(*(t.to(card) for t in _blobs(b, n, k,
                                                      seed=b * n + k)))


@pytest.mark.card
@pytest.mark.parametrize("f", [20, kernels.LLOYD_MAX_F])
@pytest.mark.parametrize("k", [8, 9, kernels.LLOYD_MAX_K])
def test_fused_pass_and_loop_match_the_plain_loop_wide(card, k, f):
    # the generic instance (every k but 7), an even F (padded rows, staged
    # by the threads) and F at the cap (four point groups in the sums)
    _check_pass_and_loop(*(t.to(card) for t in _blobs(3, 4099, k, f,
                                                      seed=k * f)))


@pytest.mark.card
def test_an_empty_cluster_moves_to_the_first_farthest_point(card):
    x, start = _blobs(2, 5000, 3, seed=11)
    # two copies of one point far from every centroid, at 1234 and 4321
    x[:, 1234] = x[:, 4321] = 3.0
    start[:, 2] = -5.0                  # nearest to no point: empty
    x, start = x.to(card), start.to(card)
    xn, tol_abs, shift, n_iter = _state(x)
    want, counts, _ = _plain_pass(x, start, xn)
    assert bool((counts[:, 2] == 0).all())
    cents = start.clone()
    kernels.lloyd_pass(x, cents, shift, n_iter, tol_abs, 300,
                       kernels.lloyd_scratch(x, 3))
    assert torch.equal(cents[:, 2], x[:, 1234])
    assert torch.equal(cents[:, 2], want[:, 2])


@pytest.mark.card
def test_exact_distance_ties_take_the_first_centroid(card):
    # every point at feature 0 = 0.5 sits exactly between centroids at
    # 0.25 and 0.75 (dyadic values: every distance term is exact); half of
    # them are nearer a third centroid
    n = 5000
    x = torch.zeros((3, n, F))
    x[:, :, 0] = 0.5
    x[:, ::2, 1] = 1.0
    start = torch.zeros((3, 3, F))
    start[:, 0, 0], start[:, 1, 0] = 0.25, 0.75
    start[:, 2, 1] = 1.0
    x, start = x.to(card), start.to(card)
    xn, tol_abs, shift, n_iter = _state(x)
    want, counts, _ = _plain_pass(x, start, xn)
    cents = start.clone()
    scratch = kernels.lloyd_scratch(x, 3)
    kernels.lloyd_pass(x, cents, shift, n_iter, tol_abs, 300, scratch)
    got = scratch.counts.sum(dim=-1).long()
    assert torch.equal(got, counts)
    assert bool(got[:, 1].eq(0).all() and got[:, 0].eq(n // 2).all())
    assert torch.equal(cents, want)


@pytest.mark.card
def test_a_rerun_is_bit_equal_and_launches_two_kernels_an_iteration(card):
    x, start = (t.to(card) for t in _blobs(8, 360_000, 7, seed=3))
    runs = []
    for _ in range(2):
        xn, tol_abs, shift, n_iter = _state(x)
        before = kernels.lloyd_pass.launches
        cents, n_iter, iters = tkm._lloyd_loop_fused(
            x, start, tol_abs, shift, n_iter, 300)
        assert kernels.lloyd_pass.launches == before + 2 * iters
        assert iters == int(n_iter.max()) and iters >= 2
        runs.append((cents, n_iter, shift))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.card
def test_fit_centroids_routes_on_the_card(card, monkeypatch):
    x, start = (t.to(card) for t in _blobs(3, 4099, 7, seed=5))
    warm = start.clone()
    before = kernels.lloyd_pass.launches
    (_, n_iter, _), loop = _profiled_fit(x, 7, init_centroids=start)
    assert loop.counts == {"problems": 3, "iters": int(n_iter.max()),
                           "fused": 1}
    assert kernels.lloyd_pass.launches == before + 2 * loop.counts["iters"]
    assert torch.equal(start, warm)     # the caller's warm start is kept
    # past the cap on K, and f64 points: raised, no launch
    before = kernels.lloyd_pass.launches
    wide = torch.rand((3, kernels.LLOYD_MAX_K + 1, F), device=card)
    with pytest.raises(ValueError, match="no kernel"):
        tkm.fit_centroids(x, kernels.LLOYD_MAX_K + 1, init_centroids=wide)
    with pytest.raises(ValueError, match="f32"):
        tkm.fit_centroids(x.double(), 7, init_centroids=start)
    assert kernels.lloyd_pass.launches == before


@pytest.mark.card
@pytest.mark.parametrize("ranks", [1, 2])
def test_a_group_fit_on_the_card_adds_the_ranks_partials(card, monkeypatch,
                                                         ranks):
    x, start = (t.to(card) for t in _blobs(3, 4099, 7, seed=6))
    (alone, n_alone, _), _ = _profiled_fit(x, 7, init_centroids=start)
    group = (_one_rank_group if ranks == 1 else _two_rank_group)(monkeypatch)
    before = kernels.lloyd_pass.launches
    (cents, n_iter, xn), loop = _profiled_fit(x, 7, init_centroids=start,
                                              group=group)
    assert loop.counts == {"problems": 3, "iters": int(n_iter.max()),
                           "fused": 1}
    assert kernels.lloyd_pass.launches == before + 2 * loop.counts["iters"]
    assert xn is None and torch.equal(n_iter, n_alone)
    # the blocks' f64 sums added in another order, then rounded once
    torch.testing.assert_close(cents, alone, rtol=1e-6, atol=0)


# ------------------------------------------------- the benchmark's reader

def _loops(*counts):
    """A session of one ``kmeans.lloyd`` span a count ``fused`` (None: the
    span has no such count, as on a program without the kernels)."""
    recs = []
    for i, c in enumerate(counts):
        got = {"problems": 8, "iters": 40}
        if c is not None:
            got["fused"] = c
        recs += [SpanRecord("turbo.batch", 2 * i + 1, None, 2 * i + 1, 0, {},
                            float(i), i + 0.5),
                 SpanRecord("kmeans.lloyd", 2 * i + 2, 2 * i + 1, 2 * i + 1,
                            0, got, i + 0.1, i + 0.4)]
    return recs


@pytest.mark.parametrize("counts, share", [
    ((1, 1, 1), 100.0), ((0, 1, 1, 1), 75.0), ((0,), 0.0),
    ((None, None), None), ((), None)])
def test_lloyd_fused_share_reader(monkeypatch, counts, share):
    monkeypatch.setattr(timing, "spans", lambda: _loops(*counts))
    got = manifest.metric_reader("lloyd_fused_share.batch").read({})
    assert got == share if share is None else got == pytest.approx(share)


def test_lloyd_fused_share_reader_without_spans(monkeypatch):
    reader = manifest.metric_reader("lloyd_fused_share.batch")
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert reader.read({}) is None
    monkeypatch.delattr(timing, "spans")        # an older checkout
    assert reader.read({}) is None
