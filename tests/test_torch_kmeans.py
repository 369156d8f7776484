"""PyTorch port vs the JAX package: KMeans (``models.kmeans``) and the
KMeans turbo programs (``kmeans_scenes_turbo``,
``kmeans_scenes_turbo_batch``) on the CPU.

The two packages draw their k-means++ noise from different random streams,
so cluster ids differ. Fits are held by quality (inertia, and the kappa of
the cluster -> class majority mapping against the rule map of the same
scene); steps and assignments from the same centroids are held exactly or
to f32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import FeatureStageConfig
from rs_image_segmentation_tpu.models import kmeans as jkm
from rs_image_segmentation_tpu.pipeline import turbo as jturbo
from rs_image_segmentation_tpu_torch.models import kmeans as tkm
from rs_image_segmentation_tpu_torch.pipeline import turbo as tturbo
from rs_image_segmentation_tpu_torch.pipeline.evaluate import (
    ClassificationEvaluator)
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    stretch_stats_batch, synthetic_scenes)

CFG = FeatureStageConfig()
K = 7
# The port's mapped kappa may trail the JAX package's by at most this much
# on a scene: the fits start from different k-means++ draws, so each lands
# in its own local optimum. Measured at 2 x 64 x 80 (scenes of seed 0),
# JAX against port: per-scene fits 0.2803 / 0.3262 and 0.2706 / 0.3257;
# the shared fit 0.2526 / 0.2769 and 0.3126 / 0.4183; the single-scene
# program on scene 0, 0.2674 / 0.2646.
KAPPA_MARGIN = 0.05


def _blobs(seed=42, k=5, per=300, f=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, f)) * 8
    return np.concatenate([centers[i] + rng.standard_normal((per, f))
                           for i in range(k)]).astype(np.float32)


# ------------------------------------------------------------- lloyd_step

def _step_inputs():
    """Points, and centroids of which the last sits far from every point,
    so its cluster is empty and relocates."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 6)).astype(np.float32)
    c = x[rng.choice(400, 5, replace=False)].copy()
    c[-1] = 100.0
    return x, c


def test_lloyd_step_matches_jax():
    x, c = _step_inputs()
    jnew, jlab, jin = (np.asarray(v) for v in jkm.lloyd_step(
        jnp.asarray(x), jnp.asarray(c)))
    new, lab, inertia = tkm.lloyd_step(torch.from_numpy(x),
                                       torch.from_numpy(c))
    np.testing.assert_array_equal(lab.numpy(), jlab)
    assert 4 not in set(jlab.tolist())            # the empty cluster
    # f32 sums of the cluster members in another order than XLA's
    np.testing.assert_allclose(new.numpy(), jnew, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(inertia), float(jin), rtol=1e-6)
    # the empty cluster takes the farthest point itself, bit for bit
    far = x[np.argmax(np.min(((x[:, None] - c[None]) ** 2).sum(-1), 1))]
    np.testing.assert_array_equal(new[4].numpy(), jnew[4])
    np.testing.assert_array_equal(new[4].numpy(), far)


def test_batched_step_equals_each_problem():
    x, c = _step_inputs()
    x2 = torch.from_numpy(np.stack([x, x[::-1].copy() * 0.5]))
    c2 = torch.from_numpy(np.stack([c, c * 0.5]))
    batch = tkm._lloyd(x2, c2, torch.sum(x2 * x2, dim=-1, keepdim=True))
    for b in range(2):
        one = tkm.lloyd_step(x2[b], c2[b])
        for got, ref in zip(batch, one):
            torch.testing.assert_close(got[b], ref, rtol=0, atol=0)


# ----------------------------------------------------- kmeans_fit_predict

def test_warm_start_from_jax_centroids():
    x = _blobs(seed=7)
    jlab, jstate = jkm.kmeans_fit_predict(jnp.asarray(x), 5, seed=42)
    lab, state = tkm.kmeans_fit_predict(
        torch.from_numpy(x), 5, init_centroids=np.asarray(jstate.centroids))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(state.centroids.numpy(),
                               np.asarray(jstate.centroids), atol=1e-5)
    assert int(state.n_iter) <= 2
    with pytest.raises(ValueError, match="expected k=4"):
        tkm.kmeans_fit_predict(torch.from_numpy(x), 4,
                               init_centroids=np.asarray(jstate.centroids))


def test_cold_fit_is_deterministic():
    x = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (500, 4)).astype(np.float32))
    l1, s1 = tkm.kmeans_fit_predict(x, 4, seed=7)
    l2, s2 = tkm.kmeans_fit_predict(x, 4, seed=7)
    assert torch.equal(l1, l2) and float(s1.inertia) == float(s2.inertia)
    assert torch.equal(s1.centroids, s2.centroids)
    l3, _ = tkm.kmeans_fit_predict(x, 4, seed=8)
    assert not torch.equal(l1, l3)      # the seed reaches the init


def test_blob_quality_matches_jax_and_sklearn():
    from sklearn.cluster import KMeans
    x = _blobs()
    sk = KMeans(n_clusters=5, random_state=42, n_init="auto").fit(x)
    _, jstate = jkm.kmeans_fit_predict(jnp.asarray(x), 5, seed=42)
    lab, state = tkm.kmeans_fit_predict(torch.from_numpy(x), 5, seed=42)
    assert float(state.inertia) <= 1.01 * float(jstate.inertia)
    assert float(state.inertia) <= 1.01 * sk.inertia_
    ours = lab.numpy()
    for i in range(5):
        blob = ours[i * 300:(i + 1) * 300]
        assert (blob == np.bincount(blob).argmax()).mean() > 0.95


def test_plus_plus_follows_its_gumbel_draws():
    """Each pick is the argmax of log(squared distance to the nearest
    earlier pick) + the generator's Gumbel noise (numpy oracle in f64; the
    noise is continuous, so no pick sits within rounding of a tie)."""
    x = _blobs()
    cents = tkm.kmeans_plus_plus_init(torch.from_numpy(x), 5,
                                      torch.Generator().manual_seed(1))
    g = tkm.gumbel_noise(torch.Generator().manual_seed(1), 5,
                         len(x)).numpy().astype(np.float64)
    picks = [int(np.argmax(g[0]))]
    d2 = np.full(len(x), np.inf)
    for i in range(1, 5):
        d2 = np.minimum(d2, ((x - x[picks[-1]]).astype(np.float64) ** 2
                             ).sum(1))
        with np.errstate(divide="ignore"):
            picks.append(int(np.argmax(np.log(d2) + g[i])))
    np.testing.assert_array_equal(cents.numpy(), x[picks])
    assert len(set(picks)) == 5


def test_minmax_scale_matches_jax_and_sklearn():
    from sklearn.preprocessing import MinMaxScaler
    x = np.random.default_rng(42).standard_normal((200, 6)).astype(
        np.float32)
    x[:, 2] = 3.0                       # a constant feature scales to 0
    got = tkm.minmax_scale_features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jkm.minmax_scale_features(jnp.asarray(x))),
        rtol=0, atol=1e-7)
    # sklearn scales as x * scale_ + min_, another rounding than
    # (x - min) / range: one ulp of values in [0, 1]
    np.testing.assert_allclose(got, MinMaxScaler().fit_transform(x),
                               rtol=0, atol=2.4e-7)


# ----------------------------------------------------- the turbo programs

@pytest.fixture(scope="module")
def scenes():
    s = synthetic_scenes(2, 64, 80, seed=0)
    return (s, *stretch_stats_batch(s))


@pytest.fixture(scope="module")
def jax_runs(scenes):
    """The JAX batch program's maps and centroids: per-scene fits, a
    shared fit, and a warm start from the shared fit's centroids."""
    s, luts, _, _ = scenes
    args = (jnp.asarray(s), jnp.asarray(luts))
    per = jturbo.kmeans_scenes_turbo_batch(*args, return_cents=True)
    shared = jturbo.kmeans_scenes_turbo_batch(*args, shared_fit=True,
                                              return_cents=True)
    warm = jturbo.kmeans_scenes_turbo_batch(*args, shared_fit=True,
                                            init_cents=shared[1],
                                            return_cents=True)
    return {name: tuple(np.asarray(v) for v in run)
            for name, run in (("per_scene", per), ("shared", shared),
                              ("warm", warm))}


@pytest.fixture(scope="module")
def rule_maps(scenes):
    s, luts, _, _ = scenes
    return tturbo.rule_based_scenes_turbo_batch(s, luts, cfg=CFG, device="cpu")


def _mapped_kappa(maps, truth) -> float:
    ev = ClassificationEvaluator(device="cpu")
    pred, true = ev.extract_valid_samples(maps, truth)
    return ev.calculate_metrics(true, ev.map_clusters_to_classes(pred, true)
                                )["kappa"]


RUNS = {"per_scene": {}, "shared": {"shared_fit": True}}


@pytest.mark.parametrize("name", ["per_scene", "shared", "warm"])
def test_assignment_to_jax_centroids_matches_jax_maps(scenes, jax_runs,
                                                      name):
    s, luts, _, _ = scenes
    jmaps, jcents = jax_runs[name]
    xs = tturbo.kmeans_features(torch.from_numpy(s), torch.from_numpy(luts),
                                CFG)
    cents = torch.from_numpy(jcents).expand(2, K, 19)
    got = (tturbo.assign_clusters(xs, cents).reshape(jmaps.shape) + 1).to(
        torch.uint8).numpy()
    # the stacks differ at the 1e-6 level (ROADMAP queue 3), so a pixel
    # near equidistant from two centroids may flip; none did when measured
    assert (got == jmaps).mean() >= 0.999


@pytest.mark.parametrize("name", ["per_scene", "shared"])
def test_fit_quality_within_margin_of_jax(scenes, jax_runs, rule_maps, name):
    s, luts, params, hists = scenes
    maps, cents = tturbo.kmeans_scenes_turbo_batch(
        s, luts, cfg=CFG, stretch_params=params, stretch_hists=hists,
        return_cents=True, device="cpu", **RUNS[name])
    assert maps.shape == (2, 64, 80) and maps.dtype == torch.uint8
    assert cents.shape == ((K, 19) if name == "shared" else (2, K, 19))
    assert int(maps.min()) >= 1 and int(maps.max()) <= K
    for b in range(2):
        port = _mapped_kappa(maps[b], rule_maps[b])
        ref = _mapped_kappa(jax_runs[name][0][b], rule_maps[b])
        assert port >= ref - KAPPA_MARGIN, (b, port, ref)


def test_warm_start_reconverges_at_once(scenes):
    s, luts, _, _ = scenes
    maps, cents = tturbo.kmeans_scenes_turbo_batch(
        s, luts, cfg=CFG, shared_fit=True, return_cents=True, device="cpu")
    xs = tturbo.kmeans_features(torch.from_numpy(s), torch.from_numpy(luts),
                                CFG)
    _, warm_cents, n_iter = tturbo.kmeans_fit(xs, K, 42, 8, True, cents)
    assert int(n_iter[0]) == 1          # the first step's shift is <= tol
    warm = tturbo.kmeans_scenes_turbo_batch(
        s, luts, cfg=CFG, shared_fit=True, init_cents=cents, device="cpu")
    ref = (tturbo.assign_clusters(xs, warm_cents.expand(2, K, 19))
           .reshape(2, 64, 80) + 1).to(torch.uint8)
    assert torch.equal(warm, ref)
    assert (warm == maps).double().mean() >= 0.999


def test_batch_equals_single_scene_program(scenes):
    """The batched per-scene program holds each scene's Lloyd loop apart:
    a scene that converges keeps its centroids while the other goes on."""
    s, luts, _, _ = scenes
    xs = tturbo.kmeans_features(torch.from_numpy(s), torch.from_numpy(luts),
                                CFG)
    _, _, n_iter = tturbo.kmeans_fit(xs, K, 42, 1, False)
    assert n_iter[0] != n_iter[1]       # one scene froze before the other
    batch = tturbo.kmeans_scenes_turbo_batch(s, luts, cfg=CFG, fit_stride=1,
                                             device="cpu")
    for b in range(2):
        one = tturbo.kmeans_scenes_turbo(s[b], luts[b], K, CFG,
                                         device="cpu")
        assert torch.equal(one, batch[b])


def test_single_scene_quality_within_margin_of_jax(scenes, rule_maps):
    s, luts, _, _ = scenes
    ref = np.asarray(jturbo.kmeans_scenes_turbo(jnp.asarray(s[0]),
                                                jnp.asarray(luts[0])))
    got = tturbo.kmeans_scenes_turbo(s[0], luts[0], K, CFG, device="cpu")
    assert got.shape == (64, 80) and got.dtype == torch.uint8
    assert (_mapped_kappa(got, rule_maps[0])
            >= _mapped_kappa(ref, rule_maps[0]) - KAPPA_MARGIN)


def test_init_cents_requires_shared_fit(scenes):
    s, luts, _, _ = scenes
    with pytest.raises(ValueError, match="shared_fit"):
        tturbo.kmeans_scenes_turbo_batch(s, luts, cfg=CFG,
                                         init_cents=np.zeros((K, 19)),
                                         device="cpu")
