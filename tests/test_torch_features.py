"""PyTorch port vs the JAX package, on the CPU: stage 2 (feature
extraction) module by module, then ``extract_features`` whole and
``hierarchical_stack_fused``. Inputs are seeded synthetic scenes through
the stage-1 LUT (numpy). Tolerance 1e-5 absolute unless stated beside the
assert; every looser bound carries its reason (ROADMAP queue 3).

Where the JAX side runs under ``jax.jit`` (as ``extract_features`` does
per family), XLA:CPU fuses multiply-adds into FMAs, while eager PyTorch
rounds every product; and XLA divides by a constant as a multiply by its
reciprocal. Both move results by a rounding step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import (
    CalibrationConfig, FeatureStageConfig)
from rs_image_segmentation_tpu.models import pca as jpca
from rs_image_segmentation_tpu.ops import morphology as jmorph
from rs_image_segmentation_tpu.ops import multiscale as jms
from rs_image_segmentation_tpu.ops import normalize as jnorm
from rs_image_segmentation_tpu.ops import stencil as jstencil
from rs_image_segmentation_tpu.ops import texture as jtex
from rs_image_segmentation_tpu.pipeline import features as jfeat
from rs_image_segmentation_tpu_torch.models import pca as tpca
from rs_image_segmentation_tpu_torch.ops import morphology as tmorph
from rs_image_segmentation_tpu_torch.ops import multiscale as tms
from rs_image_segmentation_tpu_torch.ops import normalize as tnorm
from rs_image_segmentation_tpu_torch.ops import stencil as tstencil
from rs_image_segmentation_tpu_torch.ops import texture as ttex
from rs_image_segmentation_tpu_torch.pipeline import features as tfeat
from rs_image_segmentation_tpu_torch.pipeline import preprocess as tpre
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    stretch_stats_batch, synthetic_scenes)

CFG = FeatureStageConfig()
CAL_GAINS = np.asarray(CalibrationConfig().gains)
CAL_BIASES = np.asarray(CalibrationConfig().biases)
# one rounding step of u8 / 255: XLA multiplies by the reciprocal
DIV255 = 6e-8
# (key, (atol, min share of equal pixels)) where 1e-5 absolute does not
# hold for extract_features, with why
LOOSE = {
    # EVI's denominator nir + 6 red - 7.5 blue + 1 cancels: see
    # test_torch_turbo.py; measured 2.4e-6 here
    "evi": (1e-3, 0.0),
    # sqrt(max(E[x^2] - E[x]^2, 0)) over nearly flat windows: an ulp of
    # the box sums (FMA) turns into up to sqrt(1.2e-7) = 3.5e-4
    "multi_scale_features.std_dev_scale_3": (3.5e-4, 0.0),
    "multi_scale_features.std_dev_scale_5": (3.5e-4, 0.0),
    "multi_scale_features.std_dev_scale_7": (3.5e-4, 0.0),
    # contrast reaches ~10, where an f32 ulp is ~1e-6 and the JAX route
    # sums 32 x 32 f32 products in its own order (relative 2e-6 below)
    "glcm_features.contrast": (3e-5, 0.0),
    # the jitted JAX LBP fuses each sample's bilinear taps into FMAs: a
    # tap sum within an ulp of the centre flips the sign test and the
    # code (measured 99.84 % equal at 64 x 80, 99.79 % at 50 x 77, on
    # saturated flat runs of the renormalised band); bound by share
    "lbp_feature": (None, 0.997),
}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _stage1(h, w, seed):
    """A (7, h, w) stage-1 artifact: a synthetic scene through its exact
    stretch LUT, as f32 levels."""
    scene = synthetic_scenes(1, h, w, seed=seed)[0]
    lut = stretch_stats_batch(scene[None])[0][0]
    return np.stack([lut[c][scene[c]] for c in range(7)]).astype(np.float32)


@pytest.fixture(scope="module")
def bands01():
    """Normalised bands of a 7 x 64 x 80 artifact (identical on both sides:
    the percentiles agree bit for bit here)."""
    arr = _stage1(64, 80, 7)
    ref = np.array(jax.vmap(jnorm.robust_normalize)(jnp.asarray(arr)))
    got = tnorm.robust_normalize(torch.from_numpy(arr)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    return ref


@pytest.fixture(scope="module")
def tex01(bands01):
    return np.array(jnorm.robust_normalize(jnp.asarray(bands01[3])))


def _u8(band01):
    return (band01 * np.float32(255.0)).astype(np.uint8)


def test_pca_bands_matches(bands01):
    got, ratio = tpca.pca_bands(torch.from_numpy(bands01))
    ref, ref_ratio = jpca.pca_bands(jnp.asarray(bands01))
    # svd_flip fixes each component's sign on both sides; the f32 Gram
    # and the eigensolvers differ by rounding, and the components of
    # small eigenvalues turn more (measured: PC1 4.8e-7, all 5e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_allclose(ratio.numpy(), np.asarray(ref_ratio),
                               atol=1e-6)


def test_lbp_uniform_codes(tex01):
    u8 = _u8(tex01)
    got = ttex.lbp_uniform(torch.from_numpy(u8)).numpy()
    eager = np.asarray(jtex.lbp_uniform(jnp.asarray(u8)))
    jitted = np.asarray(jax.jit(jtex.lbp_uniform)(jnp.asarray(u8)))
    # as the JAX package's own LBP tests run it (eagerly): no FMA, and
    # the codes are equal
    np.testing.assert_array_equal(got, eager)
    # under jit XLA fuses the taps into FMAs (see LOOSE["lbp_feature"]):
    # measured 99.84 % equal here, 8 of 5120 pixels, 7 of them centres
    # at 255 whose taps all read 255
    assert np.mean(got == jitted) >= 0.997


@pytest.mark.parametrize("radius", [1, 3, 5])
def test_windowed_entropy_matches(tex01, radius):
    u8 = _u8(tex01)
    got = ttex.windowed_entropy_u8(torch.from_numpy(u8), radius).numpy()
    ref = np.asarray(jtex.windowed_entropy_u8(jnp.asarray(u8), radius))
    # exact counts; log2 and the sum over levels round in their own order
    np.testing.assert_allclose(got, ref, atol=2e-6)
    assert np.array_equal(got == 0, ref == 0)


def test_multi_scale_features_match(tex01):
    got = tms.multi_scale_features(torch.from_numpy(tex01))
    ref = jms.multi_scale_features(jnp.asarray(tex01))
    assert list(got) == list(ref)
    for name in ref:
        # std: the square root of a cancelling variance (LOOSE above)
        atol = 3.5e-4 if name.startswith("std") else 1e-5
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_morphology_u8_exact(tex01, ksize):
    u8 = _u8(tex01)
    for name in ("erode", "dilate", "opening", "closing", "gradient"):
        got = getattr(tmorph, name)(torch.from_numpy(u8), ksize)
        ref = getattr(jmorph, name)(jnp.asarray(u8), ksize)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=name)
    np.testing.assert_array_equal(
        tmorph.gradient(torch.from_numpy(u8), ksize, "ellipse").numpy(),
        np.asarray(jmorph.gradient(jnp.asarray(u8), ksize, "ellipse")))


def test_morphological_features_match(tex01):
    got = tfeat.morphological_features(torch.from_numpy(tex01))
    ref = jfeat.morphological_features(jnp.asarray(tex01))
    assert list(got) == list(ref)
    for name in ref:
        # the uint8 planes are equal (test above); / 255 rounds once
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=DIV255, rtol=0, err_msg=name)


def test_stencils_match(tex01):
    u8 = _u8(tex01)
    x = u8.astype(np.float32)
    for ksize in (5, 15):
        np.testing.assert_array_equal(
            tstencil.gaussian_blur_u8(torch.from_numpy(u8), ksize).numpy(),
            np.asarray(jstencil.gaussian_blur_u8(jnp.asarray(u8), ksize)))
    np.testing.assert_array_equal(
        tstencil.laplacian(torch.from_numpy(x)).numpy(),
        np.asarray(jstencil.laplacian(jnp.asarray(x))))
    for g, r in zip(tstencil.sobel_xy(torch.from_numpy(x)),
                    jstencil.sobel_xy(jnp.asarray(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert np.array_equal(tstencil.gaussian_kernel1d(15),
                          jstencil.gaussian_kernel1d(15))


def test_filter_responses_match(tex01):
    got = tfeat.filter_responses(torch.from_numpy(tex01))
    ref = jfeat.filter_responses(jnp.asarray(tex01))
    assert list(got) == list(ref)
    for name in ref:
        # / 255 and the min-max scaling round once each
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-6, err_msg=name)


def test_gabor_responses_match(tex01):
    u8 = _u8(tex01)
    got = tstencil.gabor_responses(torch.from_numpy(u8))
    ref = jstencil.gabor_responses(jnp.asarray(u8))
    assert len(got) == len(ref) == 24
    for k, (g, r) in enumerate(zip(got, ref)):
        # the 15 x 15 kernels: a convolution in XLA, a tree of 225
        # shifted taps here; min-max scaled to [0, 1]
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=str(k))


def _flat(d, pre=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{pre}{k}.")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                yield f"{pre}{k}[{i}]", x
        else:
            yield pre + k, v


def _assert_features(got: dict, ref: dict):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    # a jitted JAX family returns its dict with sorted keys
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        r, g = np.asarray(r), got[key].cpu().numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
        atol, share = LOOSE.get(key, (1e-5, 0.0))
        if atol is None:
            assert np.mean(g == r) >= share, key
        else:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0,
                                       err_msg=key)


@pytest.mark.parametrize("shape", [(64, 80), (50, 77)])
def test_extract_features_match(shape):
    arr = _stage1(*shape, seed=7)
    ref_feats, ref_hier = jfeat.extract_features(jnp.asarray(arr), CFG)
    feats, hier = tfeat.extract_features(arr, CFG, device="cpu")
    _assert_features(feats, ref_feats)
    assert sorted(hier) == sorted(ref_hier)
    names = ["ndwi", "mndwi", "ndvi", "evi", "ndbi", "bsi", "pc1"]
    names += [f"ctx_{n}" for n in names]
    names += ["glcm_contrast", "glcm_homogeneity", "grad5", "std5",
              "sobel"]
    for key in ref_hier:
        g, r = hier[key].numpy(), np.asarray(ref_hier[key])
        assert g.shape == r.shape, key
        for c in range(r.shape[-1]):
            name = names[c] if key != "level_2" else names[14 + c]
            atol = {"evi": 1e-3, "std5": 3.5e-4,
                    "glcm_contrast": 3e-5}.get(name, 1e-5)
            np.testing.assert_allclose(g[..., c], r[..., c], atol=atol,
                                       err_msg=f"{key} {name}")


def test_extract_features_with_gabor():
    cfg = FeatureStageConfig(include_gabor=True)
    arr = _stage1(50, 77, seed=3)
    feats, _ = tfeat.extract_features(arr, cfg, include_entropy=False,
                                      device="cpu")
    assert len(feats["gabor_features"]) == 24
    assert not any(k.startswith("entropy")
                   for k in feats["multi_scale_features"])
    tex01 = jnorm.robust_normalize(jax.vmap(jnorm.robust_normalize)(
        jnp.asarray(arr))[3])
    ref = jstencil.gabor_responses(jnp.asarray(_u8(np.asarray(tex01))))
    for g, r in zip(feats["gabor_features"], ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_hierarchical_stack_fused_matches():
    arr = _stage1(64, 80, seed=11)
    got = tfeat.hierarchical_stack_fused(arr, CFG, device="cpu").numpy()
    ref = np.asarray(jfeat.hierarchical_stack_fused(jnp.asarray(arr), CFG))
    assert got.shape == ref.shape == (64, 80, 19)
    # test_torch_turbo.py's bounds: EVI 1e-3, std5 3.5e-4, GLCM contrast
    # 1e-5 + 2e-6 relative (the single jitted graph sums in its own order)
    for c in range(19):
        atol, rtol = {3: (1e-3, 0.0), 17: (3.5e-4, 0.0),
                      14: (1e-5, 2e-6)}.get(c, (1e-5, 0.0))
        np.testing.assert_allclose(got[..., c], ref[..., c], atol=atol,
                                   rtol=rtol, err_msg=str(c))
    assert np.array_equal(got, tfeat.hierarchical_stack(
        arr, CFG, device="cpu").numpy())


@pytest.mark.parametrize("shape", [(96, 96), (50, 77)])
def test_fused_stack_matches_turbo_stack(shape):
    """The JAX package's contract between its two stacks
    (tests/test_turbo.py::test_turbo_stack_matches_fused, 1e-4), held by
    the port's: the turbo stack takes its percentiles from histograms,
    the stage-2 graph from sorts (measured 6.3e-5 on EVI at 50 x 77)."""
    from rs_image_segmentation_tpu_torch.pipeline import turbo as tturbo
    scene = synthetic_scenes(1, *shape, seed=11)[0]
    lut = stretch_stats_batch(scene[None])[0][0]
    pre = tpre.preprocess_bands(scene, CAL_GAINS, CAL_BIASES, device="cpu")
    std = tfeat.hierarchical_stack_fused(pre, CFG, device="cpu").numpy()
    turbo = tturbo.hierarchical_stack_turbo_cm(scene, lut, CFG,
                                               device="cpu").numpy()
    assert np.abs(std - np.moveaxis(turbo, 0, -1)).max() < 1e-4


def test_stage2_entry_points_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = np.zeros((7, 40, 40), np.float32)
    for fn in (tfeat.extract_features, tfeat.hierarchical_stack,
               tfeat.hierarchical_stack_fused):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(arr)
