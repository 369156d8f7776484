"""PyTorch port vs the JAX package, on the CPU: stage 1 (preprocess) and
the normalisation and resize ops it and stage 2 use. Inputs come from
numpy with a seed. Tolerance 1e-5 absolute unless stated beside the
assert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import CalibrationConfig
from rs_image_segmentation_tpu.ops import normalize as jnorm
from rs_image_segmentation_tpu.ops import resize as jresize
from rs_image_segmentation_tpu.pipeline import preprocess as jpre
from rs_image_segmentation_tpu_torch.ops import normalize as tnorm
from rs_image_segmentation_tpu_torch.ops import resize as tresize
from rs_image_segmentation_tpu_torch.pipeline import preprocess as tpre
from rs_image_segmentation_tpu_torch.tools.fixtures import synthetic_scenes

CAL = CalibrationConfig()
GAINS = np.asarray(CAL.gains, np.float32)
BIASES = np.asarray(CAL.biases, np.float32)
# a rotation by 0.1 rad plus a shift
WARP = (float(np.cos(0.1)), float(-np.sin(0.1)), 5.0,
        float(np.sin(0.1)), float(np.cos(0.1)), -3.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene():
    return synthetic_scenes(1, 96, 112, seed=4)[0]


def _field(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_percentile_matches():
    x = _field(1, (50, 77)) * 300.0
    qs = [0.0, 2.0, 25.0, 50.0, 75.0, 98.0, 100.0]
    got = tnorm.percentile(torch.from_numpy(x), qs).numpy()
    ref = np.asarray(jnorm.percentile(jnp.asarray(x), jnp.asarray(qs)))
    # v_lo * (1 - frac) + v_hi * frac: XLA may fuse it into an FMA, so a
    # percentile can sit an ulp (3e-5 at 300) apart
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)
    np.testing.assert_allclose(got, np.percentile(x, qs), rtol=1e-6)
    assert float(tnorm.percentile(torch.from_numpy(x), 50.0)) == got[3]


def test_robust_normalize_matches_per_band():
    x = _field(2, (3, 50, 77)) * 255.0
    got = tnorm.robust_normalize(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.vmap(jnorm.robust_normalize)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_minmax_ops_match():
    x = _field(3, (50, 77)) * 40.0 - 7.0
    np.testing.assert_allclose(tnorm.minmax01(torch.from_numpy(x)).numpy(),
                               np.asarray(jnorm.minmax01(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_array_equal(
        tnorm.minmax_stretch_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jnorm.minmax_stretch_u8(jnp.asarray(x))))
    band01 = _field(4, (50, 77))
    np.testing.assert_array_equal(
        tnorm.quantize_levels(torch.from_numpy(band01), 32).numpy(),
        np.asarray(jnorm.quantize_levels(jnp.asarray(band01), 32)))


def test_resize_nearest_matches():
    img = np.arange(50 * 77, dtype=np.int32).reshape(50, 77)
    for shape in ((20, 31), (111, 160)):
        np.testing.assert_array_equal(
            tresize.resize_nearest(torch.from_numpy(img), shape).numpy(),
            np.asarray(jresize.resize_nearest(jnp.asarray(img), shape)))


def test_estimate_affine_from_gcps():
    m = np.asarray(WARP).reshape(2, 3)
    src = np.random.default_rng(5).random((6, 2)) * 100.0
    dst = src @ m[:, :2].T + m[:, 2]
    gcps = [((sx, sy), (dx, dy)) for (sx, sy), (dx, dy) in zip(src, dst)]
    got = tresize.estimate_affine_from_gcps(gcps)
    np.testing.assert_array_equal(got, jresize.estimate_affine_from_gcps(gcps))
    np.testing.assert_allclose(got, m, atol=1e-9)
    with pytest.raises(ValueError, match="3 GCPs"):
        tresize.estimate_affine_from_gcps(gcps[:2])


def test_warp_affine_bilinear_matches():
    img = _field(6, (2, 50, 77)) * 255.0
    got = tresize.warp_affine_bilinear(torch.from_numpy(img), WARP).numpy()
    ref = np.asarray(jresize.warp_affine_bilinear(jnp.asarray(img), WARP))
    # the source coordinates and bilinear weights are multiply-adds that
    # XLA may fuse; at values up to 255 a few ulps are ~3e-5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert (got == 0).any()         # the rotated corners read the border


def test_radiometric_calibration_matches(scene):
    got = tpre.radiometric_calibration(torch.from_numpy(scene), GAINS,
                                       BIASES).numpy()
    ref = np.asarray(jpre.radiometric_calibration(jnp.asarray(scene), GAINS,
                                                  BIASES))
    # DN * gain + bias: one FMA in XLA, two roundings here
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_preprocess_bands_uint8_bit_equal(scene):
    got = tpre.preprocess_bands(scene, GAINS, BIASES, device="cpu")
    ref = np.asarray(jpre.preprocess_bands(jnp.asarray(scene), GAINS,
                                           BIASES))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["uint16", "warp"])
def test_preprocess_bands_f32_routes_match(scene, dtype):
    dn = (scene.astype(np.uint16) * 257
          + np.random.default_rng(9).integers(0, 257, scene.shape)
          .astype(np.uint16))
    matrix = WARP if dtype == "warp" else tpre._IDENTITY
    got = tpre.preprocess_bands(dn, GAINS, BIASES, matrix,
                                device="cpu").numpy()
    ref = np.asarray(jpre.preprocess_bands(jnp.asarray(dn), GAINS, BIASES,
                                           matrix))
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    # XLA fuses the calibration (and the warp's weights) into FMAs: a
    # value an ulp apart truncates one level lower where the stretch lands
    # within an ulp of an integer (measured 99.993 % equal on 16-bit DNs,
    # 99.997 % with the warp, at 7 x 96 x 112)
    assert np.mean(diff == 0) >= 0.999
    assert diff.max() <= 1


def test_preprocess_bands_device_lut_matches(scene):
    calv = jpre.calibrated_value_table(GAINS, BIASES)
    got = tpre.preprocess_bands_device_lut(scene, calv, device="cpu")
    ref = np.asarray(jpre.preprocess_bands_device_lut(jnp.asarray(scene),
                                                      jnp.asarray(calv)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stage1_entry_points_need_a_device(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tpre.preprocess_bands(scene, GAINS, BIASES),
               lambda: tpre.preprocess_bands_f32(scene, GAINS, BIASES),
               lambda: tpre.preprocess_bands_device_lut(
                   scene, tpre.calibrated_value_table(GAINS, BIASES))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
