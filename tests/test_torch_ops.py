"""PyTorch port vs the JAX package: the stack's elementwise, stencil,
morphology, resize and GLCM ops on the CPU, inputs from a numpy seed.

Tolerance 1e-6 absolute unless stated beside the assert. XLA:CPU fuses a
multiply feeding an add into one FMA while PyTorch rounds the product
first, so results differ by a rounding step where the JAX program has a
multiply-add."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.ops import indices as jind
from rs_image_segmentation_tpu.ops import morphology as jmorph
from rs_image_segmentation_tpu.ops import resize as jresize
from rs_image_segmentation_tpu.ops import stencil as jstencil
from rs_image_segmentation_tpu.ops import texture as jtex
from rs_image_segmentation_tpu_torch.ops import indices as tind
from rs_image_segmentation_tpu_torch.ops import morphology as tmorph
from rs_image_segmentation_tpu_torch.ops import resize as tresize
from rs_image_segmentation_tpu_torch.ops import stencil as tstencil
from rs_image_segmentation_tpu_torch.ops import texture as ttex

ANGLES = (0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4)


def _field(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_spectral_indices_match():
    bands = _field(1, (7, 50, 77))
    got = tind.spectral_indices(torch.from_numpy(bands))
    ref = jind.spectral_indices(jnp.asarray(bands))
    assert list(got) == list(ref)
    for name in ref:
        d = np.abs(got[name].numpy() - np.asarray(ref[name]))
        if name == "evi":
            # EVI's denominator nir + 6 red - 7.5 blue + 1 cancels: XLA:CPU
            # evaluates it with two FMAs, PyTorch rounds each product, and
            # the ~1-ulp difference in terms of size ~8 is divided by a
            # denominator that the guard only bounds below by 1e-3
            assert d.max() < 1e-3, name
            assert np.median(d) < 1e-7, name
        else:
            assert d.max() < 1e-6, name


@pytest.mark.parametrize("border", ["reflect101", "reflect"])
@pytest.mark.parametrize("ksize", [5, 7])
def test_box_filter_matches(border, ksize):
    x = _field(2, (3, 50, 77))
    got = tstencil.box_filter(torch.from_numpy(x), ksize, border=border)
    ref = jstencil.box_filter(jnp.asarray(x), ksize, border=border)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-6


def test_sobel_magnitude_matches():
    x = np.random.default_rng(3).integers(0, 256, (2, 50, 77)).astype(
        np.float32)
    got = tstencil.sobel_magnitude(torch.from_numpy(x))
    ref = np.asarray(jstencil.sobel_magnitude(jnp.asarray(x)))
    # magnitudes reach ~1400: 1e-6 relative is a few f32 ulps
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_morphological_gradient_matches(dtype):
    x = (np.random.default_rng(4).random((2, 50, 77)) * 255).astype(dtype)
    got = tmorph.gradient(torch.from_numpy(x), 5)
    ref = np.asarray(jmorph.gradient(jnp.asarray(x), 5))
    assert got.numpy().dtype == ref.dtype
    assert np.abs(got.numpy().astype(np.float64) - ref).max() < 1e-6


def test_resize_bilinear_matches():
    grid = _field(5, (2, 4, 5))
    for shape in [(50, 77), (96, 96)]:
        got = tresize.resize_bilinear(torch.from_numpy(grid), shape)
        ref = jresize.resize_bilinear(jnp.asarray(grid), shape)
        assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-6


@pytest.mark.parametrize("step", [12, 7])
def test_extract_windows_and_glcm_matrices_exact(step):
    q = np.random.default_rng(6).integers(0, 8, (40, 53)).astype(np.int32)
    got_w = ttex._extract_windows(torch.from_numpy(q), 12, step)
    ref_w = np.asarray(jtex._extract_windows(jnp.asarray(q), 12, step))
    assert np.array_equal(got_w.numpy(), ref_w)
    got = ttex.glcm_matrices(got_w, 8, (1, 2), ANGLES)
    ref = jtex.glcm_matrices(jnp.asarray(ref_w), 8, (1, 2), ANGLES)
    # integer counts, their symmetric sum and one division: exact
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_glcm_feature_maps_match():
    band = _field(7, (96, 96))
    got = ttex.glcm_feature_maps(torch.from_numpy(band), 32, 21, 21, (1,),
                                 ANGLES)
    ref = jtex.glcm_feature_maps(jnp.asarray(band), 32, 21, 21, (1,),
                                 ANGLES)
    assert list(got) == list(ref)
    for name in ref:
        r = np.asarray(ref[name])
        # each property is an f32 sum of 32x32 terms taken in another
        # order than XLA's; contrast reaches ~(L-1)^2 / 6 ~ 160 on white
        # noise, where an ulp is 1.5e-5, so the bound scales with |value|
        np.testing.assert_allclose(got[name].numpy(), r, rtol=2e-6,
                                   atol=1e-6, err_msg=name)
