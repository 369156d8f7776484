"""PyTorch port vs the JAX package, on the CPU: the GLCM kernel's plain
version ``ops.kernels.glcm_grid_plain`` against ``glcm_grid_pallas`` in
interpret mode and against the XLA route, and the ``backend`` argument of
``ops.texture.glcm_feature_maps``. Inputs come from numpy with a seed.

The plain version reduces exact integer moments of each window's pairs
and finishes in f64, rounding once to f32; the JAX routes sum f32
products. Bounds are stated beside each assert."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.ops import texture as jtex
from rs_image_segmentation_tpu.ops.pallas_kernels import glcm_grid_pallas
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.ops import texture as ttex

ANGLES = (0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4)
OFFSETS = tuple(jtex._offset_for_angle(1, a) for a in ANGLES)
PROPS = ("contrast", "dissimilarity", "homogeneity", "energy",
         "correlation")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _xla_grid(q, levels, window):
    """The JAX XLA route's per-window props, (n_i, n_j, 5)."""
    windows = jtex._extract_windows(jnp.asarray(q), window, window)
    props = jtex.glcm_properties(jtex.glcm_matrices(windows, levels, (1,),
                                                    ANGLES))
    n_i = (q.shape[0] - window) // window + 1
    n_j = (q.shape[1] - window) // window + 1
    return np.stack([np.asarray(jnp.mean(props[k], axis=(1, 2)))
                     .reshape(n_i, n_j) for k in PROPS], axis=-1)


def _flat_windows(levels=8, window=12, shape=(48, 60), seed=42):
    """Random levels with flat windows: one constant, one at level 0, one
    of vertical stripes (flat along each column)."""
    q = np.random.default_rng(seed).integers(0, levels, shape).astype(
        np.int32)
    q[:window, :window] = 3
    q[window:2 * window, window:2 * window] = 0
    q[2 * window:3 * window, :window] = np.arange(window)[None] % levels
    return q


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
def test_plain_matches_pallas(flat):
    q = (_flat_windows() if flat else np.random.default_rng(42).integers(
        0, 8, (48, 60)).astype(np.int32))
    ref = np.asarray(glcm_grid_pallas(jnp.asarray(q), 8, 12, 12, OFFSETS,
                                      interpret=True))
    got = kernels.glcm_grid_plain(torch.from_numpy(q), 8, 12, 12,
                                  OFFSETS).numpy()
    assert got.shape == ref.shape == (4, 5, 5) and got.dtype == np.float32
    # the Pallas test's bound (tests/test_pallas.py)
    assert np.abs(ref - got).max() < 1e-4
    if flat:
        # a flat window: contrast 0, dissimilarity 0, homogeneity 1,
        # energy 1, correlation exactly 1; the JAX routes give the same
        for grid in (got, ref, _xla_grid(q, 8, 12)):
            np.testing.assert_array_equal(grid[0, 0], [0, 0, 1, 1, 1])
            np.testing.assert_array_equal(grid[1, 1], [0, 0, 1, 1, 1])


# 16 offsets, some negative: the kernel's warps loop over them
OFFSETS_16 = ((0, 1), (1, 0), (1, 1), (1, -1), (-1, 0), (0, -1), (-1, -1),
              (-1, 1), (0, 2), (2, 0), (2, 2), (-2, 3), (3, -2), (0, -3),
              (-3, 0), (2, -1))


def _edge_case(name):
    """(q, levels, window, offsets) of a glcm_grid edge case the card
    checks too, at a small size."""
    rng = np.random.default_rng(21)
    if name == "16 offsets":
        return (rng.integers(0, 8, (48, 60)).astype(np.int32), 8, 12,
                OFFSETS_16)
    if name == "window 23 on 50 x 71":
        return (rng.integers(0, 8, (50, 71)).astype(np.int32), 8, 23,
                OFFSETS)
    if name == "levels 1":
        return (rng.integers(-1, 2, (48, 60)).astype(np.int32), 1, 12,
                OFFSETS)
    if name == "levels 2":
        return (rng.integers(0, 2, (48, 60)).astype(np.int32), 2, 12,
                OFFSETS)
    if name == "inputs -1 and levels":
        return (rng.integers(-1, 9, (48, 60)).astype(np.int32), 8, 12,
                OFFSETS)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["16 offsets", "window 23 on 50 x 71",
                                  "levels 1", "levels 2",
                                  "inputs -1 and levels"])
def test_plain_matches_pallas_on_edge_cases(name):
    q, levels, window, offsets = _edge_case(name)
    ref = np.asarray(glcm_grid_pallas(jnp.asarray(q), levels, window, window,
                                      offsets, interpret=True))
    got = kernels.glcm_grid_plain(torch.from_numpy(q), levels, window,
                                  window, offsets).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(ref - got).max() < 1e-4      # the Pallas test's bound


def test_plain_batch_of_8_matches_pallas_per_band():
    q = np.random.default_rng(22).integers(-1, 9, (8, 36, 50)).astype(
        np.int32)
    got = kernels.glcm_grid_plain(torch.from_numpy(q), 8, 12, 12,
                                  OFFSETS).numpy()
    assert got.shape == (8, 3, 4, 5)
    for b in range(8):
        ref = np.asarray(glcm_grid_pallas(jnp.asarray(q[b]), 8, 12, 12,
                                          OFFSETS, interpret=True))
        assert np.abs(ref - got[b]).max() < 1e-4   # the Pallas test's bound


def test_levels_1_gives_flat_properties():
    """At one level every counted pair sits on one cell: 0, 0, 1, 1, 1;
    a window without a pair gives 0, 0, 0, 0, 1."""
    q = np.zeros((24, 36), np.int32)
    q[12:, 12:24] = -1                  # one window with no valid pair
    got = kernels.glcm_grid_plain(torch.from_numpy(q), 1, 12, 12,
                                  OFFSETS).numpy()
    np.testing.assert_array_equal(got[0, 0], [0, 0, 1, 1, 1])
    np.testing.assert_array_equal(got[1, 1], [0, 0, 0, 0, 1])


@pytest.mark.parametrize("levels", [32, 256])
def test_plain_matches_xla_route(levels):
    q = np.random.default_rng(levels).integers(
        0, levels, (96, 112)).astype(np.int32)
    ref = _xla_grid(q, levels, 21)
    got = kernels.glcm_grid_plain(torch.from_numpy(q), levels, 21, 21,
                                  OFFSETS).numpy()
    # XLA sums levels^2 f32 products; contrast reaches ~10 at 32 levels
    # and ~1e4 at 256, so the bound is relative there (an f32 ulp ~1e-7)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6)


def test_levels_outside_range_are_dropped():
    """A pair with a level outside [0, levels) is not counted, as the JAX
    one-hot forms drop it."""
    q = np.random.default_rng(5).integers(-2, 10, (48, 60)).astype(np.int32)
    got = kernels.glcm_grid_plain(torch.from_numpy(q), 8, 12, 12,
                                  OFFSETS).numpy()
    ref = np.asarray(glcm_grid_pallas(jnp.asarray(q), 8, 12, 12, OFFSETS,
                                      interpret=True))
    assert np.abs(ref - got).max() < 1e-4      # the Pallas test's bound


def test_batch_equals_each_band():
    q = np.random.default_rng(8).integers(0, 8, (3, 36, 50)).astype(
        np.int32)
    got = kernels.glcm_grid(torch.from_numpy(q), 8, 12, 12, OFFSETS)
    assert got.shape == (3, 3, 4, 5)
    for b in range(3):
        assert torch.equal(got[b], kernels.glcm_grid(
            torch.from_numpy(q[b]), 8, 12, 12, OFFSETS))


def test_wrapper_on_cpu_is_the_plain_version():
    q = torch.from_numpy(_flat_windows())
    assert torch.equal(kernels.glcm_grid(q, 8, 12, 12, OFFSETS),
                       kernels.glcm_grid_plain(q, 8, 12, 12, OFFSETS))


def test_feature_maps_kernel_backend_matches_xla():
    band = np.random.default_rng(3).random((96, 112)).astype(np.float32)
    ref = jtex.glcm_feature_maps(jnp.asarray(band))
    got = ttex.glcm_feature_maps(torch.from_numpy(band), backend="kernel")
    xla = ttex.glcm_feature_maps(torch.from_numpy(band))
    assert list(got) == list(ref) == list(xla)
    for name in ref:
        # contrast reaches ~10 (an f32 ulp ~1e-6); f32 vs exact sums
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=2e-6, atol=1e-6, err_msg=name)


def test_value_errors():
    q = torch.zeros((48, 60), dtype=torch.int32)
    with pytest.raises(ValueError, match="step == window"):
        kernels.glcm_grid(q, 8, 12, 6, OFFSETS)
    band = torch.zeros((48, 60))
    with pytest.raises(ValueError, match="distance 1"):
        ttex.glcm_feature_maps(band, 8, 12, 12, distances=(1, 2),
                               backend="kernel")
    with pytest.raises(ValueError, match="step == window"):
        ttex.glcm_feature_maps(band, 8, 12, 6, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        ttex.glcm_feature_maps(band, backend="pallas")
