"""PyTorch port vs the JAX package, on the CPU: connected-component labels
(``ops.kernels.cc_labels`` and its plain version,
``ops.components.connected_components``) and the single-mask
post-processing graph (``component_areas``, ``remove_small_components``,
``fill_holes``, ``post_process_mask``). Inputs come from numpy with a
seed; results are compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.ops import components as jcomp
from rs_image_segmentation_tpu_torch.ops import components as tcomp
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    serpentine_mask, spiral_mask)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_labels(mask, conn=8):
    return np.asarray(jcomp.connected_components(jnp.asarray(mask),
                                                 connectivity=conn))


def _smoothed_mask(shape, seed, frac=0.5):
    """A random field box-smoothed twice and thresholded at ``frac`` of its
    pixels, with 3 % of the pixels flipped: blobs with holes, ragged edges
    and single-pixel specks."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape)
    for axis in (0, 1, 0, 1):
        c = np.cumsum(np.pad(f, [(2, 2) if a == axis else (0, 0)
                                 for a in (0, 1)], mode="reflect"), axis=axis)
        f = (np.take(c, np.arange(4, shape[axis] + 4), axis=axis)
             - np.take(c, np.arange(shape[axis]), axis=axis)) / 5
    mask = f > np.quantile(f, 1 - frac)
    return (mask ^ (rng.random(shape) < 0.03)).astype(np.uint8)


@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("shape,p", [((64, 64), 0.5), ((200, 300), 0.6),
                                     ((130, 257), 0.4)])
def test_labels_match_jax_on_random_masks(shape, p, conn):
    mask = np.random.default_rng(shape[1]).random(shape) < p
    ref = _jax_labels(mask, conn)
    for got in (kernels.cc_labels(torch.from_numpy(mask), conn),
                kernels.cc_labels_plain(torch.from_numpy(mask), conn),
                tcomp.connected_components(torch.from_numpy(mask), conn)):
        assert got.dtype == torch.int32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("name", ["spiral", "serpentine", "empty", "full"])
def test_labels_match_jax_on_structured_masks(name, conn):
    """The JAX package's structured masks; empty and full share the
    spiral's shape, so the JAX reference compiles once for the three."""
    mask = {"spiral": lambda: spiral_mask(300, 300),
            "serpentine": lambda: serpentine_mask(300, 140),
            "empty": lambda: np.zeros((300, 300), bool),
            "full": lambda: np.ones((300, 300), bool)}[name]()
    got = kernels.cc_labels(torch.from_numpy(mask.astype(np.uint8)), conn)
    np.testing.assert_array_equal(got.numpy(), _jax_labels(mask, conn))


@pytest.mark.parametrize("conn", [8, 4])
def test_labels_match_cc_pallas_interpret(conn):
    from rs_image_segmentation_tpu.ops.pallas_kernels import cc_pallas
    mask = np.random.default_rng(10 + conn).random((64, 96)) < 0.55
    ref = np.asarray(cc_pallas(jnp.asarray(mask), connectivity=conn,
                               interpret=True))
    got = kernels.cc_labels(torch.from_numpy(mask), conn)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("conn", [8, 4])
def test_a_stack_labels_each_mask_on_its_own(conn):
    """Labels are mask-relative: a stack of three masks gives each mask's
    own labels, and no component crosses from one mask to the next (the
    last row of one and the first row of the next are both full)."""
    rng = np.random.default_rng(12)
    stack = rng.random((3, 64, 64)) < np.array([0.45, 0.55, 0.65])[
        :, None, None]
    stack[:, 0], stack[:, -1] = True, True
    got = kernels.cc_labels(torch.from_numpy(stack), conn).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], _jax_labels(stack[i], conn))
        single = kernels.cc_labels(torch.from_numpy(stack[i]), conn)
        np.testing.assert_array_equal(got[i], single.numpy())


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_connected_components_best_routes_agree(impl):
    mask = _smoothed_mask((60, 80), 1)
    got = tcomp.connected_components_best(torch.from_numpy(mask), 8, impl)
    np.testing.assert_array_equal(got.numpy(), _jax_labels(mask))


def test_component_areas_match_jax():
    mask = _smoothed_mask((60, 80), 2)
    labels = _jax_labels(mask)
    got = tcomp.component_areas(torch.from_numpy(labels.copy()))
    ref = np.asarray(jcomp.component_areas(jnp.asarray(labels)))
    assert got.dtype == torch.int32 and got.shape == (60 * 80,)
    np.testing.assert_array_equal(got.numpy(), ref)
    per_pixel = tcomp.component_areas_per_pixel(torch.from_numpy(mask))
    np.testing.assert_array_equal(per_pixel.numpy(), np.asarray(
        jcomp.component_areas_per_pixel(jnp.asarray(mask))))


@pytest.mark.parametrize("cc_impl", ["auto", "xla"])
@pytest.mark.parametrize("min_area", [0, 1, 12, 40])
def test_remove_small_components_matches_jax(min_area, cc_impl):
    mask = _smoothed_mask((60, 80), 3, frac=0.4)
    got = tcomp.remove_small_components(torch.from_numpy(mask), min_area,
                                        cc_impl=cc_impl)
    ref = np.asarray(jcomp.remove_small_components(jnp.asarray(mask),
                                                   min_area, cc_impl="xla"))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    if min_area == 12:
        assert 0 < got.sum() < mask.sum()


def test_fill_holes_matches_jax():
    mask = _smoothed_mask((60, 80), 4, frac=0.6)
    mask[20:40, 20:50] = 1
    mask[25:30, 25:30] = 0                 # a hole
    mask[0, :] = 0                         # a border corridor stays open
    got = tcomp.fill_holes(torch.from_numpy(mask))
    ref = np.asarray(jcomp.fill_holes(jnp.asarray(mask)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.sum() > mask.sum()


@pytest.mark.parametrize("ksize,min_area", [(3, 15), (5, 15), (3, 0),
                                            (4, 15), (0, 15), (4, 0)])
def test_post_process_mask_matches_jax(ksize, min_area):
    """Odd kernels close; an even kernel or 0 fills holes; min_area 0
    skips the removal."""
    mask = _smoothed_mask((60, 80), 5)
    got = tcomp.post_process_mask(torch.from_numpy(mask), min_area, ksize)
    ref = np.asarray(jcomp.post_process_mask(jnp.asarray(mask), min_area,
                                             ksize, cc_impl="xla"))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------ the wrapper contract

def test_cc_labels_raises_for_a_device_without_a_kernel():
    mask = torch.zeros((8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kernels.cc_labels(mask)


def test_cc_labels_checks_dtype_shape_and_connectivity():
    with pytest.raises(ValueError, match="uint8 or bool"):
        kernels.cc_labels(torch.zeros((8, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8 or bool"):
        kernels.cc_labels(torch.zeros((8,), dtype=torch.uint8))
    with pytest.raises(ValueError, match="connectivity"):
        kernels.cc_labels(torch.zeros((8, 8), dtype=torch.uint8), 6)


def test_cc_labels_on_a_cpu_tensor_does_not_launch():
    before = kernels.cc_labels.launches
    mask = torch.zeros((2, 8, 8), dtype=torch.uint8)
    mask[1, 2:4, 3:6] = 1
    got = kernels.cc_labels(mask)
    assert int(got[0].max()) == -1 and int(got[1, 2, 3]) == 2 * 8 + 3
    assert kernels.cc_labels.launches == before


def test_an_unknown_cc_impl_raises():
    mask = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="impl"):
        tcomp.connected_components_best(mask, 8, "bogus")
    with pytest.raises(ValueError, match="impl"):
        tcomp.remove_small_components(mask, 4, cc_impl="bogus")
