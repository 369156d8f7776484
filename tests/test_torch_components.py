"""PyTorch port vs the JAX package: batched min-area removal with the
semantics of the JAX package's Pallas route (``impl="pallas"``, run in
interpret mode on the CPU), the ids cap and its overflow flags included.
Inputs come from numpy; results are compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.ops import components as jcomp
from rs_image_segmentation_tpu_torch.ops import components as tcomp


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax(masks, areas, **kw):
    out = jcomp.remove_small_components_batch(
        jnp.asarray(masks), jnp.asarray(areas, jnp.int32), **kw)
    if kw.get("return_overflow"):
        return np.asarray(out[0]), np.asarray(out[1])
    return np.asarray(out)


def _port(masks, areas, **kw):
    out = tcomp.remove_small_components_batch(
        torch.from_numpy(masks), torch.tensor(areas, dtype=torch.int32), **kw)
    if kw.get("return_overflow"):
        return out[0].numpy(), out[1].numpy()
    return out.numpy()


def _noise_and_blob():
    """Mask 0: 640 one-pixel runs ranked before a 300-pixel blob; mask 1:
    a blob of mask-relative rank 0."""
    m = np.zeros((2, 40, 64), np.uint8)
    m[0, 0:20, ::2] = 1
    m[0, 30:40, 10:40] = 1
    m[1, 5:15, 5:25] = 1
    return m


def test_exact_against_the_pallas_route():
    rng = np.random.default_rng(42)
    masks = (rng.random((4, 70, 90))
             < np.array([0.3, 0.5, 0.7, 0.9])[:, None, None]).astype(np.uint8)
    areas = [5, 17, 40, 3]
    got = _port(masks, areas)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _jax(masks, areas, impl="pallas"))
    assert 0 < got.sum() < masks.sum()


def test_ids_cap_drops_the_ranks_past_bins():
    # 3-pixel-spaced dots: 12 x 15 = 180 one-pixel components (= runs)
    m = np.zeros((1, 36, 45), np.uint8)
    m[0, ::3, ::3] = 1
    got = _port(m, [1], bins=128)
    np.testing.assert_array_equal(got, _jax(m, [1], bins=128, impl="pallas"))
    assert got.sum() == 128          # the first 128 run ranks survive
    assert _port(m, [1], bins=256).sum() == 180      # room for every id


def test_overflow_flags_mark_the_capped_masks():
    m = _noise_and_blob()
    kept, ov = _port(m, [50, 50], bins=128, return_overflow=True)
    ref_kept, ref_ov = _jax(m, [50, 50], bins=128, impl="pallas",
                            return_overflow=True)
    np.testing.assert_array_equal(kept, ref_kept)
    np.testing.assert_array_equal(ov, ref_ov)
    assert ov.tolist() == [True, False]
    assert not kept[0].any()         # the blob's rank 640 >= 128: dropped
    assert kept[1, 5:15, 5:25].all()

    kept, ov = _port(m, [50, 50], return_overflow=True)
    assert ov.tolist() == [False, False]
    want = m.copy()
    want[0, 0:20] = 0                # only the one-pixel noise is too small
    np.testing.assert_array_equal(kept, want)


def test_bins_must_be_a_multiple_of_128():
    m = _noise_and_blob()
    with pytest.raises(ValueError, match="multiple of 128"):
        _jax(m, [50, 50], bins=100, impl="pallas")
    with pytest.raises(ValueError, match="multiple of 128"):
        _port(m, [50, 50], bins=100)


@pytest.mark.parametrize("conn", [8, 4])
def test_component_ids_are_first_run_ranks(conn):
    """Each component's id is the mask-relative rank of its first row run,
    the same id for every pixel of a component and distinct across
    components (JAX ``connected_components`` gives the components)."""
    rng = np.random.default_rng(3)
    masks = rng.random((3, 50, 60)) < 0.45
    ids, overflow = tcomp.component_ids(torch.from_numpy(masks), conn)
    ids = ids.numpy()
    assert not overflow.any()
    for i in range(3):
        lab = np.asarray(jcomp.connected_components(jnp.asarray(masks[i]),
                                                    connectivity=conn))
        starts = masks[i] & ~np.pad(masks[i], ((0, 0), (1, 0)))[:, :-1]
        rank = np.cumsum(starts.ravel()).reshape(starts.shape) - 1
        roots = np.unique(lab[lab >= 0])
        np.testing.assert_array_equal(np.unique(ids[i][lab >= 0]),
                                      np.sort(rank.ravel()[roots]))
        for r in roots[:50]:
            assert (ids[i][lab == r] == rank.ravel()[r]).all()
        assert (ids[i][~masks[i]] == 32768).all()
