"""PyTorch port vs the JAX package, on the CPU: host-to-device tile
streaming (``io.stream``): the tile grid, halo reads, ``stream_tiles``
with ``assemble_tiles``, the device rule, and ``HostToDevice``'s one host
copy of a strided view (on the card too, with ``-m card``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.io import stream as jstream
from rs_image_segmentation_tpu.ops.stencil import box_filter as jbox_filter
from rs_image_segmentation_tpu_torch.io import stream as tstream
from rs_image_segmentation_tpu_torch.ops.stencil import box_filter


@pytest.mark.parametrize("h,w,tile,halo", [(50, 70, 32, 0), (48, 64, 16, 2),
                                           (7, 5, 8, 3), (33, 100, 10, 4)])
def test_tile_grid_and_read_tile_match_jax(h, w, tile, halo):
    specs = tstream.tile_grid(h, w, tile, halo)
    ref = jstream.tile_grid(h, w, tile, halo)
    assert [s.__dict__ for s in specs] == [s.__dict__ for s in ref]
    assert [s.read_window for s in specs] == [s.read_window for s in ref]
    arr = np.random.default_rng(h * w).random((3, h, w)).astype(np.float32)
    for mode in ("reflect", "edge"):
        for spec, jspec in zip(specs, ref):
            np.testing.assert_array_equal(
                tstream.read_tile(arr, spec, mode),
                jstream.read_tile(arr, jspec, mode))
    # a (H, W) raster reads as one band
    np.testing.assert_array_equal(tstream.read_tile(arr[0], specs[-1]),
                                  jstream.read_tile(arr[0], ref[-1]))


def test_stream_tiles_assembles_identity():
    arr = np.random.default_rng(1).random((3, 50, 70)).astype(np.float32)
    specs = tstream.tile_grid(50, 70, tile=32, halo=0)
    out = tstream.assemble_tiles(
        tstream.stream_tiles(arr, specs, lambda t: t * 2.0, device="cpu"),
        arr.shape)
    np.testing.assert_array_equal(out, arr * 2.0)   # exact: a doubling
    ident = tstream.assemble_tiles(
        tstream.stream_tiles(arr, specs, lambda t: t, device="cpu"),
        arr.shape)
    np.testing.assert_array_equal(ident, arr)


def test_stream_tiles_with_halo_stencil_matches_jax():
    arr = np.random.default_rng(2).random((1, 48, 64)).astype(np.float32)
    specs = tstream.tile_grid(48, 64, tile=16, halo=2)
    out = tstream.assemble_tiles(
        tstream.stream_tiles(arr, specs,
                             lambda t: box_filter(t, 5)[..., 2:-2, 2:-2],
                             device="cpu"), arr.shape)
    ref = jstream.assemble_tiles(
        jstream.stream_tiles(arr, jstream.tile_grid(48, 64, tile=16, halo=2),
                             lambda t: jbox_filter(t, 5)[..., 2:-2, 2:-2]),
        arr.shape)
    # the same five-tap sums, rounded per product as in the stencil tests
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    whole = jbox_filter(jnp.asarray(arr), 5)
    # interior tiles equal the whole-raster filter; borders read the
    # reflect-padded halo
    np.testing.assert_allclose(out[..., 4:-4, 4:-4],
                               np.asarray(whole)[..., 4:-4, 4:-4], atol=1e-6)


def test_stream_tiles_empty_and_single_tile():
    arr = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    assert list(tstream.stream_tiles(arr, [], lambda t: t,
                                     device="cpu")) == []
    (spec, res), = tstream.stream_tiles(arr, tstream.tile_grid(3, 4, 8),
                                        lambda t: t + 1, device="cpu")
    assert isinstance(res, torch.Tensor)
    np.testing.assert_array_equal(res.numpy(), arr + 1)


def test_host_to_device_on_the_cpu():
    up = tstream.HostToDevice(torch.device("cpu"))
    a = np.random.default_rng(3).integers(0, 256, (7, 9, 11), dtype=np.uint8)
    for view in (a, a[:, 2:5], a[::2]):
        t = up.put(view)
        assert t.device.type == "cpu" and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), view)


# the views callers hand ``HostToDevice.put``: a resident scene, a
# streamed row chunk, a band stride, a flipped scene (negative strides,
# which ``torch.from_numpy`` refuses) and a float32 scene
VIEWS = {
    "contiguous": lambda a: a,
    "row_chunk": lambda a: a[:, 2:5],
    "band_strided": lambda a: a[::2],
    "flipped": lambda a: a[:, ::-1],
    "float32": lambda a: a.astype(np.float32) / 7,
}


def _scene(h=9, w=11, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (7, h, w),
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", list(VIEWS))
def test_stage_copies_a_view_once(name):
    view = VIEWS[name](_scene())
    up = tstream.HostToDevice(torch.device("cpu"))
    staged = up._stage(view)
    assert up.host_copy_bytes == view.nbytes       # one host copy
    assert staged.is_contiguous() and tuple(staged.shape) == view.shape
    assert staged.dtype == torch.from_numpy(np.ascontiguousarray(view)).dtype
    assert staged.numpy().tobytes() == np.ascontiguousarray(view).tobytes()
    # a smaller array refills the same buffer
    again = up._stage(view[:, :1])
    assert again.data_ptr() == staged.data_ptr()
    assert up.host_copy_bytes == view.nbytes + view[:, :1].nbytes
    np.testing.assert_array_equal(again.numpy(), view[:, :1])
    # the CPU's put wraps a C-contiguous array and copies any other once
    before = up.host_copy_bytes
    t = up.put(view)
    np.testing.assert_array_equal(t.numpy(), view)
    assert up.host_copy_bytes - before == (
        0 if view.flags.c_contiguous else view.nbytes)


@pytest.mark.card
def test_put_lands_each_view_on_the_card():
    """``put`` of every view lands bit-equal on the card after one host
    copy into a pinned slot, and a slot refilled after its copy's event
    holds the new chunk while the earlier chunk's tensor keeps its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    up = tstream.HostToDevice(dev, depth=2)
    a = _scene(600, 600)
    for name, make in VIEWS.items():
        view = make(a)
        before = up.host_copy_bytes
        got = up.put(view)
        assert up.host_copy_bytes - before == view.nbytes, name
        assert got.device.type == "cuda" and got.is_contiguous()
        np.testing.assert_array_equal(got.cpu().numpy(), view, err_msg=name)
    # row chunks of a scene, as the streamed route takes them: chunk i
    # and chunk i + 2 share a slot
    big = _scene(2016, 6000, seed=4)
    rows = 504
    chunks = [big[:, y:y + rows] for y in range(0, big.shape[1], rows)]
    first = up._turn
    outs = [up.put(c) for c in chunks]
    torch.cuda.synchronize()
    for i, (c, o) in enumerate(zip(chunks, outs)):
        np.testing.assert_array_equal(o.cpu().numpy(), c, err_msg=str(i))
    for i in (len(chunks) - 2, len(chunks) - 1):
        slot, c = up._bufs[(first + i) % 2], chunks[i]
        assert slot.is_pinned()
        assert slot[:c.nbytes].numpy().tobytes() == \
            np.ascontiguousarray(c).tobytes()


def test_stream_tiles_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    arr = np.zeros((1, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(tstream.stream_tiles(arr, tstream.tile_grid(8, 8, 4),
                                  lambda t: t))
