"""The port's kernel wrappers keep their contract on a host without CUDA:
the plain version runs only for CPU tensors, any other device launches
the kernel or raises, and a missing compiler is an error, not a fallback."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import _build, kernels
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    serpentine_mask, spiral_mask)
from rs_image_segmentation_tpu_torch.utils.timing import cuda_time_ms


def _forest():
    rng = np.random.default_rng(0)
    flat, _ = tforest.fit_random_forest(rng.random((30, 19)),
                                        rng.integers(1, 4, 30),
                                        n_estimators=3)
    return tforest._gemm_for(flat, 19)


def test_wrappers_raise_for_a_device_without_a_kernel():
    scene = torch.zeros((7, 8, 8), dtype=torch.uint8, device="meta")
    lut = torch.zeros((7, 256), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kernels.lut_hist(scene, lut)
    x = torch.zeros((19, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kernels.forest_labels(_forest(), x)


def test_wrappers_check_dtype_and_shape():
    with pytest.raises(ValueError, match="uint8"):
        kernels.lut_hist(torch.zeros((7, 8, 8)),
                         torch.zeros((7, 256), dtype=torch.uint8))
    with pytest.raises(ValueError, match="sp must be"):
        kernels.lut_hist(torch.zeros((7, 8, 8), dtype=torch.uint8),
                         torch.zeros((7, 256), dtype=torch.uint8),
                         sp=torch.zeros((7, 4), dtype=torch.int32))
    gf = _forest()
    with pytest.raises(ValueError, match="f32"):
        kernels.forest_labels(gf, torch.zeros((19, 16), dtype=torch.float64))
    with pytest.raises(ValueError, match="features"):
        kernels.forest_labels(gf, torch.zeros((18, 16)))


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = (kernels.lut_hist.launches, kernels.forest_labels.launches)
    scene = torch.randint(0, 256, (2, 7, 9, 11), dtype=torch.uint8)
    lut = torch.randint(0, 256, (2, 7, 256), dtype=torch.uint8)
    st, hist = kernels.lut_hist(scene, lut)
    assert hist.shape == (2, 7, 256) and int(hist.sum()) == 2 * 7 * 99
    kernels.forest_labels(_forest(), torch.rand((2, 19, 99)))
    assert (kernels.lut_hist.launches,
            kernels.forest_labels.launches) == before


def test_kernel_build_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc") or _build.os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(_build, "BUILD_DIR",
                        _build.BUILD_DIR.parent / "_no_such_build_dir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("lut_hist")
    assert not _build.BUILD_DIR.exists()


def test_library_names_follow_the_source():
    paths = {name: _build.library_path(name) for name in _build.KERNELS}
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert len(set(paths.values())) == len(paths)


def test_cuda_timing_refuses_to_time_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cuda_time_ms(lambda: None, 1)


# ------------------------------------------ the rule path's three kernels

I32_MAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ccmin_oracle(mask, values, conn):
    """Per-component min of ``values`` over the JAX package's
    ``connected_components`` labels, mask by mask (numpy)."""
    from rs_image_segmentation_tpu.ops.components import connected_components
    out = np.empty(mask.shape, np.int32)
    for i in range(mask.shape[0]):
        lab = np.asarray(connected_components(jnp.asarray(mask[i]),
                                              connectivity=conn)).ravel()
        fg = lab >= 0
        vmin = np.full(lab.size, I32_MAX, np.int64)
        np.minimum.at(vmin, lab[fg], values[i].ravel()[fg])
        out[i] = np.where(fg, vmin[np.maximum(lab, 0)], -1).reshape(
            mask.shape[1:])
    return out


def _ccmin_masks(name):
    """One 150 x 150 shape for every case: the JAX oracle compiles once."""
    rng = np.random.default_rng(5)
    if name == "speckle":
        return rng.random((3, 150, 150)) < np.array([0.4, 0.5, 0.6])[
            :, None, None]
    if name == "spiral":
        return spiral_mask(150, 150)[None]
    if name == "serpentine":
        return serpentine_mask(150, 150)[None]
    return np.stack([np.zeros((150, 150), bool), np.ones((150, 150), bool)])


@pytest.mark.parametrize("conn", [8, 4])
def test_ccmin_prop_plain_matches_pallas_interpret(conn):
    from rs_image_segmentation_tpu.ops.pallas_kernels import ccmin_prop_pallas
    rng = np.random.default_rng(7)
    mask = (rng.random((64, 96)) < 0.55).astype(np.uint8)
    values = rng.integers(-1000, 1000, (64, 96)).astype(np.int32)
    ref = np.asarray(ccmin_prop_pallas(jnp.asarray(mask), jnp.asarray(values),
                                       connectivity=conn, interpret=True))
    got = kernels.ccmin_prop(torch.from_numpy(mask), torch.from_numpy(values),
                             conn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("name", ["speckle", "spiral", "serpentine",
                                  "empty_and_full"])
def test_ccmin_prop_plain_matches_labels_oracle(name, conn):
    mask = _ccmin_masks(name)
    values = np.random.default_rng(6).integers(
        np.iinfo(np.int32).min, I32_MAX, mask.shape, dtype=np.int32)
    got = kernels.ccmin_prop(torch.from_numpy(mask), torch.from_numpy(values),
                             conn)
    np.testing.assert_array_equal(got.numpy(), _ccmin_oracle(mask, values,
                                                              conn))


def _rendered_roots(mask, conn, tile):
    """numpy rendering of the union-find passes of ``csrc/ccmin_prop.cu``,
    run one pixel at a time: the per-tile union-find with the kernel's
    reduced neighbour rule, then the unions across tile borders. Returns
    every pixel's stack-global root. Which pairs get united is what the
    kernel's result depends on; the order of the unions changes only the
    shape of the trees."""
    m, h, w = mask.shape
    fg = mask.reshape(-1) != 0
    parent = np.arange(m * h * w)

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    def unite(a, b):
        a, b = find(a), find(b)
        parent[max(a, b)] = min(a, b)

    def at(z, y, x):
        return z * h * w + y * w + x

    def tile_fg(z, by, bx, ty, tx):
        y, x = by + ty, bx + tx
        return (0 <= ty < tile and 0 <= tx < tile and y < h and x < w
                and fg[at(z, y, x)])

    for z in range(m):
        for by in range(0, h, tile):
            for bx in range(0, w, tile):
                for ty in range(min(tile, h - by)):
                    for tx in range(min(tile, w - bx)):
                        if not tile_fg(z, by, bx, ty, tx):
                            continue
                        g = at(z, by + ty, bx + tx)
                        up, left = g - w, g - 1
                        l = tile_fg(z, by, bx, ty, tx - 1)
                        u = tile_fg(z, by, bx, ty - 1, tx)
                        ul = tile_fg(z, by, bx, ty - 1, tx - 1)
                        ur = tile_fg(z, by, bx, ty - 1, tx + 1)
                        if l:
                            unite(g, left)
                        if conn == 8:
                            if not l:
                                if u:
                                    unite(g, up)
                                else:
                                    if ul:
                                        unite(g, up - 1)
                                    if ur:
                                        unite(g, up + 1)
                            elif not u and ur:
                                unite(g, up + 1)
                        elif u and not (l and ul):
                            unite(g, up)
    for z in range(m):
        for y in range(h):
            for x in range(w):
                g = at(z, y, x)
                tx, ty = x % tile, y % tile
                if not fg[g]:
                    continue
                if tx == 0 and x > 0 and fg[g - 1]:
                    unite(g, g - 1)
                if ty == 0 and y > 0 and fg[g - w]:
                    unite(g, g - w)
                if conn == 8 and y > 0:
                    if (tx == 0 or ty == 0) and x > 0 and fg[g - w - 1]:
                        unite(g, g - w - 1)
                    if ((tx == tile - 1 or ty == 0) and x + 1 < w
                            and fg[g - w + 1]):
                        unite(g, g - w + 1)
    return np.array([find(g) for g in range(m * h * w)])


def _kernel_rendering(mask, values, conn, tile):
    """The rendered roots, then ccmin_prop's root minima."""
    fg = mask.reshape(-1) != 0
    roots = _rendered_roots(mask, conn, tile)
    vmin = np.full(fg.size, I32_MAX, np.int64)
    np.minimum.at(vmin, roots[fg], values.reshape(-1)[fg])
    return np.where(fg, vmin[roots], -1).reshape(mask.shape)


def _label_rendering(mask, conn, tile):
    """The rendered roots, then cc_labels' labelling pass: root minus the
    mask's base at foreground, -1 at background."""
    m, h, w = mask.shape
    roots = _rendered_roots(mask, conn, tile).reshape(mask.shape)
    base = np.arange(m)[:, None, None] * (h * w)
    return np.where(mask != 0, roots - base, -1)


@pytest.mark.parametrize("tile", [32, 5])
@pytest.mark.parametrize("conn", [8, 4])
def test_ccmin_kernel_rendering_matches_plain(conn, tile):
    rng = np.random.default_rng(8)
    mask = rng.random((2, 45, 70)) < np.array([0.5, 0.65])[:, None, None]
    mask[0, 20:40, 3:60] = True            # a blob across tile borders
    values = rng.integers(0, 10 ** 6, mask.shape).astype(np.int32)
    ref = kernels.ccmin_prop(torch.from_numpy(mask),
                             torch.from_numpy(values), conn).numpy()
    np.testing.assert_array_equal(
        _kernel_rendering(mask, values, conn, tile), ref)


@pytest.mark.parametrize("tile", [32, 5])
@pytest.mark.parametrize("conn", [8, 4])
def test_cc_label_rendering_matches_plain(conn, tile):
    """The labels of a stack of three masks: roots are stack-global, so a
    label must subtract its mask's base, or masks after the first come
    out wrong."""
    rng = np.random.default_rng(13)
    mask = rng.random((3, 37, 45)) < np.array([0.5, 0.6, 0.7])[:, None, None]
    mask[1, 10:30, 2:40] = True            # a blob across tile borders
    ref = kernels.cc_labels_plain(torch.from_numpy(mask), conn).numpy()
    np.testing.assert_array_equal(_label_rendering(mask, conn, tile), ref)
    assert (ref[1:][mask[1:]] < 37 * 45).all()


def test_hist_dense_and_keep_lut_plain_match_pallas_interpret():
    from rs_image_segmentation_tpu.ops.pallas_kernels import (
        hist_dense_pallas, keep_lut_pallas)
    rng = np.random.default_rng(9)
    bins_hi = 2
    # ids below 0 and at or above bins_hi * 128 = 256 count and read nothing
    ids = rng.integers(-40, 300, (3, 4, 128)).astype(np.int32)
    ids[1, 0, :64] = 17                   # a large component
    ref_counts = np.asarray(hist_dense_pallas(jnp.asarray(ids), bins_hi,
                                              interpret=True))
    counts = kernels.hist_dense(torch.from_numpy(ids), bins_hi)
    assert counts.dtype == torch.int32 and counts.shape == (3, bins_hi, 128)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)

    min_areas = np.array([1, 2, 3], np.int32)
    table = ref_counts >= min_areas[:, None, None]
    ref_keep = np.asarray(keep_lut_pallas(
        jnp.asarray(ids), jnp.asarray(np.swapaxes(table, 1, 2), jnp.float32),
        interpret=True))
    keep = kernels.keep_lut(torch.from_numpy(ids), torch.from_numpy(table))
    assert keep.dtype == torch.int32 and keep.shape == ids.shape
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert 0 < ref_keep.sum() < ids.size


def _rule_kernel_calls(device, dtype=torch.int32, mask_dtype=torch.uint8):
    mask = torch.zeros((2, 8, 8), dtype=mask_dtype, device=device)
    ids = torch.zeros((2, 64), dtype=dtype, device=device)
    table = torch.zeros((2, 1, 128), dtype=torch.bool, device=device)
    return [lambda: kernels.ccmin_prop(mask, ids.reshape(2, 8, 8)),
            lambda: kernels.hist_dense(ids, 1),
            lambda: kernels.keep_lut(ids, table)]


def test_rule_kernel_wrappers_raise_for_a_device_without_a_kernel():
    for call in _rule_kernel_calls("meta"):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


def test_rule_kernel_wrappers_check_dtype_and_shape():
    for call in _rule_kernel_calls("cpu", dtype=torch.int64):
        with pytest.raises(ValueError, match="int32"):
            call()
    with pytest.raises(ValueError, match="uint8 or bool"):
        _rule_kernel_calls("cpu", mask_dtype=torch.float32)[0]()
    ids = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="bool"):
        kernels.keep_lut(ids, torch.zeros((2, 1, 128), dtype=torch.uint8))
    with pytest.raises(ValueError, match="connectivity"):
        kernels.ccmin_prop(torch.zeros((4, 4), dtype=torch.uint8),
                           torch.zeros((4, 4), dtype=torch.int32), 6)


def test_rule_kernel_wrappers_on_cpu_tensors_do_not_launch():
    before = (kernels.ccmin_prop.launches, kernels.hist_dense.launches,
              kernels.keep_lut.launches)
    outs = [call() for call in _rule_kernel_calls("cpu")]
    assert outs[0].shape == (2, 8, 8) and int(outs[0].max()) == -1
    assert int(outs[1][:, 0, 0].sum()) == 2 * 64
    assert int(outs[2].sum()) == 0
    assert (kernels.ccmin_prop.launches, kernels.hist_dense.launches,
            kernels.keep_lut.launches) == before
