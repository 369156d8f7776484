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
    # one table serves every band: the JAX fixed-point params are no
    # argument
    with pytest.raises(TypeError, match="sp"):
        kernels.lut_hist(torch.zeros((7, 8, 8), dtype=torch.uint8),
                         torch.zeros((7, 256), dtype=torch.uint8),
                         sp=torch.zeros((7, 15), dtype=torch.int32))
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


def _node_bits(mask, conn):
    """(M, NH, NW) bits of the union-find's nodes: for 8-connectivity a
    2 x 2 pixel block (bit 0 its top-left pixel, 1 top-right, 2
    bottom-left, 3 bottom-right; pixels past the edge 0), for 4 a pixel."""
    b = 2 if conn == 8 else 1
    m, h, w = mask.shape
    nh, nw = -(-h // b), -(-w // b)
    pad = np.zeros((m, nh * b, nw * b), bool)
    pad[:, :h, :w] = mask != 0
    bits = np.zeros((m, nh, nw), np.int64)
    for i in range(b):
        for j in range(b):
            bits |= pad[:, i::b, j::b].astype(np.int64) << (2 * i + j)
    return bits


def _joins(bits, nb, dy, dx, conn):
    """Whether a node joins its neighbour at (dy, dx), one of left (0, -1),
    up (-1, 0), up-left (-1, -1) and up-right (-1, 1)."""
    if not (bits and nb):
        return False
    if conn == 4:
        return True
    need = {(0, -1): (5, 10), (-1, 0): (3, 12), (-1, -1): (1, 8),
            (-1, 1): (2, 4)}[(dy, dx)]
    return bool(bits & need[0]) and bool(nb & need[1])


def _up_links(b, left, lb, ul, u, ur, conn):
    """The links to the row above that a node makes itself (the kernel's
    ``up_links``): a set of (dy, dx); a link is left out when its nodes
    are joined anyway through the left neighbour of the node's run or a
    run of the row above."""
    if conn == 4:
        return {(-1, 0)} if b and u and not (left and ul) else set()
    j_ul = _joins(b, ul, -1, -1, 8)
    j_u = _joins(b, u, -1, 0, 8)
    via_ul = left and _joins(lb, ul, -1, 0, 8)
    via_u = left and _joins(lb, u, -1, 1, 8)
    to_ul = j_ul or via_ul
    ul_run = _joins(u, ul, 0, -1, 8)
    to_u = j_u or via_u or (to_ul and ul_run)
    links = set()
    if j_ul and not via_ul:
        links.add((-1, -1))
    if j_u and not via_u and not (to_ul and ul_run):
        links.add((-1, 0))
    if _joins(b, ur, -1, 1, 8) and not (to_u and _joins(ur, u, 0, -1, 8)):
        links.add((-1, 1))
    return links


def _node_min(mask, values, conn, z, ny, nx):
    """Minimum over the node's foreground pixels of ``values``, or of their
    mask-relative indices when ``values`` is None."""
    b = 2 if conn == 8 else 1
    h, w = mask.shape[1:]
    ys, xs = np.nonzero(mask[z, ny * b:ny * b + b, nx * b:nx * b + b])
    ys, xs = ys + ny * b, xs + nx * b
    return int((ys * w + xs).min() if values is None
               else values[z, ys, xs].min())


def _rendered_union_find(mask, values, conn, tile):
    """numpy rendering of the four passes of ``csrc/ccmin_prop.cu``, one
    thread after another (one order the card may take): the tile pass's
    shared-memory union-find over ``tile`` x ``tile`` nodes (each node
    linked to the start of its row run, then united with the row above,
    halving finds), the border pass's slots with halving finds, the root
    pass (halving, stored roots, local minima folded into the roots) and
    the gather. ``values`` None
    renders cc_labels (minimum mask-relative index). Which pairs get united
    is what the result depends on; the order changes only the trees."""
    m, h, w = mask.shape
    bits = _node_bits(mask, conn)
    _, nh, nw = bits.shape
    per = nh * nw
    parent = np.full(m * per, -1)
    minv = np.full(m * per, I32_MAX, np.int64)
    dirs = ([(0, -1), (-1, 0), (-1, -1), (-1, 1)] if conn == 8
            else [(0, -1), (-1, 0)])

    def at(z, ny, nx):
        return z * per + ny * nw + nx

    def find(par, x, halve):
        while par[x] != x:
            if halve and par[par[x]] != par[x]:
                par[x] = par[par[x]]
            x = par[x]
        return x

    def unite(par, a, c, halve):
        a, c = find(par, a, halve), find(par, c, halve)
        par[max(a, c)] = min(a, c)

    # pass 1: each tile on its own
    for z in range(m):
        for by in range(0, nh, tile):
            for bx in range(0, nw, tile):
                local = {}
                for ny in range(by, min(by + tile, nh)):
                    for nx in range(bx, min(bx + tile, nw)):
                        if bits[z, ny, nx]:
                            local[at(z, ny, nx)] = at(z, ny, nx)
                left = {}
                for g in list(local):       # runs: straight to their start
                    ny, nx = divmod(g - z * per, nw)
                    left[g] = nx > bx and _joins(bits[z, ny, nx],
                                                 bits[z, ny, nx - 1], 0, -1,
                                                 conn)
                    if left[g]:
                        local[g] = local[g - 1]
                for g in list(local):       # then the row above
                    ny, nx = divmod(g - z * per, nw)
                    if ny == by:
                        continue

                    def tb(x, y):           # in the tile, else 0
                        return (bits[z, y, x] if bx <= x < min(bx + tile, nw)
                                else 0)
                    for dy, dx in _up_links(
                            bits[z, ny, nx], left[g], tb(nx - 1, ny),
                            tb(nx - 1, ny - 1), tb(nx, ny - 1),
                            tb(nx + 1, ny - 1), conn):
                        unite(local, g, at(z, ny + dy, nx + dx), True)
                for g in local:
                    r = find(local, g, True)
                    parent[g] = r
                    ny, nx = divmod(g - z * per, nw)
                    minv[r] = min(minv[r], _node_min(mask, values, conn, z,
                                                     ny, nx))
    # pass 2: the border slots of each tile, as the kernel numbers them
    def nb(z, x, y):                        # 0 past the node grid
        return bits[z, y, x] if 0 <= x < nw and y >= 0 else 0

    for z in range(m):
        for by in range(0, nh, tile):
            for bx in range(0, nw, tile):
                slots = ([(0, tx) for tx in range(tile)]
                         + [(ty, 0) for ty in range(tile)]
                         + ([(ty, tile - 1) for ty in range(1, tile)]
                            if conn == 8 else []))
                for k, (ty, tx) in enumerate(slots):
                    ny, nx = by + ty, bx + tx
                    if ny >= nh or nx >= nw or not bits[z, ny, nx]:
                        continue
                    b, g = bits[z, ny, nx], at(z, ny, nx)
                    if k < tile:            # top row
                        if ny == 0:
                            continue
                        lb = nb(z, nx - 1, ny) if tx > 0 else 0
                        for dy, dx in _up_links(
                                b, tx > 0 and _joins(b, lb, 0, -1, conn), lb,
                                nb(z, nx - 1, ny - 1) if conn == 8 else 0,
                                nb(z, nx, ny - 1),
                                nb(z, nx + 1, ny - 1) if conn == 8 else 0,
                                conn):
                            unite(parent, g, at(z, ny + dy, nx + dx), True)
                        continue
                    up_joined = ty > 0 and _joins(b, nb(z, nx, ny - 1), -1, 0,
                                                  conn)
                    if k < 2 * tile:        # left column
                        if nx == 0:
                            continue
                        lb, la = nb(z, nx - 1, ny), nb(z, nx - 1, ny - 1)
                        row_above = up_joined and _joins(
                            nb(z, nx, ny - 1), la, 0, -1, conn)
                        if _joins(b, lb, 0, -1, conn) and not (
                                row_above and _joins(lb, la, -1, 0, conn)):
                            unite(parent, g, g - 1, True)
                        if (conn == 8 and ty > 0 and not row_above
                                and _joins(b, la, -1, -1, 8)):
                            unite(parent, g, at(z, ny - 1, nx - 1), True)
                    elif (_joins(b, nb(z, nx + 1, ny - 1), -1, 1, 8)
                          and not (up_joined and _joins(
                              nb(z, nx + 1, ny - 1), nb(z, nx, ny - 1), 0,
                              -1, 8))):
                        unite(parent, g, at(z, ny - 1, nx + 1), True)
    # pass 3: the local roots find their roots and fold their minima
    for g in range(m * per):
        if minv[g] != I32_MAX:
            r = find(parent, g, True)
            parent[g] = r
            if r != g:
                minv[r] = min(minv[r], minv[g])
    # pass 4: the root's minimum at each foreground pixel
    b = 2 if conn == 8 else 1
    zz, yy, xx = np.indices(mask.shape)
    node = zz * per + (yy // b) * nw + xx // b
    roots = np.array([find(parent, g, False) if parent[g] >= 0 else -1
                      for g in range(m * per)])
    return np.where(mask != 0, minv[roots[node]], -1)


@pytest.mark.parametrize("tile", [32, 3])
@pytest.mark.parametrize("conn", [8, 4])
def test_ccmin_kernel_rendering_matches_plain(conn, tile):
    rng = np.random.default_rng(8)
    mask = rng.random((2, 45, 70)) < np.array([0.5, 0.65])[:, None, None]
    mask[0, 20:40, 3:60] = True            # a blob across tile borders
    values = rng.integers(0, 10 ** 6, mask.shape).astype(np.int32)
    ref = kernels.ccmin_prop(torch.from_numpy(mask),
                             torch.from_numpy(values), conn).numpy()
    np.testing.assert_array_equal(
        _rendered_union_find(mask, values, conn, tile), ref)


@pytest.mark.parametrize("tile", [32, 3])
@pytest.mark.parametrize("conn", [8, 4])
def test_cc_label_rendering_matches_plain(conn, tile):
    """The labels of a stack of three masks: labels are mask-relative, so
    masks after the first must not carry their stack offset."""
    rng = np.random.default_rng(13)
    mask = rng.random((3, 37, 45)) < np.array([0.5, 0.6, 0.7])[:, None, None]
    mask[1, 10:30, 2:40] = True            # a blob across tile borders
    ref = kernels.cc_labels_plain(torch.from_numpy(mask), conn).numpy()
    np.testing.assert_array_equal(
        _rendered_union_find(mask, None, conn, tile), ref)
    assert (ref[1:][mask[1:]] < 37 * 45).all()


def _edge_mask(name):
    rng = np.random.default_rng(17)
    if name == "odd 37 x 41":
        return rng.random((2, 37, 41)) < 0.55
    if name == "one row 1 x 97":
        return rng.random((1, 1, 97)) < 0.6
    if name == "one column 97 x 1":
        return rng.random((1, 97, 1)) < 0.6
    return serpentine_mask(61, 29)[None]     # turns 30 times, many tiles


@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("name", ["odd 37 x 41", "one row 1 x 97",
                                  "one column 97 x 1", "serpentine 61 x 29"])
def test_union_find_rendering_on_edge_shapes(name, conn):
    """Odd sizes (2 x 2 blocks cut at the right and bottom edges), one
    row, one column, and a serpentine over many 3 x 3-node tiles."""
    mask = _edge_mask(name)
    values = np.random.default_rng(18).integers(
        -10 ** 6, 10 ** 6, mask.shape).astype(np.int32)
    ref = kernels.ccmin_prop(torch.from_numpy(mask),
                             torch.from_numpy(values), conn).numpy()
    np.testing.assert_array_equal(_rendered_union_find(mask, values, conn, 3),
                                  ref)
    labels = kernels.cc_labels_plain(torch.from_numpy(mask), conn).numpy()
    np.testing.assert_array_equal(_rendered_union_find(mask, None, conn, 3),
                                  labels)


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


def _hist_case(name):
    """(ids, bins_hi) of a hist_dense edge case the card checks too."""
    rng = np.random.default_rng(12)
    if name == "single id":
        return np.full((3, 512), 5, np.int32), 2
    if name == "all background":
        return np.full((3, 512), 256, np.int32), 2
    if name == "uniform random":
        return rng.integers(0, 256, (3, 512)).astype(np.int32), 2
    if name == "bins 128":
        return rng.integers(-5, 140, (4, 384)).astype(np.int32), 1
    if name == "M = 1":
        return rng.integers(-3, 260, (1, 640)).astype(np.int32), 2
    if name == "n % 4 != 0":
        return rng.integers(-3, 260, (3, 301)).astype(np.int32), 2
    raise KeyError(name)


@pytest.mark.parametrize("name", ["single id", "all background",
                                  "uniform random", "bins 128", "M = 1",
                                  "n % 4 != 0"])
def test_hist_dense_plain_matches_pallas_on_edge_cases(name):
    from rs_image_segmentation_tpu.ops.pallas_kernels import (
        hist_dense_pallas)
    ids, bins_hi = _hist_case(name)
    m, n = ids.shape
    # the Pallas kernel takes rows of 128 ids; -1 pads them and counts
    # nothing
    padded = np.full((m, -(-n // 128) * 128), -1, np.int32)
    padded[:, :n] = ids
    ref = np.asarray(hist_dense_pallas(jnp.asarray(padded.reshape(m, -1,
                                                                  128)),
                                       bins_hi, interpret=True))
    got = kernels.hist_dense_plain(torch.from_numpy(ids), bins_hi).numpy()
    np.testing.assert_array_equal(got, ref)


def _rendered_hist_cluster(ids, bins, threads=kernels.HIST_THREADS,
                           unroll=kernels.HIST_UNROLL):
    """numpy rendering of the cluster instance of ``csrc/hist_keep.cu``
    on (M, N) ids: per mask, HIST_CLUSTER blocks each read their slice of
    16-byte words (``hist_cluster_plan``) in steps of ``threads * unroll``
    words, each thread ``unroll`` consecutive words a step, merging runs of
    equal in-range ids over its steps and adding each run once into the
    shared bins of the block that owns its granule of 128 bins (granule g:
    block ``g % HIST_CLUSTER``, local granule ``g // HIST_CLUSTER``); each
    block then writes the granules it owns. Returns the counts and the
    number of atomics."""
    m, n = ids.shape
    assert n % 4 == 0
    span4, bpb = kernels.hist_cluster_plan(n, bins)
    n4 = n // 4
    out = np.full((m, bins), -7, np.int64)      # uninitialised output
    atomics = 0
    for mask in range(m):
        words = ids[mask].reshape(n4, 4)
        shared = np.zeros((kernels.HIST_CLUSTER, bpb), np.int64)

        def add(bin_id, count):
            g = bin_id // 128
            shared[g % kernels.HIST_CLUSTER,
                   g // kernels.HIST_CLUSTER * 128 + bin_id % 128] += count
        for rank in range(kernels.HIST_CLUSTER):
            lo = rank * span4
            hi = min(lo + span4, n4)
            for t in range(threads):
                run_id, run_count = -1, 0
                for base in range(lo + t * unroll, hi, threads * unroll):
                    for u in range(unroll):
                        i = base + u
                        vals = words[i] if i < hi else (-1,) * 4
                        for v in vals:
                            if not 0 <= v < bins:
                                continue
                            if v == run_id:
                                run_count += 1
                                continue
                            if run_count:
                                add(run_id, run_count)
                                atomics += 1
                            run_id, run_count = v, 1
                if run_count:
                    add(run_id, run_count)
                    atomics += 1
        for rank in range(kernels.HIST_CLUSTER):
            for j in range(bpb // 128):
                g = j * kernels.HIST_CLUSTER + rank
                if g < bins // 128:
                    out[mask, g * 128:(g + 1) * 128] = \
                        shared[rank, j * 128:(j + 1) * 128]
    return out, atomics


@pytest.mark.parametrize("shape,bins,threads,unroll", [
    ((2, 812), 256, 4, 2),      # 203 words: 26 a block, the last 21
    ((3, 1000), 128, 3, 4),     # one granule; seven blocks own none
    ((2, 4 * 97), 384, 5, 1),   # three granules; five blocks own none
    ((2, 4 * 333), 1280, 7, 3),  # ten granules: two blocks own two
    ((2, 20000), 32768, kernels.HIST_THREADS, kernels.HIST_UNROLL),
])
def test_hist_cluster_rendering_matches_plain(shape, bins, threads, unroll):
    rng = np.random.default_rng(shape[1])
    m, n = shape
    # row runs of one id (as component ids lie), out-of-range ids between
    lengths = rng.integers(1, 40, n)
    values = rng.integers(-20, bins + 20, n)
    ids = np.repeat(values, lengths)[:m * n].reshape(m, n).astype(np.int32)
    got, atomics = _rendered_hist_cluster(ids, bins, threads, unroll)
    ref = kernels.hist_dense_plain(torch.from_numpy(ids), bins // 128)
    np.testing.assert_array_equal(got, ref.reshape(m, bins).numpy())
    in_range = int(((ids >= 0) & (ids < bins)).sum())
    assert 0 < atomics < in_range           # runs merged


def test_hist_cluster_rendering_merges_one_id_per_thread():
    """A mask of one id (the worst contention) takes one atomic a
    thread; an all-background mask none."""
    threads = 25                        # 100 words a block, 4 a thread
    one = np.full((2, 4 * 800), 9, np.int32)
    got, atomics = _rendered_hist_cluster(one, 256, threads, 4)
    assert got[:, 9].tolist() == [4 * 800] * 2
    assert int(got.sum()) == 2 * 4 * 800
    assert atomics == 2 * kernels.HIST_CLUSTER * threads
    got, atomics = _rendered_hist_cluster(np.full((2, 64), 256, np.int32),
                                          256, threads, 4)
    assert atomics == 0 and not got.any()


def test_hist_dense_instance_by_shape():
    bins = 256 * 128
    big = kernels.HIST_CLUSTER_MAX_BINS + 128
    ids = torch.zeros((4, 4096), dtype=torch.int32)
    assert kernels.hist_dense_instance(ids, bins) == "cluster"
    assert kernels.hist_dense_instance(ids, big) == "global"
    assert kernels.hist_dense_instance(ids[:1], bins) == "global"
    assert kernels.hist_dense_instance(
        torch.zeros((4, 4095), dtype=torch.int32), bins) == "global"
    offset = torch.zeros(4 * 4096 + 1, dtype=torch.int32)[1:].reshape(4, -1)
    assert kernels.hist_dense_instance(offset, bins) == "global"
    assert kernels.hist_cluster_plan(360000, bins) == (11250, 4096)
    assert kernels.hist_cluster_plan(16, 128) == (1, 128)


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


# ------------------------------------------------------------ lut_hist

def _count_word(bins, a, b, c, d):
    """``count_word`` of ``csrc/lut_hist.cu``: one add per distinct value
    of a word, with its repeats; returns the number of adds."""
    bins[a] += 1 + (b == a) + (c == a) + (d == a)
    adds = 1
    if b != a:
        bins[b] += 1 + (c == b) + (d == b)
        adds += 1
    if c != a and c != b:
        bins[c] += 1 + (d == c)
        adds += 1
    if d != a and d != b and d != c:
        bins[d] += 1
        adds += 1
    return adds


def _rendered_lut_hist(scene, lut, unit, blocks, threads, unroll):
    """numpy rendering of the ranges instance of ``csrc/lut_hist.cu``
    (``lut_hist_kernel``) on a (planes, n) uint8 scene with (planes, 256)
    tables: the blocks of ``lut_hist_plan`` each take their range of
    units; per plane they run the units wholly inside it,
    thread ``t`` taking units ``base + u * threads`` of each step, its
    lookups counted into its warp's bins with equal values of a 4-pixel
    word merged, then flush the warps' sums into the histogram; the unit
    that straddles a plane boundary is done byte by byte, straight into the
    histogram. ``lut=None`` renders ``raw_counts_kernel``, the same body
    counting the raw DNs and storing nothing. Returns the levels, the
    histogram and the shared adds."""
    planes, n = scene.shape
    if lut is None:
        lut = np.tile(np.arange(256), (planes, 1))
        stored = False
    else:
        stored = True
    flat = scene.reshape(-1)
    total = planes * n
    grid, span = kernels.lut_hist_plan(planes, n, unit, blocks)
    units = -(-total // unit)
    out = np.full(total, -1, np.int64)
    hist = np.zeros((planes, 256), np.int64)
    adds = 0
    for k in range(grid):
        lo, hi = k * span, min(k * span + span, units)
        p0 = lo * unit // n
        p1 = (min(hi * unit, total) - 1) // n
        assert p1 - p0 + 1 <= kernels.LUT_MAX_TABLES
        bins = np.zeros((-(-threads // 32), 256), np.int64)
        for p in range(p0, p1 + 1):
            ws = max(lo, -(-(p * n) // unit))
            we = min(hi, (p + 1) * n // unit)
            for t in range(threads):
                for base in range(ws + t, we, threads * unroll):
                    for u in range(unroll):
                        i = base + u * threads
                        if i >= we:
                            continue
                        levels = lut[p][flat[i * unit:(i + 1) * unit]]
                        if stored:
                            out[i * unit:(i + 1) * unit] = levels
                        if unit == 1:
                            bins[t // 32, levels[0]] += 1
                            adds += 1
                        for q in range(0, unit if unit > 1 else 0, 4):
                            adds += _count_word(bins[t // 32],
                                                *levels[q:q + 4])
            hist[p] += bins.sum(axis=0)
            bins[:] = 0
        for p in range(p0 + 1, p1 + 2):
            b = p * n
            w = b // unit
            if b % unit == 0 or not lo <= w < hi:
                continue
            for j in range(w * unit, min(w * unit + unit, total)):
                q = p - 1 if j < b else p
                if stored:
                    out[j] = lut[q][flat[j]]
                hist[q, lut[q][flat[j]]] += 1
    return out.reshape(planes, n), hist, adds


def _lut_hist_case(planes, n, smooth, seed):
    rng = np.random.default_rng(seed)
    if smooth:      # runs of one DN, as smooth scenes have
        runs = rng.integers(1, 30, planes * n)
        dn = np.repeat(rng.integers(0, 256, planes * n), runs)
        scene = dn[:planes * n].reshape(planes, n).astype(np.uint8)
    else:
        scene = rng.integers(0, 256, (planes, n), dtype=np.uint8)
    lut = rng.integers(0, 256, (planes, 256), dtype=np.uint8)
    return scene, lut


@pytest.mark.parametrize("planes,n,unit,blocks,threads,unroll,smooth", [
    (3, 91, 4, 5, 8, 2, False),        # n % 4 == 3: straddling words
    (3, 91, 4, 5, 8, 2, True),
    (1, 1001, 4, 3, 32, 4, True),      # one plane, one row
    (7, 3599, 4, 40, kernels.LUT_THREADS, kernels.LUT_UNROLL, True),
    (40, 15, 4, 2, 4, 3, False),       # many planes a block
    (3, 63, 16, 4, 4, 2, True),        # uint8 out: 16-pixel units
    (5, 3, 1, 4, 4, 2, False),         # planes shorter than a word
])
def test_lut_hist_rendering_matches_plain(planes, n, unit, blocks, threads,
                                          unroll, smooth):
    scene, lut = _lut_hist_case(planes, n, smooth, planes * n)
    got, hist, adds = _rendered_lut_hist(scene, lut, unit, blocks, threads,
                                         unroll)
    st, ref_hist = kernels.lut_hist_plain(
        torch.from_numpy(scene[:, None]), torch.from_numpy(lut), out_u8=True)
    np.testing.assert_array_equal(got, st[:, 0].numpy())
    np.testing.assert_array_equal(hist, ref_hist.numpy())
    np.testing.assert_array_equal(hist, kernels.histogram256(
        torch.from_numpy(got.astype(np.uint8)[:, None])).numpy())
    if smooth and unit > 1:
        assert adds < planes * n * 0.6      # equal values merged


def _rendered_lut_hist_cluster(scene, lut, unit, threads, unroll):
    """numpy rendering of ``lut_hist_cluster_kernel`` on a (planes, n)
    scene with ``n % unit == 0``: per plane, ``LUT_CLUSTER`` blocks each
    take ``span`` units of the plane, thread ``t`` units ``base + u *
    threads`` of each step, counted into its warp's bins with equal values
    of a word merged; each block sums its warps, and the owner of each bin
    (block ``bin // (256 // LUT_CLUSTER)``) writes the cluster's sum once.
    Returns the levels, the histogram and the owners' writes per bin."""
    planes, n = scene.shape
    per = n // unit
    span = -(-per // kernels.LUT_CLUSTER)
    out = np.full((planes, n), -1, np.int64)
    hist = np.full((planes, 256), -7, np.int64)     # uninitialised
    writes = np.zeros((planes, 256), np.int64)
    for p in range(planes):
        sums = np.zeros((kernels.LUT_CLUSTER, 256), np.int64)
        for r in range(kernels.LUT_CLUSTER):
            lo, hi = r * span, min(r * span + span, per)
            bins = np.zeros((-(-threads // 32), 256), np.int64)
            for t in range(threads):
                for base in range(lo + t, hi, threads * unroll):
                    for u in range(unroll):
                        i = base + u * threads
                        if i >= hi:
                            continue
                        levels = lut[p][scene[p, i * unit:(i + 1) * unit]]
                        out[p, i * unit:(i + 1) * unit] = levels
                        for q in range(0, unit, 4):
                            _count_word(bins[t // 32], *levels[q:q + 4])
            sums[r] = bins.sum(axis=0)
        per_rank = 256 // kernels.LUT_CLUSTER
        for r in range(kernels.LUT_CLUSTER):
            owned = slice(r * per_rank, (r + 1) * per_rank)
            hist[p, owned] = sums[:, owned].sum(axis=0)
            writes[p, owned] += 1
    return out, hist, writes


@pytest.mark.parametrize("planes,n,unit,threads,unroll,smooth", [
    (3, 92, 4, 8, 2, False),       # 23 words: two a block, the last one
    (2, 1000, 4, 8, 3, True),
    (7, 3600, 4, kernels.LUT_THREADS, kernels.LUT_UNROLL, True),
    (2, 48, 16, 4, 2, True),       # uint8 out: three units a plane
    (1, 16 * 40, 16, 2, 2, False),
])
def test_lut_hist_cluster_rendering_matches_plain(planes, n, unit, threads,
                                                  unroll, smooth):
    scene, lut = _lut_hist_case(planes, n, smooth, planes * n + 1)
    got, hist, writes = _rendered_lut_hist_cluster(scene, lut, unit,
                                                   threads, unroll)
    st, ref_hist = kernels.lut_hist_plain(
        torch.from_numpy(scene[:, None]), torch.from_numpy(lut), out_u8=True)
    np.testing.assert_array_equal(got, st[:, 0].numpy())
    np.testing.assert_array_equal(hist, ref_hist.numpy())
    assert (writes == 1).all()              # every bin written once
    assert kernels.lut_hist_instance(planes, n, unit, False) == "cluster"


def test_lut_hist_rendering_merges_a_flat_word():
    """A scene of one level takes one shared add a word."""
    scene = np.full((2, 400), 7, np.uint8)
    lut = np.tile(np.arange(256, dtype=np.uint8)[::-1], (2, 1))
    _, hist, adds = _rendered_lut_hist(scene, lut, 4, 3, 32, 2)
    assert adds == 2 * 400 // 4
    assert hist[:, 248].tolist() == [400, 400] and int(hist.sum()) == 800


def test_lut_hist_unit_and_plan():
    scene = torch.zeros((7, 600, 600), dtype=torch.uint8)
    f32 = torch.empty((7, 600, 600))
    u8 = torch.empty((7, 600, 600), dtype=torch.uint8)
    assert kernels.lut_hist_unit(scene, f32) == 4
    assert kernels.lut_hist_unit(scene, u8) == 16
    buf = torch.zeros(7 * 360000 + 16, dtype=torch.uint8)
    for off, want_f32, want_u8 in ((1, 1, 1), (4, 4, 4), (16, 4, 16)):
        view = buf[off:off + 7 * 360000].view(7, 600, 600)
        assert kernels.lut_hist_unit(view, f32) == want_f32, off
        assert kernels.lut_hist_unit(view, u8) == want_u8, off
    tiny = torch.zeros((5, 1, 3), dtype=torch.uint8)
    assert kernels.lut_hist_unit(tiny, torch.empty((5, 1, 3))) == 1
    # the main path's batch on 132 SMs: 528 ranges of 9 546 words
    assert kernels.lut_hist_plan(56, 360000, 4, 528) == (528, 9546)
    # ranges capped at LUT_MAX_TABLES planes
    grid, span = kernels.lut_hist_plan(65535, 4, 4, 528)
    assert span == kernels.LUT_MAX_TABLES - 1 and grid == -(-65535 // span)
    # the histogram takes the cluster instance where planes split into
    # whole units; the ranges instance (and its zero fill) otherwise
    assert kernels.lut_hist_instance(56, 360000, 4, False) == "cluster"
    assert kernels.lut_hist_instance(7, 360000, 16, False) == "cluster"
    assert kernels.lut_hist_instance(56, 360000, 4, True) == "ranges"
    assert kernels.lut_hist_instance(7, 601 * 599, 4, False) == "ranges"
    assert kernels.lut_hist_instance(7, 360000, 1, False) == "ranges"
    assert kernels.lut_hist_instance(65536, 16, 4, False) == "ranges"


# ------------------------------------------------- raw_counts (raw DN counts)

def _raw_counts_case(name):
    """A (C, H, W) uint8 chunk of the streamed route's shapes and edges."""
    rng = np.random.default_rng(len(name))
    shape = {"chunk (7, 504, 6000)": (7, 504, 6000),
             "ragged last chunk (7, 456, 6000)": (7, 456, 6000),
             "unaligned (7, 37, 61)": (7, 37, 61),
             "one-row planes (7, 1, 6000)": (7, 1, 6000),
             "one-row planes (3, 1, 13)": (3, 1, 13),
             "all 0": (7, 37, 61), "all 255": (7, 37, 61)}[name]
    if name == "all 0":
        return np.zeros(shape, np.uint8)
    if name == "all 255":
        return np.full(shape, 255, np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


RAW_COUNT_CASES = ["chunk (7, 504, 6000)", "ragged last chunk (7, 456, 6000)",
                   "unaligned (7, 37, 61)", "one-row planes (7, 1, 6000)",
                   "one-row planes (3, 1, 13)", "all 0", "all 255"]


def _bincounts(chunk):
    return np.stack([np.bincount(p.reshape(-1), minlength=256)
                     for p in chunk])


@pytest.mark.parametrize("name", RAW_COUNT_CASES)
def test_raw_counts_plain_matches_bincount(name):
    chunk = _raw_counts_case(name)
    counts = torch.zeros((chunk.shape[0], 256), dtype=torch.int32)
    before = kernels.raw_counts.launches
    got = kernels.raw_counts(torch.from_numpy(chunk), counts)
    assert got is counts and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _bincounts(chunk))
    assert kernels.raw_counts.launches == before      # CPU: plain, no launch


def test_raw_counts_accumulates_over_calls():
    """A scene's row chunks counted into one accumulator count the scene."""
    scene = np.random.default_rng(3).integers(0, 256, (7, 100, 61),
                                              dtype=np.uint8)
    counts = torch.zeros((7, 256), dtype=torch.int32)
    for y in range(0, 100, 42):
        kernels.raw_counts(torch.from_numpy(scene[:, y:y + 42].copy()),
                           counts)
    np.testing.assert_array_equal(counts.numpy(), _bincounts(scene))
    kernels.raw_counts(torch.from_numpy(scene), counts)
    np.testing.assert_array_equal(counts.numpy(), 2 * _bincounts(scene))


@pytest.mark.parametrize("planes,n,unit,blocks,threads,unroll,smooth", [
    (7, 3000, 16, 40, 8, 2, False),    # 16-byte units, n % 16 == 8
    (7, 3000, 16, 40, 8, 2, True),
    (3, 2257, 4, 9, 16, 4, False),     # (37, 61) planes: 4-byte aligned
    (3, 2257, 1, 9, 16, 4, True),      # unaligned base: the scalar unit
    (2, 13, 4, 528, 4, 2, False),      # planes of a few words
    (1, 4096, 16, 528, kernels.LUT_THREADS, kernels.LUT_UNROLL, True),
    (40, 15, 4, 2, 4, 3, False),       # many planes a block
])
def test_raw_counts_rendering_matches_plain(planes, n, unit, blocks, threads,
                                            unroll, smooth):
    """``raw_counts_kernel`` is lut_hist's ranges body with no table: its
    rendering counts every raw DN once, stores nothing, and adds into the
    accumulator the plain version adds into."""
    scene, _ = _lut_hist_case(planes, n, smooth, planes * n + unit)
    got, hist, adds = _rendered_lut_hist(scene, None, unit, blocks, threads,
                                         unroll)
    assert (got == -1).all()                      # nothing stored
    assert int(hist.sum()) == planes * n          # every DN counted once
    np.testing.assert_array_equal(
        hist, kernels.raw_counts_plain(
            torch.from_numpy(scene[:, None]),
            torch.zeros((planes, 256), dtype=torch.int32)).numpy())
    if smooth and unit > 1:
        assert adds < planes * n * 0.6            # equal DNs merged


def test_raw_counts_unit_and_plan():
    """The count takes lut_hist's units from the chunk's base alone, and
    lut_hist's ranges over the streamed route's chunks."""
    buf = torch.zeros(7 * 504 * 6000 + 16, dtype=torch.uint8)
    for off, want in ((0, 16), (1, 1), (4, 4), (8, 4), (16, 16)):
        view = buf[off:off + 7 * 504 * 6000].view(7, 504, 6000)
        assert kernels.lut_hist_unit(view) == want, off
    tiny = torch.zeros((3, 1, 13), dtype=torch.uint8)
    assert kernels.lut_hist_unit(tiny) == 4
    assert kernels.lut_hist_unit(tiny[:, :, :3]) == 1
    # the route's chunks on 132 SMs: 528 ranges of 16-byte units
    assert kernels.lut_hist_plan(7, 504 * 6000, 16, 528) == (528, 2506)
    assert kernels.lut_hist_plan(7, 456 * 6000, 16, 528) == (528, 2268)


def test_raw_counts_argument_checks():
    chunk = torch.zeros((7, 8, 8), dtype=torch.uint8)
    counts = torch.zeros((7, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk_u8"):
        kernels.raw_counts(chunk.to(torch.int32), counts)
    with pytest.raises(ValueError, match="chunk_u8"):
        kernels.raw_counts(chunk[None], counts)
    with pytest.raises(ValueError, match="chunk_u8"):
        kernels.raw_counts(chunk[:, :0], counts)
    with pytest.raises(ValueError, match="counts must be"):
        kernels.raw_counts(chunk, counts.to(torch.int64))
    with pytest.raises(ValueError, match="counts must be"):
        kernels.raw_counts(chunk, counts[:6])
    with pytest.raises(ValueError, match="counts must be"):
        kernels.raw_counts(chunk, torch.zeros((7, 255), dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kernels.raw_counts(chunk.to("meta"), counts.to("meta"))
    with pytest.raises(ValueError, match="tensors on"):
        kernels.raw_counts(chunk, counts.to("meta"))
    before = kernels.raw_counts.launches
    kernels.raw_counts(chunk, counts)
    assert kernels.raw_counts.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("offset", [0, 1, 5])
@pytest.mark.parametrize("name", RAW_COUNT_CASES)
def test_raw_counts_kernel_matches_plain_on_the_card(card, name, offset):
    chunk = torch.from_numpy(_raw_counts_case(name)).to(card)
    if offset:          # a view whose planes start off 16-byte alignment
        buf = torch.empty(chunk.numel() + 16, dtype=torch.uint8, device=card)
        view = buf[offset:offset + chunk.numel()].view(chunk.shape)
        view.copy_(chunk)
        chunk = view
    zeros = torch.zeros((chunk.shape[0], 256), dtype=torch.int32, device=card)
    before = kernels.raw_counts.launches
    got = kernels.raw_counts(chunk, zeros.clone())
    assert kernels.raw_counts.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.raw_counts_plain(chunk, zeros.clone()))


@pytest.mark.card
def test_raw_counts_kernel_accumulates_on_the_card(card):
    scene = np.random.default_rng(4).integers(0, 256, (7, 1100, 600),
                                              dtype=np.uint8)
    counts = torch.zeros((7, 256), dtype=torch.int32, device=card)
    before = kernels.raw_counts.launches
    for y in range(0, 1100, 504):
        kernels.raw_counts(torch.from_numpy(scene[:, y:y + 504].copy())
                           .to(card), counts)
    assert kernels.raw_counts.launches == before + 3
    np.testing.assert_array_equal(counts.cpu().numpy(), _bincounts(scene))
