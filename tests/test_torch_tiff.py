"""PyTorch port's TIFF codec (``io.tiff``, ``io.native``) against the JAX
package's, on the CPU: the same array, metadata and options give the same
file bytes in both packages, each reads the other's files, the native
and pure-Python codecs write the same bytes, and the tiled stream writer
fed by the large-scene driver writes the file JAX's writer writes for
the same rows. Also the host histogram of ``build_stretch_stats``, which
counts through ``io.native``."""

import numpy as np
import pytest

from rs_image_segmentation_tpu.core.types import GeoMeta as JGeoMeta
from rs_image_segmentation_tpu.io import tiff as jtiff
from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig)
from rs_image_segmentation_tpu_torch.core.types import GeoMeta
from rs_image_segmentation_tpu_torch.io import native, tiff
from rs_image_segmentation_tpu_torch.models.forest import (_gemm_for,
                                                           fit_random_forest)
from rs_image_segmentation_tpu_torch.pipeline import large_scene, preprocess
from rs_image_segmentation_tpu_torch.pipeline.features import (
    hierarchical_stack_fused)
from rs_image_segmentation_tpu_torch.tools.fixtures import (rule_labels,
                                                            synthetic_scenes)

TRANSFORM = (30.0, 0.0, 500000.0, 0.0, -30.0, 4649000.0)
DTYPES = [np.uint8, np.uint16, np.int16, np.float32]


def _array(dtype, shape=(3, 70, 90), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    # a narrow range keeps LZW and the predictor busy with repeats
    return rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                        shape).astype(dtype)


def _both(tmp_path, arr, **kw):
    """Write ``arr`` with each package's writer (the same options, each
    its own GeoMeta): ``(port file bytes, JAX file bytes, port path, JAX
    path)``."""
    meta = kw.pop("meta", (TRANSFORM, "EPSG:32650", 0.0))
    pp, jp = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    tiff.write_tiff(pp, arr, GeoMeta(*meta) if meta else None, **kw)
    jtiff.write_tiff(jp, arr, JGeoMeta(*meta) if meta else None, **kw)
    with open(pp, "rb") as f1, open(jp, "rb") as f2:
        return f1.read(), f2.read(), pp, jp


def _same_read(a, b):
    """Two ``read_tiff`` results (one per package) agree: arrays, and
    every metadata field."""
    (arr_a, info_a), (arr_b, info_b) = a, b
    assert arr_a.dtype == arr_b.dtype
    np.testing.assert_array_equal(arr_a, arr_b)
    assert (info_a.meta.transform, info_a.meta.crs, info_a.meta.nodata) == (
        info_b.meta.transform, info_b.meta.crs, info_b.meta.nodata)
    assert info_a.band_names == info_b.band_names
    assert (info_a.width, info_a.height, info_a.count, info_a.compression,
            info_a.tiled) == (info_b.width, info_b.height, info_b.count,
                              info_b.compression, info_b.tiled)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
@pytest.mark.parametrize("compression", ["none", "lzw", "deflate"])
def test_same_bytes_and_cross_read(tmp_path, compression, tiled, dtype):
    arr = _array(dtype)
    port, jax_, pp, jp = _both(tmp_path, arr, compression=compression,
                               tiled=tiled, tile_size=32,
                               band_names=["b0", None, "b2"])
    assert port == jax_
    back, info = tiff.read_tiff(pp)
    np.testing.assert_array_equal(back, arr)
    assert info.meta == GeoMeta(TRANSFORM, "EPSG:32650", 0.0)
    # each package reads the other's file the same way
    _same_read(tiff.read_tiff(jp), jtiff.read_tiff(pp))


@pytest.mark.parametrize("predictor", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16],
                         ids=lambda d: np.dtype(d).name)
def test_predictor_same_bytes(tmp_path, predictor, dtype):
    arr = _array(dtype, (2, 45, 61), seed=3)
    port, jax_, pp, jp = _both(tmp_path, arr, compression="lzw",
                               predictor=predictor)
    assert port == jax_
    _same_read(tiff.read_tiff(pp), jtiff.read_tiff(jp))
    np.testing.assert_array_equal(tiff.read_tiff(pp)[0], arr)


@pytest.mark.parametrize("case", ["bigtiff", "planar", "palette",
                                  "no_meta", "float64"])
def test_layouts_same_bytes(tmp_path, case):
    arr = _array(np.uint8, (2, 50, 40), seed=4)
    kw = {"compression": "lzw"}
    if case == "bigtiff":
        kw.update(bigtiff=True, tiled=True, tile_size=16)
    elif case == "planar":
        kw.update(planar=2)
    elif case == "palette":
        arr = arr[:1] % 4
        kw.update(colormap=np.array([[0, 0, 0], [0, 128, 0], [0, 0, 255],
                                     [255, 0, 0]], np.uint8))
    elif case == "no_meta":
        kw.update(meta=None)
    else:
        arr = _array(np.float32, (2, 50, 40), seed=4).astype(np.float64)
    port, jax_, pp, jp = _both(tmp_path, arr, **kw)
    assert port == jax_
    _same_read(tiff.read_tiff(pp), jtiff.read_tiff(jp))
    if case == "palette":
        assert np.array_equal(tiff.read_tiff(pp)[1].colormap,
                              jtiff.read_tiff(jp)[1].colormap)


@pytest.mark.parametrize("shape", [(1, 123, 217), (3, 40, 50)])
def test_packbits_read_matches_jax(tmp_path, shape):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    img = rng.integers(0, 4, shape).astype(np.uint8)
    img[:, :, : shape[2] // 2] = 7          # long runs as well as literals
    p = str(tmp_path / "pb.tif")
    pil = (PIL.fromarray(img[0]) if shape[0] == 1
           else PIL.fromarray(np.moveaxis(img, 0, -1)))
    pil.save(p, compression="packbits")
    arr, info = tiff.read_tiff(p)
    assert info.compression == tiff.COMP_PACKBITS
    np.testing.assert_array_equal(arr, img)
    _same_read((arr, info), jtiff.read_tiff(p))


def test_codecs_match_jax_and_native_matches_python(monkeypatch):
    rng = np.random.default_rng(6)
    datas = [rng.integers(0, 16, size=n, dtype=np.uint8).tobytes()
             for n in (0, 1, 7, 1000, 65537)]
    # a run of three 9s, then a literal 1, 2, 3: six bytes a group
    packbits = bytes([254, 9, 2, 1, 2, 3]) * 50
    assert native.available()
    encoded = [tiff.lzw_encode(d) for d in datas]
    unpacked = tiff.packbits_decode(packbits, 300)
    for d, e in zip(datas, encoded):
        assert e == jtiff.lzw_encode(d)
        assert tiff.lzw_decode(e, len(d)) == d
    assert unpacked == jtiff.packbits_decode(packbits, 300)
    assert unpacked == bytes([9, 9, 9, 1, 2, 3]) * 50
    monkeypatch.setattr(native, "available", lambda: False)
    python_encoded = [tiff.lzw_encode(d) for d in datas]
    # equal bytes for every non-empty input (a writer never encodes an
    # empty strip or tile). For empty input native/tiffcodec.cpp emits
    # its end code twice (clear, end, end: 4 bytes) where the Python
    # encoder emits clear, end (3 bytes); both decode to nothing.
    assert python_encoded[1:] == encoded[1:]
    assert (encoded[0], python_encoded[0]) == (bytes.fromhex("80406020"),
                                               bytes.fromhex("804040"))
    assert [tiff.lzw_decode(e, len(d))
            for d, e in zip(datas, encoded)] == datas
    assert tiff.lzw_decode(python_encoded[0], 0) == b""
    assert tiff.packbits_decode(packbits, 300) == unpacked


@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_native_and_python_write_same_bytes(tmp_path, monkeypatch, tiled,
                                            dtype):
    arr = _array(dtype, (2, 130, 70), seed=7)
    kw = dict(compression="lzw", tiled=tiled, tile_size=64)
    native_path, py_path = str(tmp_path / "n.tif"), str(tmp_path / "p.tif")
    tiff.write_tiff(native_path, arr, GeoMeta(TRANSFORM, "EPSG:32650"), **kw)
    monkeypatch.setattr(native, "available", lambda: False)
    tiff.write_tiff(py_path, arr, GeoMeta(TRANSFORM, "EPSG:32650"), **kw)
    back, _ = tiff.read_tiff(native_path)     # read by the Python decoder
    with open(native_path, "rb") as f1, open(py_path, "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(back, arr)


def test_geometa_matches_jax():
    gt = (500000.0, 30.0, 0.0, 4649000.0, 0.0, -30.0)
    ours, theirs = GeoMeta.from_gdal(gt, "EPSG:32650", 0.0), \
        JGeoMeta.from_gdal(gt, "EPSG:32650", 0.0)
    assert (ours.transform, ours.crs, ours.nodata) == (
        theirs.transform, theirs.crs, theirs.nodata)
    assert ours.to_gdal() == theirs.to_gdal() == gt
    assert ours.pixel_size == theirs.pixel_size == (30.0, -30.0)
    assert GeoMeta().is_identity() and not ours.is_identity()


def test_tile_stream_writer_matches_both_writers(tmp_path):
    """Arbitrary row chunks give the file of a whole-array write_tiff,
    and of JAX's stream writer fed the same chunks."""
    h, w = 777, 513                     # non-multiples of the tile size
    labels = np.random.default_rng(8).integers(0, 4, (h, w)).astype(np.uint8)
    meta = (TRANSFORM, "EPSG:32650", 0.0)
    ref = str(tmp_path / "ref.tif")
    tiff.write_tiff(ref, labels[None], GeoMeta(*meta), compression="lzw",
                    tiled=True, tile_size=256)
    paths = []
    for mod, gm in ((tiff, GeoMeta), (jtiff, JGeoMeta)):
        paths.append(str(tmp_path / f"{mod.__name__}.tif"))
        with mod.TiffTileStreamWriter(paths[-1], h, w, labels.dtype,
                                      gm(*meta), compression="lzw",
                                      tile_size=256) as sw:
            y = 0
            for chunk in (100, 300, 56, 200, 121):  # uneven, sums to 777
                sw.write_rows(labels[y:y + chunk])
                y += chunk
    blobs = []
    for p in [ref] + paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1] == blobs[2]
    np.testing.assert_array_equal(tiff.read_tiff(paths[0])[0][0], labels)


def test_tile_stream_writer_validates(tmp_path):
    sw = tiff.TiffTileStreamWriter(str(tmp_path / "x.tif"), 10, 8, np.uint8)
    sw.write_rows(np.zeros((4, 8), np.uint8))
    with pytest.raises(ValueError, match="rows must be"):
        sw.write_rows(np.zeros((2, 9), np.uint8))
    with pytest.raises(ValueError, match="more rows"):
        sw.write_rows(np.zeros((7, 8), np.uint8))
    with pytest.raises(ValueError, match="rows were written"):
        sw.close()


def test_large_scene_writer_matches_jax_writer(tmp_path):
    """``classify_large_scene_streamed(writer=)`` at 252 x 252 (tile_rows
    63) into the port's stream writer: the file equals the one JAX's
    writer writes for the same rows, and holds the returned map."""
    raw = synthetic_scenes(1, 252, 252, seed=41)[0]
    cfg = FeatureStageConfig()
    pre = large_scene.preprocess_large(raw, CalibrationConfig(),
                                       device="cpu")
    st = hierarchical_stack_fused(pre, cfg, device="cpu").numpy()
    flat = st.reshape(-1, 19)
    pick = np.random.default_rng(3).choice(flat.shape[0], 60, replace=False)
    forest, _ = fit_random_forest(flat[pick],
                                  rule_labels(st.transpose(2, 0, 1), pick),
                                  n_estimators=8, seed=0)
    gf = _gemm_for(forest, 19)
    meta = (TRANSFORM, "EPSG:32650", 0.0)
    port_path, jax_path = str(tmp_path / "p.tif"), str(tmp_path / "j.tif")
    with tiff.TiffTileStreamWriter(port_path, 252, 252, np.uint8,
                                   GeoMeta(*meta), tile_size=128) as sw:
        labels = large_scene.classify_large_scene_streamed(
            raw, gf, CalibrationConfig(), cfg, tile_rows=63, writer=sw,
            device="cpu")
    with jtiff.TiffTileStreamWriter(jax_path, 252, 252, np.uint8,
                                    JGeoMeta(*meta), tile_size=128) as jw:
        for y in range(0, 252, 63):
            jw.write_rows(labels[y:y + 63])
    with open(port_path, "rb") as f1, open(jax_path, "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(tiff.read_tiff(port_path)[0][0], labels)
    assert len(np.unique(labels)) > 1


@pytest.mark.parametrize("shape", [(7, 60, 50), (7, 601, 599)])
def test_stretch_stats_native_count_equals_bincount(monkeypatch, shape):
    """build_stretch_stats counts through io.native.hist_u8; the numpy
    count it takes without the library gives the same statistics."""
    scene = synthetic_scenes(1, *shape[1:], seed=2)[0]
    cal = CalibrationConfig()
    g, b = np.asarray(cal.gains), np.asarray(cal.biases)
    with_native = preprocess.build_stretch_stats(scene, g, b)
    monkeypatch.setattr(native, "hist_u8", lambda arr: None)
    without = preprocess.build_stretch_stats(scene, g, b)
    for x, y in zip(with_native, without):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_native_builds_into_the_port_build_dir():
    """The codec builds from native/tiffcodec.cpp into the port's own
    _build/ under a hashed name; nothing is written under native/."""
    assert native.available()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libtiffcodec-")
    a = np.random.default_rng(9).integers(0, 256, 100001).astype(np.uint8)
    np.testing.assert_array_equal(native.hist_u8(a),
                                  np.bincount(a, minlength=256))
    with pytest.raises(ValueError, match="uint8"):
        native.hist_u8(a.astype(np.int16))
