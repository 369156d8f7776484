"""PyTorch port's stage artifacts (``io.artifacts``) and stage-3 fixtures
(``tools.fixtures``) against the JAX package's, on the CPU: the loaders
give the same dicts for the same files, the flattening gives the same keys
and arrays, and ``save_feature_artifacts`` fed tensors writes ``.npy``
and GeoTIFF files byte-equal to the JAX package's from the same arrays,
and a pickle that the JAX package's loaders read equal and that holds no
tensor. Inputs are made from numpy seeds."""

import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.types import GeoMeta as JGeoMeta
from rs_image_segmentation_tpu.io import artifacts as jart
from rs_image_segmentation_tpu.io.tiff import write_tiff as jwrite_tiff
from rs_image_segmentation_tpu.tools import fixtures as jfix
from rs_image_segmentation_tpu_torch.core.types import GeoMeta, Raster
from rs_image_segmentation_tpu_torch.backend import host_numpy
from rs_image_segmentation_tpu_torch.io import artifacts as tart
from rs_image_segmentation_tpu_torch.tools import fixtures as tfix

H, W = 12, 10
GEO = (500000.0, 30.0, 0.0, 4000000.0, 0.0, -30.0)


def _assert_same(got, ref, where="root"):
    """Equal structure, types and values (arrays: dtype, shape, bits)."""
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), where
        for k in ref:
            _assert_same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{where}[{i}]")
    else:
        assert type(got) is type(ref) and got == ref, (where, got, ref)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _stage2_like(seed=0):
    """A stage-2 features dict (nested multi-scale dicts, the PCA planes
    as a list, a 1-D variance ratio) and its hierarchical stacks, numpy."""
    rng = np.random.default_rng(seed)
    plane = lambda: rng.standard_normal((H, W)).astype(np.float32)  # noqa: E731
    feats = {k: plane() for k in ("ndvi", "evi", "ndwi", "ndbi")}
    feats["pca_result"] = [plane() for _ in range(3)]
    feats["variance_ratio"] = rng.random(3).astype(np.float32)
    feats["glcm_features"] = {"contrast": plane(), "homogeneity": plane()}
    feats["multi_scale_features"] = {"mean_scale_3": plane(),
                                     "std_dev_scale_3": plane()}
    level1 = rng.standard_normal((H, W, 14)).astype(np.float32)
    level2 = rng.standard_normal((H, W, 5)).astype(np.float32)
    hier = {"level_1": level1, "level_2": level2,
            "all": np.concatenate([level1, level2], axis=-1)}
    return feats, hier


def _tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return tree


# ------------------------------------------------------------ load_features

def _write_container(tmp_path, kind):
    rng = np.random.default_rng(3)
    if kind == "npy_dict":
        p = str(tmp_path / "f.npy")
        np.save(p, {"ndvi": rng.random((H, W)), "height": H, "width": W},
                allow_pickle=True)
    elif kind == "npy_bands":
        p = str(tmp_path / "f.npy")
        np.save(p, rng.random((4, H, W)).astype(np.float32))
    elif kind == "npy_plane":
        p = str(tmp_path / "f.npy")
        np.save(p, rng.random((H, W)).astype(np.float32))
    elif kind == "pkl":
        p = str(tmp_path / "f.pkl")
        jfix.make_dummy_feature_pkl(p, shape=(H, W), seed=4)
    else:
        p = str(tmp_path / "f.tif")
        jwrite_tiff(p, rng.random((3, H, W)).astype(np.float32),
                    JGeoMeta.from_gdal(GEO, "EPSG:32630"),
                    band_names=["ndvi", "", "ndbi"])
    return p


@pytest.mark.parametrize("kind", ["npy_dict", "npy_bands", "npy_plane",
                                  "pkl", "tif"])
def test_load_features_matches_jax(tmp_path, kind):
    p = _write_container(tmp_path, kind)
    _assert_same(tart.load_features(p), jart.load_features(p))


def test_load_features_rejects_what_jax_rejects(tmp_path):
    p = str(tmp_path / "f.txt")
    open(p, "w").close()
    for fn in (tart.load_features, jart.load_features):
        with pytest.raises(ValueError, match="unsupported"):
            fn(p)
    p = str(tmp_path / "l.pkl")
    with open(p, "wb") as f:
        pickle.dump([1, 2], f)
    for fn in (tart.load_features, jart.load_features):
        with pytest.raises(ValueError, match="does not hold a dict"):
            fn(p)


# -------------------------------------------------- normalize_features_structure

def _nested_cases():
    arr = np.arange(H * W, dtype=np.float32).reshape(H, W)
    return {
        # tests/test_tools_and_io.py::test_normalize_features_structure_nested
        "nested": {
            "all_extracted_features_dict": {"ndvi": arr,
                                            "glcm": {"contrast": arr}},
            "hierarchical_features": {"all": np.zeros((H, W, 19),
                                                      np.float32)},
            "lst": [arr, arr],
            "dimensions": (H, W),
            "geo_transform": GEO,
            "crs": "EPSG:32630"},
        "transform_and_ints": {"ndvi": arr, "transform": list(
            (30.0, 0.0, 5e5, 0.0, -30.0, 4e6)), "height": H, "width": W},
        "bad_geo_transform": {"ndvi": arr, "geo_transform": (1.0, 2.0)},
        "shape_from_arrays": {"x": {"y": [arr + 1, arr + 2]},
                              "variance_ratio": np.ones(3)},
        "mixed_list_and_1d": {"lst": [arr, 3.0], "vec": np.ones(5),
                              "hierarchical_features": {"a": arr, "b": 1}},
        "empty": {},
    }


@pytest.mark.parametrize("case", list(_nested_cases()))
def test_normalize_features_structure_matches_jax(case):
    loaded = _nested_cases()[case]
    got = tart.normalize_features_structure(loaded)
    ref = jart.normalize_features_structure(loaded)
    _assert_same(got, ref)


def test_normalize_features_structure_nested_keys():
    flat = tart.normalize_features_structure(_nested_cases()["nested"])
    assert "all_extracted_features_dict_ndvi" in flat
    assert "all_extracted_features_dict_glcm_contrast" in flat
    assert flat["hierarchical_all"].shape == (H, W, 19)
    assert "lst_0" in flat and "lst_1" in flat
    assert flat["height"] == H and flat["width"] == W
    assert flat["transform"] == (30.0, 0.0, 500000.0, 0.0, -30.0, 4000000.0)


def test_alias_feature_keys_matches_jax():
    f = {"all_extracted_features_dict_ndvi": np.zeros((2, 2)),
         "all_extracted_features_dict_ndwi": np.ones((2, 2)),
         "ndwi": np.full((2, 2), 7.0), "other": 1}
    got, ref = tart.alias_feature_keys(f), jart.alias_feature_keys(f)
    _assert_same(got, ref)
    assert got["ndvi"] is f["all_extracted_features_dict_ndvi"]
    assert got["ndwi"] is f["ndwi"]     # an existing bare key wins
    got = tart.alias_feature_keys({"p_x": 1}, prefix="p_")
    assert got == jart.alias_feature_keys({"p_x": 1}, prefix="p_")


# ---------------------------------------------------- save_feature_artifacts

@pytest.mark.parametrize("with_meta", [True, False])
def test_save_feature_artifacts_matches_jax(tmp_path, with_meta):
    feats, hier = _stage2_like()
    meta = GeoMeta.from_gdal(GEO, "EPSG:32630") if with_meta else None
    jmeta = JGeoMeta.from_gdal(GEO, "EPSG:32630") if with_meta else None
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    tpaths = tart.save_feature_artifacts(tdir, _tensors(feats),
                                         _tensors(hier), meta)
    jpaths = jart.save_feature_artifacts(jdir, feats, hier, jmeta)
    assert sorted(tpaths) == sorted(jpaths)
    for key in ("level_1", "level_2", "all", "tif"):
        assert os.path.basename(tpaths[key]) == os.path.basename(jpaths[key])
        assert filecmp.cmp(tpaths[key], jpaths[key], shallow=False), key

    raw = open(tpaths["pkl"], "rb").read()
    assert b"torch" not in raw             # loads without torch or a card
    loaded = pickle.loads(raw)
    assert not any(isinstance(x, torch.Tensor) for x in _leaves(loaded))
    # the JAX package's loaders read the port's pickle as they read theirs
    _assert_same(jart.load_features(tpaths["pkl"]),
                 jart.load_features(jpaths["pkl"]))
    _assert_same(
        jart.normalize_features_structure(jart.load_features(tpaths["pkl"])),
        jart.normalize_features_structure(jart.load_features(jpaths["pkl"])))
    assert loaded["dimensions"] == (H, W)
    assert isinstance(loaded["all_extracted_features_dict"]["pca_result"],
                      list)


def test_host_numpy_keeps_python_leaves():
    tree = {"t": torch.arange(3), "f": 1.5, "tup": (torch.ones(2), "s"),
            "lst": [np.zeros(1)], "none": None}
    out = host_numpy(tree)
    assert isinstance(out["t"], np.ndarray)
    assert out["f"] == 1.5 and isinstance(out["f"], float)
    assert isinstance(out["tup"], tuple) and out["tup"][1] == "s"
    assert isinstance(out["tup"][0], np.ndarray)
    assert out["lst"][0] is tree["lst"][0] and out["none"] is None


# ------------------------------------------------------------------ fixtures

def test_synthetic_geometa_matches_jax():
    got, ref = tfix.synthetic_geometa((5, 7)), jfix.synthetic_geometa((5, 7))
    assert (got.transform, got.crs, got.nodata) == (ref.transform, ref.crs,
                                                    ref.nodata)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_dummy_feature_pkl_matches_jax(tmp_path, seed):
    tp, jp = str(tmp_path / "t" / "d.pkl"), str(tmp_path / "j" / "d.pkl")
    got = tfix.make_dummy_feature_pkl(tp, shape=(9, 11), seed=seed)
    ref = jfix.make_dummy_feature_pkl(jp, shape=(9, 11), seed=seed)
    _assert_same(got, ref)
    assert filecmp.cmp(tp, jp, shallow=False)
    _assert_same(tfix.make_dummy_feature_pkl(shape=(4, 4)),
                 jfix.make_dummy_feature_pkl(shape=(4, 4)))


@pytest.mark.parametrize("n_classes,seed", [(4, 0), (7, 5)])
def test_make_random_classification_map_matches_jax(n_classes, seed):
    got = tfix.make_random_classification_map((13, 17), n_classes, seed)
    ref = jfix.make_random_classification_map((13, 17), n_classes, seed)
    _assert_same(got, ref)


def test_raster_accessors():
    data = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    r = Raster(torch.from_numpy(data), GeoMeta(crs="EPSG:32630"), ("a", "b"))
    assert r.shape == (2, 3, 4) and r.count == 2
    assert (r.height, r.width) == (3, 4)
    assert torch.equal(r.band(1), torch.from_numpy(data[1]))
    assert isinstance(r.numpy(), np.ndarray)
    np.testing.assert_array_equal(r.numpy(), data)
    plane = data[0]
    r2 = r.with_data(plane)
    assert r2.count == 1 and r2.band(0) is plane
    assert r2.meta is r.meta and r2.band_names == ("a", "b")
