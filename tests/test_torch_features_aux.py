"""PyTorch port's ``ops.features_aux`` and ``pipeline.visualize`` against
the JAX package's, on the CPU. Inputs are made from numpy seeds and given
to the port as arrays and as tensors; the JAX package's own tests of
these functions (``tests/test_tools_and_io.py``) are run against the
port too."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.ops import features_aux as jaux
from rs_image_segmentation_tpu_torch.ops import features_aux as taux
from rs_image_segmentation_tpu_torch.pipeline import visualize as tvis

H, W = 12, 14
INDEX_KEYS = ["ndwi", "mndwi", "ndvi", "evi", "ndbi", "bsi"]


def _planes(seed=0, keys=INDEX_KEYS):
    rng = np.random.default_rng(seed)
    return {k: rng.random((H, W)).astype(np.float32) for k in keys}


def _as(kind, x):
    return torch.from_numpy(x) if kind == "tensor" else x


def _dev(kind):
    """Arrays name the CPU; CPU tensors keep their own device."""
    return None if kind == "tensor" else "cpu"


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_feature_selection_by_variance_matches_jax(kind):
    rng = np.random.default_rng(1)
    keep = rng.random((10, 10)).astype(np.float32)
    # variance 0.0099 and 0.0101: either side of the 0.01 threshold
    near_lo = (np.arange(100).reshape(10, 10) % 2 * 0.199).astype(
        np.float32)
    near_hi = (np.arange(100).reshape(10, 10) % 2 * 0.201).astype(
        np.float32)
    feats = {"keep": keep, "flat": np.full((10, 10), 0.5, np.float32),
             "near_lo": near_lo, "near_hi": near_hi,
             "lst": [keep, np.zeros((10, 10), np.float32)],
             "all_flat": [np.zeros((10, 10), np.float32)],
             "nested": {"keep": keep, "drop": np.zeros((10, 10),
                                                       np.float32)},
             "vec": np.ones(10), "scalar": 3.0}
    port_in = {k: ([_as(kind, x) for x in v] if isinstance(v, list) else
                   {kk: _as(kind, x) for kk, x in v.items()}
                   if isinstance(v, dict) else
                   _as(kind, v) if isinstance(v, np.ndarray) else v)
               for k, v in feats.items()}
    got = taux.feature_selection_by_variance(port_in, 0.01,
                                             device=_dev(kind))
    ref = jaux.feature_selection_by_variance(feats, 0.01)
    assert list(got) == list(ref)
    assert len(got["lst"]) == len(ref["lst"]) == 1
    assert list(got["nested"]) == list(ref["nested"]) == ["keep"]
    assert got["keep"] is port_in["keep"]
    assert "near_hi" in got and "near_lo" not in got


def test_feature_selection_by_variance_flat_and_nested():
    """tests/test_tools_and_io.py::test_feature_selection_by_variance."""
    rng = np.random.default_rng(42)
    flat = {"keep": rng.random((10, 10)).astype(np.float32),
            "drop": np.full((10, 10), 0.5, np.float32),
            "nested": {"keep": rng.random((10, 10)).astype(np.float32),
                       "drop": np.zeros((10, 10), np.float32)}}
    out = taux.feature_selection_by_variance(flat, 0.01, device="cpu")
    assert "keep" in out and "drop" not in out
    assert "drop" not in out.get("nested", {})


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("method,weights", [("weighted_sum", None),
                                            ("weighted_sum", [0.7, 0.3]),
                                            ("concat", None)])
def test_feature_fusion_matches_jax(kind, method, weights):
    f = _planes(2)
    got = taux.feature_fusion_for_segmentation(
        [_as(kind, f["ndvi"]), _as(kind, f["ndwi"])], weights, method,
        device=_dev(kind))
    ref = jaux.feature_fusion_for_segmentation([f["ndvi"], f["ndwi"]],
                                               weights, method)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    # products and one sum per pixel, rounded the same way on both sides
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_feature_fusion_unknown_method():
    f = _planes(2)
    with pytest.raises(ValueError, match="unknown fusion method"):
        taux.feature_fusion_for_segmentation([f["ndvi"]], method="max",
                                             device="cpu")
    with pytest.raises(ValueError, match="unknown fusion method"):
        jaux.feature_fusion_for_segmentation([f["ndvi"]], method="max")


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_prepare_features_for_segmentation_matches_jax(kind):
    f = _planes(3)
    keys = ["ndvi", "ndwi", "missing", "bsi"]
    got = taux.prepare_features_for_segmentation(
        {k: _as(kind, v) for k, v in f.items()}, keys, device=_dev(kind))
    ref = np.asarray(jaux.prepare_features_for_segmentation(f, keys))
    assert tuple(got.shape) == ref.shape == (H, W, 3)
    # the percentiles agree; the clip-and-scale divides once
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="none of the requested"):
        taux.prepare_features_for_segmentation(f, ["missing"], device="cpu")
    with pytest.raises(ValueError, match="none of the requested"):
        jaux.prepare_features_for_segmentation(f, ["missing"])


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_hierarchical_feature_fusion_matches_jax(kind):
    f = _planes(4)
    got = taux.hierarchical_feature_fusion({k: _as(kind, v)
                                            for k, v in f.items()},
                                           device=_dev(kind))
    ref = np.asarray(jaux.hierarchical_feature_fusion(f))
    assert tuple(got.shape) == (H, W, 6)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("sources,target", [((1, 2), 1), ((2, 3), 5)])
def test_semantic_merge_water_classes_matches_jax(kind, sources, target):
    seg = np.random.default_rng(5).integers(0, 5, (H, W)).astype(np.int32)
    got = taux.semantic_merge_water_classes(_as(kind, seg), sources, target,
                                            device=_dev(kind))
    ref = np.asarray(jaux.semantic_merge_water_classes(jnp.asarray(seg),
                                                       sources, target))
    np.testing.assert_array_equal(got.numpy(), ref)
    small = taux.semantic_merge_water_classes(np.array([[1, 2], [3, 2]]),
                                              device="cpu")
    assert small.tolist() == [[1, 1], [3, 1]]


def _importance_inputs():
    f = _planes(6)
    fused = np.stack([f[k] for k in INDEX_KEYS], axis=-1)
    labels = np.zeros((H, W), np.int64)
    labels[:, : W // 2] = 1
    labels[:, W // 2:] = 2
    labels[0, :] = 0                        # unlabelled pixels are skipped
    return fused, labels


def test_feature_importance_matches_jax_with_sklearn():
    pytest.importorskip("sklearn")
    fused, labels = _importance_inputs()
    got = taux.evaluate_feature_importance_for_classes(
        torch.from_numpy(fused), torch.from_numpy(labels), n_estimators=5)
    ref = jaux.evaluate_feature_importance_for_classes(fused, labels,
                                                       n_estimators=5)
    # the same sklearn fit on the same rows
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (6,) and abs(got.sum() - 1.0) < 1e-6


def test_feature_importance_matches_jax_without_sklearn(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.startswith("sklearn"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    fused, labels = _importance_inputs()
    got = taux.evaluate_feature_importance_for_classes(fused, labels,
                                                       n_estimators=5)
    ref = jaux.evaluate_feature_importance_for_classes(fused, labels,
                                                       n_estimators=5)
    # both count splits of the same NumPy CART trainer from one seed
    np.testing.assert_array_equal(got, ref)
    assert abs(got.sum() - 1.0) < 1e-12


NEED_A_DEVICE = {
    "feature_selection_by_variance":
        lambda f: taux.feature_selection_by_variance(f),
    "feature_fusion_for_segmentation":
        lambda f: taux.feature_fusion_for_segmentation([f["ndvi"]]),
    "prepare_features_for_segmentation":
        lambda f: taux.prepare_features_for_segmentation(f, ["ndvi"]),
    "hierarchical_feature_fusion":
        lambda f: taux.hierarchical_feature_fusion(f),
    "semantic_merge_water_classes":
        lambda f: taux.semantic_merge_water_classes(f["ndvi"] > 0.5),
}


@pytest.mark.parametrize("name", sorted(NEED_A_DEVICE))
def test_array_inputs_need_a_device(monkeypatch, name):
    """Arrays with no device run on CUDA, so without CUDA they raise; a
    named device or a tensor's own device needs no CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = _planes(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NEED_A_DEVICE[name](f)
    got = NEED_A_DEVICE[name]({k: torch.from_numpy(v) for k, v in f.items()})
    assert isinstance(got, (dict, torch.Tensor))


# ---------------------------------------------------------------- visualize

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_visualize_combined_indices(tmp_path, rng, kind):
    """tests/test_tools_and_io.py::test_visualize_combined_indices."""
    h = w = 16
    feats = {"all_extracted_features_dict_bsi": rng.random((h, w)),
             "ndvi": rng.random((h, w)),
             "mndwi": rng.random((h, w))}
    feats = {k: _as(kind, v) for k, v in feats.items()}
    p = str(tmp_path / "combined.png")
    assert tvis.visualize_combined_indices(feats, p) == p
    assert os.path.exists(p)


def test_visualize_combined_grayscale_fallback(tmp_path, rng):
    """tests/test_tools_and_io.py::test_visualize_combined_grayscale_fallback."""
    feats = {"ndvi": rng.random((8, 8))}
    p = str(tmp_path / "gray.png")
    assert tvis.visualize_combined_indices(feats, p) == p
    assert os.path.exists(p)


def test_visualize_combined_nothing_to_draw(tmp_path):
    p = str(tmp_path / "sub" / "none.png")
    assert tvis.visualize_combined_indices({"vec": np.ones(4)}, p) is None
    assert not os.path.exists(p) and os.path.isdir(tmp_path / "sub")


def test_visualize_selected_features(tmp_path):
    f = _planes(7)
    feats = {"ndvi": f["ndvi"], "ndwi": torch.from_numpy(f["ndwi"]),
             "vec": np.ones(3)}
    p = str(tmp_path / "sel" / "grid.png")
    assert tvis.visualize_selected_features(feats, ["ndvi", "ndwi", "vec",
                                                    "missing"], p) == p
    assert os.path.exists(p)
    assert tvis.visualize_selected_features(feats, ["vec"], p + "x") is None
