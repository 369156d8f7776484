"""PyTorch port vs the JAX package, end to end on the CPU: the 19-channel
stack, forest labels over the JAX stack, and ``classify_scenes_turbo``;
plus the port's import and device rules."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import FeatureStageConfig
from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.pipeline import turbo as jturbo
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.pipeline import turbo as tturbo
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    rule_labels, stretch_stats_batch, synthetic_scenes)

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = FeatureStageConfig()
CHANNELS = ["ndwi", "mndwi", "ndvi", "evi", "ndbi", "bsi", "pc1"]
CHANNELS += [f"ctx_{c}" for c in CHANNELS] + [
    "glcm_contrast", "glcm_homogeneity", "grad5", "std5", "sobel"]

# per-channel (atol, rtol) where 1e-5 absolute does not hold, with why
LOOSE = {
    # EVI's denominator nir + 6 red - 7.5 blue + 1 cancels; XLA:CPU fuses
    # its multiply-adds into FMAs, PyTorch rounds each product, and the
    # ~1-ulp difference of terms of size ~8 is divided by a denominator
    # the guard only bounds below by 1e-3
    "evi": (1e-3, 0.0),
    # sqrt(max(E[x^2] - E[x]^2, 0)) over nearly flat 5x5 windows: the box
    # sums differ by an ulp (FMA contraction as above), the difference
    # cancels to ~0 and the square root turns one ulp of 1.0 (1.2e-7)
    # into up to sqrt(1.2e-7) = 3.5e-4
    "std5": (3.5e-4, 0.0),
    # an f32 sum of 32x32 terms summed in another order than XLA's;
    # contrast reaches ~10 here, where an ulp is ~1e-6
    "glcm_contrast": (1e-5, 2e-6),
}


def _scene_batch(b, h, w, seed):
    scenes = synthetic_scenes(b, h, w, seed=seed)
    return (scenes, *stretch_stats_batch(scenes))


def _jax_stack(scene, lut):
    return np.array(jturbo.hierarchical_stack_turbo_cm(
        jnp.asarray(scene), jnp.asarray(lut), CFG))


@pytest.mark.parametrize("shape", [(2, 96, 96), (1, 50, 77)])
def test_stack_channels_match_jax(shape):
    scenes, luts, _, _ = _scene_batch(*shape, seed=11)
    got = tturbo.hierarchical_stack_turbo_cm(scenes, luts, CFG,
                                             device="cpu").numpy()
    assert got.shape == (shape[0], 19) + shape[1:] and got.dtype == np.float32
    for b in range(shape[0]):
        ref = _jax_stack(scenes[b], luts[b])
        for k, name in enumerate(CHANNELS):
            atol, rtol = LOOSE.get(name, (1e-5, 0.0))
            np.testing.assert_allclose(got[b, k], ref[k], atol=atol,
                                       rtol=rtol, err_msg=name)


def _forest_from_rules(stack, n_samples=60, n_estimators=20):
    """A JAX-trained forest on rule labels of the JAX stack (4 classes by
    NDVI and NDWI), and its port twin carried across as numpy."""
    rng = np.random.default_rng(3)
    flat = stack.reshape(19, -1)
    pick = rng.choice(flat.shape[1], n_samples, replace=False)
    forest, _ = jforest.fit_random_forest(flat[:, pick].T,
                                          rule_labels(stack, pick),
                                          n_estimators=n_estimators, seed=0)
    gf = jforest._gemm_for(forest, 19)
    tgf = tforest.gemm_forest_from_numpy(
        {k: np.asarray(v) for k, v in gf._asdict().items()})
    return gf, tgf


def test_labels_bit_equal_on_the_jax_stack():
    scenes, luts, _, _ = _scene_batch(1, 96, 96, seed=12)
    stack = _jax_stack(scenes[0], luts[0])
    gf, tgf = _forest_from_rules(stack)
    x = stack.reshape(19, -1)
    ref = np.asarray(jturbo.gemm_labels_cm(gf, jnp.asarray(x), 4096))
    got = kernels.forest_labels(tgf, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(ref)) > 1


def test_classify_scenes_turbo_agrees_with_jax():
    scenes, luts, params, hists = _scene_batch(2, 96, 96, seed=13)
    gf, tgf = _forest_from_rules(_jax_stack(scenes[0], luts[0]))
    # the JAX program on the CPU ignores the stretch params (its preamble
    # takes the table route there), so one reference serves all variants
    ref = np.asarray(jturbo.classify_scenes_turbo(
        jnp.asarray(scenes), jnp.asarray(luts), gf, CFG))
    variants = [dict(), dict(stretch_params=params),
                dict(stretch_params=params, stretch_hists=hists)]
    for kw in variants:
        got = tturbo.classify_scenes_turbo(scenes, luts, tgf, CFG,
                                           device="cpu", **kw)
        assert got.shape == (2, 96, 96) and got.dtype == torch.uint8
        agreement = (got.numpy() == ref).mean()
        assert agreement >= 0.999, (list(kw), agreement)
    assert len(np.unique(ref)) > 1


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    scenes, luts, _, _ = _scene_batch(1, 50, 77, seed=14)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tturbo.hierarchical_stack_turbo_cm(scenes[0], luts[0], CFG)
    flat, _ = tforest.fit_random_forest(
        np.random.default_rng(0).random((20, 19)), np.arange(20) % 3,
        n_estimators=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tturbo.classify_scenes_turbo(scenes, luts,
                                     tforest._gemm_for(flat, 19), CFG)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "rs_image_segmentation_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib"), (path, mod)
            assert top != "rs_image_segmentation_tpu", (path, mod)
