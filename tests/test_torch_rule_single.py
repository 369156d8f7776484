"""PyTorch port vs the JAX package, on the CPU: the single-scene rule graph
(``pipeline.classify.rule_based_classify``), the single-scene rule program
``pipeline.turbo.rule_based_scenes_turbo`` and the uncapped large-scene
route ``pipeline.large_scene.rule_based_large_scene``, including a noise
scene that the batched program flags for its id cap. Inputs come from
numpy with a seed; maps are compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import RuleBasedConfig
from rs_image_segmentation_tpu.pipeline import classify as jclassify
from rs_image_segmentation_tpu.pipeline import large_scene as jlarge
from rs_image_segmentation_tpu.pipeline import turbo as jturbo
from rs_image_segmentation_tpu_torch.core import config as tconfig
from rs_image_segmentation_tpu_torch.pipeline import classify as tclassify
from rs_image_segmentation_tpu_torch.pipeline import large_scene as tlarge
from rs_image_segmentation_tpu_torch.pipeline import turbo as tturbo
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    stretch_stats_batch, synthetic_scenes)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _stretch(scene, lut):
    """The stage-1 artifact of a raw (7, H, W) scene: each band through
    its stretch LUT."""
    return np.stack([lut[c][scene[c]] for c in range(scene.shape[0])])


@pytest.fixture(scope="module")
def scenes():
    """2 synthetic 7 x 96 x 112 scenes, their LUTs, and the JAX
    single-scene program's maps."""
    raw = synthetic_scenes(2, 96, 112, seed=31)
    luts = stretch_stats_batch(raw)[0]
    ref = [np.asarray(jturbo.rule_based_scenes_turbo(jnp.asarray(s),
                                                     jnp.asarray(lt)))
           for s, lt in zip(raw, luts)]
    return raw, luts, ref


def _index_planes():
    """The index planes of the JAX package's cc_impl test (120 x 130): a
    Gaussian-smoothed random field, scaled and shifted per index."""
    import cv2
    base = np.random.default_rng(42).standard_normal((120, 130))
    smooth = cv2.GaussianBlur(base.astype(np.float32), (21, 21), 5)
    return (np.clip(smooth * 2.0, -1, 1),
            np.clip(-smooth * 1.5 + 0.1, -1, 1),
            np.clip(-smooth * 1.8 + 0.05, -1, 1),
            np.clip(np.roll(smooth, 31, axis=1) * 1.7, -1, 1))


@pytest.mark.parametrize("cc_impl", ["auto", "xla"])
def test_rule_based_classify_matches_jax(cc_impl):
    planes = _index_planes()
    ref = np.asarray(jclassify.rule_based_classify(
        *(jnp.asarray(p) for p in planes), RuleBasedConfig(), cc_impl="xla"))
    got = tclassify.rule_based_classify(
        *(torch.from_numpy(p) for p in planes), tconfig.RuleBasedConfig(),
        cc_impl=cc_impl)
    assert got.dtype == torch.uint8 and got.shape == (120, 130)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) >= 4


def test_rule_masks_and_paint_match_jax():
    planes = _index_planes()
    jp = [jnp.asarray(p) for p in planes]
    tp = [torch.from_numpy(p) for p in planes]
    masks = {}
    for kind in ("vegetation", "water", "builtup"):
        got = tclassify.rule_mask(kind, *tp, cc_impl="xla")
        ref = np.asarray(jclassify.rule_mask(kind, *jp, cc_impl="xla"))
        np.testing.assert_array_equal(got.numpy(), ref)
        masks[kind] = got
    painted = tclassify.paint_rule_masks(masks["vegetation"], masks["water"],
                                         masks["builtup"])
    np.testing.assert_array_equal(painted.numpy(), np.asarray(
        jclassify.paint_rule_masks(*(jnp.asarray(masks[k].numpy()) for k in
                                     ("vegetation", "water", "builtup")))))
    bare = tclassify.bare_rule_mask(painted, tp[0], tp[3], cc_impl="xla")
    np.testing.assert_array_equal(bare.numpy(), np.asarray(
        jclassify.bare_rule_mask(jnp.asarray(painted.numpy()), jp[0], jp[3],
                                 cc_impl="xla")))
    with pytest.raises(ValueError, match="unknown rule mask kind"):
        tclassify.rule_mask("snow", *tp)


@pytest.mark.parametrize("i", [0, 1])
def test_single_scene_program_matches_jax(scenes, i):
    raw, luts, ref = scenes
    got = tturbo.rule_based_scenes_turbo(raw[i], luts[i], device="cpu")
    assert got.shape == (96, 112) and got.dtype == torch.uint8
    # bit-equal: the port's index planes are bit-equal to the JAX
    # program's (test_torch_rule.py), and every later stage is integer or
    # a comparison
    np.testing.assert_array_equal(got.numpy(), ref[i])


def test_single_scene_program_equals_the_batched_one(scenes):
    raw, luts, ref = scenes
    batch = tturbo.rule_based_scenes_turbo_batch(raw, luts, device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(batch[i].numpy(), ref[i])
    assert set(np.unique(ref[0])) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("with_hists", [False, True])
def test_large_scene_route_matches_jax(scenes, with_hists):
    raw, luts, ref = scenes
    arr = _stretch(raw[0], luts[0])
    hists = tlarge.band_histograms_u8(arr) if with_hists else None
    if with_hists:
        assert hists.dtype == np.int64 and hists.shape == (7, 256)
        np.testing.assert_array_equal(hists, jlarge.band_histograms_u8(arr))
    got = tlarge.rule_based_large_scene(arr, hists=hists, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jlarge.rule_based_large_scene(
        arr, hists=hists))
    np.testing.assert_array_equal(got, ref[0])      # == the turbo program


def test_a_capped_noise_scene_reroutes_to_the_uncapped_route():
    """Uniform noise gives masks with more row runs than the 32768-id cap:
    the batched program flags the scene, and the uncapped route, which
    labels whole masks, matches the JAX one."""
    raw = np.random.default_rng(5).integers(0, 256, (1, 7, 480, 480),
                                            dtype=np.uint8)
    luts = stretch_stats_batch(raw)[0]
    _, overflow = tturbo.rule_based_scenes_turbo_batch(
        raw, luts, return_overflow=True, device="cpu")
    assert overflow.tolist() == [True]
    arr = _stretch(raw[0], luts[0])
    got = tlarge.rule_based_large_scene(arr, device="cpu")
    np.testing.assert_array_equal(got, jlarge.rule_based_large_scene(arr))
    single = tturbo.rule_based_scenes_turbo(raw[0], luts[0], device="cpu")
    np.testing.assert_array_equal(single.numpy(), got)


def test_the_single_scene_program_on_cpu_tensors_launches_nothing(scenes):
    from rs_image_segmentation_tpu_torch.ops import kernels
    raw, luts, _ = scenes
    counts = [k.launches for k in (kernels.cc_labels, kernels.ccmin_prop,
                                   kernels.hist_dense, kernels.keep_lut,
                                   kernels.lut_hist)]
    tturbo.rule_based_scenes_turbo(raw[0], luts[0], device="cpu")
    assert [k.launches for k in (kernels.cc_labels, kernels.ccmin_prop,
                                 kernels.hist_dense, kernels.keep_lut,
                                 kernels.lut_hist)] == counts


def test_new_entry_points_do_not_fall_back_to_the_cpu(scenes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    raw, luts, _ = scenes
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tturbo.rule_based_scenes_turbo(raw[0], luts[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlarge.rule_based_large_scene(_stretch(raw[0], luts[0]))
