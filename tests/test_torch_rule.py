"""PyTorch port vs the JAX package, on the CPU: the batched rule program
``rule_based_scenes_turbo_batch`` end to end, and the ops it adds
(``threshold_binary``, ellipse elements, closing and opening). Inputs come
from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import (
    FeatureStageConfig, RuleBasedConfig)
from rs_image_segmentation_tpu.ops import morphology as jmorph
from rs_image_segmentation_tpu.ops import threshold as jthr
from rs_image_segmentation_tpu.pipeline import turbo as jturbo
from rs_image_segmentation_tpu_torch.core import config as tconfig
from rs_image_segmentation_tpu_torch.ops import morphology as tmorph
from rs_image_segmentation_tpu_torch.ops import threshold as tthr
from rs_image_segmentation_tpu_torch.pipeline import turbo as tturbo
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    stretch_stats_batch, synthetic_scenes)

CFG = FeatureStageConfig()


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def batch():
    """2 synthetic 7 x 96 x 112 scenes, their stretch stats, and the JAX
    program's labels and overflow flags. On the CPU the JAX program takes
    its uncapped XLA route for min-area removal, so agreement with the
    port's capped kernels also shows that the cap does not engage."""
    scenes = synthetic_scenes(2, 96, 112, seed=21)
    luts, params, hists = stretch_stats_batch(scenes)
    ref, ref_ov = jturbo.rule_based_scenes_turbo_batch(
        jnp.asarray(scenes), jnp.asarray(luts), CFG, return_overflow=True)
    return scenes, luts, params, hists, np.asarray(ref), np.asarray(ref_ov)


def test_threshold_binary_matches():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3, 40, 50)).astype(np.float32)
    x[0, :5] = np.nan
    x[1, :3] = 0.25                       # exactly at the threshold
    x[2, 0, :4] = [np.inf, -np.inf, np.float32(0.05), -0.1]
    for threshold, above in [(0.25, True), (0.05, True), (0.2, False),
                             (-0.1, False), (0.0, True)]:
        got = tthr.threshold_binary(torch.from_numpy(x), threshold, above)
        ref = np.asarray(jthr.threshold_binary(jnp.asarray(x), threshold,
                                               above))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_ellipse_element_matches(ksize):
    assert tmorph.ellipse_element(ksize) == jmorph.ellipse_element(ksize)
    assert tmorph._ellipse_spans(ksize) == jmorph._ellipse_spans(ksize)


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("op", ["closing", "opening", "erode", "dilate"])
def test_ellipse_morphology_matches(op, ksize):
    rng = np.random.default_rng(2)
    masks = (rng.random((3, 40, 53)) < 0.5).astype(np.uint8)
    levels = rng.random((2, 31, 47)).astype(np.float32)
    # grey levels through the two primitives, the rule path's uint8 masks
    # through all four
    for x in (masks, levels) if op in ("erode", "dilate") else (masks,):
        got = getattr(tmorph, op)(torch.from_numpy(x), ksize, shape="ellipse")
        ref = np.asarray(getattr(jmorph, op)(jnp.asarray(x), ksize,
                                             shape="ellipse"))
        assert got.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(got.numpy(), ref)


def test_rect_morphology_keeps_its_results():
    x = (np.random.default_rng(4).random((2, 30, 41)) * 255).astype(np.uint8)
    for op in ("closing", "opening"):
        got = getattr(tmorph, op)(torch.from_numpy(x), 5)
        ref = np.asarray(getattr(jmorph, op)(jnp.asarray(x), 5))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_rule_configs_match():
    assert (tconfig.RuleBasedConfig().__dict__
            == RuleBasedConfig().__dict__)


@pytest.mark.parametrize("stats", ["none", "hists", "params_and_hists"])
def test_rule_program_agrees_with_jax(batch, stats):
    # host histograms alone skip the card's count; params are not read
    scenes, luts, params, hists, ref, ref_ov = batch
    kw = {"none": {}, "hists": dict(stretch_hists=hists),
          "params_and_hists": dict(stretch_params=params,
                                   stretch_hists=hists)}[stats]
    got, ov = tturbo.rule_based_scenes_turbo_batch(
        scenes, luts, CFG, return_overflow=True, device="cpu", **kw)
    assert got.shape == (2, 96, 112) and got.dtype == torch.uint8
    assert ov.tolist() == [False, False] and ref_ov.tolist() == [False, False]
    # bit-equal: the index planes below come out bit-equal, and every
    # stage after them is integer or a comparison
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref)) == {0, 1, 2, 3, 4}


def test_rule_stages_after_the_indices_are_bit_equal(batch):
    """The port's thresholds, morphology, min-area removal and paint on the
    JAX program's own index planes reproduce its labels exactly."""
    scenes, luts, _, _, ref, _ = batch
    nd = jax.vmap(lambda s, lt: jturbo._rule_front(s, lt, CFG))(
        jnp.asarray(scenes), jnp.asarray(luts))
    planes = [torch.from_numpy(np.array(p)) for p in nd]
    got, ov = tturbo._rule_labels(*planes, tconfig.RuleBasedConfig())
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not ov.any()
    ported = tturbo._rule_front(torch.from_numpy(scenes),
                                torch.from_numpy(luts), tconfig
                                .FeatureStageConfig())
    # The percentile interpolation v_lo*(1-frac) + v_hi*frac is a
    # multiply-add that XLA:CPU may fuse into an FMA where PyTorch rounds
    # twice (ROADMAP queue 3); on these planes it makes no difference.
    for p, q in zip(ported, planes):
        np.testing.assert_array_equal(p.numpy(), q.numpy())


def test_rule_program_does_not_fall_back_to_the_cpu(batch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    scenes, luts = batch[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tturbo.rule_based_scenes_turbo_batch(scenes, luts, CFG)
