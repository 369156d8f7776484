"""PyTorch port vs the JAX package: host stretch tables, the preamble
(``lut_hist``) and the histogram primitives. Every result here is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import CalibrationConfig
from rs_image_segmentation_tpu.ops.pallas_kernels import lut_hist_pallas
from rs_image_segmentation_tpu.pipeline import preprocess as jpre
from rs_image_segmentation_tpu.pipeline import turbo as jturbo
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.pipeline import preprocess as tpre
from rs_image_segmentation_tpu_torch.pipeline import turbo as tturbo
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    FULL_RANGE_BAND, synthetic_scenes)

CAL = CalibrationConfig()
GAINS, BIASES = np.asarray(CAL.gains), np.asarray(CAL.biases)


def _scenes():
    """Two smoothed 96x96 scenes and one ragged 50x77 scene."""
    return list(synthetic_scenes(2, 96, 96, seed=5)) + [
        synthetic_scenes(1, 50, 77, seed=6)[0]]


def test_calibrated_value_table_bit_equal():
    assert np.array_equal(tpre.calibrated_value_table(GAINS, BIASES),
                          jpre.calibrated_value_table(GAINS, BIASES))


@pytest.mark.parametrize("fn", ["build_stretch_lut", "build_stretch_params",
                                "build_stretch_stats"])
def test_stretch_tables_bit_equal(fn):
    scenes = _scenes()
    # a constant band exercises the mode-0 route for a flat band
    scenes[0][2] = 7
    for scene in scenes:
        got = getattr(tpre, fn)(scene, GAINS, BIASES)
        ref = getattr(jpre, fn)(scene, GAINS, BIASES)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r), fn


def test_fixture_scenes_mix_table_and_fixed_point_bands():
    for scene in _scenes():
        _, sp = tpre.build_stretch_params(scene, GAINS, BIASES)
        assert sp[FULL_RANGE_BAND, 0] == 0
        assert (np.delete(sp[:, 0], FULL_RANGE_BAND) == 1).all()


def _lut_inputs(scene):
    lut, sp, hist = tpre.build_stretch_stats(scene, GAINS, BIASES)
    return lut.astype(np.uint8), sp, hist


@pytest.mark.parametrize("out_u8", [False, True])
def test_lut_hist_plain_matches_pallas_table_and_sp(out_u8):
    for scene in _scenes():
        lut, sp, hist = _lut_inputs(scene)
        # the port's table alone against both of the JAX kernel's routes
        st, h = kernels.lut_hist(torch.from_numpy(scene),
                                 torch.from_numpy(lut), out_u8=out_u8)
        ref_st, ref_h = lut_hist_pallas(jnp.asarray(scene), jnp.asarray(lut),
                                        interpret=True, out_u8=out_u8)
        ref_sp, ref_hs = lut_hist_pallas(jnp.asarray(scene), jnp.asarray(lut),
                                         interpret=True, out_u8=out_u8,
                                         sp=jnp.asarray(sp))
        assert st.dtype == (torch.uint8 if out_u8 else torch.float32)
        assert np.array_equal(st.numpy(), np.asarray(ref_st))
        assert np.array_equal(st.numpy(), np.asarray(ref_sp))
        assert np.array_equal(h.numpy(), np.asarray(ref_h))
        assert np.array_equal(h.numpy(), hist)
        assert np.array_equal(h.numpy(), np.asarray(ref_hs))


def test_lut_hist_plain_matches_pallas_skip_hist_batched():
    scenes = np.stack(_scenes()[:2])
    luts, sps = zip(*[_lut_inputs(s)[:2] for s in scenes])
    got = kernels.lut_hist(torch.from_numpy(scenes),
                           torch.from_numpy(np.stack(luts)), skip_hist=True)
    assert got.shape == scenes.shape
    for b in range(2):
        ref = lut_hist_pallas(jnp.asarray(scenes[b]), jnp.asarray(luts[b]),
                              interpret=True, sp=jnp.asarray(sps[b]),
                              skip_hist=True)
        assert np.array_equal(got[b].numpy(), np.asarray(ref))


def test_lut_hist_random_tables_and_argument_checks(rng):
    scene = rng.integers(0, 256, (3, 33, 47)).astype(np.uint8)
    lut = rng.integers(0, 256, (3, 256)).astype(np.uint8)
    st, hist = kernels.lut_hist(torch.from_numpy(scene),
                                torch.from_numpy(lut))
    ref_st, ref_h = lut_hist_pallas(jnp.asarray(scene), jnp.asarray(lut),
                                    interpret=True)
    assert np.array_equal(st.numpy(), np.asarray(ref_st))
    assert np.array_equal(hist.numpy(), np.asarray(ref_h))
    # skip_hist needs nothing else: the stretched scene alone
    alone = kernels.lut_hist(torch.from_numpy(scene), torch.from_numpy(lut),
                             skip_hist=True)
    assert isinstance(alone, torch.Tensor)
    assert np.array_equal(alone.numpy(), np.asarray(ref_st))
    with pytest.raises(ValueError, match="lut_u8"):
        kernels.lut_hist(torch.from_numpy(scene),
                         torch.from_numpy(lut[:2]))


def test_apply_u8_lut_and_histogram256_exact(rng):
    planes = rng.integers(0, 256, (7, 33, 47)).astype(np.uint8)
    lut = rng.integers(0, 256, (7, 256)).astype(np.uint8)
    got = tturbo.apply_u8_lut(torch.from_numpy(planes), torch.from_numpy(lut))
    ref = np.asarray(jturbo.apply_u8_lut_mxu(jnp.asarray(planes),
                                             jnp.asarray(lut)))
    assert np.array_equal(got.numpy(), ref)
    hist = tturbo.histogram256(torch.from_numpy(planes))
    assert hist.dtype == torch.int32
    assert np.array_equal(hist.numpy(),
                          np.asarray(jturbo.histogram256(jnp.asarray(planes))))


def test_percentiles_from_counts_exact(rng):
    vals = rng.integers(0, 256, (3, 4001)).astype(np.uint8)
    counts = np.stack([np.bincount(v, minlength=256) for v in vals]
                      ).astype(np.int32)
    values = np.sort(rng.random((3, 256)).astype(np.float32), axis=1)
    qs = (2.0, 25.0, 50.0, 75.0, 98.0)
    got = tturbo.percentiles_from_counts(torch.from_numpy(counts),
                                         torch.from_numpy(values), qs, 4001)
    ref = jturbo.percentiles_from_counts(jnp.asarray(counts),
                                         jnp.asarray(values), qs, 4001)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(ref))


def _counts_case(name):
    """``(scene, gains, biases)`` of a derivation-from-counts case."""
    scene = synthetic_scenes(1, 64, 80, seed=11)[0]
    gains, biases = GAINS.copy(), BIASES.copy()
    if name == "a constant band":
        scene[2] = 7
    elif name == "a band spanning 0-255":
        scene[FULL_RANGE_BAND] = np.arange(scene[0].size).reshape(
            scene[0].shape) % 256
    elif name == "a single-DN band":
        scene = scene[:, :1, :1].copy()      # every band one pixel
    elif name == "a negative gain":
        gains[1] = -gains[1]
    elif name == "a gain whose A32 passes 2**23":
        scene[4] = 100 + (scene[4] > 128)    # two adjacent DNs: A = 255
    return scene, gains, biases


@pytest.mark.parametrize("name", [
    "seeded tiles", "a constant band", "a band spanning 0-255",
    "a single-DN band", "a negative gain", "a gain whose A32 passes 2**23"])
def test_stretch_stats_from_counts_bit_equal_to_jax(name):
    scene, gains, biases = _counts_case(name)
    counts = np.stack([np.bincount(b.reshape(-1), minlength=256)
                       for b in scene])
    got = tpre.stretch_stats_from_counts(counts, gains, biases)
    ref = jpre.build_stretch_stats(scene, gains, biases)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    # the one table pair the port's programs take
    for g, r in zip(tpre.stretch_tables_from_counts(counts, gains, biases),
                    (ref[0], ref[2])):
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    # the port's host route derives from the same counts
    for g, r in zip(tpre.build_stretch_stats(scene, gains, biases), ref):
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    # int32 counts, as the card's accumulator returns them, give the same
    for g, r in zip(tpre.stretch_stats_from_counts(
            counts.astype(np.int32), gains, biases), ref):
        assert np.array_equal(g, r), name
    sp = got[1]
    if name == "a gain whose A32 passes 2**23":
        assert sp[4, 0] == 0
    if name == "a negative gain":
        assert sp[1, 0] == 1 and sp[1, 1] < 0
    if name in ("a constant band", "a band spanning 0-255"):
        band = 2 if name == "a constant band" else FULL_RANGE_BAND
        assert sp[band, 0] == 0


def test_stretch_stats_from_counts_refuses_an_empty_band():
    counts = np.zeros((2, 256), np.int64)
    counts[0, 9] = 4
    with pytest.raises(ValueError, match="band 1 has no pixels"):
        tpre.stretch_stats_from_counts(counts, GAINS[:2], BIASES[:2])
