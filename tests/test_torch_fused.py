"""PyTorch port vs the JAX package, on the CPU: the plain versions of the
fused elementwise kernels (``fused_spectral_indices``,
``fused_calibrate_stretch``) against the Pallas functions in interpret
mode and against the stage-1 f32 path; and forests of more than 16
classes, which the forest kernel now takes. Inputs come from numpy with a
seed; bounds are stated beside each assert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.core.config import CalibrationConfig
from rs_image_segmentation_tpu.models import forest as jforest
from rs_image_segmentation_tpu.ops.pallas_kernels import (
    fused_calibrate_stretch, fused_spectral_indices)
from rs_image_segmentation_tpu.pipeline import preprocess as jpre
from rs_image_segmentation_tpu.pipeline import turbo as jturbo
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import kernels
from rs_image_segmentation_tpu_torch.tools.fixtures import synthetic_scenes

CAL = CalibrationConfig()
GAINS = np.asarray(CAL.gains, np.float32)
BIASES = np.asarray(CAL.biases, np.float32)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """This module's small tensors gain nothing from eight intra-op
    threads; other test workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_indices_plain_matches_pallas():
    bands = np.random.default_rng(123).random((7, 60, 70)).astype(
        np.float32)
    ref = np.asarray(fused_spectral_indices(jnp.asarray(bands),
                                            interpret=True))
    got = kernels.fused_spectral_indices_plain(torch.from_numpy(bands))
    assert got.shape == ref.shape == (7, 60, 70)
    for i, name in enumerate(kernels.INDEX_ORDER):
        diff = np.abs(ref[i] - got[i].numpy())
        # the Pallas test's bounds (tests/test_pallas.py): EVI's guarded
        # denominator cancels, and XLA fuses its multiply-adds
        assert np.median(diff) < 1e-6, name
        assert diff.max() < 1e-3, name


def test_indices_batch_and_wrapper():
    bands = torch.from_numpy(np.random.default_rng(1).random(
        (2, 6, 20, 30)).astype(np.float32))
    got = kernels.fused_spectral_indices(bands)
    assert got.shape == (2, 7, 20, 30)
    for b in range(2):
        assert torch.equal(got[b], kernels.fused_spectral_indices_plain(
            bands[b]))


def test_calibrate_stretch_plain_matches_pallas():
    bands = np.random.default_rng(42).integers(0, 256, (7, 40, 50)).astype(
        np.float32)
    ref = np.asarray(fused_calibrate_stretch(jnp.asarray(bands), GAINS,
                                             BIASES, interpret=True))
    got = kernels.fused_calibrate_stretch_plain(torch.from_numpy(bands),
                                                GAINS, BIASES).numpy()
    # the Pallas test's bound: the Pallas kernel scales by 255 / (mx - mn)
    # where the stage-1 path divides (cal - mn) * 255 by (mx - mn)
    assert np.abs(ref - got).max() < 1e-2


def _dn_scenes():
    """Scene 0 of a seeded batch as 16-bit DNs (DN * 257 plus seeded noise
    in [0, 257)) and as float DNs."""
    scene = synthetic_scenes(1, 96, 112, seed=4)[0]
    rng = np.random.default_rng(9)
    u16 = (scene.astype(np.uint16) * 257
           + rng.integers(0, 257, scene.shape).astype(np.uint16))
    f32 = scene.astype(np.float32) * 1.37 + rng.random(scene.shape,
                                                       dtype=np.float32)
    return {"uint16": u16, "float32": f32}


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
@pytest.mark.parametrize("negative_gain", [False, True],
                         ids=["gains", "negative_gain"])
def test_calibrate_stretch_truncated_matches_jax_f32_route(dtype,
                                                           negative_gain):
    dn = _dn_scenes()[dtype]
    gains = GAINS * (np.where(np.arange(7) == 2, -1, 1).astype(np.float32)
                     if negative_gain else 1)
    ref = np.asarray(jpre.preprocess_bands_f32(
        jnp.asarray(dn), jnp.asarray(gains), jnp.asarray(BIASES)))
    got = kernels.fused_calibrate_stretch(torch.from_numpy(dn), gains,
                                          BIASES).to(torch.uint8).numpy()
    diff = np.abs(ref.astype(np.int32) - got.astype(np.int32))
    share = float(np.mean(diff == 0))
    # XLA:CPU fuses DN * gain + bias into one FMA, PyTorch rounds the
    # product: a calibrated value an ulp apart truncates one level lower
    # where the stretch lands within an ulp of an integer (measured: all
    # equal on float DNs, 99.993 % on 16-bit DNs at 7 x 96 x 112)
    assert share >= 0.999, share
    assert diff.max() <= 1


def test_calibrate_stretch_flat_band():
    """A flat band divides by zero on both sides: the same non-finite
    values, then the same uint8."""
    dn = _dn_scenes()["uint16"].copy()
    dn[2] = 777
    f32 = kernels.fused_calibrate_stretch(torch.from_numpy(dn), GAINS,
                                          BIASES)
    cal = dn[2].astype(np.float32) * GAINS[2] + BIASES[2]
    with np.errstate(invalid="ignore"):
        ref_f32 = (cal - cal.min()) * np.float32(255.0) / (cal.max()
                                                          - cal.min())
    assert np.isnan(ref_f32).all() and torch.isnan(f32[2]).all()
    ref = np.asarray(jpre.preprocess_bands_f32(
        jnp.asarray(dn), jnp.asarray(GAINS), jnp.asarray(BIASES)))
    np.testing.assert_array_equal(f32[2].to(torch.uint8).numpy(), ref[2])


def test_calibrate_stretch_wrapper_on_cpu_is_the_plain_version():
    dn = torch.from_numpy(_dn_scenes()["uint16"])
    assert torch.equal(
        kernels.fused_calibrate_stretch(dn, GAINS, BIASES),
        kernels.fused_calibrate_stretch_plain(dn, GAINS, BIASES))


def test_forest_of_20_classes_matches_jax():
    """20 seeded labels: the plain forest labels equal the JAX package's
    ``gemm_labels_cm`` (the CUDA kernel no longer caps the class count)."""
    rng = np.random.default_rng(20)
    x = rng.random((200, 19)).astype(np.float32)
    y = np.concatenate([np.arange(20), rng.integers(0, 20, 180)])
    forest, _ = tforest.fit_random_forest(x, y, n_estimators=10, seed=3)
    gf = tforest._gemm_for(forest, 19)
    assert gf.leaf_dist.shape[1] == 20
    pix = rng.random((19, 2048)).astype(np.float32)
    got = kernels.forest_labels(gf, torch.from_numpy(pix)).numpy()
    jgf = jforest.GemmForest(*(jnp.asarray(t.numpy()) for t in gf))
    ref = np.asarray(jturbo.gemm_labels_cm(jgf, jnp.asarray(pix)))
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) > 16
