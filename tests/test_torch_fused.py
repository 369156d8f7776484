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


# ------------------------------------ the calibrate-stretch kernel's partition

def _lo_of(a, b):
    """NaN-propagating min, as the kernel's ``lo_of`` (and torch.aminmax)."""
    return a if (a < b or a != a) else b


def _hi_of(a, b):
    return a if (a > b or a != a) else b


def _rendered_calibrate_stretch(dn, gains, biases):
    """numpy rendering of ``calibrate_stretch_kernel``: per band, the
    ``STRETCH_CLUSTER`` blocks of ``calibrate_stretch_plan`` each reduce
    the DN extremes of their slice (empty slices give the identities), the
    cluster folds the blocks' extremes, the ends are ``gain * d + bias`` in
    f32 and the stretch ``(cal - mn) * 255 / (mx - mn)``. Returns the f32
    output and each band's per-block extremes."""
    c, h, w = dn.shape
    hw = h * w
    span, _ = kernels.calibrate_stretch_plan(hw, dn.dtype.itemsize)
    is_f = dn.dtype == np.float32
    ident = (np.float32(np.inf), np.float32(-np.inf)) if is_f else (
        np.iinfo(np.int32).max, np.iinfo(np.int32).min)
    g = np.asarray(gains, np.float32)
    b = np.asarray(biases, np.float32)
    out = np.empty((c, hw), np.float32)
    blocks = []
    for band in range(c):
        flat = dn[band].reshape(-1)
        ext = []
        for r in range(kernels.STRETCH_CLUSTER):
            lo, hi = ident
            for v in flat[r * span:(r + 1) * span]:
                v = v if is_f else int(v)
                lo, hi = _lo_of(lo, v), _hi_of(hi, v)
            ext.append((lo, hi))
        dlo, dhi = ident
        for lo, hi in ext:
            dlo, dhi = _lo_of(dlo, lo), _hi_of(dhi, hi)
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            e0 = np.float32(dlo) * g[band] + b[band]
            e1 = np.float32(dhi) * g[band] + b[band]
            mn, mx = _lo_of(e0, e1), _hi_of(e0, e1)
            cal = flat.astype(np.float32) * g[band] + b[band]
            out[band] = (cal - mn) * np.float32(255.0) / (mx - mn)
        blocks.append(ext)
    return out.reshape(c, h, w), blocks


def _stretch_case(name):
    rng = np.random.default_rng(len(name))
    if name == "uint16, 601 x 599 cut to 13 x 37":     # a ragged last slice
        return _dn_scenes()["uint16"][:, :13, :37].copy()
    if name == "f32 with a NaN":
        dn = _dn_scenes()["float32"][:, :20, :30].copy()
        dn[3, 7, 11] = np.nan
        return dn
    if name == "uint16, a flat band":
        dn = _dn_scenes()["uint16"][:, :9, :41].copy()
        dn[2] = 777
        return dn
    if name == "uint8, 5 x 5":                   # most blocks empty
        return rng.integers(0, 256, (7, 5, 5), dtype=np.uint8)
    return rng.random((7, 16, 16), dtype=np.float32) * 1e4   # f32, 16 x 16


@pytest.mark.parametrize("negative_gain", [False, True],
                         ids=["gains", "negative_gains"])
@pytest.mark.parametrize("name", ["uint16, 601 x 599 cut to 13 x 37",
                                  "f32 with a NaN", "uint16, a flat band",
                                  "uint8, 5 x 5", "f32, 16 x 16"])
def test_calibrate_stretch_rendering_matches_plain(name, negative_gain):
    dn = _stretch_case(name)
    gains = GAINS * (np.where(np.arange(7) % 2 == 1, -1, 1).astype(
        np.float32) if negative_gain else 1)
    got, blocks = _rendered_calibrate_stretch(dn, gains, BIASES)
    ref = kernels.fused_calibrate_stretch_plain(torch.from_numpy(dn), gains,
                                                BIASES).numpy()
    np.testing.assert_array_equal(got, ref)
    span, instance = kernels.calibrate_stretch_plan(
        dn.shape[1] * dn.shape[2], dn.dtype.itemsize)
    assert instance == "staged" and span % 4 == 0
    if name == "f32 with a NaN":    # one block's extremes are NaN: the band
        assert sum(np.isnan(lo) for lo, _ in blocks[3]) == 1
        assert np.isnan(ref[3]).all() and np.isfinite(ref[2]).all()
    if name == "uint16, a flat band":
        assert np.isnan(ref[2]).all()


def test_calibrate_stretch_plan_by_shape():
    assert kernels.calibrate_stretch_plan(360000, 2) == (22500, "staged")
    assert kernels.calibrate_stretch_plan(360000, 4) == (22500, "staged")
    assert kernels.calibrate_stretch_plan(601 * 599, 2) == (22500, "staged")
    assert kernels.calibrate_stretch_plan(6000 * 6000, 2) == (
        2250000, "streamed")
    # past STRETCH_STAGE_BYTES a block: 1000 x 1000 f32 is 250 KB a block
    assert kernels.calibrate_stretch_plan(10 ** 6, 4)[1] == "streamed"
    assert kernels.calibrate_stretch_plan(10 ** 6, 1)[1] == "staged"


@pytest.mark.parametrize("how", ["list", "tuple", "f64 array", "f32 array",
                                 "f64 CPU tensor"])
def test_calibrate_stretch_wrapper_takes_host_gains_alike(how):
    """Gains and biases as host sequences, arrays or CPU tensors give the
    same output; the wrapper turns each into the f32 values the kernel
    takes by value."""
    dn = torch.from_numpy(_dn_scenes()["uint16"])
    g64, b64 = np.asarray(CAL.gains), np.asarray(CAL.biases)
    conv = {"list": list, "tuple": tuple, "f64 array": np.asarray,
            "f32 array": lambda v: np.asarray(v, np.float32),
            "f64 CPU tensor": torch.tensor}[how]
    got = kernels.fused_calibrate_stretch(dn, conv(g64), conv(b64))
    ref = kernels.fused_calibrate_stretch_plain(dn, GAINS, BIASES)
    assert torch.equal(got, ref)
    host = kernels._band_values(conv(g64), dn)
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    np.testing.assert_array_equal(host, GAINS)


def test_calibrate_stretch_band_values_on_the_card_and_the_cap():
    """Tensors on another device than the CPU stay there (read by the
    kernel); host values past STRETCH_MAX_HOST_BANDS raise."""
    x = torch.zeros((7, 4, 4), device="meta")
    dev = kernels._band_values(torch.zeros(7, dtype=torch.float64,
                                           device="meta"), x)
    assert dev.device.type == "meta" and dev.dtype == torch.float32
    with pytest.raises(ValueError, match="one gain and bias per band"):
        kernels._band_values([1.0] * 6, x)
    many = kernels.STRETCH_MAX_HOST_BANDS + 1
    with pytest.raises(ValueError, match="on the card"):
        kernels._band_values([1.0] * many, torch.zeros((many, 2, 2)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kernels.fused_calibrate_stretch(torch.zeros(
            (7, 4, 4), dtype=torch.uint16, device="meta"), GAINS, BIASES)
