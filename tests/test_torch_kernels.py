"""The port's kernel wrappers keep their contract on a host without CUDA:
the plain version runs only for CPU tensors, any other device launches
the kernel or raises, and a missing compiler is an error, not a fallback."""

import shutil

import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import _build, kernels
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
    with pytest.raises(ValueError, match="sp must be"):
        kernels.lut_hist(torch.zeros((7, 8, 8), dtype=torch.uint8),
                         torch.zeros((7, 256), dtype=torch.uint8),
                         sp=torch.zeros((7, 4), dtype=torch.int32))
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
