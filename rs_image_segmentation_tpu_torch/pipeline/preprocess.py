"""Stage 1, preprocessing: radiometric calibration, the affine warp and
the per-band linear stretch to uint8; and the host stretch tables of the
turbo preamble.

Counterpart of ``rs_image_segmentation_tpu.pipeline.preprocess``, with the
same numpy semantics for the host tables: an exact f64 per-DN
calibrate+stretch LUT and the int32 histogram of the stretched scene, the
two tables the port's programs take (:func:`stretch_tables_from_counts`);
the JAX package's int32 fixed-point per-band params are built only by its
counterparts :func:`build_stretch_params` and :func:`build_stretch_stats`,
which the parity tests hold bit-equal. The device routes:

* ``preprocess_bands`` on a uint8 scene with the identity warp: the exact
  host LUT, applied on the device (bit-equal to the JAX package);
* any other dtype (16-bit Landsat 8/9 DNs, float rasters) or a real warp:
  ``preprocess_bands_f32``, which runs the CUDA kernel
  ``ops.kernels.fused_calibrate_stretch``: with the identity warp on the
  DNs, with a warp (a GCP fit) on the calibrated and warped radiance, with
  unit gains and zero biases, so that the kernel does the stretch alone.

``run_preprocessing_stage`` is the stage-1 file driver: a GeoTIFF in, the
Float32 GeoTIFF of the uint8 levels out (and the false-colour PNG).

Entry points run on CUDA unless the caller names another device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, resolve_device
from ..core.config import CalibrationConfig
from ..core.types import Raster
from ..io import native as _native
from ..io.tiff import read_tiff, write_tiff
from ..ops.kernels import apply_u8_lut, fused_calibrate_stretch
from ..ops.resize import estimate_affine_from_gcps, warp_affine_bilinear
from ..utils.timing import span

_IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def radiometric_calibration(bands: torch.Tensor, gains: Sequence[float],
                            biases: Sequence[float]) -> torch.Tensor:
    """DN -> radiance in f32, per band ``DN * gain + bias``."""
    g = as_tensor(gains, bands.device, torch.float32)[:, None, None]
    b = as_tensor(biases, bands.device, torch.float32)[:, None, None]
    return bands.to(torch.float32) * g + b


def preprocess_bands_f32(bands, gains, biases,
                         matrix: Tuple[float, ...] = _IDENTITY,
                         device: DeviceLike = None) -> torch.Tensor:
    """The f32 device route: ``(C, H, W)`` DNs of any dtype -> ``(C, H, W)``
    uint8. Identity warp: the fused calibrate + stretch kernel, truncated.
    A real warp: calibrate, ``warp_affine_bilinear``, then the same kernel
    with unit gains and zero biases (``x * 1 + 0`` is ``x`` in f32), which
    leaves it the per-band ``minmax_stretch_u8``. Truncation boundaries
    may differ from f64 by one level."""
    dev = resolve_device(device)
    x = as_tensor(bands, dev)
    if tuple(matrix) != _IDENTITY:
        cal = radiometric_calibration(x, gains, biases)
        x = warp_affine_bilinear(cal, np.asarray(matrix).reshape(2, 3))
        gains = np.ones(x.shape[0], np.float32)
        biases = np.zeros(x.shape[0], np.float32)
    return fused_calibrate_stretch(x, gains, biases).to(torch.uint8)


def preprocess_bands(bands, gains, biases,
                     matrix: Tuple[float, ...] = _IDENTITY,
                     device: DeviceLike = None) -> torch.Tensor:
    """Calibrate -> affine warp -> per-band min-max stretch to uint8, the
    input of stage 2. A uint8 scene with the identity warp (the
    reference's live path) takes the exact f64 per-DN LUT built on the
    host and a gather on the device, bit-equal to the reference's numpy
    math; any other dtype or a real warp takes
    :func:`preprocess_bands_f32`."""
    dev = resolve_device(device)
    dtype = bands.dtype if isinstance(bands, torch.Tensor) else np.asarray(
        bands).dtype
    if tuple(matrix) != _IDENTITY or dtype not in (np.uint8, torch.uint8):
        return preprocess_bands_f32(bands, gains, biases, matrix, dev)
    arr = (bands.cpu().numpy() if isinstance(bands, torch.Tensor)
           else np.asarray(bands))
    lut = build_stretch_lut(arr, gains, biases).astype(np.uint8)
    return apply_u8_lut(as_tensor(bands, dev),
                        torch.from_numpy(lut).to(dev))


def preprocess_bands_device_lut(bands_u8, calv,
                                device: DeviceLike = None) -> torch.Tensor:
    """The LUT route with no per-scene host work: per-band DN histogram,
    the present DNs' calibrated min and max from ``calv`` (the (C, 256)
    :func:`calibrated_value_table`), an f32 stretch LUT and a gather, all
    on the device. Not bit-equal to :func:`preprocess_bands`: f32
    truncation can land one level below f64 on boundary DNs."""
    dev = resolve_device(device)
    x = as_tensor(bands_u8, dev)
    cv = as_tensor(calv, dev, torch.float32)
    c = x.shape[0]
    flat = x.reshape(c, -1).long()
    hist = torch.zeros((c, 256), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    present = hist > 0
    mn = torch.amin(torch.where(present, cv, float("inf")), dim=1,
                    keepdim=True)
    mx = torch.amax(torch.where(present, cv, float("-inf")), dim=1,
                    keepdim=True)
    # absent DNs below mn go negative and wrap in the cast; no pixel
    # gathers them
    lut = ((cv - mn) * 255.0 / (mx - mn)).to(torch.uint8)
    return apply_u8_lut(x, lut)


def calibrated_value_table(gains, biases) -> np.ndarray:
    """(C, 256) float32 table of f64-computed calibrated values per DN."""
    g = np.asarray(gains, np.float64)[:, None]
    b = np.asarray(biases, np.float64)[:, None]
    dn = np.arange(256, dtype=np.float64)[None, :]
    return (g * dn + b).astype(np.float32)


STRETCH_FIXUPS = 6      # per-band fixup slots in the fixed-point params
_STRETCH_SHIFT = 16
_DN = np.arange(256, dtype=np.float64)


def _band_lut(g: float, b: float, vmin: int, vmax: int) -> np.ndarray:
    """One band's exact (256,) f64 calibrate+stretch LUT (uint8 levels)
    from its gain, bias and its min and max DN.

    The present-value min/max of a band is the calibrated value of its
    min/max DN (calibration is affine per band). DNs outside the band's
    [min, max] go below 0 or above 255 before the uint8 cast and wrap
    around; the scene never indexes them."""
    cal = g * _DN + b
    ends = (cal[vmin], cal[vmax])
    mn, mx = min(ends), max(ends)  # handles negative gains too
    return ((cal - mn) * 255.0 / (mx - mn)).astype(np.uint8)


def _band_params(lut: np.ndarray, g: float, b: float, vmin: int,
                 vmax: int) -> np.ndarray:
    """One band's ``(3 + 2*STRETCH_FIXUPS,)`` int32 fixed-point params for
    its LUT ``lut`` (:func:`_band_lut`); see :func:`build_stretch_params`."""
    k = STRETCH_FIXUPS
    sp = np.full(3 + 2 * k, -1, np.int32)
    sp[0] = 0
    mn, mx = sorted((g * vmin + b, g * vmax + b))
    if mx <= mn:
        return sp                                       # mode 0
    a = 255.0 * g / (mx - mn)
    off = (b - mn) * 255.0 / (mx - mn)
    a32 = int(round(a * (1 << _STRETCH_SHIFT)))
    if abs(a32) > (1 << 23):     # A32 * 255 must stay in int32
        return sp                                       # mode 0
    v = np.arange(vmin, vmax + 1, dtype=np.int64)
    want = lut[vmin:vmax + 1].astype(np.int64)
    best = None
    for db in range(-2, 3):
        b32 = int(round(off * (1 << _STRETCH_SHIFT))) + db
        cand = np.clip((a32 * v + b32) >> _STRETCH_SHIFT, 0, 255)
        bad = np.flatnonzero(cand != want)
        if best is None or len(bad) < len(best[1]):
            best = (b32, bad, cand)
    b32, bad, cand = best
    if len(bad) > k:
        return sp                                       # mode 0
    sp[0] = 1
    sp[1] = a32
    sp[2] = b32
    for s, j in enumerate(bad):
        sp[3 + s] = int(v[j])
        sp[3 + k + s] = int(want[j] - cand[j])
    return sp


def build_stretch_lut(arr_u8: np.ndarray, gains, biases) -> np.ndarray:
    """Exact (C, 256) f64 calibrate+stretch LUT for a uint8 scene, from
    each band's min and max DN (two scans a band, no histogram)."""
    g = np.asarray(gains, np.float64)
    b = np.asarray(biases, np.float64)
    lut = np.zeros((arr_u8.shape[0], 256), np.float32)
    for i in range(arr_u8.shape[0]):
        lut[i] = _band_lut(g[i], b[i], int(arr_u8[i].min()),
                           int(arr_u8[i].max()))
    return lut


def build_stretch_params(arr_u8: np.ndarray, gains, biases):
    """``(lut, params)``: the exact stretch LUT plus per-band int32
    fixed-point params ``(C, 3 + 2*STRETCH_FIXUPS)``, per band
    ``[mode, A32, B32, fix_dn*K, fix_delta*K]``.

    ``mode=1`` guarantees ``clip((A32*dn + B32) >> 16, 0, 255) + fixups ==
    lut[dn]`` for every DN in the band's [min, max]; ``mode=0`` marks bands
    whose LUT the fixed point cannot reproduce within the fixup budget
    (full-range bands, near-constant bands). Unused fixup slots hold DN -1.
    Valid only for the scene the params were built from. The JAX
    package's counterpart: no program of the port reads the params."""
    lut, params, _ = build_stretch_stats(arr_u8, gains, biases)
    return lut, params


def _count_range(counts: np.ndarray, band: int) -> Tuple[int, int]:
    """A band's min and max DN: its first and last non-empty bins."""
    present = np.flatnonzero(counts)
    if not present.size:
        raise ValueError(f"band {band} has no pixels")
    return int(present[0]), int(present[-1])


def stretch_tables_from_counts(counts: np.ndarray, gains, biases):
    """``(lut, hist_stretched)`` of a scene from its ``(C, 256)`` raw-DN
    counts alone, the tables the port's programs take, bit-equal to
    :func:`build_stretch_stats`'s: the LUT from each band's min and max DN
    (:func:`_count_range`), and the stretched histogram as the counts
    pushed through the LUT (DNs outside [min, max] have zero counts, so
    their wrapped LUT entries add nothing). O(C x 256) on the host, marked
    ``stretch.params``."""
    counts = np.asarray(counts, np.int64)
    g = np.asarray(gains, np.float64)
    b = np.asarray(biases, np.float64)
    c = counts.shape[0]
    lut = np.zeros((c, 256), np.float32)
    hist = np.zeros((c, 256), np.int64)
    with span("stretch.params"):
        for i in range(c):
            lut[i] = _band_lut(g[i], b[i], *_count_range(counts[i], i))
            np.add.at(hist[i], lut[i].astype(np.int64), counts[i])
    return lut, hist.astype(np.int32)


def stretch_stats_from_counts(counts: np.ndarray, gains, biases):
    """``(lut, params, hist_stretched)``: :func:`stretch_tables_from_counts`
    plus the JAX package's fixed-point params of each band
    (:func:`_band_params`), also marked ``stretch.params``."""
    lut, hist = stretch_tables_from_counts(counts, gains, biases)
    g = np.asarray(gains, np.float64)
    b = np.asarray(biases, np.float64)
    params = np.zeros((lut.shape[0], 3 + 2 * STRETCH_FIXUPS), np.int32)
    with span("stretch.params"):
        for i in range(lut.shape[0]):
            params[i] = _band_params(lut[i], g[i], b[i],
                                     *_count_range(counts[i], i))
    return lut, params, hist


def band_counts(arr_u8: np.ndarray) -> np.ndarray:
    """``(C, 256)`` int64 raw-DN counts of a uint8 scene: one
    ``io.native.hist_u8`` call a band (the C++ codec library), or
    ``np.bincount`` where that library cannot be built. Marked
    ``stretch.hist``."""
    counts = np.zeros((arr_u8.shape[0], 256), np.int64)
    with span("stretch.hist"):
        for i in range(arr_u8.shape[0]):
            hist_raw = _native.hist_u8(arr_u8[i])
            if hist_raw is None:
                hist_raw = np.bincount(arr_u8[i].reshape(-1), minlength=256)
            counts[i] = hist_raw
    return counts


def build_stretch_stats(arr_u8: np.ndarray, gains, biases):
    """``(lut, params, hist_stretched)``: the exact stretch LUT, the JAX
    package's fixed-point params (:func:`build_stretch_params`) and the
    exact (C, 256) int32 histogram of the stretched scene — the raw-DN
    bincount pushed through the LUT (the LUT is a per-DN function, so this
    equals histogramming the stretched image). Each band is counted once
    (:func:`band_counts`), and every table comes from the counts
    (:func:`stretch_stats_from_counts`). The JAX package's signature: the
    port's programs read the LUT and the histogram alone."""
    return stretch_stats_from_counts(band_counts(arr_u8), gains, biases)


def run_preprocessing_stage(input_path: str, output_path: str,
                            vis_dir: Optional[str] = None,
                            config: CalibrationConfig = CalibrationConfig(),
                            gcp_matrix: Optional[Sequence[float]] = None,
                            gcps=None, device: DeviceLike = None) -> Raster:
    """Stage 1 on files: read the GeoTIFF, preprocess on ``device`` (CUDA
    unless named), write the uint8 levels as a Float32 GeoTIFF with the
    input's georeferencing (and, with ``vis_dir``, the 4-3-2 false-colour
    before/after PNG). ``gcps``, ``((src_x, src_y), (dst_x, dst_y))``
    pairs, give the affine warp by least squares; else ``gcp_matrix``;
    else the identity. Returns a ``Raster`` of the host uint8 levels."""
    dev = resolve_device(device)
    arr, info = read_tiff(input_path)
    if gcps is not None:
        matrix = tuple(estimate_affine_from_gcps(gcps).reshape(-1))
    elif gcp_matrix is not None:
        matrix = tuple(gcp_matrix)
    else:
        matrix = _IDENTITY
    out_np = preprocess_bands(arr, np.asarray(config.gains),
                              np.asarray(config.biases), matrix=matrix,
                              device=dev).cpu().numpy()

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    write_tiff(output_path, out_np.astype(np.float32), info.meta)

    if vis_dir:
        os.makedirs(vis_dir, exist_ok=True)
        _false_color_comparison(arr, out_np,
                                os.path.join(vis_dir,
                                             "preprocessing_result.png"))
    return Raster(out_np, info.meta)


def _false_color_comparison(before: np.ndarray, after: np.ndarray,
                            path: str) -> None:
    """4-3-2 false-colour before/after side by side (host, matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def composite(stack):
        rgb = np.stack([stack[3], stack[2], stack[1]],
                       axis=-1).astype(np.float32)
        mx = rgb.max() or 1.0
        return rgb / mx

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    axes[0].imshow(composite(before))
    axes[0].set_title("Before preprocessing (4-3-2)")
    axes[0].axis("off")
    axes[1].imshow(composite(after))
    axes[1].set_title("After preprocessing (4-3-2)")
    axes[1].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
