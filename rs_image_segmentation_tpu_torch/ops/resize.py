"""Resize and warp: cv2-compatible bilinear and nearest resize, and the
affine warp of stage 1.

Counterpart of ``rs_image_segmentation_tpu.ops.resize``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resize_bilinear(img: torch.Tensor, out_shape: Tuple[int, int]
                    ) -> torch.Tensor:
    """Resize the trailing two dims: half-pixel centers, edge clamp."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_shape
    sy, sx = h / oh, w / ow
    f32 = dict(dtype=torch.float32, device=img.device)
    ry = (torch.arange(oh, **f32) + 0.5) * sy - 0.5
    rx = (torch.arange(ow, **f32) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(ry), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(rx), 0, w - 1).to(torch.int64)
    fy = torch.clamp(ry - y0.to(torch.float32), 0.0, 1.0)
    fx = torch.clamp(rx - x0.to(torch.float32), 0.0, 1.0)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)

    r0 = img[..., y0, :]
    r1 = img[..., y1, :]
    a, b = r0[..., :, x0], r0[..., :, x1]
    c, d = r1[..., :, x0], r1[..., :, x1]
    fy = fy[:, None]
    fx = fx[None, :]
    top = a * (1 - fx) + b * fx
    bot = c * (1 - fx) + d * fx
    return top * (1 - fy) + bot * fy


def resize_nearest(img: torch.Tensor, out_shape: Tuple[int, int]
                   ) -> torch.Tensor:
    """Nearest-neighbour resize of the trailing two dims with half-pixel
    centres (cv2.INTER_NEAREST, skimage order=0 without anti-aliasing)."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_shape
    ry = torch.clamp_max((torch.arange(oh, device=img.device) * h) // oh,
                         h - 1)
    rx = torch.clamp_max((torch.arange(ow, device=img.device) * w) // ow,
                         w - 1)
    return img[..., ry, :][..., :, rx]


def estimate_affine_from_gcps(gcps) -> np.ndarray:
    """Least-squares 2x3 affine (host numpy, f64) mapping src -> dst from
    ground control points ``((src_x, src_y), (dst_x, dst_y))``; it plugs
    into :func:`warp_affine_bilinear`."""
    gcps = list(gcps)
    if len(gcps) < 3:
        raise ValueError("at least 3 GCPs are required for an affine fit")
    a = np.zeros((2 * len(gcps), 6), np.float64)
    b = np.zeros(2 * len(gcps), np.float64)
    for i, ((sx, sy), (dx, dy)) in enumerate(gcps):
        a[2 * i] = [sx, sy, 1.0, 0.0, 0.0, 0.0]
        a[2 * i + 1] = [0.0, 0.0, 0.0, sx, sy, 1.0]
        b[2 * i] = dx
        b[2 * i + 1] = dy
    coef, *_ = np.linalg.lstsq(a, b, rcond=None)
    return coef.reshape(2, 3)


def warp_affine_bilinear(img: torch.Tensor, matrix, out_shape=None,
                         border_value: float = 0.0) -> torch.Tensor:
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT) for a 2x3 forward
    matrix: ``dst(x, y) = src(M^-1 (x, y, 1))`` over the trailing two dims.
    The inverse is taken in f64 on the host and applied in f32, as in the
    JAX package."""
    m = np.asarray(matrix, dtype=np.float64).reshape(2, 3)
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))
    coef = [float(np.float32(v)) for v in inv[:2].reshape(-1)]
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_shape if out_shape is not None else (h, w)
    f32 = dict(dtype=torch.float32, device=img.device)
    ys, xs = torch.meshgrid(torch.arange(oh, **f32), torch.arange(ow, **f32),
                            indexing="ij")
    src_x = coef[0] * xs + coef[1] * ys + coef[2]
    src_y = coef[3] * xs + coef[4] * ys + coef[5]
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = src_x - x0
    fy = src_y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def sample(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[..., torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
        return torch.where(inb, v, border_value)

    a = sample(y0i, x0i)
    b = sample(y0i, x0i + 1)
    c = sample(y0i + 1, x0i)
    d = sample(y0i + 1, x0i + 1)
    top = a * (1 - fx) + b * fx
    bot = c * (1 - fx) + d * fx
    return (top * (1 - fy) + bot * fy).to(img.dtype)
