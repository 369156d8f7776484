"""cv2.INTER_LINEAR-compatible bilinear resize.

Counterpart of ``rs_image_segmentation_tpu.ops.resize.resize_bilinear``.
"""

from __future__ import annotations

from typing import Tuple

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
