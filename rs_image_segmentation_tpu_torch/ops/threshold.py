"""Thresholding.

Counterpart of ``rs_image_segmentation_tpu.ops.threshold``; so far only
``threshold_binary``, the comparison the rule program uses.
"""

from __future__ import annotations

import torch


def threshold_binary(x: torch.Tensor, threshold: float,
                     above: bool = True) -> torch.Tensor:
    """uint8 mask of ``x > threshold`` (``x < threshold`` with
    ``above=False``), NaNs read as 0 first. A Python ``threshold`` is
    compared in ``x``'s dtype, as the JAX package compares a weak-typed
    scalar."""
    x = torch.nan_to_num(x, nan=0.0)
    mask = (x > threshold) if above else (x < threshold)
    return mask.to(torch.uint8)
