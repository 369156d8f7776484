"""Batched min-area removal over a stack of binary masks.

Counterpart of ``rs_image_segmentation_tpu.ops.components``; so far only
``remove_small_components_batch`` with the semantics of its Pallas route
(the route held to the ``bins`` id cap). Three CUDA kernels carry it:
``ops.kernels.ccmin_prop`` spreads each component's id, ``hist_dense``
counts the areas and ``keep_lut`` reads each pixel's keep bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .kernels import HIST_LO, ccmin_prop, hist_dense, keep_lut


def run_rank_seeds(fg: torch.Tensor) -> torch.Tensor:
    """(M, H, W) bool -> int32 seeds: at each pixel, the number of row-run
    starts of its mask up to and including it in linear order, minus 1.

    The count is nondecreasing in linear order, so its minimum over a
    component sits on the component's first run: the mask-relative,
    0-based rank of that run. It is constant on the component, distinct
    across components and dense within the mask's run count."""
    starts = fg & ~F.pad(fg[..., :-1], (1, 0))
    flat = starts.reshape(fg.shape[0], -1)
    return (torch.cumsum(flat, 1, dtype=torch.int32) - 1).reshape(fg.shape)


def component_ids(masks: torch.Tensor, connectivity: int = 8,
                  bins: int = 32768) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, H, W) masks -> ``(ids, overflow)``: each foreground pixel's
    component id (the rank of the component's first row run within its
    mask) where it is below ``bins``, else ``bins``, which also marks the
    background; and an (M,) bool marking masks where some id reached
    ``bins``."""
    fg = masks != 0
    ids = ccmin_prop(fg, run_rank_seeds(fg), connectivity)
    overflow = torch.where(fg, ids, -1).amax(dim=(1, 2)) >= bins
    return torch.where(fg & (ids < bins), ids, bins), overflow


def remove_small_components_batch(masks: torch.Tensor,
                                  min_areas: torch.Tensor,
                                  connectivity: int = 8, bins: int = 32768,
                                  return_overflow: bool = False):
    """Zero out, per mask of an (M, H, W) stack, the components whose area
    is below that mask's ``min_areas`` entry (M,). Returns uint8 masks, and
    with ``return_overflow`` also the (M,) bool overflow flags.

    ``bins`` caps the component ids per mask and must be a multiple of 128
    (the JAX package's (hi, lo) layout of the counts). A component whose
    first-run rank reaches ``bins`` is dropped as if too small, and its
    mask is flagged: callers reroute flagged masks to an uncapped path.
    The JAX package cut the histogram's cost with smaller bins tiers when
    every id allowed; a Hopper histogram's cost does not grow with its bin
    count, so this always counts all ``bins``, which is what the tiers
    reproduced."""
    if bins % HIST_LO:
        raise ValueError(f"bins must be a multiple of 128, got {bins}")
    m = masks.shape[0]
    ids, overflow = component_ids(masks, connectivity, bins)
    counts = hist_dense(ids, bins // HIST_LO)
    areas = torch.as_tensor(min_areas, device=masks.device)
    keep = keep_lut(ids, counts >= areas.reshape(m, 1, 1))
    out = ((masks != 0) & (keep != 0)).to(torch.uint8)
    return (out, overflow) if return_overflow else out
