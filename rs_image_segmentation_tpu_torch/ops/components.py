"""Connected components, hole filling and mask post-processing.

Counterpart of ``rs_image_segmentation_tpu.ops.components``:

* the single-mask graph: ``connected_components`` (the plain fixed-point
  labels), ``connected_components_best`` (CUDA kernel
  ``ops.kernels.cc_labels``), ``component_areas``,
  ``remove_small_components``, ``fill_holes`` and ``post_process_mask``;
* ``remove_small_components_batch`` with the semantics of the JAX
  package's Pallas route (the route held to the ``bins`` id cap). Three
  CUDA kernels carry it: ``ops.kernels.ccmin_prop`` spreads each
  component's id, ``hist_dense`` counts the areas and ``keep_lut`` reads
  each pixel's keep bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .kernels import (HIST_LO, cc_labels, cc_labels_plain, ccmin_prop,
                      hist_dense, keep_lut)
from .morphology import closing, opening


def connected_components(mask: torch.Tensor,
                         connectivity: int = 8) -> torch.Tensor:
    """(H, W) mask -> int32 labels: each component carries the minimum
    linear index of its pixels, background -1. The plain graph on any
    device (neighbour min, row and column run minima, one pointer jump per
    round), run to its fixed point: the JAX function's ``max_iters`` only
    bounds that loop."""
    return cc_labels_plain(mask, connectivity)


def connected_components_best(mask: torch.Tensor, connectivity: int = 8,
                              impl: str = "auto") -> torch.Tensor:
    """Connected-component labels, bit-equal across implementations.
    ``"auto"`` and ``"pallas"`` take ``ops.kernels.cc_labels`` (the CUDA
    kernel for a CUDA tensor, its plain version for a CPU tensor);
    ``"xla"`` takes :func:`connected_components` on any device."""
    if impl in ("auto", "pallas"):
        return cc_labels(mask, connectivity)
    if impl == "xla":
        return connected_components(mask, connectivity)
    raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', not {impl!r}")


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """Pixel count per root label: int32 of length H*W, zero where no
    component has its root."""
    flat = labels.reshape(-1)
    return torch.bincount(flat[flat >= 0].long(),
                          minlength=flat.numel()).to(torch.int32)


def _areas_per_pixel(labels: torch.Tensor) -> torch.Tensor:
    """Area of each pixel's component, 0 at background."""
    counts = component_areas(labels)
    area = counts[labels.clamp_min(0).long()]
    return torch.where(labels >= 0, area, 0)


def component_areas_per_pixel(mask: torch.Tensor,
                              connectivity: int = 8) -> torch.Tensor:
    """Area of each pixel's component (0 at background), from the plain
    labels of :func:`connected_components`."""
    return _areas_per_pixel(connected_components(mask, connectivity))


def remove_small_components(mask: torch.Tensor, min_area: int,
                            connectivity: int = 8,
                            cc_impl: str = "auto") -> torch.Tensor:
    """Zero out the components of an (H, W) mask whose area is below
    ``min_area``; uint8 out."""
    labels = connected_components_best(mask, connectivity, impl=cc_impl)
    keep = _areas_per_pixel(labels) >= min_area
    return ((mask != 0) & keep).to(torch.uint8)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.binary_fill_holes equivalent on an (H, W) mask: holes
    are background regions not 4-connected to the border. Here the
    background's 4-connected components are labelled, and those with a
    border pixel stay background. The JAX function's ``max_iters`` only
    bounded its flood loop."""
    fg = mask != 0
    labels = connected_components(~fg, 4)
    border = torch.cat([labels[0], labels[-1], labels[:, 0], labels[:, -1]])
    # only background pixels carry labels >= 0: reach is background
    reach = torch.isin(labels, border[border >= 0])
    return (~reach).to(torch.uint8)


def post_process_mask(mask: torch.Tensor, min_area: int = 100,
                      smooth_kernel_size: int = 3,
                      do_fill_holes: bool = True,
                      cc_impl: str = "auto") -> torch.Tensor:
    """The reference's ``advanced_post_processing``: an ellipse closing
    (as its hole filler when the kernel is odd, else :func:`fill_holes`),
    removal of 8-connected components below ``min_area`` (skipped when
    ``min_area <= 0``), then an ellipse opening when the kernel is odd."""
    out = mask.to(torch.uint8)
    odd = smooth_kernel_size > 0 and smooth_kernel_size % 2 == 1
    if do_fill_holes and odd:
        out = closing(out, smooth_kernel_size, shape="ellipse")
    elif do_fill_holes:
        out = fill_holes(out)
    if min_area > 0:
        out = remove_small_components(out, min_area, connectivity=8,
                                      cc_impl=cc_impl)
    if odd:
        out = opening(out, smooth_kernel_size, shape="ellipse")
    return out


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
    every id allowed. This always counts all ``bins``, which is what the
    tiers reproduced. The kernel's cost does grow with ``bins``, but only
    by zeroing and writing each bin once (each block of a mask's cluster
    owns an eighth of them): 3.1 MB of counts against 34.6 MB of ids at 24
    masks of 600 x 600 and 32768 bins."""
    if bins % HIST_LO:
        raise ValueError(f"bins must be a multiple of 128, got {bins}")
    m = masks.shape[0]
    ids, overflow = component_ids(masks, connectivity, bins)
    counts = hist_dense(ids, bins // HIST_LO)
    areas = torch.as_tensor(min_areas, device=masks.device)
    keep = keep_lut(ids, counts >= areas.reshape(m, 1, 1))
    out = ((masks != 0) & (keep != 0)).to(torch.uint8)
    return (out, overflow) if return_overflow else out
