"""Stage 2, feature extraction: indices, PCA, texture, the hierarchical
stack.

Counterpart of ``rs_image_segmentation_tpu.pipeline.features``: a (7, H, W)
stack -> a dict of named feature planes and the canonical 19-channel
hierarchical stack, in the JAX package's (H, W, C) layout:

  channels 0-6  : level 1 [ndwi, mndwi, ndvi, evi, ndbi, bsi, pc1]
  channels 7-13 : 7x7 box-filtered (BORDER_REFLECT) copies of 0-6
  channels 14-18: level 2 [glcm_contrast, glcm_homogeneity,
                  morph_gradient_5, std_dev_scale_5, sobel_mag]

On CUDA the seven indices run the kernel ``ops.kernels
.fused_spectral_indices`` and the GLCM the kernel ``ops.kernels.glcm_grid``
(``glcm_feature_maps(backend="kernel")``); on CPU tensors their plain
versions. Everything else is plain torch ops. The texture band is always
``cfg.texture_band_index`` (NIR), renormalised with the default
percentiles, as the reference does. ``run_feature_extraction_stage`` is
the stage-2 file driver (the stage-1 GeoTIFF in; the ``.npy`` stacks, the
pickle and the feature GeoTIFF out, through ``io.artifacts``), and
``visualize_features`` its plots. Entry points run on CUDA unless the
caller names another device.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, host_numpy, resolve_device
from ..core.config import FeatureStageConfig
from ..io.artifacts import save_feature_artifacts
from ..io.tiff import read_tiff
from ..models.pca import pca_bands
from ..ops.kernels import INDEX_ORDER, fused_spectral_indices
from ..ops.morphology import closing, dilate, erode, gradient, opening
from ..ops.multiscale import multi_scale_features
from ..ops.normalize import robust_normalize
from ..ops.stencil import (box_filter, gabor_responses, gaussian_blur_u8,
                           laplacian, sobel_magnitude)
from ..ops.texture import glcm_feature_maps, lbp_feature


def _u8(band01: torch.Tensor) -> torch.Tensor:
    return (band01 * 255.0).to(torch.uint8)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    return (x - torch.min(x)) / (torch.max(x) - torch.min(x) + 1e-10)


def morphological_features(band01: torch.Tensor, kernel_sizes=(3, 5, 7)
                           ) -> Dict[str, torch.Tensor]:
    """uint8 erode, dilate, open, close and gradient per kernel size, times
    1/255: XLA compiles the JAX package's ``x / 255.0`` so, and a forest
    threshold can sit exactly on a level k / 255 (so in the stack below)."""
    u8 = _u8(band01)
    out = {}
    for k in kernel_sizes:
        for name, fn in (("erosion", erode), ("dilation", dilate),
                         ("opening", opening), ("closing", closing),
                         ("gradient", gradient)):
            out[f"{name}_{k}"] = fn(u8, k).to(torch.float32) * (1.0 / 255.0)
    return out


def filter_responses(band01: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gaussian 5 and 15, DoG, Laplacian and Sobel magnitude of the
    uint8-quantized band."""
    u8 = _u8(band01)
    g5 = gaussian_blur_u8(u8, 5).to(torch.float32) * (1.0 / 255.0)
    g15 = gaussian_blur_u8(u8, 15).to(torch.float32) * (1.0 / 255.0)
    lap = laplacian(u8.to(torch.float32)) * (1.0 / 255.0)
    smag = sobel_magnitude(u8.to(torch.float32)) * (1.0 / 255.0)
    return {"gaussian_5": g5, "gaussian_15": g15, "dog": _minmax(g5 - g15),
            "laplacian": _minmax(lap),
            "sobel_mag": smag / (torch.max(smag) + 1e-10)}


def add_spatial_context(stack_hwc: torch.Tensor, window_size: int = 7
                        ) -> torch.Tensor:
    """Concatenate each channel's window mean (BORDER_REFLECT): (H, W, C)
    -> (H, W, 2C)."""
    ctx = box_filter(stack_hwc.movedim(-1, 0), window_size, border="reflect")
    return torch.cat([stack_hwc, ctx.movedim(0, -1)], dim=-1)


def normalize_bands(bands: torch.Tensor, cfg: FeatureStageConfig
                    ) -> torch.Tensor:
    """Each band clipped to its configured percentiles and scaled to
    [0, 1]."""
    n = cfg.normalize
    return robust_normalize(bands, n.lower_percentile, n.upper_percentile,
                            n.epsilon)


def index_features(bands01: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The seven indices through the fused kernel, by name."""
    return dict(zip(INDEX_ORDER, fused_spectral_indices(bands01).unbind(0)))


def texture_band(bands01: torch.Tensor, cfg: FeatureStageConfig
                 ) -> torch.Tensor:
    """The texture band, renormalised with the default percentiles."""
    return robust_normalize(bands01[cfg.texture_band_index])


def glcm_features(tex01: torch.Tensor, cfg: FeatureStageConfig
                  ) -> Dict[str, torch.Tensor]:
    """The five GLCM maps through the ``glcm_grid`` kernel."""
    g = cfg.glcm
    return glcm_feature_maps(tex01, g.levels, g.window_size, g.step_size,
                             g.distances, g.angles, backend="kernel")


def assemble(idx: Dict[str, torch.Tensor], pc1: torch.Tensor,
             glcm: Dict[str, torch.Tensor], grad5: torch.Tensor,
             std5: torch.Tensor, smag: torch.Tensor, window_size: int = 7
             ) -> Dict[str, torch.Tensor]:
    """The level-1 (with context), level-2 and combined (H, W, C) stacks."""
    level_1 = torch.stack([idx["ndwi"], idx["mndwi"], idx["ndvi"],
                           idx["evi"], idx["ndbi"], idx["bsi"], pc1], dim=-1)
    level_2 = torch.stack([glcm["contrast"], glcm["homogeneity"], grad5,
                           std5, smag], dim=-1)
    level_1_ctx = add_spatial_context(level_1, window_size)
    return {"level_1": level_1_ctx, "level_2": level_2,
            "all": torch.cat([level_1_ctx, level_2], dim=-1)}


def extract_features(bands, cfg: FeatureStageConfig = FeatureStageConfig(),
                     normalize_input: bool = True,
                     include_entropy: bool = True,
                     device: DeviceLike = None
                     ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """The stage-2 graph: (7, H, W) raw or preprocessed bands -> (features
    dict, hierarchical dict with 'level_1' 14-channel, 'level_2' 5-channel
    and 'all' 19-channel (H, W, C) stacks), on ``device`` (CUDA unless
    named)."""
    bands = as_tensor(bands, resolve_device(device), torch.float32)
    if normalize_input:
        bands = normalize_bands(bands, cfg)
    feats: dict = {}
    idx = index_features(bands)
    feats.update(idx)
    pca_imgs, variance_ratio = pca_bands(bands, use_robust_scaling=True)
    feats["pca_result"] = pca_imgs
    feats["variance_ratio"] = variance_ratio
    tex01 = texture_band(bands, cfg)
    glcm = glcm_features(tex01, cfg)
    feats["glcm_features"] = glcm
    feats["lbp_feature"] = lbp_feature(tex01, n_points=cfg.lbp.n_points,
                                       radius=float(cfg.lbp.radius))
    ms = multi_scale_features(
        tex01, scales=cfg.multiscale.scales,
        entropy_max_scale=cfg.multiscale.entropy_max_scale,
        include_entropy=include_entropy)
    feats["multi_scale_features"] = ms
    morph = morphological_features(tex01, cfg.morphology.kernel_sizes)
    feats["morphological_features"] = morph
    filt = filter_responses(tex01)
    feats["filter_features"] = filt
    if cfg.include_gabor:
        feats["gabor_features"] = gabor_responses(_u8(tex01))
    hierarchical = assemble(idx, pca_imgs[0], glcm, morph["gradient_5"],
                            ms["std_dev_scale_5"], filt["sobel_mag"],
                            cfg.context.window_size)
    return feats, hierarchical


def hierarchical_stack(bands, cfg: FeatureStageConfig = FeatureStageConfig(),
                       device: DeviceLike = None) -> torch.Tensor:
    """Just the canonical (H, W, 19) stack, the classification input."""
    return extract_features(bands, cfg, device=device)[1]["all"]


def hierarchical_stack_fused(bands,
                             cfg: FeatureStageConfig = FeatureStageConfig(),
                             include_entropy: bool = True,
                             device: DeviceLike = None) -> torch.Tensor:
    """The (H, W, 19) stack from only the ops that feed it: one graph with
    no intermediate dict, as the JAX package's single-program variant
    (``include_entropy`` is accepted for its signature; no channel of the
    stack reads entropy)."""
    bands = normalize_bands(as_tensor(bands, resolve_device(device), torch.float32), cfg)
    idx = index_features(bands)
    pca_imgs, _ = pca_bands(bands, use_robust_scaling=True)
    tex01 = texture_band(bands, cfg)
    glcm = glcm_features(tex01, cfg)
    u8 = _u8(tex01)
    grad5 = gradient(u8, 5).to(torch.float32) * (1.0 / 255.0)
    mean5 = box_filter(tex01, 5)
    std5 = torch.sqrt(torch.clamp_min(box_filter(tex01 * tex01, 5)
                                      - mean5 * mean5, 0.0))
    smag = sobel_magnitude(u8.to(torch.float32)) * (1.0 / 255.0)
    smag = smag / (torch.max(smag) + 1e-10)
    return assemble(idx, pca_imgs[0], glcm, grad5, std5, smag,
                    cfg.context.window_size)["all"]


def run_feature_extraction_stage(
    input_path: str,
    output_dir: str,
    cfg: FeatureStageConfig = FeatureStageConfig(),
    vis: bool = True,
    include_entropy: bool = True,
    device: DeviceLike = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Stage 2 on files: read the stage-1 GeoTIFF (NoData -> NaN -> 0),
    run :func:`extract_features` on ``device`` (CUDA unless named), and
    write the ``.npy`` stacks, the pickle and the 19-band GeoTIFF (and,
    with ``vis``, the plots). Returns the features and the hierarchical
    stacks as host numpy, ``pca_result`` as a list of 2-D planes."""
    dev = resolve_device(device)
    arr, info = read_tiff(input_path)
    data = arr.astype(np.float32)
    if info.meta.nodata is not None:
        data[data == info.meta.nodata] = np.nan
    feats, hier = extract_features(np.nan_to_num(data), cfg,
                                   include_entropy=include_entropy,
                                   device=dev)
    feats_np = host_numpy(feats)
    hier_np = host_numpy(hier)
    # the reference stores pca_result as a list of 2-D arrays
    if "pca_result" in feats_np:
        feats_np["pca_result"] = list(feats_np["pca_result"])

    save_feature_artifacts(output_dir, feats_np, hier_np, info.meta)
    if vis:
        visualize_features(feats_np, hier_np, output_dir)
    return feats_np, hier_np


def visualize_features(feats: Dict, hier: Dict, output_dir: str) -> None:
    """Index maps, the PCA composite and variance bars, and the level-1,
    level-2 and combined feature grids as PNGs (host, matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    feats, hier = host_numpy(feats), host_numpy(hier)
    os.makedirs(output_dir, exist_ok=True)
    index_cmaps = {"ndvi": "RdYlGn", "ndwi": "Blues", "mndwi": "Blues",
                   "ndbi": "RdGy_r", "bsi": "YlOrBr"}
    fig, axes = plt.subplots(1, 5, figsize=(25, 5))
    for ax, (name, cmap) in zip(axes, index_cmaps.items()):
        im = ax.imshow(np.asarray(feats[name]), cmap=cmap, vmin=-1, vmax=1)
        ax.set_title(name.upper())
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "index_maps.png"), dpi=120)
    plt.close(fig)

    pca = feats.get("pca_result")
    if pca is not None:
        pca = np.stack(pca) if isinstance(pca, list) else np.asarray(pca)
        rgb = np.stack([(p - p.min()) / (p.max() - p.min() + 1e-10)
                        for p in pca[:3]], axis=-1)
        fig, axes = plt.subplots(1, 2, figsize=(13, 6))
        axes[0].imshow(rgb)
        axes[0].set_title("PCA PC1-3 composite")
        axes[0].axis("off")
        vr = np.asarray(feats["variance_ratio"])
        axes[1].bar(np.arange(1, len(vr) + 1), vr)
        axes[1].set_title("Explained variance ratio")
        axes[1].set_xlabel("component")
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, "feature_pca.png"), dpi=120)
        plt.close(fig)

        # the reference also writes the variance bars to a file of their own
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.bar(np.arange(1, len(vr) + 1), vr)
        ax.set_title("PCA explained variance ratio")
        ax.set_xlabel("component")
        ax.set_ylabel("ratio")
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, "pca_variance_explained.png"),
                    dpi=120)
        plt.close(fig)

    for key, fname in (("level_1", "level_1_features.png"),
                       ("level_2", "level_2_features.png"),
                       ("all", "combined_features.png")):
        stack = np.asarray(hier[key])
        n = stack.shape[-1]
        cols = min(n, 7)
        rows = -(-n // cols)
        fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
        axes = np.atleast_2d(axes)
        for i in range(rows * cols):
            ax = axes[i // cols, i % cols]
            ax.axis("off")
            if i < n:
                ax.imshow(stack[:, :, i], cmap="viridis")
                ax.set_title(f"ch {i}", fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, fname), dpi=100)
        plt.close(fig)
