"""Tool CLIs mirroring the reference's runnable modules
(collect_samples, generate_roi_mask, supervised_classifiers __main__s).

Counterpart of ``rs_image_segmentation_tpu.cli.tools_cli``, with the JAX
package's flags, defaults and printed lines. ``supervised_cli`` predicts
on a device and takes ``--device`` (default: the CUDA card); the other
two are host numpy. Installed as ``rs-seg-torch-roi-mask`` and
``rs-seg-torch-supervised``."""

from __future__ import annotations

import argparse

from .stages import _add_device


def collect_samples_cli(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Interactive sample collection (reference "
                    "modules/collect_samples.py)")
    p.add_argument("--image",
                   default="data/TM_image_AA_preprocessed.png/"
                           "TM_image_AA_preprocessed.tif")
    p.add_argument("--features",
                   default="output/feature_outputs/all_hierarchical_features.npy")
    p.add_argument("--output", default="data/samples.pkl")
    args = p.parse_args(argv)

    import numpy as np
    from ..io.tiff import read_tiff
    from ..tools.sampling import collect_samples
    arr, _ = read_tiff(args.image)
    # 4-3-2 false color (reference collect_samples.py:118-123 uses bands 3,2,1)
    rgb = np.stack([arr[3], arr[2], arr[1]], axis=-1)
    feats = np.load(args.features)
    collect_samples(rgb, feats, args.output)


def generate_roi_mask_cli(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Burn samples.pkl into a ROI mask (reference "
                    "modules/generate_roi_mask.py)")
    p.add_argument("--samples", default="data/samples.pkl")
    p.add_argument("--reference",
                   default="data/TM_image_AA_preprocessed.png/"
                           "TM_image_AA_preprocessed.tif",
                   help="raster whose shape the mask copies")
    p.add_argument("--output", default="output/ROI/roi_mask.npy")
    args = p.parse_args(argv)

    from ..io.tiff import read_tiff
    from ..tools.sampling import generate_roi_mask_from_samples
    arr, _ = read_tiff(args.reference)
    mask = generate_roi_mask_from_samples(args.samples, arr.shape[-2:],
                                          args.output)
    print(f"ROI mask {mask.shape} with {(mask != 0).sum()} labeled px "
          f"-> {args.output}")


def supervised_cli(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Bundled supervised workflow (reference "
                    "modules/supervised_classifiers.py __main__)")
    p.add_argument("--samples", default="data/samples.pkl")
    p.add_argument("--features",
                   default="output/feature_outputs/all_hierarchical_features.npy")
    p.add_argument("--output-dir", default="output")
    _add_device(p)
    args = p.parse_args(argv)

    from ..tools.supervised import run_supervised_workflow
    class_map = run_supervised_workflow(args.samples, args.features,
                                        args.output_dir, device=args.device)
    print(f"class_map {class_map.shape} -> {args.output_dir}/class_map.npy")
