"""Stage CLI entry points of the port, with the JAX package's flags,
defaults and printed lines (``rs_image_segmentation_tpu.cli.stages``), plus
``--device`` (default: the CUDA card; ``--device cpu`` runs on the CPU).
Installed as ``rs-seg-torch-preprocess``, ``rs-seg-torch-features``,
``rs-seg-torch-classify`` and ``rs-seg-torch-evaluate``."""

from __future__ import annotations

import argparse
import os


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")


def stage1(argv=None) -> None:
    p = argparse.ArgumentParser(description="Stage 1: preprocessing")
    p.add_argument("--input", default="data/raw/AA.tif")
    p.add_argument("--output",
                   default="data/TM_image_AA_preprocessed.png/"
                           "TM_image_AA_preprocessed.tif")
    p.add_argument("--vis-dir", default="data")
    _add_device(p)
    args = p.parse_args(argv)
    from ..pipeline.preprocess import run_preprocessing_stage
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    run_preprocessing_stage(args.input, args.output, args.vis_dir,
                            device=args.device)
    print(f"stage 1 done -> {args.output}")


def stage2(argv=None) -> None:
    p = argparse.ArgumentParser(description="Stage 2: feature extraction")
    p.add_argument("--input",
                   default="data/TM_image_AA_preprocessed.png/"
                           "TM_image_AA_preprocessed.tif")
    p.add_argument("--output-dir", default="output/feature_outputs")
    p.add_argument("--no-vis", action="store_true")
    p.add_argument("--no-entropy", action="store_true",
                   help="skip the rank-entropy multi-scale features")
    _add_device(p)
    args = p.parse_args(argv)
    from ..pipeline.features import run_feature_extraction_stage
    run_feature_extraction_stage(args.input, args.output_dir,
                                 vis=not args.no_vis,
                                 include_entropy=not args.no_entropy,
                                 device=args.device)
    print(f"stage 2 done -> {args.output_dir}")


def stage3(argv=None) -> None:
    p = argparse.ArgumentParser(description="Stage 3: classification")
    p.add_argument("--features",
                   default="output/feature_outputs/all_features_and_metadata.pkl")
    p.add_argument("--method", default="kmeans",
                   choices=["rule_based", "kmeans", "random_forest"])
    p.add_argument("--output-dir", default="output/segmentation_results")
    p.add_argument("--labeled-roi", default="labeled_roi.tif")
    p.add_argument("--no-hierarchical-all", action="store_true")
    _add_device(p)
    args = p.parse_args(argv)
    from ..pipeline.classify import run_classification_stage
    run_classification_stage(
        args.features, method=args.method, output_dir=args.output_dir,
        use_hierarchical_all=not args.no_hierarchical_all,
        labeled_roi_file=args.labeled_roi, device=args.device)
    print(f"stage 3 done -> {args.output_dir}")


def stage4(argv=None) -> None:
    p = argparse.ArgumentParser(description="Stage 4: evaluation")
    p.add_argument("--classification", default="output/class_map.npy")
    p.add_argument("--roi", default="output/ROI/roi_mask.npy")
    p.add_argument("--output-dir", default="output/evaluation_results")
    p.add_argument("--no-cluster-mapping", action="store_true")
    _add_device(p)
    args = p.parse_args(argv)
    from ..pipeline.evaluate import ClassificationEvaluator
    ev = ClassificationEvaluator(device=args.device)
    metrics = ev.evaluate_classification(
        args.classification, args.roi, args.output_dir,
        map_clusters=not args.no_cluster_mapping)
    print(f"OA={metrics['overall_accuracy']:.4f} "
          f"Kappa={metrics['kappa']:.4f} -> {args.output_dir}")
