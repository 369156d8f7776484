"""Stage CLI entry points of the port, with the JAX package's flags,
defaults and printed lines (``rs_image_segmentation_tpu.cli.stages``), plus
``--device`` (default: the CUDA card; ``--device cpu`` runs on the CPU).
Installed as ``rs-seg-torch-preprocess``, ``rs-seg-torch-features``,
``rs-seg-torch-classify``, ``rs-seg-torch-evaluate``,
``rs-seg-torch-classify-large`` and ``rs-seg-torch-batch``.

``classify_large`` and ``batch_classify`` load a ``--model`` ``.npz``
through ``models.serialize.load_flat_forest`` and any other ``--model``
(a joblib sklearn forest) through ``models.forest.forest_from_sklearn``,
importing joblib only then; without ``--model`` they train from the
``--samples`` points over the port's ``hierarchical_stack_fused``."""

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


def classify_large(argv=None) -> None:
    """Memory-bounded tiled classification of arbitrarily large scenes."""
    p = argparse.ArgumentParser(
        description="Tiled large-scene classification (global semantics)")
    p.add_argument("--scene", required=True,
                   help="raw (7-band uint8) or preprocessed scene GeoTIFF")
    p.add_argument("--raw", action="store_true",
                   help="scene is raw DNs: run the tiled preprocess first")
    p.add_argument("--method", default="random_forest",
                   choices=["random_forest", "kmeans", "rule_based"],
                   help="classification method (the reference's three "
                        "stage-3 branches, 3_classification.py:335-485)")
    p.add_argument("--clusters", type=int, default=7,
                   help="k for --method kmeans (reference default 7)")
    p.add_argument("--samples", default="data/samples.pkl")
    p.add_argument("--model", default=None,
                   help="joblib/npz forest to load instead of training")
    p.add_argument("--output", default="output/class_map_large.tif")
    p.add_argument("--tile-rows", type=int, default=504)
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist per-tile progress here; a re-run resumes "
                        "from the last completed tile")
    _add_device(p)
    args = p.parse_args(argv)

    import numpy as np

    from ..backend import resolve_device
    from ..io.tiff import TiffTileStreamWriter, read_tiff
    from ..models.forest import _gemm_for
    from ..pipeline.large_scene import (
        classify_large_scene, classify_large_scene_resumable,
        kmeans_large_scene, kmeans_large_scene_resumable, preprocess_large,
        rule_based_large_scene, rule_based_large_scene_resumable)

    dev = resolve_device(args.device)
    arr, info = read_tiff(args.scene)
    hists = None
    if args.raw:
        # the tiled preprocess counts the stretched-value histograms as a
        # byproduct; passing them on skips the classify pipeline's
        # whole-scene histogram pass
        arr, hists = preprocess_large(arr.astype(np.uint8),
                                      return_hist=True, device=dev)
    else:
        arr = arr.astype(np.uint8)

    if args.method == "kmeans":
        if args.checkpoint_dir:
            result = kmeans_large_scene_resumable(
                arr, args.checkpoint_dir, n_clusters=args.clusters,
                tile_rows=args.tile_rows, device=dev)
        else:
            result = kmeans_large_scene(arr, n_clusters=args.clusters,
                                        tile_rows=args.tile_rows, device=dev)
        _write_large_output(args.output, result, info)
        return
    if args.method == "rule_based":
        if args.checkpoint_dir:
            result = rule_based_large_scene_resumable(
                arr, args.checkpoint_dir, hists=hists, device=dev)
        else:
            result = rule_based_large_scene(arr, hists=hists, device=dev)
        _write_large_output(args.output, result, info)
        return

    if args.model:
        forest, depth = _load_forest(args.model)
    else:
        # train from point samples over a small feature extraction pass
        from ..pipeline.features import hierarchical_stack_fused
        from ..tools.sampling import training_matrix_from_samples
        from ..tools.supervised import train_random_forest_from_samples
        stack = hierarchical_stack_fused(arr, device=dev).cpu().numpy()
        x, y = training_matrix_from_samples(args.samples, stack)
        forest, depth = train_random_forest_from_samples(x, y)

    gf = _gemm_for(forest, 19)
    if args.checkpoint_dir:
        result = classify_large_scene_resumable(
            arr, gf, args.checkpoint_dir, tile_rows=args.tile_rows,
            hists=hists, device=dev)
        _write_large_output(args.output, result, info)
    else:
        # stream the GeoTIFF encode under the card's tile compute
        # (io.tiff.TiffTileStreamWriter) instead of writing after the loop
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with TiffTileStreamWriter(args.output, arr.shape[1], arr.shape[2],
                                  np.uint8, info.meta,
                                  compression="lzw") as sw:
            result = classify_large_scene(arr, gf, tile_rows=args.tile_rows,
                                          hists=hists, writer=sw, device=dev)
        print(f"large-scene classification {result.shape} -> {args.output}")


def _load_forest(path: str):
    """(FlatForest, depth) of a ``.npz`` (``models.serialize``) or a
    joblib sklearn forest."""
    if path.endswith(".npz"):
        from ..models.serialize import load_flat_forest
        return load_flat_forest(path)
    import joblib

    from ..models.forest import forest_from_sklearn
    return forest_from_sklearn(joblib.load(path))


def _write_large_output(path: str, result, info) -> None:
    import numpy as np

    from ..io.tiff import write_tiff
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_tiff(path, result.astype(np.uint8)[None], info.meta,
               compression="lzw", tiled=True)
    print(f"large-scene classification {result.shape} -> {path}")


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


def batch_classify(argv=None) -> None:
    """Multi-scene batch classification (BASELINE config #5): N scenes ->
    GeoTIFF class map + optional Kappa report each, through the turbo
    program (uniform uint8 scenes) or the streamed one
    (``tools.batch.run_batch_workflow``)."""
    p = argparse.ArgumentParser(
        description="Batch scene classification (turbo path)")
    p.add_argument("scenes", nargs="+", help="raw 7-band uint8 scene TIFFs")
    p.add_argument("--samples", default="data/samples.pkl",
                   help="point samples to train from (ignored with --model)")
    p.add_argument("--model", default=None,
                   help="joblib/npz forest to load instead of training")
    p.add_argument("--rois", nargs="*", default=None,
                   help="per-scene ROI .npy/.tif for Kappa reports")
    p.add_argument("--output-dir", default="output/batch_results")
    _add_device(p)
    args = p.parse_args(argv)

    import numpy as np

    from ..backend import resolve_device
    from ..tools.batch import run_batch_workflow

    dev = resolve_device(args.device)
    if args.model:
        forest, depth = _load_forest(args.model)
    else:
        from ..core.config import CalibrationConfig
        from ..io.tiff import read_tiff
        from ..pipeline.features import hierarchical_stack_fused
        from ..pipeline.preprocess import preprocess_bands
        from ..tools.sampling import training_matrix_from_samples
        from ..tools.supervised import train_random_forest_from_samples
        cal = CalibrationConfig()
        arr, _ = read_tiff(args.scenes[0])
        pre = preprocess_bands(arr, np.asarray(cal.gains),
                               np.asarray(cal.biases), device=dev)
        stack = hierarchical_stack_fused(pre.float(), device=dev)
        x, y = training_matrix_from_samples(args.samples,
                                            stack.cpu().numpy())
        forest, depth = train_random_forest_from_samples(x, y)

    results = run_batch_workflow(args.scenes, forest, depth,
                                 args.output_dir, roi_paths=args.rois,
                                 device=dev)
    for r in results:
        extra = (f"  OA={r['overall_accuracy']:.4f} Kappa={r['kappa']:.4f}"
                 if "overall_accuracy" in r else "")
        print(f"{r['scene']} -> {r['class_map']}{extra}")
    print(f"batch classification: {len(results)} scene(s) -> "
          f"{args.output_dir}")
