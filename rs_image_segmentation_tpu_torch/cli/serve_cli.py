"""``rs-seg-torch-serve``: run the batching classification server on the
card.

Counterpart of ``rs_image_segmentation_tpu.cli.serve_cli``, with its
flags and defaults plus ``--device`` (default: the CUDA card); the
training inputs default to the project-relative ``data/samples.pkl`` and
``data/raw/AA.tif`` of the other CLIs. The model comes from (in priority order) ``--model`` (an npz saved by
``models.serialize.save_flat_forest``), or ``--samples`` + ``--scene``
(train on the fly exactly like the reference's supervised workflow,
modules/supervised_classifiers.py:118-163), over the port's
``hierarchical_stack_fused``. The engine
(``serving.engine.InferenceEngine``) is built and warmed up, then
``serving.server.serve`` answers until interrupted.
"""

from __future__ import annotations

import argparse

from .stages import _add_device


def serve_cli(argv=None) -> None:
    p = argparse.ArgumentParser(description="Batching classification server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--method", default="random_forest",
                   choices=("random_forest", "kmeans", "rule_based"),
                   help="DEFAULT classification method (reference stage-3 "
                        "trio); clients may override per request with "
                        "?method=...; kmeans/rule_based need no model")
    p.add_argument("--clusters", type=int, default=7,
                   help="k for --method kmeans (reference default 7)")
    p.add_argument("--model", default=None,
                   help="npz forest (models.serialize.save_flat_forest)")
    p.add_argument("--samples", default="data/samples.pkl",
                   help="(x, y) pickle to train from when --model is absent")
    p.add_argument("--scene", default="data/raw/AA.tif",
                   help="scene used to derive training features when "
                        "training from --samples")
    p.add_argument("--warmup", action="append", default=[],
                   metavar="HxW", help="pre-compile for these scene shapes "
                                       "(repeatable), e.g. --warmup 600x600")
    p.add_argument("--warmup-all-methods", action="store_true",
                   help="warm every routable method for the --warmup "
                        "shapes, not just the default one")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--max-pending", type=int, default=256,
                   help="queued-scene cap before submissions get 503")
    p.add_argument("--request-timeout", type=float, default=600.0,
                   help="per-request device timeout in seconds (504 past "
                        "it); 0 = wait forever")
    p.add_argument("--program-cache", type=int, default=32,
                   help="max live compiled (method, bucket, shape) device "
                        "programs; LRU-evicted beyond this")
    p.add_argument("--strict-shapes", action="append", default=[],
                   metavar="HxW",
                   help="reject scene shapes outside this allowlist "
                        "(repeatable) instead of cold-compiling them")
    p.add_argument("--kmeans-shared-fit", action="store_true",
                   help="fit ONE kmeans model per batch instead of per "
                        "scene (cluster ids comparable across the batch; "
                        "fit cost amortizes over it) — departs from the "
                        "reference's per-scene fits; for "
                        "same-distribution traffic")
    p.add_argument("--kmeans-fit-stride", type=int, default=8,
                   help="systematic-subsample stride for the kmeans fit; "
                        "1 = the full-pixel per-scene fit (pre-round-4 "
                        "behavior). Quality ladder (bundled ROI, mapped "
                        "kappa): see docs/BENCHMARKS.md")
    p.add_argument("--kmeans-warm-start", action="store_true",
                   help="seed each batch's shared fit from the previous "
                        "batch's converged centroids (needs "
                        "--kmeans-shared-fit): steady-state traffic pays "
                        "a few convergence-gated Lloyd iterations and "
                        "cluster ids stay stable ACROSS batches")
    _add_device(p)
    args = p.parse_args(argv)

    import numpy as np

    from ..backend import resolve_device
    from ..serving.engine import EngineConfig, InferenceEngine
    from ..serving.server import serve

    dev = resolve_device(args.device)
    if args.model:
        # a forest enables random_forest routing even when the default
        # method is kmeans/rule_based
        from ..models.serialize import load_flat_forest
        forest, depth = load_flat_forest(args.model)
    elif args.method != "random_forest":
        forest, depth = None, 0
    else:
        from ..core.config import CalibrationConfig
        from ..io.tiff import read_tiff
        from ..pipeline.features import hierarchical_stack_fused
        from ..pipeline.preprocess import preprocess_bands
        from ..tools.sampling import SampleSet
        from ..tools.supervised import train_random_forest_from_samples
        cal = CalibrationConfig()
        arr, _ = read_tiff(args.scene)
        pre = preprocess_bands(arr, np.asarray(cal.gains),
                               np.asarray(cal.biases), device=dev)
        stack = hierarchical_stack_fused(pre.float(),
                                         device=dev).cpu().numpy()
        coords, labels = SampleSet.load(args.samples)
        x = np.nan_to_num(stack[coords[:, 1], coords[:, 0], :])
        forest, depth = train_random_forest_from_samples(x, labels)

    engine = InferenceEngine(
        forest, depth, method=args.method, n_clusters=args.clusters,
        engine_cfg=EngineConfig(
            max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms,
            max_pending=args.max_pending,
            program_cache=args.program_cache,
            strict_shapes=(tuple(
                (int(sp.partition("x")[0]), int(sp.partition("x")[2]))
                for sp in args.strict_shapes)
                if args.strict_shapes else None),
            kmeans_shared_fit=args.kmeans_shared_fit,
            kmeans_fit_stride=args.kmeans_fit_stride,
            kmeans_warm_start=args.kmeans_warm_start),
        device=dev)
    shapes = []
    for spec in args.warmup:
        h, _, w = spec.partition("x")
        shapes.append((int(h), int(w)))
    if shapes:
        methods = (engine.available_methods() if args.warmup_all_methods
                   else None)
        print(f"warming {shapes} (methods: "
              f"{methods or (args.method,)}) ...", flush=True)
        engine.warmup(shapes, methods=methods)
    serve(engine, args.host, args.port,
          request_timeout=args.request_timeout or None)


if __name__ == "__main__":
    serve_cli()
