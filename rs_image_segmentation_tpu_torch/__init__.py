"""PyTorch + CUDA port of ``rs_image_segmentation_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package so each counterpart is easy to find.
The port imports neither JAX nor the JAX package; it keeps its own copies
of the host-side numpy code it needs (configs, stretch tables, the CART
trainer).

Ported:
* the supervised turbo path ``pipeline.turbo.classify_scenes_turbo`` —
  raw ``(B, 7, H, W)`` uint8 scenes -> stretch preamble (CUDA kernel
  ``lut_hist``) -> 19-channel channel-major stack -> forest labels (CUDA
  kernel ``forest_labels``) -> ``(B, H, W)`` uint8 class maps;
* the batched rule program ``pipeline.turbo.rule_based_scenes_turbo_batch``
  (CUDA kernels ``ccmin_prop``, ``hist_dense`` and ``keep_lut``);
* the single-scene rule program ``pipeline.turbo.rule_based_scenes_turbo``
  and the uncapped large-scene route
  ``pipeline.large_scene.rule_based_large_scene``, both through
  ``pipeline.classify.rule_based_classify`` (CUDA kernel ``cc_labels``);
* stage 1, ``pipeline.preprocess.preprocess_bands`` (uint8: the exact
  host LUT; other dtypes: CUDA kernel ``fused_calibrate_stretch``), into
  stage 2, ``pipeline.features.extract_features`` and
  ``hierarchical_stack_fused`` (CUDA kernels ``fused_spectral_indices``
  and ``glcm_grid``);
* the KMeans programs, forest predict and stage 4's metrics;
* the tiled large-scene pipeline, ``pipeline.large_scene``
  (``preprocess_large``, ``classify_large_scene`` and its streamed and
  resumable forms, ``kmeans_large_scene`` and the resumable KMeans and
  rule drivers; CUDA kernels ``lut_hist``, ``forest_labels`` and
  ``cc_labels``), with host-to-device tile streaming from pinned memory
  (``io.stream``);
* serving, ``serving.engine.InferenceEngine`` (dynamic batching of the
  three turbo programs on the card) behind ``serving.server``'s HTTP API,
  with ``serving.client``; the (Geo)TIFF codec ``io.tiff`` with its native
  binding ``io.native``, ``models.serialize`` (the JAX package's npz
  formats), ``core.types.GeoMeta`` and ``utils.log``;
* the four-stage file pipeline: the stage drivers of
  ``pipeline.preprocess``, ``features``, ``classify`` and ``evaluate``
  with their writers and plots, ``io.artifacts`` (the stage-2 files),
  ``pipeline.visualize``, ``ops.features_aux``, ``core.types.Raster`` and
  ``cli.stages``'s ``stage1`` … ``stage4``;
* the tools and the rest of the CLI: ``tools.sampling``,
  ``tools.supervised``, ``tools.batch`` (the batch workflow's turbo and
  streamed branches), ``utils.guards``, ``utils.timing``,
  ``utils.traceview``, ``utils.plotting``, ``cli.tools_cli``,
  ``cli.serve_cli`` and ``cli.stages``'s ``classify_large`` and
  ``batch_classify``;
* multi-device runs, ``parallel`` on ``torch.distributed`` (one process
  a rank, one device a rank, local blocks and explicit collectives:
  meshes, halo rings, the all-reduce KMeans fit, forest rows and leaves,
  spatial sharding, stage pipelining, the multi-process rehearsal with
  ``cli.multihost_cli``) and ``tools.batch.run_batch_workflow``'s
  ``mesh``.

Nothing of the JAX package is left unported.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit device they raise (``backend.py``).
"""

__version__ = "0.1.0"
