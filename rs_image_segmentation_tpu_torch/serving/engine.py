"""Batching inference engine: a long-lived classifier process core.

Counterpart of ``rs_image_segmentation_tpu.serving.engine``. The expensive
things (forest tensorization and packing, kernel builds, device
residency) are paid once per process, not once per request, and
concurrent requests for same-shaped scenes coalesce into one batched
program on the card: the turbo programs (``pipeline.turbo``) keep every
per-scene statistic per scene, so a batch of B scenes costs one set of
launches instead of B.

Design:

* Requests enter a (method, shape)-keyed pending map; a single dispatch
  thread drains the oldest group, waiting up to ``batch_window_ms`` for
  stragglers of the same method+shape (dynamic batching). The method is
  chosen **per request**, so one engine and one program cache serve
  mixed rf/kmeans/rule traffic.
* The group pads UP to a *bucket* (default 1/2/4/8) by repeating the last
  scene. Padding is exact: every per-scene statistic (percentiles, PCA,
  GLCM normalizers) is computed per scene, so scene i's class map does
  not depend on what else sits in the batch; padded outputs are dropped.
  Buckets bound the distinct program shapes per scene shape to
  len(buckets).
* Per-(method, bucket, shape) programs are built on first use or ahead of
  time via :meth:`InferenceEngine.warmup` (which also builds the CUDA
  kernels and packs the forest onto the card).
* A forest of any size takes the batched supervised program: past
  ``models.forest.GEMM_MAX_LEAVES`` its GEMM form keeps a sparse path,
  and ``ops.kernels.forest_labels`` walks it as it walks any other.
* The pending queue is bounded (``EngineConfig.max_pending``): beyond it
  ``submit`` fails fast with :class:`EngineSaturated` instead of letting
  host memory grow without bound under a wedged device.
* Futures are handled cancellation-safely: the dispatch loop claims each
  request with ``Future.set_running_or_notify_cancel()`` and skips ones
  a client cancelled while queued (e.g. after a client-side timeout), so
  a cancelled future can never poison the rest of its batch.

The engine runs on ``device`` (CUDA unless the caller names the CPU; with
no CUDA device and no device named it raises). The dispatch thread and a
caller's :meth:`warmup` share the device's default stream. Results
surface as ``concurrent.futures.Future``s of numpy ``(H, W)`` uint8 maps;
``classify`` is the blocking convenience wrapper.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import DeviceLike, as_tensor, resolve_device
from ..core.config import CalibrationConfig, FeatureStageConfig
from ..models.forest import FlatForest, GemmForest, _gemm_for
from ..pipeline import large_scene, turbo
from ..pipeline.preprocess import band_counts, stretch_tables_from_counts
from ..utils.log import get_logger
from ..utils.timing import span

_log = get_logger("serving")


class EngineSaturated(RuntimeError):
    """Raised by ``submit`` when the pending queue is at ``max_pending``
    — the fail-fast back-pressure signal (HTTP layer maps it to 503)."""


@dataclass(frozen=True)
class EngineConfig:
    """Dynamic-batching knobs. ``buckets`` is normalized against
    ``max_batch``: buckets above it are dropped, and ``max_batch`` itself
    is appended if absent — so every group size has a bucket and the
    largest bucket is always reachable (any ``max_batch >= 1`` works).

    ``program_cache`` bounds the number of live (method, bucket, scene
    shape) programs: beyond it the least-recently-used one is dropped.
    ``strict_shapes`` optionally pins an (H, W) allowlist: submissions
    outside it are rejected up front (HTTP 400).

    ``kmeans_fit_stride``: systematic-subsample stride for the kmeans
    fit (``pipeline.turbo.kmeans_scenes_turbo_batch``).

    ``kmeans_shared_fit``: fit ONE k-means model per batch (subsample
    drawn across all scenes) instead of per scene — an opt-in departure
    from the reference's per-scene fits for same-distribution traffic:
    cluster ids become comparable across the batch and the fit cost
    amortizes over it."""
    max_batch: int = 8                   # scenes per device program
    batch_window_ms: float = 5.0         # wait for same-shape stragglers
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    latency_window: int = 256            # recent per-request latencies kept
    max_pending: int = 256               # queued scenes before submit 503s
    program_cache: int = 32              # live (method, bucket, shape) programs
    strict_shapes: Optional[Tuple[Tuple[int, int], ...]] = None
    kmeans_fit_stride: int = 8
    kmeans_shared_fit: bool = False
    kmeans_warm_start: bool = False      # seed the shared fit from the
    # previous batch's converged centroids (requires kmeans_shared_fit):
    # steady-state traffic pays a few convergence-gated Lloyd iterations
    # instead of a full k-means++ seed + fit. Deliberately history-
    # dependent (cluster ids stay stable ACROSS batches — the production
    # property); leave off for per-batch reproducibility.

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be sorted unique: {self.buckets}")
        if self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {self.max_pending}")
        if self.program_cache < 1:
            raise ValueError(
                f"program_cache must be >= 1, got {self.program_cache}")
        if self.kmeans_fit_stride < 1:
            raise ValueError(f"kmeans_fit_stride must be >= 1, "
                             f"got {self.kmeans_fit_stride}")
        if self.kmeans_warm_start and not self.kmeans_shared_fit:
            raise ValueError("kmeans_warm_start requires kmeans_shared_fit "
                             "(warm centroids are the shared-fit state)")
        if self.strict_shapes is not None:
            object.__setattr__(self, "strict_shapes", tuple(
                (int(h), int(w)) for h, w in self.strict_shapes))
        eff = tuple(b for b in self.buckets if b <= self.max_batch)
        if not eff or eff[-1] != self.max_batch:
            eff = eff + (self.max_batch,)
        object.__setattr__(self, "buckets", eff)


@dataclass
class _Request:
    scene: np.ndarray
    future: Future
    t_submit: float = field(default_factory=time.perf_counter)


class InferenceEngine:
    """Long-lived scene classifier with dynamic batching.

    Serves any of the reference's three classification methods:
    ``random_forest`` (needs a trained forest), ``kmeans`` (unsupervised,
    k-means++ + Lloyd), or ``rule_based`` (threshold rules + morphology
    and connected-component post-processing). The constructor's
    ``method`` is only the *default*; every :meth:`submit` /
    :meth:`classify` may name its own, and one engine batches mixed
    traffic per (method, shape) group.

    Parameters
    ----------
    forest, depth:
        A trained ``FlatForest`` (``models.forest``) and its max depth —
        e.g. from ``models.forest.fit_random_forest`` or
        ``models.serialize.load_flat_forest``. Only required for requests
        with ``method="random_forest"``. ``depth`` is accepted as the JAX
        package's engine takes it (the CLI and the tests pass it); the
        forest kernel reads each tree's depth from the forest itself.
    device:
        Where the programs run: CUDA unless the caller names another
        device (``"cpu"``); with no CUDA device and none named, raises.
    """

    METHODS = ("random_forest", "kmeans", "rule_based")

    def __init__(self, forest: Optional[FlatForest] = None,
                 depth: int = 0,
                 cal: CalibrationConfig = CalibrationConfig(),
                 cfg: FeatureStageConfig = FeatureStageConfig(),
                 engine_cfg: EngineConfig = EngineConfig(),
                 method: str = "random_forest",
                 n_clusters: int = 7, kmeans_seed: int = 42,
                 device: DeviceLike = None):
        self._device = resolve_device(device)
        if method not in self.METHODS:
            raise ValueError(f"method must be one of {self.METHODS}, "
                             f"got {method!r}")
        if method == "random_forest" and forest is None:
            raise ValueError("random_forest serving needs a trained forest")
        if n_clusters < 2:
            raise ValueError(f"kmeans needs n_clusters >= 2, "
                             f"got {n_clusters}")
        self._method = method
        self._cal = cal
        self._cfg = cfg
        self._ecfg = engine_cfg
        self._n_clusters = n_clusters
        self._kmeans_seed = kmeans_seed
        self._gains = np.asarray(cal.gains)
        self._biases = np.asarray(cal.biases)
        self._forest = None
        self._gf = None
        if forest is not None:
            self._forest = FlatForest(*(t.to(self._device) for t in forest))
            gf = _gemm_for(self._forest, n_features=19)
            self._gf = GemmForest(*(t.to(self._device) for t in gf))

        self._lock = threading.Condition()
        # key = (method, scene.shape); value = FIFO of requests
        self._pending: "collections.OrderedDict[tuple, collections.deque]" = \
            collections.OrderedDict()
        self._closed = False
        self._stats = {
            "requests": 0, "batches": 0, "padded_scenes": 0,
            "errors": 0, "cancelled": 0, "rejected": 0,
            "rejected_shape": 0, "program_evictions": 0,
            "rule_overflow_reroutes": 0,
            # seconds and counts: submit to claim, and the host stretch
            # statistics of each dispatched batch
            "queue_wait_s": 0.0, "queue_waits": 0,
            "host_stats_s": 0.0, "host_stats_batches": 0,
            "batch_sizes": collections.Counter(),
            "methods": collections.Counter(),
        }
        # LRU of live programs: (method, bucket, (c, h, w), warm) -> the
        # per-key closure from _build_program (holding the device-resident
        # forest); bounded by program_cache
        self._programs: "collections.OrderedDict" = collections.OrderedDict()
        # warm-start state: last converged shared-fit centroids per scene
        # shape (kmeans_warm_start only)
        self._km_cents: Dict[tuple, np.ndarray] = {}
        self._latencies: collections.deque = collections.deque(
            maxlen=engine_cfg.latency_window)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="rs-seg-dispatch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- public

    @property
    def device(self) -> torch.device:
        """The device the engine's programs run on."""
        return self._device

    def available_methods(self) -> Tuple[str, ...]:
        """Methods this engine can route (random_forest needs a forest)."""
        if self._forest is not None:
            return self.METHODS
        return tuple(m for m in self.METHODS if m != "random_forest")

    def submit(self, scene: np.ndarray,
               method: Optional[str] = None) -> Future:
        """Enqueue a raw uint8 ``(7, H, W)`` scene; resolves to the
        ``(H, W)`` uint8 class map. ``method`` overrides the engine
        default for this request."""
        scene = np.asarray(scene)
        fut: Future = Future()
        try:
            method = self._resolve_method(method)
            self._validate(scene)
        except Exception as e:
            fut.set_exception(e)
            return fut
        # copy: the batch may dispatch after the caller regains control,
        # and a caller mutating its array must not corrupt the result
        # (np.ascontiguousarray aliases already-contiguous input)
        req = _Request(scene.copy(), fut)
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError("engine is shut down"))
                return fut
            n_pending = sum(len(q) for q in self._pending.values())
            if n_pending >= self._ecfg.max_pending:
                self._stats["rejected"] += 1
                fut.set_exception(EngineSaturated(
                    f"engine saturated: {n_pending} scenes pending "
                    f"(max_pending={self._ecfg.max_pending})"))
                return fut
            self._pending.setdefault((method, scene.shape),
                                     collections.deque()).append(req)
            self._stats["requests"] += 1
            self._stats["methods"][method] += 1
            self._lock.notify_all()
        return fut

    def classify(self, scene: np.ndarray, timeout: Optional[float] = None,
                 method: Optional[str] = None) -> np.ndarray:
        """Blocking single-scene convenience wrapper around :meth:`submit`.

        On timeout the queued request is cancelled (so the dispatch loop
        skips it) before the TimeoutError propagates."""
        fut = self.submit(scene, method=method)
        try:
            return fut.result(timeout=timeout)
        except FutureTimeoutError:
            fut.cancel()
            raise

    def warmup(self, shapes: Sequence[Tuple[int, int]],
               buckets: Optional[Sequence[int]] = None,
               methods: Optional[Sequence[str]] = None) -> None:
        """Build programs for ``(H, W)`` scene shapes ahead of traffic.

        Runs a dummy scene through every (method, bucket, shape)
        combination so first real requests find the kernels built and the
        forest on the card. ``methods`` defaults to the engine's default
        method; pass ``engine.available_methods()`` to warm everything
        routable. Shapes are validated up front the same way ``submit``
        validates scenes, so a bad shape is a ValueError here."""
        buckets = tuple(buckets) if buckets is not None else self._ecfg.buckets
        methods = (tuple(methods) if methods is not None
                   else (self._method,))
        nb = len(self._gains)
        for m in methods:
            self._resolve_method(m)
        for h, w in shapes:
            # same dimension contract submit enforces
            self._validate(np.zeros((nb, int(h), int(w)), np.uint8))
        rng = np.random.default_rng(0)
        for h, w in shapes:
            # random content: a constant band would make the stretch LUT's
            # min==max division degenerate (as it would in the reference)
            scene = rng.integers(0, 256, (nb, int(h), int(w))
                                 ).astype(np.uint8)
            for m in methods:
                for b in buckets:
                    self._run_batch([scene] * b, method=m, bucket=b,
                                    record_stats=False)
                    if m == "kmeans" and self._ecfg.kmeans_warm_start:
                        # warm the warm-start variant too (extra centroids
                        # input); state is seeded with a dummy and dropped
                        # so warmup never contaminates real warm-start
                        # state
                        key = (nb, int(h), int(w))
                        with self._lock:
                            self._km_cents[key] = rng.random(
                                (self._n_clusters, 19)).astype(np.float32)
                        try:
                            self._run_batch([scene] * b, method=m, bucket=b,
                                            record_stats=False)
                        finally:
                            with self._lock:
                                self._km_cents.pop(key, None)

    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._latencies)
            st = {
                "method": self._method,
                "available_methods": list(self.available_methods()),
                "requests": self._stats["requests"],
                "batches": self._stats["batches"],
                "padded_scenes": self._stats["padded_scenes"],
                "errors": self._stats["errors"],
                "cancelled": self._stats["cancelled"],
                "rejected": self._stats["rejected"],
                "pending": sum(len(q) for q in self._pending.values()),
                "batch_sizes": dict(self._stats["batch_sizes"]),
                "methods": dict(self._stats["methods"]),
                "warm_programs": sorted(
                    [m, b, list(s)] + (["warm_start"] if wm else [])
                    for m, b, s, wm in self._programs),
                "program_cache_size": len(self._programs),
                "program_cache_limit": self._ecfg.program_cache,
                "program_evictions": self._stats["program_evictions"],
                "rule_overflow_reroutes":
                    self._stats["rule_overflow_reroutes"],
                "rejected_shape": self._stats["rejected_shape"],
                "queue_wait_s": {"sum": self._stats["queue_wait_s"],
                                 "count": self._stats["queue_waits"]},
                "host_stats_s": {"sum": self._stats["host_stats_s"],
                                 "count": self._stats["host_stats_batches"]},
                "strict_shapes": (
                    [list(s) for s in self._ecfg.strict_shapes]
                    if self._ecfg.strict_shapes is not None else None),
                # a forest of any size takes the GEMM form
                "gemm_forest": self._forest is not None,
            }
        if lat:
            st["latency_s"] = {
                "p50": lat[len(lat) // 2],
                "p90": lat[min(len(lat) - 1, int(len(lat) * 0.9))],
                "max": lat[-1],
                "n": len(lat),
            }
        return st

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the dispatch thread; pending requests fail."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for q in self._pending.values():
                for req in q:
                    # claim before failing: a future the client already
                    # cancelled must not receive set_exception
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(
                            RuntimeError("engine shut down"))
            self._pending.clear()
            self._lock.notify_all()
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------ internal

    def _resolve_method(self, method: Optional[str]) -> str:
        method = method if method is not None else self._method
        if method not in self.METHODS:
            raise ValueError(f"method must be one of {self.METHODS}, "
                             f"got {method!r}")
        if method == "random_forest" and self._forest is None:
            raise ValueError("random_forest requests need an engine "
                             "constructed with a trained forest")
        return method

    def _validate(self, scene: np.ndarray) -> None:
        nb = len(self._gains)
        if scene.ndim != 3 or scene.shape[0] != nb:
            raise ValueError(f"scene must be ({nb}, H, W), got {scene.shape}")
        if scene.dtype != np.uint8:
            raise ValueError(f"scene must be uint8 raw DNs (stage-1 input "
                             f"contract), got {scene.dtype}")
        if (scene.shape[1] < self._cfg.glcm.window_size
                or scene.shape[2] < self._cfg.glcm.window_size):
            raise ValueError(
                f"scene {scene.shape[1]}x{scene.shape[2]} smaller than the "
                f"GLCM window ({self._cfg.glcm.window_size})")
        allow = self._ecfg.strict_shapes
        if allow is not None and (scene.shape[1], scene.shape[2]) not in allow:
            with self._lock:
                self._stats["rejected_shape"] += 1
            raise ValueError(
                f"scene shape {scene.shape[1]}x{scene.shape[2]} not in the "
                f"strict-shapes allowlist {sorted(allow)}")

    def _dispatch_loop(self) -> None:
        while True:
            group: List[_Request] = []
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if self._closed:
                    return
                # oldest (method, shape) group first (insertion order)
                key = next(iter(self._pending))
            method = key[0]
            # dynamic batching: linger up to batch_window_ms for stragglers
            deadline = time.perf_counter() + self._ecfg.batch_window_ms / 1e3
            while True:
                with self._lock:
                    q = self._pending.get(key)
                    now = time.perf_counter()
                    while q and len(group) < self._ecfg.max_batch:
                        req = q.popleft()
                        # claim the future; skip ones cancelled while
                        # queued (client timeout / disconnect)
                        if req.future.set_running_or_notify_cancel():
                            group.append(req)
                            self._stats["queue_wait_s"] += now - req.t_submit
                            self._stats["queue_waits"] += 1
                        else:
                            self._stats["cancelled"] += 1
                    if q is not None and not q:
                        del self._pending[key]
                    if self._closed or len(group) >= self._ecfg.max_batch:
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._lock.wait(timeout=remaining)
            if not group:
                continue
            try:
                maps = self._run_batch([r.scene for r in group],
                                       method=method)
                now = time.perf_counter()
                with self._lock:
                    for r in group:
                        self._latencies.append(now - r.t_submit)
                for r, m in zip(group, maps):
                    if not r.future.done():
                        r.future.set_result(m)
            except Exception as e:   # surface per-request, keep serving
                _log.exception("batch of %d failed", len(group))
                with self._lock:
                    self._stats["errors"] += len(group)
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _bucket_for(self, n: int) -> int:
        for b in self._ecfg.buckets:
            if b >= n:
                return b
        return self._ecfg.buckets[-1]

    def _run_batch(self, scenes: List[np.ndarray],
                   method: Optional[str] = None,
                   bucket: Optional[int] = None,
                   record_stats: bool = True) -> List[np.ndarray]:
        with span("serve.batch"):
            method = method if method is not None else self._method
            n = len(scenes)
            if method == "kmeans" and self._ecfg.kmeans_shared_fit:
                # shared fit draws its subsample ACROSS the batch (stride
                # scales with b), so padded duplicates would enter the fit —
                # over-weighting the repeated scene and changing every output
                # vs an unpadded run. Disabling padding (b = n) keeps the
                # exactness contract.
                b = n
            elif method == "kmeans":
                # per-scene fits dispatch through the SINGLE-SCENE program
                # below (b = n: padding would be pure waste) — see there
                b = n
            else:
                b = bucket if bucket is not None else self._bucket_for(n)
            # pad up by repeating the last scene: per-scene statistics (and
            # frozen converged lanes) make the first n outputs bit-identical
            # to an unpadded run
            padded = list(scenes) + [scenes[-1]] * (b - n)
            batch = np.stack(padded)
            # each scene's stretch LUT and its stretched-value histogram,
            # from its raw counts: the preamble then skips its own count
            t_stats = time.perf_counter()
            stats = [stretch_tables_from_counts(band_counts(s), self._gains,
                                                self._biases)
                     for s in padded]
            t_stats = time.perf_counter() - t_stats
            luts, hists = (np.stack(p) for p in zip(*stats))
            luts = luts.astype(np.uint8)
            with self._lock:
                if record_stats:
                    self._stats["batches"] += 1
                    self._stats["batch_sizes"][n] += 1
                    self._stats["padded_scenes"] += b - n
                    self._stats["host_stats_s"] += t_stats
                    self._stats["host_stats_batches"] += 1
            dev = self._device
            inputs = (as_tensor(batch, dev), as_tensor(luts, dev),
                      as_tensor(hists, dev))
            if method == "kmeans" and self._ecfg.kmeans_warm_start:
                # shared-fit warm start: seed this batch's Lloyd loop from the
                # last converged centroids for this scene shape (tiny K x F
                # host state; convergence-gated, so quality is self-healing)
                shape_key = tuple(batch.shape[1:])
                with self._lock:
                    prev = self._km_cents.get(shape_key)
                run = self._program_for(method, b, batch.shape[1:],
                                        warm=prev is not None)
                if prev is not None:
                    maps, cents = run(*inputs, prev)
                else:
                    maps, cents = run(*inputs)
                if record_stats:    # warmup traffic must not seed real state
                    with self._lock:
                        self._km_cents[shape_key] = cents.cpu().numpy()
            elif method == "kmeans" and not self._ecfg.kmeans_shared_fit:
                # default per-scene-fit route: dispatch each scene through
                # the SAME single-scene program the direct-request path runs,
                # regardless of how many arrived together, so responses are
                # bit-identical however requests are batched, and no scene
                # waits on the slowest lane's Lloyd iterations
                run = self._program_for(method, 1, batch.shape[1:])
                maps = torch.cat([run(*(x[i:i + 1] for x in inputs))
                                  for i in range(n)])
            else:
                run = self._program_for(method, b, batch.shape[1:])
                maps = run(*inputs)
            if method == "rule_based":
                maps, overflow = maps
                out = maps[:n].cpu().numpy()
                ov = overflow[:n].cpu().numpy()
                if ov.any() and not record_stats:
                    # warmup scenes are random noise (~H*W/4 runs — far past
                    # the cap by construction); their outputs are discarded,
                    # so paying the slow uncapped reroute would warm nothing
                    pass
                elif ov.any():
                    # the batched min-area machinery hit its 32768-id cap on
                    # these scenes (dense speckle / very large rasters) —
                    # recompute them through the uncapped whole-image path.
                    # Inputs match exactly: the stretched scene is the LUT
                    # applied to the raw DNs and `hists` already holds the
                    # stretched-value histograms.
                    nb = luts.shape[1]
                    for i in np.nonzero(ov)[0]:
                        pre = luts[i][np.arange(nb)[:, None, None], padded[i]]
                        out[i] = large_scene.rule_based_large_scene(
                            pre, cfg=self._cfg,
                            hists=hists[i].astype(np.int64), device=dev)
                    with self._lock:
                        self._stats["rule_overflow_reroutes"] += int(ov.sum())
                    _log.warning("min-area id cap hit on %d scene(s); "
                                 "rerouted to the uncapped rule path",
                                 int(ov.sum()))
                return [out[i] for i in range(n)]
            out = maps[:n].cpu().numpy()
            return [out[i] for i in range(n)]

    def _program_for(self, method: str, bucket: int, shape: tuple,
                     warm: bool = False):
        """LRU-cached per-(method, bucket, scene-shape) program: the
        closure from :meth:`_build_program`. The cache cardinality is
        bounded by ``EngineConfig.program_cache``. ``warm`` selects the
        kmeans warm-start variant (extra centroids input)."""
        key = (method, bucket, tuple(shape), warm)
        with self._lock:
            run = self._programs.get(key)
            if run is not None:
                self._programs.move_to_end(key)
                return run
        run = self._build_program(method, warm=warm)
        with self._lock:
            while len(self._programs) >= self._ecfg.program_cache:
                self._programs.popitem(last=False)
                self._stats["program_evictions"] += 1
            self._programs[key] = run
        return run

    def _build_program(self, method: str, warm: bool = False):
        """The batched program for ``method`` as a plain
        (batch, luts, stretch_hists) callable on the engine's device.
        Under ``kmeans_warm_start`` the kmeans program also returns the
        converged centroids, and the ``warm`` variant takes them as a
        fourth input."""
        cfg, dev = self._cfg, self._device
        if method == "random_forest":
            gf = self._gf

            def run(bd, ld, hd):
                return turbo.classify_scenes_turbo(
                    bd, ld, gf, cfg, stretch_hists=hd, device=dev)
        elif method == "kmeans":
            k, seed = self._n_clusters, self._kmeans_seed
            stride = self._ecfg.kmeans_fit_stride
            shared = self._ecfg.kmeans_shared_fit
            track = self._ecfg.kmeans_warm_start

            if warm:
                def run(bd, ld, hd, prev):
                    return turbo.kmeans_scenes_turbo_batch(
                        bd, ld, n_clusters=k, cfg=cfg, seed=seed,
                        fit_stride=stride, stretch_hists=hd,
                        shared_fit=shared, init_cents=prev,
                        return_cents=True, device=dev)
            else:
                def run(bd, ld, hd):
                    return turbo.kmeans_scenes_turbo_batch(
                        bd, ld, n_clusters=k, cfg=cfg, seed=seed,
                        fit_stride=stride, stretch_hists=hd,
                        shared_fit=shared, return_cents=track, device=dev)
        else:
            def run(bd, ld, hd):
                # return_overflow: (maps, (B,) bool) — scenes whose
                # min-area stage hit the 32768-id cap get rerouted to
                # the uncapped path in _run_batch instead of silently
                # returning a truncated label map
                return turbo.rule_based_scenes_turbo_batch(
                    bd, ld, cfg, stretch_hists=hd, return_overflow=True,
                    device=dev)
        return run
