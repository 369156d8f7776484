"""HTTP front-end for the batching inference engine. Stdlib only.

Counterpart of ``rs_image_segmentation_tpu.serving.server``: the same
routes, status codes, timing headers and content negotiation.

Endpoints
---------
``GET  /healthz``          liveness + backend + queue depth
``GET  /stats``            engine counters / latency percentiles
``POST /warmup``           JSON ``{"shapes": [[H, W], ...], "buckets": [..],
                           "methods": ["random_forest", ...]}``
``POST /v1/classify``      body = scene; response = class map

Classify content negotiation (request ``Content-Type``):

* ``application/x-npy`` — body is ``np.save`` bytes of a ``(7, H, W)``
  uint8 array; response is ``np.save`` bytes of the ``(H, W)`` uint8 map.
* ``image/tiff`` — body is GeoTIFF bytes (the stage-1 raw-scene
  contract); response is a GeoTIFF class map carrying the input's
  geotransform/CRS (``?format=npy`` forces npy out).

``?method=random_forest|kmeans|rule_based`` selects the classification
method per request; omitted = the engine's default. ``/healthz`` reports
``"backend"`` as the engine's device type (``"cuda"`` or ``"cpu"``).

Back-pressure: device-side concurrency is bounded by the engine's dynamic
batching; host-side, the engine's bounded pending queue maps to **503**
(EngineSaturated) and the per-request device timeout (``request_timeout``
in :func:`make_server`) maps to **504** with the queued request cancelled
— so wedged device programs cannot pin handler threads or accumulate
unbounded scene bytes.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import time
import urllib.parse
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from ..io.tiff import read_tiff, write_tiff
from ..utils.log import get_logger
from .engine import EngineSaturated, InferenceEngine

_log = get_logger("serving.http")

MAX_BODY = 1 << 30   # 1 GiB: a 36 MP x 7-band uint8 scene is ~252 MB


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _load_npy(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


class _Handler(BaseHTTPRequestHandler):
    # set by serve(); class attributes so ThreadingHTTPServer handlers
    # see them
    engine: InferenceEngine = None
    request_timeout: Optional[float] = 600.0
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------ plumbing
    def log_message(self, fmt, *args):          # route through our logger
        _log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if code >= 400:
            # error paths may leave an unread request body; on a keep-alive
            # connection the next request line would be parsed out of body
            # bytes, so force the connection closed
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _read_body(self) -> Optional[bytes]:
        n = int(self.headers.get("Content-Length", 0))
        if n <= 0:
            self._send_json(411, {"error": "Content-Length required"})
            return None
        if n > MAX_BODY:
            self._send_json(413, {"error": f"body over {MAX_BODY} bytes"})
            return None
        return self.rfile.read(n)

    # ------------------------------------------------------------- routes
    def do_GET(self):
        if self.path == "/healthz":
            st = self.engine.stats()
            self._send_json(200, {"ok": True,
                                  "backend": self.engine.device.type,
                                  "pending": st["pending"]})
        elif self.path == "/stats":
            self._send_json(200, self.engine.stats())
        elif self.path == "/metrics":
            self._send(200, _prometheus_metrics(self.engine.stats()),
                       "text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        path, _, query = self.path.partition("?")
        try:
            if path == "/warmup":
                body = self._read_body()
                if body is None:
                    return
                spec = json.loads(body)
                shapes = [tuple(map(int, s)) for s in spec.get("shapes", [])]
                self.engine.warmup(shapes, spec.get("buckets"),
                                   spec.get("methods"))
                self._send_json(200, {"warmed": shapes})
            elif path == "/v1/classify":
                self._classify(query)
            else:
                self._send_json(404, {"error": f"no route {path}"})
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": str(e)})
        except Exception as e:                      # keep the server alive
            _log.exception("request failed")
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    def _classify(self, query: str) -> None:
        t0 = time.perf_counter()
        body = self._read_body()
        if body is None:
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        params = urllib.parse.parse_qs(query)
        want_npy = params.get("format", [""])[0] == "npy"
        method = params.get("method", [None])[0]
        meta = None
        if ctype == "image/tiff":
            scene, meta = _read_tiff_bytes(body)
        elif ctype in ("application/x-npy", "application/octet-stream", ""):
            scene = _load_npy(body)
        else:
            self._send_json(415, {"error": f"unsupported Content-Type "
                                           f"{ctype}"})
            return
        t1 = time.perf_counter()
        try:
            class_map = self.engine.classify(scene, method=method,
                                             timeout=self.request_timeout)
        except EngineSaturated as e:
            self._send_json(503, {"error": str(e)})
            return
        except FutureTimeoutError:
            self._send_json(504, {"error": f"classification exceeded "
                                           f"{self.request_timeout}s"})
            return
        t2 = time.perf_counter()
        if meta is not None and not want_npy:
            payload, out_ct = _write_tiff_bytes(class_map, meta), "image/tiff"
        else:
            payload, out_ct = _npy_bytes(class_map), "application/x-npy"
        # server-side decomposition of the request: decode = body read +
        # npy/tiff parse, engine = queue wait + batcher + device round
        # trip, encode = response serialization. What the client measures
        # beyond the sum is connection + wire time.
        self.send_response(200)
        self.send_header("Content-Type", out_ct)
        self.send_header("Content-Length", str(len(payload)))
        self.send_header("X-Decode-Ms", f"{(t1 - t0) * 1e3:.1f}")
        self.send_header("X-Engine-Ms", f"{(t2 - t1) * 1e3:.1f}")
        self.send_header("X-Encode-Ms",
                         f"{(time.perf_counter() - t2) * 1e3:.1f}")
        self.end_headers()
        self.wfile.write(payload)


def _prometheus_metrics(st: dict) -> bytes:
    """Prometheus text exposition of the engine counters (scrape with
    any stock Prometheus)."""
    lines = []

    def add(name, kind, help_, value, labels=""):
        lines.append(f"# HELP rsseg_{name} {help_}")
        lines.append(f"# TYPE rsseg_{name} {kind}")
        lines.append(f"rsseg_{name}{labels} {value}")

    add("requests_total", "counter", "scenes submitted", st["requests"])
    add("batches_total", "counter", "device programs dispatched",
        st["batches"])
    add("padded_scenes_total", "counter", "bucket-padding duplicates",
        st["padded_scenes"])
    add("errors_total", "counter", "requests failed in device batches",
        st["errors"])
    add("cancelled_total", "counter", "requests cancelled while queued",
        st["cancelled"])
    add("rejected_total", "counter", "requests rejected at max_pending",
        st["rejected"])
    add("rejected_shape_total", "counter",
        "requests rejected by the strict-shapes allowlist",
        st.get("rejected_shape", 0))
    add("pending", "gauge", "scenes waiting for dispatch", st["pending"])
    add("program_cache_size", "gauge",
        "live (method, bucket, shape) device programs",
        st.get("program_cache_size", 0))
    add("program_evictions_total", "counter",
        "LRU-evicted device programs", st.get("program_evictions", 0))
    for key, what, unit in (
            ("queue_wait", "from submit to dispatch", "requests"),
            ("host_stats", "building host stretch statistics", "batches")):
        add(f"{key}_seconds_total", "counter", f"seconds {what}",
            f"{st[key + '_s']['sum']:.6f}")
        add(f"{key}_seconds_count", "counter",
            f"{unit} counted in rsseg_{key}_seconds_total",
            st[key + "_s"]["count"])
    lines.append("# HELP rsseg_method_requests_total requests per method")
    lines.append("# TYPE rsseg_method_requests_total counter")
    for m, n in sorted(st.get("methods", {}).items()):
        lines.append(f'rsseg_method_requests_total{{method="{m}"}} {n}')
    lat = st.get("latency_s")
    if lat:
        lines.append("# HELP rsseg_latency_seconds request latency "
                     "(recent window)")
        lines.append("# TYPE rsseg_latency_seconds summary")
        for q in ("p50", "p90"):
            lines.append(f'rsseg_latency_seconds{{quantile='
                         f'"0.{q[1:]}"}} {lat[q]:.6f}')
        lines.append(f"rsseg_latency_seconds_count {lat['n']}")
    return ("\n".join(lines) + "\n").encode()


def _read_tiff_bytes(body: bytes) -> Tuple[np.ndarray, object]:
    with tempfile.NamedTemporaryFile(suffix=".tif", delete=False) as f:
        f.write(body)
        tmp = f.name
    try:
        arr, info = read_tiff(tmp)
        return arr, info.meta
    finally:
        os.unlink(tmp)


def _write_tiff_bytes(class_map: np.ndarray, meta) -> bytes:
    with tempfile.NamedTemporaryFile(suffix=".tif", delete=False) as f:
        tmp = f.name
    try:
        write_tiff(tmp, class_map.astype(np.uint8)[None], meta,
                   compression="lzw", tiled=True)
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        os.unlink(tmp)


def make_server(engine: InferenceEngine, host: str = "127.0.0.1",
                port: int = 8471,
                request_timeout: Optional[float] = 600.0
                ) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``.server_address`` holds
    the bound (host, port) — pass port 0 for an ephemeral one.
    ``request_timeout`` bounds how long a handler thread blocks on the
    engine before answering 504 (None = wait forever)."""
    handler = type("BoundHandler", (_Handler,),
                   {"engine": engine, "request_timeout": request_timeout})
    return ThreadingHTTPServer((host, port), handler)


def serve(engine: InferenceEngine, host: str = "127.0.0.1",
          port: int = 8471,
          request_timeout: Optional[float] = 600.0) -> None:
    """Blocking serve loop (CLI entry); Ctrl-C shuts the engine down."""
    httpd = make_server(engine, host, port, request_timeout)
    _log.info("serving on http://%s:%d", *httpd.server_address[:2])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.shutdown()
