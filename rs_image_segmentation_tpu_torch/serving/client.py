"""Minimal stdlib client for the serving HTTP API (stdlib and numpy
only; the port's own copy of ``rs_image_segmentation_tpu.serving.client``)."""

from __future__ import annotations

import http.client
import io
import json
import urllib.parse
import urllib.request
from typing import Optional, Sequence, Tuple

import numpy as np


class ServingSession:
    """Keep-alive client: one persistent HTTP/1.1 connection reused
    across requests.

    ``classify_array`` via module-level functions opens a fresh TCP
    connection per request (urllib has no pooling). The server speaks
    HTTP/1.1 keep-alive, so a session amortizes connection setup to zero;
    it also surfaces the server's X-Decode/Engine/Encode-Ms timing
    headers."""

    def __init__(self, base_url: str, timeout: float = 300.0):
        u = urllib.parse.urlparse(base_url)
        self._conn = http.client.HTTPConnection(u.hostname, u.port,
                                                timeout=timeout)
        self.last_timing: dict = {}

    def classify_array(self, scene: np.ndarray,
                       method: Optional[str] = None) -> np.ndarray:
        buf = io.BytesIO()
        np.save(buf, np.asarray(scene))
        path = "/v1/classify" + (f"?method={method}" if method else "")
        self._conn.request("POST", path, body=buf.getvalue(),
                           headers={"Content-Type": "application/x-npy"})
        resp = self._conn.getresponse()
        payload = resp.read()
        self.last_timing = {
            k: float(resp.headers[h]) for k, h in
            [("decode_ms", "X-Decode-Ms"), ("engine_ms", "X-Engine-Ms"),
             ("encode_ms", "X-Encode-Ms")] if resp.headers.get(h)}
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {payload[:200]!r}")
        return np.load(io.BytesIO(payload), allow_pickle=False)

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _post(url: str, body: bytes, ctype: str, timeout: float):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=timeout)


def classify_array(base_url: str, scene: np.ndarray,
                   timeout: float = 300.0,
                   method: Optional[str] = None) -> np.ndarray:
    """POST a (7, H, W) uint8 scene as npy; returns the (H, W) class map.
    ``method`` selects the per-request classification method."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(scene))
    url = f"{base_url}/v1/classify" + (f"?method={method}" if method else "")
    with _post(url, buf.getvalue(),
               "application/x-npy", timeout) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def classify_tiff(base_url: str, tif_path: str, out_path: Optional[str] = None,
                  timeout: float = 300.0,
                  method: Optional[str] = None) -> Optional[np.ndarray]:
    """POST GeoTIFF bytes. With ``out_path``: writes the GeoTIFF class map
    (geo metadata preserved) and returns None; without: returns the map
    as an array (``?format=npy``)."""
    with open(tif_path, "rb") as f:
        body = f.read()
    q = []
    if not out_path:
        q.append("format=npy")
    if method:
        q.append(f"method={method}")
    url = f"{base_url}/v1/classify" + ("?" + "&".join(q) if q else "")
    with _post(url, body, "image/tiff", timeout) as resp:
        payload = resp.read()
    if out_path:
        with open(out_path, "wb") as f:
            f.write(payload)
        return None
    return np.load(io.BytesIO(payload), allow_pickle=False)


def warmup(base_url: str, shapes: Sequence[Tuple[int, int]],
           buckets: Optional[Sequence[int]] = None,
           methods: Optional[Sequence[str]] = None,
           timeout: float = 1200.0) -> dict:
    body = json.dumps({"shapes": [list(s) for s in shapes],
                       **({"buckets": list(buckets)} if buckets else {}),
                       **({"methods": list(methods)} if methods else {})})
    with _post(f"{base_url}/warmup", body.encode(), "application/json",
               timeout) as resp:
        return json.loads(resp.read())


def stats(base_url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(f"{base_url}/stats", timeout=timeout) as r:
        return json.loads(r.read())


def healthz(base_url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(f"{base_url}/healthz", timeout=timeout) as r:
        return json.loads(r.read())
