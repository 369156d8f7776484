"""The open-loop load generator of ``open_loop_http``, run as its own
process so its interpreter does not share the server's.

    python perfbench/loops/loadgen.py SPEC.json

The spec names the server's port, the .npy file of the scene pool, the
requests (offset in seconds from the start, pool index) and the output
path. The generator encodes each pool scene's request body, opens
``connections`` keep-alive connections, sends ``warm`` requests one after
another, prints ``ready`` and waits for ``go`` on its standard input.
Then each request is handed to a free connection at its due time (open
loop: a late connection makes the request late, and its latency counts
from the due time), and every response body is read and hashed. It waits
for outstanding responses up to ``grace_s`` past the last due time, writes
``{"requests": [...], "lateness": ...}`` and the first body of each
(pool index, digest) to the output path (JSON, then ``.npz``), and prints
``done``.
"""

from __future__ import annotations

import hashlib
import http.client
import io
import json
import queue
import sys
import threading
import time

import numpy as np


def _body(scene: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, scene)
    return buf.getvalue()


def _post(conn, path: str, body: bytes):
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/x-npy"})
    resp = conn.getresponse()
    data = resp.read()
    return resp, data


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    pool = np.load(spec["pool"])
    bodies = [_body(s) for s in pool]
    path = f"/v1/classify?method={spec['method']}"
    host, port = "127.0.0.1", spec["port"]
    conns = [http.client.HTTPConnection(host, port, timeout=spec["grace_s"])
             for _ in range(spec["connections"])]
    for i in range(spec["warm"]):
        _post(conns[i % len(conns)], path, bodies[i % len(bodies)])
    offsets = spec["offsets"]
    picks = spec["picks"]
    n = len(offsets)
    rec = [None] * n
    kept: dict = {}
    lock = threading.Lock()
    todo: "queue.Queue" = queue.Queue()

    def worker(conn):
        while True:
            item = todo.get()
            if item is None:
                return
            k, due = item
            sent = time.perf_counter()
            r = {"pick": picks[k], "due": due - t0, "sent": sent - t0}
            try:
                resp, data = _post(conn, path, bodies[picks[k]])
                r["status"] = resp.status
                if resp.status == 200:
                    for key, hdr in (("decode_ms", "X-Decode-Ms"),
                                     ("engine_ms", "X-Engine-Ms"),
                                     ("encode_ms", "X-Encode-Ms")):
                        r[key] = float(resp.getheader(hdr, "nan"))
                    digest = hashlib.blake2b(data, digest_size=16).hexdigest()
                    r["digest"] = digest
                    with lock:
                        kept.setdefault((picks[k], digest), data)
            except (OSError, http.client.HTTPException) as e:
                r["status"] = 0
                r["error"] = f"{type(e).__name__}: {e}"
                conn.close()
            r["done"] = time.perf_counter() - t0
            rec[k] = r

    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 2
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in conns]
    for t in threads:
        t.start()
    for k, off in enumerate(offsets):
        due = t0 + off
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put((k, due))
    for _ in threads:
        todo.put(None)
    deadline = time.perf_counter() + spec["grace_s"]
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    out = [r if r is not None else {"pick": picks[k], "due": offsets[k],
                                    "status": 0, "error": "no response"}
           for k, r in enumerate(rec)]
    late = sorted(r["sent"] - r["due"] for r in out if "sent" in r)
    summary = {"requests": out,
               "lateness_s": {"max": late[-1] if late else None,
                              "p99": late[int(0.99 * (len(late) - 1))]
                              if late else None}}
    with open(spec["out"] + ".json", "w") as f:
        json.dump(summary, f)
    np.savez(spec["out"] + ".npz", **{
        f"{p}_{d}": np.load(io.BytesIO(b)) for (p, d), b in kept.items()})
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
