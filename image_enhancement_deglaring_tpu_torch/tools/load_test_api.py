"""Load-test the /infer path of a running server.

    python -m image_enhancement_deglaring_tpu_torch.tools.load_test_api \\
        --url http://127.0.0.1:4000 [--size 512] [--filter adaptive|up] \\
        [--requests 200 --concurrency 16]          # closed loop
        [--rate 100 --duration 10 --connections 64] # open loop

Counterpart of ``scripts/load_test_api.py`` without PIL: it posts a
document-like grayscale PNG (written by the port's codec) to ``/infer``
over keep-alive connections and prints one JSON line with the
throughput and the latency percentiles. By default the PNG's rows carry
the filters PIL's encoder picks (sub, up and Paeth rows), as the JAX
tool's PIL-written upload and real clients do; ``--filter up`` writes
every row "up", which the server decodes fastest.

- Closed loop (the default): ``--concurrency`` connections, each sending
  its next request when the last one is answered, ``--requests`` in all.
  Latency is send to answer.
- Open loop (``--rate`` > 0): requests arrive on a fixed schedule,
  ``--rate`` per second for ``--duration`` seconds, whatever the server
  does; up to ``--connections`` are in flight at once. Latency runs from
  a request's scheduled arrival to its answer, so time spent waiting for
  a free connection counts (no coordinated omission).

``--selftest`` starts an in-process server with an engine that returns
its input at once: it measures the HTTP and host image layer alone.
One warm request is sent before the clock starts. The exit code is 1 if
any request failed.
"""

from __future__ import annotations

import argparse
import http.client
import json
import queue
import sys
import threading
import time
from urllib.parse import urlparse

import numpy as np

from ..data.png import encode_png


def make_document_png(size: int, filter_type: int | str = "adaptive") -> bytes:
    """Synthetic scanned-document page: white ground, text lines, glare
    (``scripts/load_test_api.py``'s page, encoded by the port's codec
    under ``filter_type``, by default PIL's choice of filters)."""
    rng = np.random.default_rng(0)
    img = np.full((size, size), 235, np.uint8)
    for r in range(size // 12, size - 10, size // 24):
        mask = rng.random(size) < 0.4
        img[r : r + max(2, size // 64), mask] = 40
    yy, xx = np.mgrid[0:size, 0:size]
    glare = (80 * np.exp(-(((yy - size * 0.4) / (size * 0.5)) ** 2
                           + ((xx - size * 0.6) / (size * 0.6)) ** 2)))
    img = np.clip(img.astype(np.int32) + glare.astype(np.int32), 0, 255)
    return encode_png(img.astype(np.uint8), filter_type=filter_type)


def multipart_body(png: bytes) -> tuple[bytes, dict]:
    boundary = "LOADTESTBOUND"
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="image"; '
        f'filename="doc.png"\r\nContent-Type: image/png\r\n\r\n'
    ).encode() + png + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


class _Client:
    """One keep-alive connection; reconnects after a failed request."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.host, self.port, self.timeout = host, port, timeout
        self.conn = http.client.HTTPConnection(host, port, timeout=timeout)

    def infer(self, body: bytes, headers: dict) -> bool:
        try:
            self.conn.request("POST", "/infer", body=body, headers=headers)
            resp = self.conn.getresponse()
            data = resp.read()
            return resp.status == 200 and b'"image"' in data
        except (OSError, http.client.HTTPException):
            self.conn.close()
            self.conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
            return False

    def close(self) -> None:
        self.conn.close()


def _percentiles(latencies: list[float]) -> dict:
    lat = sorted(latencies)

    def pct(p):
        return lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 if lat else None

    return {"latency_ms_p50": pct(0.50), "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99)}


def closed_loop(host: str, port: int, body: bytes, headers: dict, *,
                requests: int, concurrency: int) -> dict:
    lock = threading.Lock()
    remaining = [requests]
    latencies: list[float] = []
    errors = [0]

    def worker():
        client = _Client(host, port)
        while True:
            with lock:
                if remaining[0] <= 0:
                    break
                remaining[0] -= 1
            t0 = time.perf_counter()
            ok = client.infer(body, headers)
            dt = time.perf_counter() - t0
            with lock:
                if ok:
                    latencies.append(dt)
                else:
                    errors[0] += 1
        client.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return {"mode": "closed", "concurrency": concurrency, "requests_ok": len(latencies),
            "errors": errors[0], "wall_s": wall, "req_per_s": len(latencies) / wall,
            **_percentiles(latencies)}


def open_loop(host: str, port: int, body: bytes, headers: dict, *,
              rate: float, duration: float, connections: int) -> dict:
    n = max(1, int(round(rate * duration)))
    arrivals: queue.Queue = queue.Queue()
    lock = threading.Lock()
    latencies: list[float] = []
    errors = [0]
    start = time.perf_counter() + 0.05

    def worker():
        client = _Client(host, port)
        while True:
            due = arrivals.get()
            if due is None:
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            ok = client.infer(body, headers)
            done = time.perf_counter()
            with lock:
                if ok:
                    latencies.append(done - due)
                else:
                    errors[0] += 1
        client.close()

    # the schedule is known up front: request i is due at start + i / rate;
    # a worker takes the next due time as soon as it is free
    for i in range(n):
        arrivals.put(start + i / rate)
    for _ in range(connections):
        arrivals.put(None)
    threads = [threading.Thread(target=worker) for _ in range(connections)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - start
    return {"mode": "open", "rate_per_s": rate, "duration_s": duration,
            "connections": connections, "requests_ok": len(latencies),
            "errors": errors[0], "wall_s": wall, "req_per_s": len(latencies) / wall,
            **_percentiles(latencies)}


class _PassthroughEngine:
    """Instant engine: isolates the HTTP/host layer (multipart, decode,
    resizes, PNG encode, base64, keep-alive loop) from the device."""

    def submit(self, img_u8):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result(img_u8)
        return fut

    def stats(self):
        return {"requests_served": -1}

    def stop(self):
        pass


def _start_selftest_server():
    import socket
    import tempfile

    from ..serve.http_server import DeglareServer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = DeglareServer(_PassthroughEngine(), host="127.0.0.1", port=port,
                           image_size=512, log_dir=tempfile.mkdtemp(prefix="loadtest-"))
    threading.Thread(target=server.run, daemon=True).start()
    for _ in range(100):
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=1)
            c.request("GET", "/ping")
            c.getresponse().read()
            return port
        except OSError:
            time.sleep(0.1)
    raise RuntimeError("selftest server failed to start")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="http://127.0.0.1:4000")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--filter", choices=["adaptive", "up"], default="adaptive",
                    help="PNG row filters of the upload: PIL's choice, or all 'up'")
    ap.add_argument("--requests", type=int, default=200, help="closed loop: requests in all")
    ap.add_argument("--concurrency", type=int, default=16, help="closed loop: connections")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open loop: arrivals per second (0 = closed loop)")
    ap.add_argument("--duration", type=float, default=10.0, help="open loop: seconds")
    ap.add_argument("--connections", type=int, default=64,
                    help="open loop: most requests in flight at once")
    ap.add_argument("--selftest", action="store_true",
                    help="spin up an in-process server with a passthrough "
                         "engine: measures the HTTP/host layer alone")
    args = ap.parse_args(argv)
    if args.selftest:
        args.url = f"http://127.0.0.1:{_start_selftest_server()}"
    u = urlparse(args.url)
    png = make_document_png(args.size, 2 if args.filter == "up" else "adaptive")
    body, headers = multipart_body(png)

    # one warm request before the clock starts; a down server still gives
    # the errors-counted summary below
    warm = _Client(u.hostname, u.port, timeout=600)
    if not warm.infer(body, headers):
        print("warm request failed; proceeding cold", file=sys.stderr)
    warm.close()
    if args.rate > 0:
        result = open_loop(u.hostname, u.port, body, headers, rate=args.rate,
                           duration=args.duration, connections=args.connections)
    else:
        result = closed_loop(u.hostname, u.port, body, headers,
                             requests=args.requests, concurrency=args.concurrency)
    result["input"] = (f"{args.size}x{args.size} document PNG, {args.filter} filters "
                       f"({len(png)} B)")
    print(json.dumps(result))
    return 0 if result["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
