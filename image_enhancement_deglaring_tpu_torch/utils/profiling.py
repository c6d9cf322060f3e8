"""Profiling and tracing utilities.

Counterpart of ``image_enhancement_deglaring_tpu.utils.profiling``:

- :func:`trace` captures a ``torch.profiler`` trace of the enclosed region
  (host ops, and the device's kernels and copies when a card is present)
  into a Chrome/TensorBoard ``*.pt.trace.json`` file;
- :func:`start_trace_server` serves captures on demand. torch has no live
  profiler server like ``jax.profiler.start_server``, so this is a small
  HTTP endpoint: ``GET /trace?ms=N`` traces N ms and answers with the
  file's path. Device work is recorded process-wide (CUPTI), so kernels
  that other threads launch, such as the serving engine's, land in the
  capture; host ops are those of the thread that started the session;
- :class:`StepTimer`: rolling step timing without a profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

MAX_CAPTURE_MS = 60_000


def start_trace(log_dir: str):
    """Start a profiler session (CPU, plus CUDA when a card is present)
    that writes into ``log_dir``; pass it to :func:`stop_trace`."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # host ops of the caller's thread only: the experimental
    # profile_all_threads session crashes the process (SIGSEGV / abort) when
    # it starts or stops while other threads run torch ops, as a loader's
    # or the serving engine's do
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> str:
    """Stop a session from :func:`start_trace` after the device's queued
    work, and write its trace into ``log_dir``; returns the file's path."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                      f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed region into ``log_dir``."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


def start_trace_server(port: int = 9999, log_dir: str | None = None) -> ThreadingHTTPServer:
    """Serve on-demand captures on 127.0.0.1:``port`` from a daemon thread.
    ``GET /trace?ms=N`` (default 1000, at most 60000) records N ms of the
    process's device work (and this thread's host ops) into ``log_dir`` (default ``$TMPDIR/deglare_traces``)
    and answers ``{"trace": path, "ms": N}``; a request during a capture
    answers 409. Returns the server (``shutdown()`` stops it)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "deglare_traces")
    busy = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _answer(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (http.server's name)
            url = urlparse(self.path)
            if url.path != "/trace":
                self._answer(404, {"detail": "GET /trace?ms=N"})
                return
            try:
                ms = int(parse_qs(url.query).get("ms", ["1000"])[0])
            except ValueError:
                ms = -1
            if not 0 < ms <= MAX_CAPTURE_MS:
                self._answer(400, {"detail": f"ms must be in 1..{MAX_CAPTURE_MS}"})
                return
            if not busy.acquire(blocking=False):
                self._answer(409, {"detail": "a capture is running"})
                return
            try:
                prof = start_trace(log_dir)
                time.sleep(ms / 1000)
                path = stop_trace(prof, log_dir)
            finally:
                busy.release()
            self._answer(200, {"trace": path, "ms": ms})

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="trace-server", daemon=True).start()
    return server


class StepTimer:
    """Rolling window step timer: call ``tick(n_items)`` once per step."""

    def __init__(self, window: int = 50):
        self._times: deque[float] = deque(maxlen=window + 1)
        self._items: deque[int] = deque(maxlen=window)
        self._times.append(time.perf_counter())

    def tick(self, n_items: int = 1) -> None:
        self._times.append(time.perf_counter())
        self._items.append(n_items)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    @property
    def items_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._items) / dt if dt > 0 else 0.0

    @property
    def ms_per_step(self) -> float:
        sps = self.steps_per_sec
        return 1000.0 / sps if sps > 0 else float("inf")
