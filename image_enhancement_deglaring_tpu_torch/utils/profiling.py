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
- :func:`span` marks a stretch of the program's own host work (the serving
  engine's threads, the train step) while any ``torch.profiler`` session
  runs in the process, on whichever thread runs it. :func:`spans` reads
  the records; :func:`stop_trace` writes a session's records into its
  trace, on the rows of their threads, beside those threads' CUDA calls.

A span records its name, its start and end on ``time.perf_counter_ns()``,
the native id of its thread, the enclosing span on the same thread, and
small attributes. The profiler gives a thread's CUDA runtime calls its
native id where it records that thread's host ops (the thread that
started the session), and otherwise the thread's pthread id cut to 32
bits (:func:`trace_tids`). The records go into one ring of
:data:`SPAN_RING` entries for the whole process. With no session running,
a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple
from urllib.parse import parse_qs, urlparse

from torch.autograd import profiler as _autograd_profiler

MAX_CAPTURE_MS = 60_000
SPAN_RING = 1 << 16
ANCHOR = "profiling.anchor"
ANCHORS = 5


class SpanRecord(NamedTuple):
    """One finished span; ``parent`` is the ``id`` of the span that
    enclosed it on its thread, or None."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    tid: int
    parent: int | None
    attrs: dict


_ring: deque = deque(maxlen=SPAN_RING)
_ring_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_threads: dict[int, tuple[str, int]] = {}  # native id -> (name, pthread id)


def _thread_stack() -> list:
    """This thread's open span ids; the first call registers the thread
    (:func:`stop_trace` drops threads that have ended)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.tid = threading.get_native_id()
        _threads[_local.tid] = (threading.current_thread().name, threading.get_ident())
    return stack


def trace_tids(native_id: int) -> tuple[int, ...]:
    """The ``tid`` values a profiler trace may give the CUDA calls of the
    thread with ``native_id``: the native id itself, else its pthread id's
    low 32 bits, read unsigned or as the magnitude of a signed number.
    Only threads that recorded a span are known."""
    if native_id not in _threads:
        return (native_id,)
    low = _threads[native_id][1] & 0xFFFFFFFF
    return (native_id, low, (1 << 32) - low)


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _thread_stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        record = (self.id, self.name, self.start_ns, end, _local.tid, self.parent, self.attrs)
        with _ring_lock:
            _ring.append(record)
        return False


class _Off:
    """The span while no session runs: records nothing, and is false, so
    that ``if sp:`` skips attributes that cost something to compute."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """``with span("engine.step", batch=7) as sp:`` records the block while
    a ``torch.profiler`` session runs in the process; ``sp.set(...)`` adds
    attributes before it ends."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def spans(start_ns: int = 0, end_ns: int | None = None) -> list[SpanRecord]:
    """The records in the ring whose start lies in ``[start_ns, end_ns]``
    (``time.perf_counter_ns()``), oldest first."""
    with _ring_lock:
        records = list(_ring)
    return [SpanRecord._make(r) for r in records
            if r[2] >= start_ns and (end_ns is None or r[2] <= end_ns)]


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
    prof.spans_from_ns = time.perf_counter_ns()  # the session's spans, for stop_trace
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> str:
    """Stop a session from :func:`start_trace` after the device's queued
    work, and write its trace into ``log_dir``, with the session's spans
    (:func:`span`) on their threads' rows; returns the file's path."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    anchors_ns = _anchors()
    prof.stop()
    stop_ns = time.perf_counter_ns()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                      f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    records = spans(getattr(prof, "spans_from_ns", 0), stop_ns)
    if records:
        _write_spans(path, records, anchors_ns)
    alive = {t.native_id for t in threading.enumerate()}
    for tid in [tid for tid in _threads if tid not in alive]:  # such as HTTP handlers'
        del _threads[tid]
    return path


def _anchors() -> list[int]:
    """Ranges both clocks see: ``ANCHORS`` ``ANCHOR`` ranges in the
    profiler's timeline, and the ``perf_counter_ns`` read inside each. The
    shortest is the anchor: a range that another thread's hold on the
    interpreter lock stretched, or the slow first range of a process, maps
    the clocks less exactly."""
    import torch

    marks = []
    for _ in range(ANCHORS):
        with torch.profiler.record_function(ANCHOR):
            marks.append(time.perf_counter_ns())
    return marks


def _write_spans(path: str, records: list, anchors_ns: list[int]) -> None:
    """Add ``records`` to the trace at ``path`` as complete events on their
    threads' rows (the first of :func:`trace_tids` the trace has, else the
    native id), mapped onto its clock by the shortest of the session's last
    ``ANCHOR`` ranges (:func:`_anchors`). The file is read and written
    whole, which takes time and memory in proportion to the capture's
    length (PERF.md gives the H100 host's rate)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    ranges = sorted((e for e in events if e.get("name") == ANCHOR and "dur" in e),
                    key=lambda e: float(e["ts"]))[-len(anchors_ns):]
    if len(ranges) != len(anchors_ns):
        return
    a, mark = min(zip(ranges, anchors_ns), key=lambda p: float(p[0]["dur"]))
    offset_us = float(a["ts"]) + float(a["dur"]) / 2 - mark / 1e3
    present = {e.get("tid") for e in events if e.get("ph") == "X"}
    rows = {}
    for tid in {r.tid for r in records}:
        rows[tid] = next((t for t in trace_tids(tid) if t in present), tid)
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for tid, row in sorted(rows.items()):
        if row not in named:
            events.append({"ph": "M", "name": "thread_name", "pid": a["pid"], "tid": row,
                           "args": {"name": _threads.get(tid, (str(tid),))[0]}})
    for r in records:
        events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": a["pid"],
                       "tid": rows[r.tid], "ts": r.start_ns / 1e3 + offset_us,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": dict(r.attrs, span=r.id, parent=r.parent)})
    text = json.dumps(doc)  # one call of the C encoder: json.dump's chunks are Python's
    with open(path, "w") as f:
        f.write(text)


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
    process's device work, this thread's host ops and every thread's spans
    (:func:`span`, such as the serving engine's) into ``log_dir`` (default
    ``$TMPDIR/deglare_traces``) and answers ``{"trace": path, "ms": N}``;
    a request during a capture answers 409. Returns the server
    (``shutdown()`` stops it)."""
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
