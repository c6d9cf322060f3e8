"""Cross-process engine sharing for multi-worker serving.

The port's counterpart of ``image_enhancement_deglaring_tpu.serve.ipc``,
line for line: it is pure Python over ``multiprocessing.connection``.
One process owns the GPU, its CUDA context and the kernels, so the way to
scale the host-bound part of serving (multipart parsing, PNG decode, luma,
LANCZOS, PNG encode: the bottleneck PERF.md measures) across a host's
CPUs is:

- one ENGINE process owns the device: it runs the micro-batching
  InferenceEngine and an :class:`EngineIPCServer` on a unix socket;
- N HTTP WORKER processes bind the same port via SO_REUSEPORT (the kernel
  load-balances accepts) and do all host work, shipping 512^2 uint8
  frames to the engine over the socket via :class:`RemoteEngine`.

Frames from every worker land in the same engine queue, so requests
arriving on different workers still coalesce into one device batch.
A worker neither imports torch nor initialises CUDA, and workers start
with the ``spawn`` context: a ``fork`` of a process whose CUDA context
exists is fatal to the child. Without the engine's socket a worker's
``RemoteEngine`` raises; it never falls back to an engine of its own.
The reference has no counterpart (single uvicorn process,
reference: api/app.py:221-222).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from multiprocessing.connection import Client, Listener

import numpy as np


class EngineIPCServer:
    """Runs next to the InferenceEngine; serves frames from worker procs.

    Wire protocol (pickled tuples):
      worker -> engine:  ("infer", req_id, uint8 ndarray) | ("stats", req_id)
      engine -> worker:  ("ok", req_id, result) | ("err", req_id, message)
    """

    #: worker connects the socket queues before the accept thread takes
    #: them: ``Listener``'s default of 1 let a fourth worker's connect fail
    #: with EAGAIN on the card's host while that thread waited for the GIL
    BACKLOG = 64

    def __init__(self, engine, address: str):
        self.engine = engine
        self.address = address
        self._listener: Listener | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    def start(self) -> None:
        if os.path.exists(self.address):
            os.unlink(self.address)
        self._listener = Listener(self.address, family="AF_UNIX", backlog=self.BACKLOG)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except Exception:
                pass
        if os.path.exists(self.address):
            try:
                os.unlink(self.address)
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                if self._stop.is_set():
                    return  # stop() closed the listener — clean exit
                # transient accept failure (ECONNABORTED from a client
                # dropping mid-handshake, EMFILE under fd pressure):
                # returning here would permanently stop accepting new
                # workers while the engine keeps running
                time.sleep(0.1)
                continue
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            # prune finished connection threads so the list stays bounded
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn) -> None:
        # replies go through a per-connection writer thread: future
        # callbacks run in the ENGINE's drainer thread, and a conn.send
        # that blocks on a wedged worker's socket there would freeze
        # result delivery for every worker
        out_q: queue.Queue = queue.Queue(maxsize=1024)

        def writer():
            while True:
                item = out_q.get()
                if item is None:
                    return
                try:
                    conn.send(item)
                except (OSError, BrokenPipeError):
                    return

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

        def reply(kind, req_id, payload):
            try:
                out_q.put_nowait((kind, req_id, payload))
            except queue.Full:
                # the worker stopped reading: dropping the reply would leave
                # its Future unresolved for the client's full timeout —
                # close the connection instead so RemoteEngine fails every
                # pending future promptly ("engine connection lost")
                try:
                    conn.close()
                except Exception:
                    pass

        try:
            while not self._stop.is_set():
                msg = conn.recv()
                kind, req_id = msg[0], msg[1]
                if kind == "stats":
                    reply("ok", req_id, self.engine.stats())
                elif kind == "infer":
                    try:
                        fut = self.engine.submit(msg[2])
                    except Exception as e:
                        # per-request error (e.g. wrong frame shape), NOT a
                        # reason to kill the whole worker connection
                        reply("err", req_id, str(e))
                        continue
                    fut.add_done_callback(
                        lambda f, rid=req_id: reply("ok", rid, f.result())
                        if f.exception() is None
                        else reply("err", rid, str(f.exception()))
                    )
                else:
                    reply("err", req_id, f"unknown message kind {kind!r}")
        except (EOFError, OSError):
            pass
        finally:
            # close first (unblocks a writer stuck in conn.send), then make
            # room for the sentinel so the writer thread always exits
            try:
                conn.close()
            except Exception:
                pass
            while True:
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            out_q.put(None)


class RemoteEngine:
    """Drop-in for InferenceEngine inside HTTP worker processes: submit()
    and stats() proxy over the unix socket; never imports torch."""

    def __init__(self, address: str):
        self._conn = Client(address, family="AF_UNIX")
        self._send_lock = threading.Lock()
        self._pending: dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 0
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                kind, req_id, payload = self._conn.recv()
                with self._pending_lock:
                    fut = self._pending.pop(req_id, None)
                if fut is None or fut.done():
                    continue
                if kind == "ok":
                    fut.set_result(payload)
                else:
                    fut.set_exception(RuntimeError(payload))
        # broad on purpose: ANY reader death (unpickling error on a corrupt
        # frame, unexpected message shape, ...) must fail the pending
        # futures — a silently dead reader leaves every in-flight AND future
        # request hanging its full timeout on a live-looking connection
        except Exception as e:
            with self._pending_lock:
                pending = list(self._pending.values())
                self._pending.clear()
            for fut in pending:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError(f"engine connection lost: {e}"))

    def _request(self, kind: str, payload=None) -> Future:
        fut: Future = Future()
        with self._pending_lock:
            req_id = self._next_id
            self._next_id += 1
            self._pending[req_id] = fut
        msg = (kind, req_id) if payload is None else (kind, req_id, payload)
        with self._send_lock:
            self._conn.send(msg)
        return fut

    def submit(self, img_u8: np.ndarray) -> Future:
        return self._request("infer", np.ascontiguousarray(img_u8))

    def stats(self) -> dict:
        return self._request("stats").result(timeout=10)

    def stop(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass


def _worker_main(address: str, host: str, port: int, image_size: int,
                 log_dir: str | None, model_info: dict | None = None) -> None:
    """HTTP worker entry point (spawned process): SO_REUSEPORT server backed
    by a RemoteEngine. Never imports torch or initializes CUDA.

    Runs the SAME SIGTERM drain loop as single-process serving
    (DeglareServer.serve_until_sigterm): on SIGTERM the worker stops
    accepting, answers every in-flight request, then exits 0 — so a
    rolling update of ``--workers N`` mode drops nothing."""
    import asyncio

    from .http_server import DeglareServer

    engine = RemoteEngine(address)
    # per-process log file: RotatingFileHandler's rename rotation is not
    # multi-process safe on a shared path
    server = DeglareServer(engine, host=host, port=port,
                           image_size=image_size, mode="resize",
                           log_dir=log_dir,
                           log_filename=f"api.worker{os.getpid()}.log",
                           model_info=model_info)

    async def run():
        srv = await asyncio.start_server(server._handle, host, port,
                                         reuse_port=True)
        server.logger.info(f"worker {os.getpid()} serving on {host}:{port}")
        await server.serve_until_sigterm(srv)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()


class MultiprocessServer:
    """Owns the worker processes + IPC server of ``--workers N`` serving.

    ``stop()`` performs the multi-process analogue of the single-process
    SIGTERM drain: SIGTERM every worker (each runs serve_until_sigterm, so
    it finishes its in-flight requests first), join with a grace deadline,
    SIGKILL stragglers, then tear down the IPC listener. Workers are also
    daemonic as a last-resort leak guard, but normal shutdown is owned
    here — previously nothing joined or terminated them at all."""

    def __init__(self, ipc: EngineIPCServer, procs: list):
        self.ipc = ipc
        self.procs = procs

    def __iter__(self):  # legacy (ipc, procs) unpacking
        return iter((self.ipc, self.procs))

    def any_alive(self) -> bool:
        return any(p.is_alive() for p in self.procs)

    #: default drain deadline: must exceed the HTTP layer's bounded engine
    #: wait (DeglareServer.INFER_TIMEOUT_S = 300 s — sized for cold remote
    #: dispatches), or stop() would SIGKILL a worker mid-drain and drop
    #: exactly the in-flight requests the drain exists to protect
    DRAIN_GRACE_S = 330.0

    def stop(self, grace_s: float | None = None) -> None:
        import time

        if grace_s is None:
            grace_s = self.DRAIN_GRACE_S
        for p in self.procs:
            if p.is_alive():
                p.terminate()  # SIGTERM -> worker drain loop
        deadline = time.monotonic() + grace_s
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():  # drain wedged past the grace window
                p.kill()
                p.join(timeout=5.0)
        self.ipc.stop()


def serve_multiprocess(engine, *, host: str, port: int, image_size: int,
                       n_workers: int, log_dir: str | None = None,
                       address: str | None = None,
                       model_info: dict | None = None) -> MultiprocessServer:
    """Start the IPC server + n_workers HTTP worker processes; returns a
    :class:`MultiprocessServer` that owns their lifecycle (callers must
    ``stop()`` it; it also unpacks as the legacy ``(ipc, procs)`` pair)."""
    import multiprocessing as mp
    import tempfile

    address = address or os.path.join(tempfile.gettempdir(),
                                      f"deglare_engine_{os.getpid()}.sock")
    ipc = EngineIPCServer(engine, address)
    ipc.start()
    ctx = mp.get_context("spawn")
    procs = []
    for _ in range(n_workers):
        p = ctx.Process(target=_worker_main,
                        args=(address, host, port, image_size, log_dir,
                              model_info),
                        daemon=True)
        p.start()
        procs.append(p)
    return MultiprocessServer(ipc, procs)
