"""The port's multi-worker serving (``serve/ipc.py``, ``cli.serve
--workers N``) on the CPU: the counterparts of tests/test_serve.py's IPC
tests (round trip, two spawned workers end to end, a bad frame's error
reply, the SIGTERM drain of both workers, the reader's death failing every
pending future, the worker import path), with the port's engine on the
CPU; the workers' answers equal the single-process server's byte for
byte. Every spawning test has its own time limits."""

import base64
import glob
import http.client
import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from multiprocessing.connection import Listener

import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.cli import serve as jax_serve_cli
from image_enhancement_deglaring_tpu_torch.cli import serve as serve_cli
from image_enhancement_deglaring_tpu_torch.data.png import decode_png, encode_png
from image_enhancement_deglaring_tpu_torch.models import LightweightUNet
from image_enhancement_deglaring_tpu_torch.serve import InferenceEngine, http_server
from image_enhancement_deglaring_tpu_torch.serve.ipc import (
    EngineIPCServer,
    MultiprocessServer,
    RemoteEngine,
    serve_multiprocess,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "deploy", "models", "best_model.onnx")
SIZE = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(**kw):
    model = LightweightUNet(features_start=4, generator=torch.Generator().manual_seed(1))
    return InferenceEngine(model, image_size=SIZE, max_batch_size=4, batch_timeout_ms=2.0,
                           compute_dtype=torch.float32, warmup=False, device="cpu", **kw)


def _frames(n, seed=0):
    return (np.random.default_rng(seed).random((n, SIZE, SIZE)) * 255).astype(np.uint8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, method, path, body=None, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _wait_ready(port, timeout=60):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            if _request(port, "GET", "/ping", timeout=5) == (200, b'{"message":"pong"}'):
                return
        except OSError as e:
            last = e
        time.sleep(0.1)
    raise AssertionError(f"no server answered /ping on port {port}: {last}")


def _wait_workers(log_dir, n, alive, timeout=120):
    """/ping answers once one worker is up: wait until ``n`` workers have
    logged that they serve."""
    deadline = time.time() + timeout
    while sum("serving on" in open(p).read()
              for p in glob.glob(os.path.join(log_dir, "api.worker*.log"))) < n:
        assert time.time() < deadline and alive(), "a worker never came up"
        time.sleep(0.1)


def _multipart(img_u8):
    boundary = "testboundary123"
    body = (f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="image"; filename="test.png"\r\n'
            "Content-Type: image/png\r\n\r\n").encode() + encode_png(img_u8) \
        + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def test_remote_engine_ipc_roundtrip(tmp_path):
    """RemoteEngine <-> EngineIPCServer: frames cross the unix socket and
    the results are the in-process engine's."""
    eng = _engine()
    addr = str(tmp_path / "engine.sock")
    ipc = EngineIPCServer(eng, addr)
    ipc.start()
    try:
        remote = RemoteEngine(addr)
        imgs = _frames(5)
        outs = np.stack([f.result(timeout=60) for f in [remote.submit(im) for im in imgs]])
        want = eng.infer_batch(imgs)
        diff = np.abs(outs.astype(np.int16) - want.astype(np.int16))
        assert outs.dtype == np.uint8 and diff.max() <= 1  # floor wobble across batchings
        assert remote.stats()["requests_served"] >= 5
        remote.stop()
    finally:
        ipc.stop()
        eng.stop()
    assert not os.path.exists(addr)


def test_remote_engine_bad_frame_err_reply(tmp_path):
    """A wrong-shape frame over IPC gets a per-request error reply; the
    connection survives and later requests still work."""
    eng = _engine()
    addr = str(tmp_path / "e.sock")
    ipc = EngineIPCServer(eng, addr)
    ipc.start()
    try:
        remote = RemoteEngine(addr)
        bad = remote.submit(np.zeros((SIZE + 3, SIZE), np.uint8))
        with pytest.raises(RuntimeError, match="frame"):
            bad.result(timeout=30)
        good = remote.submit(np.zeros((SIZE, SIZE), np.uint8))
        assert good.result(timeout=60).shape == (SIZE, SIZE)
        with pytest.raises(RuntimeError, match="unknown message kind"):
            remote._request("reload").result(timeout=30)
        remote.stop()
    finally:
        ipc.stop()
        eng.stop()


def test_remote_engine_reader_death_fails_pending(tmp_path):
    """ANY malformed engine->worker frame (not just EOF) fails the pending
    futures promptly."""
    address = str(tmp_path / "bad_engine.sock")
    listener = Listener(address, family="AF_UNIX")
    try:
        box = {}
        t = threading.Thread(target=lambda: box.setdefault("remote", RemoteEngine(address)))
        t.start()
        conn = listener.accept()
        t.join(30)
        remote = box["remote"]
        fut = remote._request("stats")
        conn.recv()  # consume the request so the pipe stays in sync
        conn.send(("ok", 0))  # 2-tuple: unpack ValueError in the reader
        with pytest.raises(RuntimeError, match="engine connection lost"):
            fut.result(timeout=30)
        remote.stop()
        conn.close()
    finally:
        listener.close()


def test_remote_engine_without_the_engine_socket_raises(tmp_path):
    """A worker never carries on with an engine of its own."""
    with pytest.raises(OSError):
        RemoteEngine(str(tmp_path / "missing.sock"))


def test_multiprocess_workers_end_to_end(tmp_path):
    """2 spawned HTTP worker processes (SO_REUSEPORT) share one CPU engine
    over IPC: every answer equals the single-process server's byte for
    byte, /stats through a worker is the engine's with the model info, and
    stop() drains both workers to exit code 0."""
    eng = _engine()
    eng.start()
    info = {"model_path": "/m.onnx", "model": "lightweight"}
    single = http_server.DeglareServer(eng, host="127.0.0.1", port=_free_port(), image_size=SIZE,
                                       log_dir=str(tmp_path / "single"), model_info=info)
    threading.Thread(target=single.run, daemon=True).start()
    port = _free_port()
    mps = serve_multiprocess(eng, host="127.0.0.1", port=port, image_size=SIZE, n_workers=2,
                             log_dir=str(tmp_path / "logs"), address=str(tmp_path / "e.sock"),
                             model_info=info)
    assert isinstance(mps, MultiprocessServer)
    ipc, procs = mps  # the (ipc, procs) unpacking stays supported
    try:
        _wait_ready(single.port)
        _wait_ready(port)
        _wait_workers(str(tmp_path / "logs"), 2, mps.any_alive)
        rng = np.random.default_rng(3)
        uploads = [rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8),
                   rng.integers(0, 256, (40, 52), dtype=np.uint8),
                   rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)]
        for img in uploads * 2:  # one at a time (batches of 1): lands on both workers
            body, headers = _multipart(img)
            want = _request(single.port, "POST", "/infer", body, headers)
            got = _request(port, "POST", "/infer", body, headers)
            assert got[0] == want[0] == 200
            assert got[1] == want[1]
            out = decode_png(base64.b64decode(json.loads(got[1])["image"]))
            assert out.shape == img.shape[:2]
        assert all(p.is_alive() for p in procs)
        status, data = _request(port, "GET", "/stats")
        stats = json.loads(data)
        assert status == 200 and stats["model_path"] == "/m.onnx"
        assert stats["requests_served"] == eng.stats()["requests_served"] == 12
        assert _request(port, "POST", "/infer", b"", {})[0] == 400
    finally:
        mps.stop(grace_s=60)
        eng.stop()
    assert not mps.any_alive()
    assert [p.exitcode for p in procs] == [0, 0]
    assert not os.path.exists(tmp_path / "e.sock")
    assert len(glob.glob(str(tmp_path / "logs" / "api.worker*.log"))) == 2


def test_multiprocess_sigterm_drains_both_workers(tmp_path):
    """SIGTERM on the parent forwards to both HTTP workers, each of which
    finishes its in-flight requests before exiting 0: every request already
    on the wire is answered 200, or 503 with Connection: close if the drain
    caught it unparsed, never dropped."""
    script = textwrap.dedent("""
        import signal, sys, threading, time
        from concurrent.futures import Future
        from image_enhancement_deglaring_tpu_torch.serve.ipc import serve_multiprocess

        class SlowEcho:
            # a host-side engine stand-in with a 1 s latency, so that
            # requests are caught mid-flight
            def submit(self, img):
                fut = Future()
                def work():
                    time.sleep(1.0)
                    fut.set_result(img)
                threading.Thread(target=work, daemon=True).start()
                return fut
            def stats(self):
                return {}
            def stop(self):
                pass

        port, logdir, sock = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        mps = serve_multiprocess(SlowEcho(), host="127.0.0.1", port=port,
                                 image_size=64, n_workers=2, log_dir=logdir,
                                 address=sock)
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        print("READY", flush=True)
        while not stop.is_set() and mps.any_alive():
            stop.wait(0.5)
        mps.stop()
        codes = [p.exitcode for p in mps.procs]
        assert codes == [0, 0], codes
        assert "torch" not in sys.modules
        print("DRAINED-EXIT", flush=True)
    """)
    port = _free_port()
    logdir = str(tmp_path / "logs")
    proc = subprocess.Popen([sys.executable, "-c", script, str(port), logdir,
                             str(tmp_path / "e.sock")], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        deadline, ready = time.time() + 120, False
        while time.time() < deadline and not ready:
            if sel.select(timeout=1.0):
                line = proc.stdout.readline()
                if not line and proc.poll() is not None:
                    break
                ready = "READY" in line
        sel.unregister(proc.stdout)
        assert ready, "parent never printed READY"
        _wait_ready(port)
        _wait_workers(logdir, 2, lambda: proc.poll() is None)

        img = (np.random.default_rng(0).random((64, 64)) * 255).astype(np.uint8)
        body, headers = _multipart(img)
        results = [None] * 12
        sent = threading.Barrier(13, timeout=60)  # 12 senders + main

        def do_req(i):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("POST", "/infer", body=body, headers=headers)
                sent.wait()
                resp = conn.getresponse()
                results[i] = (resp.status, resp.read())
            except Exception as e:  # a dropped connection
                results[i] = ("EXC", repr(e))
            finally:
                conn.close()

        threads = [threading.Thread(target=do_req, args=(i,)) for i in range(len(results))]
        for t in threads:
            t.start()
        sent.wait()  # all 12 requests on the wire
        time.sleep(0.6)  # let the workers dispatch them (engine latency 1 s)
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(60)
        n_ok = 0
        for st_data in results:
            assert st_data is not None, "request thread never finished"
            status, data = st_data
            assert status in (200, 503), st_data
            if status == 200:
                assert "image" in json.loads(data)
                n_ok += 1
        assert n_ok >= 1, results
        out = proc.communicate(timeout=120)[0]
        assert "DRAINED-EXIT" in out, out
        assert proc.returncode == 0
        worker_logs = glob.glob(os.path.join(logdir, "api.worker*.log"))
        assert len(worker_logs) == 2
        served = [open(p).read().count("Successfully processed image") for p in worker_logs]
        assert sum(served) == n_ok, (served, n_ok)
    finally:
        proc.kill()
        proc.wait(30)


def test_worker_import_path_stays_torch_free():
    """A spawned HTTP worker imports these modules: none of them may load
    torch (data/__init__ and serve/__init__ re-export lazily)."""
    code = (
        "import sys\n"
        "import image_enhancement_deglaring_tpu_torch.serve.http_server\n"
        "import image_enhancement_deglaring_tpu_torch.serve.imaging\n"
        "import image_enhancement_deglaring_tpu_torch.serve.metrics\n"
        "import image_enhancement_deglaring_tpu_torch.serve.openapi\n"
        "import image_enhancement_deglaring_tpu_torch.serve.ipc\n"
        "import image_enhancement_deglaring_tpu_torch.data.png\n"
        "from image_enhancement_deglaring_tpu_torch.data import decode_png, encode_png\n"
        "pulled = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')]\n"
        "assert not pulled, f'worker import path pulled in {pulled[:3]}'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("flags", [["--mode", "tile"], ["--mode", "both"], ["--allow_reload"]])
def test_cli_serve_usage_errors_before_the_model_loads(flags, tmp_path):
    """The JAX CLI's two usage errors, with its messages; the model path
    does not exist, so a load would raise another error."""
    argv = ["--model_path", str(tmp_path / "none.onnx"), "--workers", "2", *flags]
    with pytest.raises(SystemExit) as want:
        jax_serve_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        serve_cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "requires" in str(got.value)


def test_cli_serve_workers_answers_and_drains_on_sigterm(tmp_path):
    """``cli.serve --workers 2`` on the CPU: /ping and one /infer answer
    through the workers, and SIGTERM on the parent exits 0."""
    port = _free_port()
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_enhancement_deglaring_tpu_torch.cli.serve",
         "--model_path", ONNX, "--host", "127.0.0.1", "--port", str(port), "--workers", "2",
         "--device", "cpu", "--image_size", str(SIZE), "--compute_dtype", "float32",
         "--max_batch_size", "2", "--log_dir", str(tmp_path / "logs")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _wait_ready(port, timeout=120)
        _wait_workers(str(tmp_path / "logs"), 2, lambda: proc.poll() is None)
        img = np.random.default_rng(5).integers(0, 256, (SIZE, SIZE), dtype=np.uint8)
        status, data = _request(port, "POST", "/infer", *_multipart(img))
        assert status == 200
        assert decode_png(base64.b64decode(json.loads(data)["image"])).shape == (SIZE, SIZE)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0, out
    finally:
        proc.kill()
        proc.wait(30)
    assert not glob.glob(str(tmp_path / "deglare_engine_*.sock"))
    assert len(glob.glob(str(tmp_path / "logs" / "api.worker*.log"))) == 2


def test_engine_socket_queues_every_worker_connect(tmp_path):
    """Workers connect at once while the engine's accept thread is busy:
    the socket queues all of them (a backlog of 1 let one fail with EAGAIN
    on the card's host, with 4 workers)."""
    ipc = EngineIPCServer(_engine(), str(tmp_path / "e.sock"))
    ipc._accept_loop = lambda: None  # nothing accepts
    ipc.start()
    clients, errors = [], []

    def connect():
        try:
            clients.append(RemoteEngine(ipc.address))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=connect, daemon=True) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not errors and len(clients) == 8
    finally:
        for c in clients:
            c.stop()
        ipc.stop()
