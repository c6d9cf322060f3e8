"""Lifecycle rehearsal through the port's own CLIs: the reference's user
workflow (reference: README.md:63-171) end to end, with a check at every
stage.

    python -m image_enhancement_deglaring_tpu_torch.tools.e2e_lifecycle \
        [--device cuda] [--size 64] [--epochs 2] [--work_dir DIR]

Each stage runs the port's real CLI in a subprocess:

  1. synthesize an SD1-contract dataset         (cli.make_synthetic)
  2. validate it                                (cli.check_dataset)
  3. sweep: random, 3 trials, 2 epochs at 32^2  (cli.sweep)
  4. train with the sweep's best batch size     (cli.train)
     (at most 16), lr and weight decay
  5. export the best checkpoint to ONNX         (cli.export_onnx)
  6. evaluate the ONNX artifact                 (cli.evaluate; its L1
     against the train loop's best val loss)
  7. promotion gate against the shipped         (tools.crossval_artifact)
     artifact on a fresh held-out seed
  8. serve the ONNX artifact over HTTP          (cli.serve)
  9. drive the live API                         (cli.test_api --test all)
 10. frontend proxy round trip                  (frontend/app.py /infer)
 11. SIGTERM drain: the server exits 0

It prints ``PASS <stage> (<seconds>s)`` per stage and a final
``E2E_SUMMARY {json}`` with each stage's seconds and the gate's verdict:
the stages of the JAX package's ``scripts/e2e_lifecycle.py``. ``--device``
(default cuda) goes to every stage that runs the model; without
``--work_dir`` the run works in a temporary directory and removes it.
"""

from __future__ import annotations

import argparse
import base64
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = "image_enhancement_deglaring_tpu_torch"
PY = sys.executable
# n_train is sized so every batch size the sweep samples fits
N_TRAIN, N_VAL = 24, 8
SWEEP_COUNT, SWEEP_EPOCHS, SWEEP_SIZE = 3, 2, 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_http(url: str, deadline_s: float, proc=None) -> bytes:
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        if proc is not None and proc.poll() is not None:
            raise SystemExit(f"FAIL: server died rc={proc.returncode}")
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return resp.read()
        except OSError:
            time.sleep(0.5)
    raise SystemExit(f"FAIL: {url} not up within {deadline_s}s")


def _multipart(field: str, fname: str, payload: bytes) -> tuple[bytes, str]:
    boundary = "e2eBoundary7430"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{field}"; filename="{fname}"\r\n'
            "Content-Type: image/png\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class Lifecycle:
    """The stages' shared state: environment, working directory, timings."""

    def __init__(self, work_dir: str):
        self.work_dir = work_dir
        path = os.environ.get("PYTHONPATH")
        self.env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
        self.seconds: dict[str, float] = {}

    def passed(self, tag: str, t0: float) -> None:
        self.seconds[tag] = round(time.time() - t0, 2)
        print(f"PASS {tag} ({self.seconds[tag]:.1f}s)", flush=True)

    def run(self, tag: str, args: list, timeout: float) -> str:
        """One CLI in a subprocess (cwd: the working directory); its stdout."""
        t0 = time.time()
        r = subprocess.run([PY, *args], env=self.env, cwd=self.work_dir, capture_output=True,
                           text=True, timeout=timeout)
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-4000:] + "\n" + r.stderr[-4000:] + "\n")
            raise SystemExit(f"FAIL {tag}: rc={r.returncode}")
        self.passed(tag, t0)
        return r.stdout

    def popen(self, args: list, extra_env: dict | None = None) -> subprocess.Popen:
        return subprocess.Popen([PY, *args], env=dict(self.env, **(extra_env or {})),
                                cwd=self.work_dir, stdout=subprocess.DEVNULL,
                                stderr=subprocess.STDOUT)


def rehearse(lc: Lifecycle, *, device: str, size: int, epochs: int) -> dict:
    """Stages 1-11; returns the summary."""
    w = lc.work_dir
    data, sweep, models = (os.path.join(w, d) for d in ("data", "sweep", "models"))
    summary: dict = {"device": device, "size": size}

    lc.run("make_synthetic", ["-m", f"{PKG}.cli.make_synthetic", "--out_dir", data,
                              "--n_train", str(N_TRAIN), "--n_val", str(N_VAL),
                              "--size", str(size)], 600)
    # rc 0 == every triptych passes the dimension / RGBA / decode checks
    lc.run("check_dataset", ["-m", f"{PKG}.cli.check_dataset", data, "--width", str(3 * size),
                             "--height", str(size)], 600)

    # random method: cheap and a fixed trial count, as the JAX script runs it
    lc.run("sweep", ["-m", f"{PKG}.cli.sweep", "--data_dir", os.path.join(data, "train"),
                     "--output_dir", sweep, "--sweep_count", str(SWEEP_COUNT),
                     "--max_epochs", str(SWEEP_EPOCHS), "--early_stop_min_iter", "1",
                     "--eta", "2", "--image_size", str(SWEEP_SIZE), "--method", "random",
                     "--num_workers", "2", "--device", device], 1800)
    with open(os.path.join(sweep, "sweep_results.json")) as f:
        best = json.load(f)["best"]
    if best is None or not best["best_val_loss"] < 1.0:
        raise SystemExit(f"FAIL sweep: best trial {best}")
    summary["sweep_best_val_loss"] = best["best_val_loss"]
    summary["sweep_best"] = {k: best[k] for k in ("trial_id", "batch_size", "lr", "wd")}

    lc.run("train", ["-m", f"{PKG}.cli.train", "--data_dir", os.path.join(data, "train"),
                     "--output_dir", models, "--epochs", str(epochs),
                     "--batch_size", str(min(best["batch_size"], 16)), "--lr", str(best["lr"]),
                     "--weight_decay", str(best["wd"]), "--image_size", str(size),
                     "--validation_metrics_every", "1", "--num_workers", "2",
                     "--save_every", "1000", "--device", device], 1800)
    with open(os.path.join(models, "logs", "metrics.jsonl")) as f:
        val_losses = [r["val_loss"] for r in map(json.loads, f) if "val_loss" in r]
    if not val_losses:
        raise SystemExit("FAIL train: no val_loss records in metrics.jsonl")
    best_val = min(val_losses)
    # a non-divergence gate, not convergence (with few epochs and a
    # sweep-chosen small LR, epoch 1 can be the best): an untrained model's
    # L1 on [0, 1] images is ~0.2-0.5
    if not (best_val < 1.0 and all(math.isfinite(v) for v in val_losses)):
        raise SystemExit(f"FAIL train: diverged, val losses {val_losses}")
    summary["train_best_val_loss"] = best_val

    onnx_path = os.path.join(models, "best_model.onnx")
    lc.run("export_onnx", ["-m", f"{PKG}.cli.export_onnx", "--model_path",
                           os.path.join(models, "best_model"), "--output", onnx_path], 600)
    summary["onnx_bytes"] = os.path.getsize(onnx_path)
    if summary["onnx_bytes"] <= 1_000_000:  # ~1.9 MB of float32 weights
        raise SystemExit(f"FAIL export_onnx: {summary['onnx_bytes']} bytes")

    # the exported artifact's L1 against the train loop's best val loss:
    # both are means at the same size; the tolerance covers the train
    # loop's bf16 forward and the other images of the train directory
    out = lc.run("evaluate_onnx", ["-m", f"{PKG}.cli.evaluate", "--model_path", onnx_path,
                                   "--data_dir", os.path.join(data, "train"),
                                   "--image_size", str(size), "--batch_size", "8",
                                   "--device", device], 900)
    onnx_l1 = float(next(ln for ln in out.splitlines()
                         if ln.startswith("L1 Loss:")).split(":")[1])
    if abs(onnx_l1 - best_val) >= max(0.02, 0.25 * best_val):
        raise SystemExit(f"FAIL evaluate_onnx: L1 {onnx_l1} vs train best val {best_val}")
    summary["onnx_l1"] = onnx_l1

    # the promotion gate against the shipped artifact (a fresh held-out seed)
    out = lc.run("crossval_gate", ["-m", f"{PKG}.tools.crossval_artifact", "--candidate",
                                   onnx_path, "--n", "8", "--size", str(size),
                                   "--batch_size", "4", "--device", device], 900)
    gate = json.loads(out.strip().splitlines()[-1])
    if gate["verdict"] not in ("promote", "keep_incumbent"):
        raise SystemExit(f"FAIL crossval_gate: {gate}")
    summary["gate_verdict"] = gate["verdict"]

    api_port, fe_port = _free_port(), _free_port()
    t0 = time.time()
    server = lc.popen(["-m", f"{PKG}.cli.serve", "--model_path", onnx_path, "--host",
                       "127.0.0.1", "--port", str(api_port), "--image_size", str(size),
                       "--log_dir", os.path.join(w, "serve_logs"), "--device", device])
    frontend = None
    try:
        ping = _wait_http(f"http://127.0.0.1:{api_port}/ping", 600, server)
        if json.loads(ping) != {"message": "pong"}:
            raise SystemExit(f"FAIL serve_up: /ping answered {ping!r}")
        lc.passed("serve_up", t0)

        sample = os.path.join(data, "val", sorted(os.listdir(os.path.join(data, "val")))[0])
        lc.run("test_api_all", ["-m", f"{PKG}.cli.test_api", "--test", "all", "--url",
                                f"http://127.0.0.1:{api_port}", "--image", sample,
                                "--timeout", "300"], 600)

        # browser -> frontend /infer -> API
        t0 = time.time()
        frontend = lc.popen([os.path.join(REPO, "frontend", "app.py")],
                            {"API_URL": f"http://127.0.0.1:{api_port}", "PORT": str(fe_port),
                             "HOST": "127.0.0.1"})
        _wait_http(f"http://127.0.0.1:{fe_port}/", 120, frontend)
        with open(sample, "rb") as f:
            body, ctype = _multipart("image", "sample.png", f.read())
        req = urllib.request.Request(f"http://127.0.0.1:{fe_port}/infer", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=300) as resp:
            png = base64.b64decode(json.loads(resp.read())["image"])
        if png[:8] != b"\x89PNG\r\n\x1a\n":
            raise SystemExit(f"FAIL frontend_proxy: answer starts {png[:8]!r}")
        lc.passed("frontend_proxy", t0)

        # drain: SIGTERM must exit 0 (the k8s preStop contract)
        t0 = time.time()
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=120)
        if rc != 0:
            raise SystemExit(f"FAIL sigterm_drain: rc={rc}")
        lc.passed("sigterm_drain", t0)
    finally:
        for proc in (frontend, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    summary["stage_seconds"] = lc.seconds
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Lifecycle rehearsal through the port's CLIs")
    p.add_argument("--device", default="cuda", help="torch device of every model stage")
    p.add_argument("--size", type=int, default=64,
                   help="image size of the train/eval/serve stages (divisible by 16)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--work_dir", default=None,
                   help="keep the stages' files here (default: a temporary directory)")
    args = p.parse_args(argv)

    t_all = time.time()
    work_dir = os.path.abspath(args.work_dir or tempfile.mkdtemp(prefix="e2e_lifecycle_"))
    os.makedirs(work_dir, exist_ok=True)
    try:
        summary = rehearse(Lifecycle(work_dir), device=args.device, size=args.size,
                           epochs=args.epochs)
    finally:
        if args.work_dir is None:
            shutil.rmtree(work_dir, ignore_errors=True)
    summary["wall_s"] = round(time.time() - t_all, 2)
    print("E2E_SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
