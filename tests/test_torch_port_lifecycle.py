"""The port's lifecycle rehearsal (``tools/e2e_lifecycle.py``) on the CPU:
synthesize -> validate -> sweep -> train at the sweep's best -> export ->
evaluate the export -> serve -> ``cli.test_api --test all`` -> frontend
proxy -> SIGTERM drain, each stage the port's CLI in its own process, at
32x32 for 2 epochs (~30 s).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("make_synthetic", "check_dataset", "sweep", "train", "export_onnx", "evaluate_onnx",
          "serve_up", "test_api_all", "frontend_proxy", "sigterm_drain")


def test_lifecycle_rehearsal_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "image_enhancement_deglaring_tpu_torch.tools.e2e_lifecycle",
         "--device", "cpu", "--size", "32", "--epochs", "2", "--work_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        # 32x32 tensors: one intra-op thread per stage keeps the stages'
        # thread pools from oversubscribing cores other test processes use
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    passed = [ln.split()[1] for ln in r.stdout.splitlines() if ln.startswith("PASS ")]
    assert tuple(passed) == STAGES, r.stdout
    summary = json.loads(next(ln for ln in r.stdout.splitlines()
                              if ln.startswith("E2E_SUMMARY ")).split(" ", 1)[1])
    assert set(summary["stage_seconds"]) == set(STAGES)
    assert summary["device"] == "cpu" and summary["onnx_bytes"] > 1_000_000
    assert summary["train_best_val_loss"] < 1.0
    # the train stage took the sweep's winner (its results file, the
    # trainer's logged config)
    with open(tmp_path / "sweep" / "sweep_results.json") as f:
        best = json.load(f)["best"]
    assert summary["sweep_best"] == {k: best[k] for k in ("trial_id", "batch_size", "lr", "wd")}
    assert summary["sweep_best_val_loss"] == best["best_val_loss"] < 1.0
    with open(tmp_path / "models" / "logs" / "config.json") as f:
        config = json.load(f)
    assert (config["lr"], config["weight_decay"], config["batch_size"]) == (
        best["lr"], best["wd"], min(best["batch_size"], 16))
    assert os.path.exists(tmp_path / "models" / "best_model.onnx")
    assert os.path.exists(tmp_path / "test_output")  # cli.test_api's answer, in the work dir
