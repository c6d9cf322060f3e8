"""The benchmark's own CPU tests: its files load by name, its work counts,
its references against the port at toy sizes, its result line, its
import guard, and a cell added from new files alone."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.families import enhanced_unet as en
from perfbench.families import lightweight_unet as lw
from perfbench.reference import train as ref_train
from perfbench.reference.precision import Precision

from .conftest import ROOT

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
LW = harness.load_json(os.path.join(ROOT, "perfbench/configs/lwunet_prod.json"))
EN = harness.load_json(os.path.join(ROOT, "perfbench/configs/enhanced_unet16.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_its_files_by_name(cell):
    spec = harness.Spec(ROOT, cell)
    assert spec.limits and spec.end_to_end and spec.per_layer
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    spec.module("drivers", spec.traffic["driver"])
    spec.module("families", spec.cfg["family"])
    for m in spec.end_to_end + spec.per_layer:
        assert callable(spec.module("metrics", m["name"]).read)


def test_every_metric_and_config_has_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "metrics", m["name"] + ".py"))
    for c in BENCH["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cfg,size,flops", [(LW, 512, 6_048_186_368), (LW, 64, 94_502_912),
                                            (EN, 512, 32_111_329_280), (EN, 64, 501_739_520)])
def test_forward_flops_match_the_flop_counter(cfg, size, flops):
    family = lw if cfg["family"] == "lightweight_unet" else en
    assert family.flops_per_image(dict(cfg, image_size=size)) == flops


def test_flop_formula_against_torch_flop_counter_at_a_toy_size():
    from torch.utils.flop_counter import FlopCounterMode

    from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet, LightweightUNet

    for family, model, cfg in ((lw, LightweightUNet(), dict(LW, image_size=32)),
                               (en, EnhancedUNet(init_features=4),
                                dict(EN, image_size=32, init_features=4))):
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model(torch.rand(1, 32, 32, 1))
        assert family.flops_per_image(cfg) == fc.get_total_flops()


def test_kernel_work_counts_at_one_shape():
    sites = lw.kernel_sites(LW, 8)
    assert len(sites["gn_silu"]) == 14 and len(sites["conv_gn_silu"]) == 4
    # K1 at enc1: 8 x 512^2 x 8 bf16 read once and written once, scale and bias
    assert sites["gn_silu"][0] == (2 * 8 * 512 * 512 * 8 * 2 + 2 * 8 * 4, 0)
    # K3 at enc4.conv1: 8 x 64^2 x 32 -> 64
    nbytes, ops = sites["conv_gn_silu"][0]
    assert nbytes == (8 * 64 * 64 * (32 + 64) + 9 * 32 * 64) * 2 + 2 * 64 * 4
    assert ops == 2 * 64 * 64 * 9 * 32 * 64 * 8
    assert en.kernel_sites(EN, 8) == {}


def test_lightweight_reference_matches_the_port_in_float32():
    from image_enhancement_deglaring_tpu_torch.eval.harness import load_model_for_eval

    cfg = dict(LW, image_size=64)
    model, _ = load_model_for_eval(lw.weights_path(cfg, ROOT), model_arch="lightweight",
                                   compute_dtype=torch.float32, device="cpu")
    x = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port = model(x)[..., 0]
        ref = lw.reference_forward(cfg, Precision("f32"))(lw.onnx_params(cfg, ROOT, "cpu"),
                                                     x.permute(0, 3, 1, 2))[:, 0]
    assert (port - ref).abs().max().item() < 1e-4


def test_enhanced_reference_matches_the_port_in_training_mode():
    cfg = dict(EN, image_size=32, init_features=4)
    params = en.seed_params(cfg, torch.Generator().manual_seed(1), "cpu")
    model = en.training_model(dict(cfg, compute_dtype="float32"), "cpu")
    mine = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in params.items():
            mine[en.port_names(cfg)[k]].copy_(en.to_port_layout(k, v))
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(2))
    model.train()
    port = model(x, train=True, generator=torch.Generator().manual_seed(5))[..., 0]
    ref = en.reference_forward(dict(cfg, compute_dtype="float32"), Precision("f32"))(
        params, x.permute(0, 3, 1, 2), torch.Generator().manual_seed(5))[:, 0]
    assert (port - ref).abs().max().item() < 1e-4


def test_enhanced_reference_follows_the_stated_mixed_precision():
    """In bf16 the model takes its input and first convs in bf16 and the rest
    in float32: the reference, told the same, follows it closely on the CPU
    (no TF32 there), and the reference in float32 throughout does not."""
    cfg = dict(EN, image_size=32, init_features=4)
    assert cfg["compute_dtype"] == "bfloat16"
    params = en.seed_params(cfg, torch.Generator().manual_seed(1), "cpu")
    model = en.training_model(cfg, "cpu")
    mine = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in params.items():
            mine[en.port_names(cfg)[k]].copy_(en.to_port_layout(k, v))
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(2))
    port = model(x, train=True, generator=torch.Generator().manual_seed(5))[..., 0]
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        ref = en.reference_forward(dict(cfg, compute_dtype=dtype), Precision("f32"))(
            params, x.permute(0, 3, 1, 2), torch.Generator().manual_seed(5))[:, 0]
        gaps[dtype] = (port - ref).abs().max().item()
    assert gaps["bfloat16"] < 1e-4 < gaps["float32"], gaps


def test_reference_augmentation_and_plan_follow_the_trainer():
    from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
    from image_enhancement_deglaring_tpu_torch.train.resident import epoch_batch_plan

    x = torch.rand(6, 16, 16, 1, generator=torch.Generator().manual_seed(3))
    y = torch.rand(6, 16, 16, 1, generator=torch.Generator().manual_seed(4))
    a = device_augment_batch(torch.Generator().manual_seed(9), x, y)
    b = ref_train.augment(torch.Generator().manual_seed(9), x, y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for epoch in (0, 3):
        assert torch.equal(epoch_batch_plan(123456789, epoch, 40, 8, device="cpu"),
                           ref_train.plan(123456789, epoch, 40, 8, "cpu"))


def test_lower_precisions_round_more():
    x = torch.linspace(-3, 3, 1001)
    err = {p: (Precision(p).operand(x) - x).abs().max().item() for p in ("f32", "bf16", "fp8")}
    assert err["f32"] == 0 < err["bf16"] < err["fp8"]


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port_or_jax():
    folder = os.path.join(ROOT, "perfbench", "reference")
    for f in os.listdir(folder):
        if f.endswith(".py"):
            found = _imports(os.path.join(folder, f))
            assert not found & {"image_enhancement_deglaring_tpu_torch", *harness.FORBIDDEN}, f


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "image_enhancement_deglaring_tpu_torch_fake", sys)
    assert "image_enhancement_deglaring_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_a_run_loads_no_jax_module(tiny_root):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from perfbench import harness; "
            "harness.run_cell(sys.argv[2], 'lwunet_prod.serve_closed_b64', seed=5, seconds=0.5, "
            "trace=False, device='cpu'); print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, ROOT, tiny_root], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_the_result_line_has_the_contract_keys(tiny_root):
    r = harness.run_cell(tiny_root, "lwunet_prod.serve_closed_b64", seed=2 ** 31 + 11,
                         seconds=1.0, trace=False, device="cpu")
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["metrics"]) == {"serve_img_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    json.dumps(r, allow_nan=False)


def test_same_seed_same_inputs():
    from perfbench.inputs.pages import glared_pages

    a = glared_pages(torch.Generator().manual_seed(2 ** 32 + 3), 3, 64, "cpu")
    b = glared_pages(torch.Generator().manual_seed(2 ** 32 + 3), 3, 64, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    glared, truth = a
    assert (glared >= truth).all() and truth.float().mean() > 150


def test_a_cell_config_and_metric_added_as_new_files_run(tiny_root):
    pb = os.path.join(tiny_root, "perfbench")
    cfg = harness.load_json(f"{pb}/configs/lwunet_prod.json")
    cfg["name"] = "lwunet_copy"
    with open(f"{pb}/configs/lwunet_copy.json", "w") as f:
        json.dump(cfg, f)
    traffic = harness.load_json(f"{pb}/traffic/serve_closed_b64.json")
    with open(f"{pb}/traffic/serve_closed_few.json", "w") as f:
        json.dump(dict(traffic, outstanding=4), f)
    with open(f"{pb}/cells/lwunet_copy.serve_closed_few.json", "w") as f:
        json.dump({"limits": harness.load_json(
            f"{pb}/cells/lwunet_prod.serve_closed_b64.json")["limits"]}, f)
    with open(f"{pb}/metrics/requests_per_step.few.py", "w") as f:
        f.write("def read(run):\n    w = run.window\n"
                "    return w['served'] / w['batches'] if w['batches'] else None\n")
    bench = harness.load_json(f"{tiny_root}/BENCHMARK.json")
    bench["configs"].append({"name": "lwunet_copy", "source": "a copy",
                             "file": "perfbench/configs/lwunet_copy.json", "reduced": [],
                             "why": "a test"})
    cell = "lwunet_copy.serve_closed_few"
    bench["workloads"].append({"name": cell, "config": "lwunet_copy",
                               "traffic": "serve_closed_few", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "serve_img_per_s")["workloads"].append(cell)
    bench["per_layer"].append({"name": "requests_per_step.few", "unit": "images/step",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving queue", "moves": "serve_img_per_s",
                               "workloads": [cell]})
    with open(f"{tiny_root}/BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    r = harness.run_cell(tiny_root, cell, seed=77, seconds=1.0, trace=False, device="cpu")
    assert r["correct"] and set(r["metrics"]) == {"serve_img_per_s", "setup_s"}
    r = harness.run_cell(tiny_root, cell, seed=78, seconds=1.0, trace=True, device="cpu")
    assert r["correct"] and "requests_per_step.few" in r["metrics"]
    assert 1.0 <= r["metrics"]["requests_per_step.few"]["value"] <= 4.0


@pytest.mark.parametrize("cell", ["lwunet_prod.serve_closed_b64", "lwunet_prod.train_resident_b32",
                                  "enhanced_unet16.train_resident_b32"])
def test_sound_runs_at_toy_sizes_are_correct(tiny_root, cell):
    r = harness.run_cell(tiny_root, cell, seed=2 ** 31 + 99, seconds=1.0, trace=False,
                         device="cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_weights_other_than_the_pinned_ones_stop_the_run(tiny_root):
    path = os.path.join(tiny_root, "deploy", "models", "best_model.onnx")
    with open(path, "ab") as f:
        f.write(b"\0")
    with pytest.raises(SystemExit, match="sha256"):
        lw.onnx_params(LW, tiny_root, "cpu")
