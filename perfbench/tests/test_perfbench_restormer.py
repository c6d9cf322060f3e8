"""The Restormer configuration and its serving cell: their files by name,
the family's work count against torch's FLOP counter, the reference
against the port, the readers of the per-block spans, and ``correct``
against the control and the planted faults at toy sizes on the CPU."""

from __future__ import annotations

import filecmp
import os

import pytest
import torch

from perfbench import block_spans, harness, model_faults
from perfbench.families import restormer as fam
from perfbench.reference.precision import Precision

from .conftest import ROOT, _edit
from .test_perfbench_spans import SYNC_END, _call, _on_trace, _record, _slice

RESTORMER = "restormer_gray48.serve_closed_b16"
CFG = harness.load_json(os.path.join(ROOT, "perfbench/configs/restormer_gray48.json"))
TOY = dict(CFG, image_size=32, dim=8, num_blocks=[1, 1, 1, 1], num_refinement_blocks=1)


@pytest.fixture
def toy_root(tiny_root):
    pb = os.path.join(tiny_root, "perfbench")
    _edit(f"{pb}/configs/restormer_gray48.json", image_size=32, dim=8, num_blocks=[1, 1, 1, 1],
          num_refinement_blocks=1)
    _edit(f"{pb}/traffic/serve_closed_b16.json", max_batch_size=4, outstanding=8, pages=8,
          sample=8, warm_s=0.3)
    return tiny_root


def test_the_new_cell_resolves_by_name():
    spec = harness.Spec(ROOT, RESTORMER)
    names = {m["name"] for m in spec.end_to_end + spec.per_layer}
    assert names == {"serve_img_per_s", "setup_s", "idle_share.serve", "step_host_ms.serve",
                     "queue_wait_ms.serve", "mfu.serve", "mdta_ms_per_image.serve",
                     "gdfn_ms_per_image.serve", "conv_ms_per_step.serve",
                     "fetch_copy_ms.serve"}
    assert spec.cfg["family"] == "restormer" and spec.traffic["driver"] == "serve_seeded"
    assert spec.cell["chips"] == 1 and spec.limits["worst_image_mean_gap"]["max"] > 0
    spec.module("drivers", spec.traffic["driver"])


def test_the_configuration_holds_the_published_widths():
    from image_enhancement_deglaring_tpu_torch.models.restormer import GRAY_CONFIG

    assert {k: CFG[k] for k in GRAY_CONFIG} == GRAY_CONFIG
    assert CFG["reduced"] == [] and CFG["control_precision"] == "fp8"
    model = fam.training_model(CFG, "cpu")
    assert sum(p.numel() for p in model.parameters()) == CFG["parameters"] == 26_109_076


def test_flops_per_image_equals_the_flop_counter_on_the_port():
    from torch.utils.flop_counter import FlopCounterMode

    for cfg in (TOY, dict(TOY, image_size=48, heads=[2, 2, 4, 4], num_blocks=[2, 1, 1, 2])):
        model = fam.training_model(dict(cfg, compute_dtype="float32"), "cpu")
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model(torch.rand(1, cfg["image_size"], cfg["image_size"], 1))
        assert fam.flops_per_image(cfg) == fc.get_total_flops()
    assert fam.flops_per_image(CFG) == 1_237_697_298_432  # about 1.24 TFLOP a 512^2 page


def test_the_benchmarks_reference_is_the_repositorys():
    assert filecmp.cmp(os.path.join(ROOT, "reference", "restormer.py"),
                       os.path.join(ROOT, "perfbench", "reference", "restormer.py"), shallow=False)


def test_the_served_model_carries_the_seeded_weights_of_the_reference():
    cfg = dict(TOY, weights_seed=2 ** 40 + 3)
    model = fam.serving_model(dict(cfg, compute_dtype="float32"), ROOT, "cpu")
    p = fam.onnx_params(cfg, ROOT, "cpu")
    assert torch.equal(p["output.weight"], fam.onnx_params(cfg, ROOT, "cpu")["output.weight"])
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port = model(x)[..., 0]
        ref = fam.reference_forward(cfg, Precision("f32"))(p, x.permute(0, 3, 1, 2))[:, 0]
    assert (port - ref).abs().max().item() < 1e-5
    assert p["output.weight"].sum(dim=(2, 3)).abs().max().item() < 1e-6  # centred kernels
    other = fam.onnx_params(dict(cfg, weights_seed=5), ROOT, "cpu")
    assert not torch.equal(p["output.weight"], other["output.weight"])


def test_the_cell_is_correct_and_the_control_and_faults_are_not(toy_root):
    kw = dict(seed=2 ** 31 + 7, seconds=2.0, trace=False, device="cpu")
    sound = harness.run_cell(toy_root, RESTORMER, **kw)
    assert sound["correct"] and sound["failed"] == 0, sound["checks"]
    gap = sound["info"]["readings"]["worst_image_mean_gap"]
    for fault in model_faults.FAULTS:
        broken = harness.run_cell(toy_root, RESTORMER, **kw,
                                  run_class=model_faults.run_class(fault))
        assert broken["correct"] is False, (fault, broken["checks"])
    control = harness.run_cell(toy_root, RESTORMER, **kw, control=CFG["control_precision"])
    assert control["info"]["readings"]["worst_image_mean_gap"] > 2 * gap


class _Run:
    def __init__(self, trace, cfg):
        self.trace_data, self.cfg, self.family = trace, cfg, fam


def test_per_image_block_time_weighs_each_level_by_its_blocks():
    """One forward's eight stages at batch 4 (blocks of the toy: one each,
    so two at (2, 16) and (3, 32) and at (1, 16)), each span launching one
    kernel of known length, and a ninth span whose kernel ran after the
    slice: it is left out."""
    stages = [(1, 8), (2, 16), (3, 32), (4, 64), (3, 32), (2, 16), (1, 16), (1, 16), (1, 8)]
    plan = [("restormer.mdta", 1, {"level": lv, "heads": 1, "channels": c, "images": 4})
            for lv, c in stages]
    before, recs = _record(plan)
    trace = _slice(before, 1.0, [])
    extra = []
    durs = [400.0 * (i + 1) for i in range(len(recs))]
    for i, r in enumerate(recs):
        a, b = _on_trace(r, trace)
        extra.append(_call("cudaLaunchKernel", r.tid, (a + b) / 2, 5.0, 100 + i))
        if i < len(recs) - 1:
            extra.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "pid": 0, "tid": 7,
                          "ts": SYNC_END + 10.0 * i, "dur": durs[i],
                          "args": {"correlation": 100 + i}})
    run = _Run(_slice(before, 1.0, [(SYNC_END, SYNC_END + 1e6)], extra), TOY)
    groups: dict = {}
    for (lv, c), d in zip(stages[:-1], durs):
        groups.setdefault((lv, c), []).append(d / 4 / 1e3)
    want = sum(n * sum(groups[k]) / len(groups[k]) for k, n in fam.blocks_per_forward(TOY).items())
    assert fam.blocks_per_forward(TOY) == {(1, 8): 1, (2, 16): 2, (3, 32): 2, (4, 64): 1,
                                           (1, 16): 2}
    assert block_spans.device_ms_per_image(run, "restormer.mdta") == pytest.approx(want)
    spec = harness.Spec(ROOT, RESTORMER)
    assert spec.module("metrics", "mdta_ms_per_image.serve").read(run) == pytest.approx(want)
    assert spec.module("metrics", "gdfn_ms_per_image.serve").read(run) is None
    # a level with no whole span in the slice: nothing honest to report
    assert block_spans.device_ms_per_image(_Run(run.trace_data, dict(TOY, dim=4)),
                                           "restormer.mdta") is None

