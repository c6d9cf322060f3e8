"""``correct`` has to come out false where the timed path is broken
underneath, and where the reference in a lower precision takes the
program's place.

The fault tests skip the harness's look for a card and drive the rest of
a run on the CPU at toy sizes (``tiny_root``), once per fault the cell
can have: an answer altered where it is produced, half of the batch left
out, a step that returns its state unchanged. One card has no exchange
between cards to leave out. The control tests run every cell at its own
size on the card, with the committed limits.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench import faults, harness

from .conftest import ROOT

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = ["lwunet_prod.serve_closed_b64"]
TRAIN = ["lwunet_prod.train_resident_b32", "enhanced_unet16.train_resident_b32"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SERVE for f in faults.SERVING]
                         + [(c, f) for c in TRAIN for f in faults.TRAINING])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    sound = harness.run_cell(tiny_root, cell, seed=4242, seconds=1.0, trace=False,
                             device="cpu")
    assert sound["correct"], sound["checks"]
    broken = harness.run_cell(tiny_root, cell, seed=4242, seconds=1.0, trace=False,
                              device="cpu", run_class=faults.run_class(fault))
    assert broken["correct"] is False, broken["checks"]


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_the_control_is_not_correct_at_toy_sizes(tiny_root, cell):
    spec = harness.Spec(tiny_root, cell)
    r = harness.run_cell(tiny_root, cell, seed=31337, seconds=1.0, trace=False, device="cpu",
                         control=spec.cfg["control_precision"])
    sound = harness.run_cell(tiny_root, cell, seed=31337, seconds=1.0, trace=False,
                             device="cpu")
    worse = [k for k, c in r["checks"].items() if "limit" in c
             and c["value"] > sound["checks"][k]["value"]]
    assert worse, (r["checks"], sound["checks"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_at_the_cells_own_size_the_program_passes_and_the_control_fails(card, cell):
    spec = harness.Spec(ROOT, cell)
    sound = harness.run_cell(ROOT, cell, seed=2 ** 31 + 404, seconds=3.0, trace=False)
    assert sound["correct"], json.dumps(sound["checks"])
    torch.cuda.empty_cache()
    control = harness.run_cell(ROOT, cell, seed=2 ** 31 + 404, seconds=3.0, trace=False,
                               control=spec.cfg["control_precision"])
    assert control["correct"] is False, json.dumps(control["checks"])
