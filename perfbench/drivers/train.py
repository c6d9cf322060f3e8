"""Resident training as ``train_model(resident=True)`` runs its epochs:
``make_train_epoch_segmented`` over ``make_step_body`` with device
augmentation, from a set of synthetic pairs held on the device.

Traffic parameters (the mix's ``.json``):
  ``batch_size``     the step's batch
  ``pairs``          pairs held on the device (the resident cache)
  ``segments``       segments per epoch (``cli.train --resident_segments``)
  ``lr``, ``weight_decay``, ``clip_grad_norm``   the trainer's defaults
  ``checked_steps``  the first steps the reference follows
  ``warm_steps``     further steps before the window
  ``trace_steps``    steps of the traced slice after the window

Set-up builds one training state, takes its first steps through the
segment call the window uses (one planned row each), keeps what the
comparison needs, and hands the same state to the window. The window
runs whole segments of the epochs' plans until ``--seconds`` have passed;
each segment ends in the loss fetch ``train_model`` makes, and the window
in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import trace as tracing
from ..inputs.pages import glared_pages
from ..reference import train as reference
from ..reference.precision import Precision, exact


def run(run) -> dict:
    from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
    from image_enhancement_deglaring_tpu_torch.train import TrainState, make_optimizer
    from image_enhancement_deglaring_tpu_torch.train.resident import (ResidentData,
                                                                       make_train_epoch_segmented)

    cfg, tr, dev = run.cfg, run.traffic, run.device
    size, bs = cfg["image_size"], tr["batch_size"]
    gen = torch.Generator(device=dev).manual_seed(run.subseed("pages"))
    glared, truth = glared_pages(gen, tr["pairs"], size, dev)
    pages = (glared.cpu(), truth.cpu())  # for the reference, after the window
    run.mark("inputs")
    family = run.family
    params0 = family.seed_params(cfg, torch.Generator(device=dev).manual_seed(
        run.subseed("weights")), dev)
    train_seed = run.subseed("train")
    stateful = family.STATEFUL
    if run.control is not None:  # the reference in a lower precision, in the program's place
        del glared, truth
        rows = reference.plan(train_seed, 0, tr["pairs"], bs, dev)[:tr["checked_steps"]]
        program = reference_steps(run, run.control, params0, pages, rows, train_seed, stateful)
        program["grads"] = {k: family.to_port_layout(k, g) for k, g in program["grads"].items()}
        run.attempted, run.failed = tr["checked_steps"], 0
        run.memory_peak()
        run.checks = _compare(run, program, params0, pages, rows, train_seed, stateful)
        return {}
    dtype = getattr(torch, cfg["compute_dtype"])
    data = ResidentData((glared.float() / 255.0).to(dtype)[..., None],
                        (truth.float() / 255.0)[..., None], tr["pairs"])
    del glared, truth
    model = family.training_model(cfg, dev)
    names = family.port_names(cfg)
    port = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in params0.items():
            port[names[k]].copy_(family.to_port_layout(k, v))
    run.mark("model")
    state = TrainState(model=model,
                       optimizer=make_optimizer(model, tr["lr"], tr["weight_decay"],
                                                tr["clip_grad_norm"]),
                       generator=torch.Generator(device=dev).manual_seed(train_seed))
    augment = device_augment_batch
    if run.trace:
        def augment(generator, x, y):
            with tracing.record("perfbench.augment"):
                return device_augment_batch(generator, x, y)
    plan, segment = make_train_epoch_segmented(batch_size=bs, stateful=stateful,
                                               augment_fn=augment)
    segment = run.patch_segment(segment, state)

    epoch, pos = 0, 0
    idx = plan(train_seed, epoch, data.n, dev)
    seg_len = -(-idx.shape[0] // max(1, min(tr["segments"], idx.shape[0])))

    def take(n_steps: int):
        """The next ``n_steps`` rows of the plans, one epoch after another."""
        nonlocal epoch, pos, idx
        if pos >= idx.shape[0]:
            epoch, pos = epoch + 1, 0
            idx = plan(train_seed, epoch, data.n, dev)
        rows = idx[pos:pos + n_steps]
        pos += rows.shape[0]
        return rows

    def train(rows):
        nonlocal state
        state, losses = segment(state, data.x, data.y, rows)
        with tracing.record("perfbench.train.fetch"):
            return losses.double().cpu()

    # the first steps, one segment call each, and what the comparison reads
    names_r = {v: k for k, v in names.items()}
    losses, grads, grad_norms = [], None, None
    for _ in range(tr["checked_steps"]):
        losses.append(float(train(take(1))[0]))
        if grad_norms is None:  # AdamW's first moment after one step is (1 - b1) g
            b1 = state.optimizer.param_groups[0]["betas"][0]
            grads = {names_r[n]: state.optimizer.state.get(p, {}).get("exp_avg",
                                                                      torch.zeros_like(p))
                     .detach() / (1 - b1) for n, p in model.named_parameters()}
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
    change = {names_r[n]: float((family.to_port_layout(names_r[n], params0[names_r[n]]) - p.detach()
                                 ).norm()) for n, p in model.named_parameters()}
    run.mark("checked_steps")
    if tr["warm_steps"]:
        train(take(tr["warm_steps"]))
    if dev.type == "cuda":
        torch.cuda.synchronize()

    run.window_opened()
    t0 = time.perf_counter()
    steps, seg_s = 0, []
    while True:
        t = time.perf_counter()
        rows = take(seg_len - (pos % seg_len) if pos % seg_len else seg_len)
        train(rows)
        steps += rows.shape[0]
        seg_s.append((time.perf_counter() - t, rows.shape[0]))
        if time.perf_counter() - t0 >= run.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    run.attempted, run.failed = steps, 0
    if run.trace:  # the device alone, then the attribution to the host's ops
        with tracing.Capture(host_ops=False) as cap:
            train(take(tr["trace_steps"]))
        with family.annotate_norm_act(model, tracing.record), \
                tracing.Capture(host_ops=True) as ops:
            ops_rows = take(tr["trace_steps"])
            train(ops_rows)
        run.set_trace(cap.trace, [])
        run.ops_trace = ops.trace
        run.ops_steps = int(ops_rows.shape[0])
    run.memory_peak()
    del state, model, port, data, segment
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    window = {"window_s": window_s, "steps": steps, "batch": bs, "images": steps * bs,
              "segment_ms_median": statistics.median(s / n * 1e3 for s, n in seg_s)}
    run.window = window
    program = {"losses": losses, "grads": grads, "grad_norms": grad_norms,
               "change_norms": change}
    rows = reference.plan(train_seed, 0, tr["pairs"], bs, dev)[:tr["checked_steps"]]
    run.checks = _compare(run, program, params0, pages, rows, train_seed, stateful)
    return window


def reference_steps(run, precision: str, params0: dict, pages, rows, train_seed: int,
                    stateful: bool) -> dict:
    """The reference's first steps on the checked rows, in ``precision``,
    with its own generator of the program's seed, from the inputs as the
    resident cache holds them (the configuration's compute dtype)."""
    tr, dev = run.traffic, run.device
    gen = torch.Generator(device=dev).manual_seed(train_seed)
    x_u8, y_u8 = (t.to(dev) for t in pages)
    with exact():
        return reference.first_steps(
            run.family.reference_forward(run.cfg, Precision(precision)), params0, x_u8, y_u8,
            rows.to(dev), gen, lr=tr["lr"], wd=tr["weight_decay"],
            clip=tr["clip_grad_norm"], stateful=stateful,
            input_dtype=getattr(torch, run.cfg["compute_dtype"]))


def _compare(run, program: dict, params0: dict, pages, rows, train_seed: int,
             stateful: bool) -> dict:
    """The program's first steps against the reference's: the largest
    relative gap of a step's loss, and the first step's; by the worst leaf
    the gap between the two norms of the first gradient and of the change
    over the checked steps, each against the larger of the reference
    leaf's norm and the median leaf's; and the norm of the difference of
    the first gradients over the reference's norm, all leaves together and
    by the worst leaf.
    Leaves whose reference gradient is below a thousandth of the median
    leaf's (nought to rounding) are left out."""
    ref = reference_steps(run, "f32", params0, pages, rows, train_seed, stateful)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad_norms"].values())
    live = [k for k, v in ref["grad_norms"].items() if v >= 1e-3 * g_med]

    def worst(key):
        """The worst leaf's gap, and the leaf."""
        med = statistics.median(ref[key][k] for k in live)
        return max((abs(program[key][k] - ref[key][k]) / max(ref[key][k], med), k) for k in live)

    layout = run.family.to_port_layout
    diff = {k: float((program["grads"][k] - layout(k, ref["grads"][k])).norm()) for k in live}
    g_live = statistics.median(ref["grad_norms"][k] for k in live)
    grad_norm_gap, grad_norm_leaf = worst("grad_norms")
    change_norm_gap, change_norm_leaf = worst("change_norms")
    grad_leaf_gap, grad_leaf = max((diff[k] / max(ref["grad_norms"][k], g_live), k) for k in live)
    return {"loss_gap": loss_gap,
            "loss1_gap": abs(program["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_norm_gap": grad_norm_gap, "change_norm_gap": change_norm_gap,
            "grad_gap": (sum(d * d for d in diff.values())
                         / sum(ref["grad_norms"][k] ** 2 for k in live)) ** 0.5,
            "grad_leaf_gap": grad_leaf_gap,
            "worst_leaves": {"grad_norm_gap": grad_norm_leaf, "change_norm_gap": change_norm_leaf,
                             "grad_leaf_gap": grad_leaf},
            "leaves": len(live), "leaves_left_out": len(ref["grad_norms"]) - len(live)}
