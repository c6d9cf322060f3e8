"""The training loop.

Counterpart of ``image_enhancement_deglaring_tpu.train.loop``: L1 loss,
global-norm gradient clip at 1.0 to optax's rule, AdamW (betas .9/.999,
eps 1e-8, decoupled weight decay on every parameter), ReduceLROnPlateau,
validation PSNR/SSIM on the first <= 4 clipped images of each batch,
early stop, best and periodic checkpoints, best-weights restore, exact
resume, SIGTERM handling and experiment logging.

On the card:
- a step is forward, backward, clip and update on the current stream;
  compute runs in the model's dtype (bf16 by default), parameters and
  optimizer state in float32; a float32 model trains inside
  ``highest_precision()`` (no TF32), as its forward runs;
- the LR lives in the optimizer's ``param_groups``, so a plateau
  reduction rebuilds nothing;
- per-step losses stay on the device and are fetched once per epoch;
- ``DevicePrefetcher`` copies batch N+1 on a side stream during step N;
- ``resident=True`` trains from the decoded set held in device memory
  (``train.resident``): the host decodes once, before the first epoch;
  ``device_augment=True`` augments each batch on the device;
- augmentation and dropout draw from one generator on the device
  (``TrainState.generator``), saved in every checkpoint, so a resumed run
  continues the stream;
- while a ``torch.profiler`` session runs (``profile_dir``), the step
  records the span ``train.step`` (``utils.profiling.span``) around
  ``train.augment``, ``train.forward`` (forward and loss),
  ``train.backward``, ``train.reduce`` (under a mesh), ``train.clip`` and
  ``train.update``; the loop records ``train.data_wait`` (the prefetcher's
  next batch) and ``train.fetch`` (the losses' copy to the host), the
  resident segment ``train.gather``.

Over several GPUs (``mesh=``, a ``parallel.mesh.DataMesh``; one process
per device), as JAX's step over its global mesh:
- each rank steps on its rows of every global batch; the gradients are
  summed over the ranks and divided by their number before the clip, which
  gives the global batch's mean gradient, so the clip and AdamW run alike
  on every rank; rank 0's initial weights are broadcast first;
- BatchNorm takes its statistics over the global batch (``models.
  enhanced_unet.synced_batch_stats``);
- the training loss and the validation metrics are those of the global
  batch (sums and counts added over the ranks once per epoch, padded rows
  masked); the PSNR/SSIM subset is the global batch's first rows;
- rank 0 alone prints, logs, plots and writes checkpoints; a resume is read
  by rank 0 and broadcast (``restore_checkpoint_all_hosts``), as is the
  best-model bar; a signal on any rank stops every rank at the next epoch
  (or resident segment) boundary (``preemption_agreed``);
- each rank's generator is seeded from (seed, rank), so ranks draw
  different augmentations and dropout masks, and each rank's state is
  saved (``rng_by_rank``) for an exact resume at the same world size.

On the card every GroupNorm+SiLU of a LightweightUNet trains through the
port's differentiable kernel pair (``ops.fused_kernels.gn_silu_train``),
and every BatchNorm of an EnhancedUNet through ``bn_act_train``; the
model's sites choose them (``ops.fused_kernels.gn_silu_site``,
``batch_norm_site``). K1-K5 are forward-only, as the TPU kernels are, and
refuse to run under autograd: train a LightweightUNet built with
``kernels=False``, as ``cli.train`` builds it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..data.dataset import DevicePrefetcher
from ..modelio.params_import import (
    export_jax_batch_stats,
    export_jax_opt_state,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from ..models.enhanced_unet import synced_batch_stats
from ..ops.conv_blocks import highest_precision
from ..ops.metrics import batched_psnr_ssim, l1_loss
from ..utils.profiling import span, start_trace, stop_trace
from ..utils.pytree import flatten_tree, unflatten_tree
from .checkpoint import restore_checkpoint, restore_checkpoint_all_hosts, save_checkpoint
from .lr_control import ReduceLROnPlateau
from .preempt import PreemptionGuard, preemption_agreed


class ClippedAdamW(torch.optim.AdamW):
    """optax's ``chain(clip_by_global_norm(clip_grad_norm), adamw(lr, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay))`` as a torch AdamW over one
    parameter group: ``step()`` is AdamW's update, and the train step clips
    the gradients first (:func:`clip_grad_norm_`) when ``clip_grad_norm >
    0``. optax applies ``p - lr * (adam + wd * p)`` and torch ``p * (1 - lr
    * wd) - lr * adam``: equal in exact arithmetic, apart in the last bits."""

    def __init__(self, params, lr: float, weight_decay: float, clip_grad_norm: float = 1.0):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        self.clip_grad_norm = float(clip_grad_norm)


@dataclass
class TrainState:
    """What a step changes: the model's parameters and BatchNorm buffers
    (in the module), the optimizer and its state, the step count, and the
    generator that device augmentation and dropout draw from. It must lie
    on the model's device; ``train_model`` seeds one there."""

    model: torch.nn.Module
    optimizer: ClippedAdamW
    step: int = 0
    generator: torch.Generator = field(default_factory=lambda: torch.Generator().manual_seed(0))


def make_optimizer(model: torch.nn.Module, lr: float, weight_decay: float,
                   clip_grad_norm: float = 1.0) -> ClippedAdamW:
    """Clip by global norm, then AdamW, over every parameter of ``model``."""
    return ClippedAdamW(model.parameters(), lr, weight_decay, clip_grad_norm)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Write ``lr`` into every parameter group."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def clip_grad_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: with ``norm`` the L2 norm of all
    gradients together, each gradient becomes ``(g / norm) * max_norm``
    when ``norm >= max_norm`` and stays as it is otherwise. Returns the
    norm. (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm
    + 1e-6)`` whenever it is below 1: another function.)"""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    clipping = norm >= max_norm  # stays on the device: no host sync per step
    for g in grads:
        g.copy_(torch.where(clipping, (g / norm) * max_norm, g))
    return norm


def average_gradients(params, mesh) -> None:
    """Each gradient becomes its sum over the ranks divided by their number
    (one all-reduce over one flat buffer, after the backward): with equal
    rows per rank, the mean gradient of the global batch."""
    from ..parallel.mesh import all_reduce_sum

    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh).div_(mesh.world)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def make_step_body(*, stateful: bool = False, augment_fn=None, mesh=None):
    """The (state, x, y) -> (state, loss) step: forward in the model's
    dtype, float32 L1 on its float32 output, backward, the clip and
    AdamW's update. ``loss`` stays on the device.

    ``mesh`` (several ranks): ``x, y`` are this rank's rows of the global
    batch, the gradients are averaged over the ranks before the clip
    (:func:`average_gradients`), BatchNorm normalizes with the global
    batch's statistics, and ``loss`` is this rank's mean.

    ``augment_fn(generator, x, y) -> (x, y)`` (``ops.augment_device``)
    augments the batch first, drawing from ``state.generator``.
    ``stateful=True`` is the step of a model with BatchNorm and dropout
    (EnhancedUNet): its forward runs with ``train=True``, normalizing with
    the batch statistics, updating the running ones and drawing its dropout
    masks from the same generator."""

    def step_body(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        with span("train.step"):
            model, opt = state.model, state.optimizer
            model.train()
            opt.zero_grad(set_to_none=True)
            if augment_fn is not None:
                with span("train.augment"):
                    x, y = augment_fn(state.generator, x, y)
            exact = getattr(model, "dtype", torch.float32) == torch.float32
            params = [p for g in opt.param_groups for p in g["params"]]
            with (highest_precision() if exact else contextlib.nullcontext(),
                  synced_batch_stats(mesh)):
                with span("train.forward"):
                    out = model(x, train=True, generator=state.generator) if stateful else model(x)
                    loss = l1_loss(out, y)
                with span("train.backward"):
                    loss.backward()
                if mesh is not None and mesh.in_group:  # a group of one still reduces
                    with span("train.reduce"):
                        average_gradients(params, mesh)
                if opt.clip_grad_norm > 0:
                    with span("train.clip"), torch.no_grad():
                        clip_grad_norm_(params, opt.clip_grad_norm)
                with span("train.update"):
                    opt.step()
            state.step += 1
        return state, loss.detach()

    return step_body


def _subset_rows(metric_subset: int, b: int, mesh) -> int:
    """How many of this rank's ``b`` rows lie among the global batch's first
    ``metric_subset`` (rank r's rows are the global rows [r*b, (r+1)*b))."""
    if mesh is None or mesh.world == 1:
        return min(metric_subset, b)
    k = min(metric_subset, b * mesh.world)
    return min(max(k - mesh.rank * b, 0), b)


def make_val_body(metric_subset: int = 4, *, with_metrics: bool = True, mesh=None):
    """(model, x, y, mask) -> (batch L1, subset PSNR mean, subset SSIM mean,
    prediction), under ``no_grad``. ``mask`` is (B,) 1.0 for real samples
    and 0.0 for padding. The metrics are taken on the clipped prediction of
    the first <= ``metric_subset`` images, the loss on the raw one;
    ``with_metrics=False`` skips the metrics (they return 0.0). Under
    ``mesh`` the batch is this rank's rows and every value is this rank's:
    the subset is those of its rows among the global batch's first
    ``metric_subset`` (:func:`val_row`, :func:`global_val_rows`)."""

    def val_step(model, x, y, mask):
        model.eval()
        with torch.no_grad():
            out = model(x).float()
            yf = y.float()
            m = mask.float()[:, None, None, None]
            denom = torch.clamp(mask.float().sum() * float(np.prod(x.shape[1:])), min=1.0)
            loss = torch.sum(torch.abs(out - yf) * m) / denom
            if not with_metrics:
                zero = torch.zeros((), dtype=torch.float32, device=out.device)
                return loss, zero, zero, out
            k = _subset_rows(metric_subset, x.shape[0], mesh)
            if k == 0:
                zero = torch.zeros((), dtype=torch.float32, device=out.device)
                return loss, zero, zero, out
            psnrs, ssims = batched_psnr_ssim(out[:k], yf[:k], clip_pred=True)
            mk = mask.float()[:k]
            mk_n = torch.clamp(mk.sum(), min=1.0)
            # where(), not *mask: a padded all-zero row can give mse = 0 and
            # psnr = inf, and inf * 0.0 = NaN would poison the sum
            psnr = torch.sum(torch.where(mk > 0, psnrs, torch.zeros_like(psnrs))) / mk_n
            ssim = torch.sum(torch.where(mk > 0, ssims, torch.zeros_like(ssims))) / mk_n
        return loss, psnr, ssim, out

    return val_step


# the JAX package jits each body into its step; eager PyTorch runs the body
make_train_step, make_val_step = make_step_body, make_val_body


def val_row(loss, psnr, ssim, mask, metric_subset: int = 4, mesh=None) -> torch.Tensor:
    """One validation batch's row on the device: [L1, subset PSNR, subset
    SSIM, real samples], and over several ranks the real samples of this
    rank's share of the subset."""
    row = [loss, psnr, ssim, mask.float().sum()]
    if mesh is not None and mesh.world > 1:
        row.append(mask.float()[:_subset_rows(metric_subset, mask.shape[0], mesh)].sum())
    return torch.stack(row)


def global_val_rows(rows: np.ndarray, mesh) -> np.ndarray:
    """Every rank's (batches, 5) :func:`val_row` rows -> the global batches'
    [L1, PSNR, SSIM, real samples, subset samples]: L1 weighted by real
    samples, PSNR and SSIM by the subset's real samples, added over the
    ranks (one all-reduce). One process: the rows as they are."""
    if mesh is None or mesh.world == 1 or rows.size == 0:
        return rows
    from ..parallel.mesh import all_reduce_sum

    loss, psnr, ssim, n, k = rows.T
    sums = torch.from_numpy(np.stack([loss * n, psnr * np.maximum(k, 1), ssim * np.maximum(k, 1),
                                      n, k], axis=1))
    loss, psnr, ssim, n, k = all_reduce_sum(sums, mesh).numpy().T
    return np.stack([np.where(n > 0, loss / np.maximum(n, 1), 0.0), psnr / np.maximum(k, 1),
                     ssim / np.maximum(k, 1), n, k], axis=1)


def _rank_seed(seed: int, rank: int) -> int:
    """One 63-bit generator seed from (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


class _PaddedValLoader:
    """Pads every (x, y) batch to a fixed batch size and appends a (B,)
    real-sample mask."""

    def __init__(self, loader, static_b: int):
        self.loader = loader
        self.static_b = static_b

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for x, y in self.loader:
            b = x.shape[0]
            if b < self.static_b:
                pad = self.static_b - b
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
            mask = np.zeros((self.static_b,), np.float32)
            mask[:b] = 1.0
            yield x, y, mask


def _host_memory_bytes() -> int:
    """A CPU device's budget for a resident cache: the host's memory."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def train_model(model, train_loader, val_loader, *, epochs: int,
                lr: float = 0.002362532125818593,
                weight_decay: float = 6.753784966611083e-05,
                clip_grad_norm: float = 1.0, patience: int = 10,
                output_dir: str = "./models_out", save_every: int = 10,
                plateau_factor: float = 0.5, plateau_patience: int = 5,
                validation_metrics_every: int = 5, log_images_every: int = 5,
                mesh=None, seed: int = 42, logger=None, init_params=None,
                progress: bool = True, start_epoch: int = 0,
                resume_state: TrainState | None = None,
                resume_from: str | None = None,
                lr_controller: ReduceLROnPlateau | None = None,
                watch_every: int = 0, profile_dir: str | None = None,
                profile_steps: int = 0, device_augment: bool = False,
                resident: bool = False, prefetch: int = 2,
                preempt_guard=None, handle_preemption: bool = True,
                resident_segments: int = 8, device=None):
    """Train ``model`` (any of the port's families, moved to ``device``) in
    place; returns (best_params, best_model_state, best_val_loss,
    final_state) as the JAX package does: best_params is the JAX-named tree
    of numpy arrays from the best epoch, best_model_state the BatchNorm
    statistics of the same epoch as ``{"batch_stats": tree}`` (``{}`` for a
    model without them).

    The model starts from its own parameters, or from ``init_params`` (a
    JAX-named tree, ``load_jax_params``). ``device`` defaults to CUDA and
    raises without a card unless "cpu" is passed. ``resume_from``: a
    checkpoint directory; the run continues where it stopped (params,
    BatchNorm statistics, optimizer state, step, generator, epoch, LR
    controller, early-stop counter; a mid-epoch checkpoint re-enters its
    epoch at the next batch). On SIGTERM/SIGINT the running step finishes,
    ``output_dir/preempt_checkpoint`` is written and the function returns.

    ``resident``: cache the decoded train and val sets on the device once
    (``train.resident``; the loaders must not augment on the host) and run
    each epoch from there, in up to ``resident_segments`` segments with a
    preemption check between them; the step sequence does not depend on
    the segment count, and a mid-epoch checkpoint lands on a segment
    boundary. A mid-epoch checkpoint resumes only in the mode that wrote
    it. ``device_augment``: augment every batch on the device
    (``ops.augment_device``). ``profile_dir`` with ``profile_steps > 0``:
    a profiler trace (``utils.profiling``) of the first epoch's first
    ``profile_steps`` steps, or of its whole resident epoch, written there.

    ``mesh``: a ``parallel.mesh.DataMesh`` of several ranks (the module
    docstring), which owns the device: a ``device`` naming another raises. The streaming loaders
    yield this rank's rows (``parallel.distributed.LocalSliceLoader``); the
    resident ones are global, identical on every rank. The returned values
    are the same on every rank."""
    world = 1 if mesh is None else mesh.world
    is_host0 = mesh is None or mesh.rank == 0
    from ..parallel.mesh import run_device

    dev = run_device(device, mesh)
    say = print if is_host0 else (lambda *a, **k: None)
    os.makedirs(output_dir, exist_ok=True)

    if not (len(val_loader) or len(train_loader)):
        raise ValueError("train_model: both loaders are empty — no data to train on")
    model = model.to(dev)
    if init_params is not None:
        load_jax_params(model, unflatten_tree(
            {k: np.asarray(v, np.float32) for k, v in flatten_tree(init_params).items()}))
    stateful = next(model.buffers(), None) is not None
    if world > 1:
        from ..parallel.mesh import all_gather_array, replicate

        replicate(model, mesh)  # every rank starts from rank 0's weights

    def model_state() -> dict:
        return {"batch_stats": export_jax_batch_stats(model)} if stateful else {}

    if resume_state is not None:
        state = resume_state
    else:
        gen_seed = seed if world == 1 else _rank_seed(seed, mesh.rank)
        state = TrainState(model=model,
                           optimizer=make_optimizer(model, lr, weight_decay, clip_grad_norm),
                           generator=torch.Generator(device=dev).manual_seed(gen_seed))
    clip = state.optimizer.clip_grad_norm > 0

    resumed_stale_epochs = 0
    resume_mid_epoch, resume_skip_steps = -1, 0
    if resume_from is not None:
        if world > 1:
            # rank 0 reads, every rank receives: a rank-local read of a
            # missing or lagging directory would crash some ranks and leave
            # the rest waiting in the next collective
            item, meta = restore_checkpoint_all_hosts(
                resume_from, params_template=export_jax_params(model),
                opt_state_template=export_jax_opt_state(state.optimizer, model, clip=clip),
                model_state_template=model_state(), mesh=mesh)
        else:
            item, meta = restore_checkpoint(resume_from)
        load_jax_params(model, item["params"], item.get("model_state", {}).get("batch_stats"))
        load_jax_opt_state(state.optimizer, model, item["opt_state"])
        if meta.get("step") is not None:
            state.step = int(meta["step"])
        rng = meta.get("rng")
        if world > 1:
            # each rank's own stream where the run had this many ranks; else
            # rank 0 continues the saved one and the others keep (seed, rank)
            by_rank = meta.get("rng_by_rank") or []
            rng = (by_rank[mesh.rank] if len(by_rank) == world
                   else rng if mesh.rank == 0 else None)
        if rng is not None:
            state.generator.set_state(torch.tensor(rng, dtype=torch.uint8))
        resumed_stale_epochs = int(meta.get("epochs_without_improvement", 0))
        if meta.get("mid_epoch"):
            if "resident" in meta and bool(meta["resident"]) != resident:
                saved = "resident" if meta["resident"] else "streaming"
                now = "resident" if resident else "streaming"
                raise ValueError(
                    f"mid-epoch checkpoint was written by a {saved} run but this resume is "
                    f"{now}: the two modes count epoch_step against different batch plans "
                    "(loader order vs device permutation). Resume with the same "
                    "--resident_data setting as the preempted run.")
            resume_mid_epoch = int(meta.get("epoch", 0))
            resume_skip_steps = int(meta.get("epoch_step", 0))
            start_epoch = max(start_epoch, resume_mid_epoch)
        else:
            start_epoch = max(start_epoch, int(meta.get("epoch", -1)) + 1)
        if lr_controller is None and meta.get("lr_state"):
            lr_controller = ReduceLROnPlateau(lr, factor=plateau_factor,
                                              patience=plateau_patience)
            lr_controller.load_state_dict(meta["lr_state"])
        say(f"Resumed from {resume_from} at epoch {start_epoch}")

    augment_fn = None
    if device_augment:
        from ..ops.augment_device import device_augment_batch

        augment_fn = device_augment_batch
    train_step = make_train_step(stateful=stateful, augment_fn=augment_fn, mesh=mesh)
    val_step_metrics = make_val_step(mesh=mesh)
    val_step_plain = make_val_step(with_metrics=False, mesh=mesh)
    val_static_b = int(getattr(val_loader, "batch_size", 0) or 0)
    if not val_static_b:  # a loader without batch_size: its first batch says
        val_static_b = next(iter(val_loader if len(val_loader) else train_loader))[0].shape[0]
    padded_val = _PaddedValLoader(val_loader, val_static_b)
    # the input goes to the device in the model's compute dtype (its first
    # op is this cast); the target stays float32
    input_dtype = torch.bfloat16 if getattr(model, "dtype", None) == torch.bfloat16 else None

    if resident:
        from .resident import (batch_val_cache, cache_on_device, make_train_epoch_segmented,
                               make_val_epoch)

        # the resident loaders are global: every rank caches the whole set
        # and takes its rows of each planned batch
        train_batch = int(getattr(train_loader, "batch_size", 0)
                          or next(iter(train_loader))[0].shape[0])
        workers = getattr(train_loader, "num_workers", 8)
        budget = None if dev.type == "cuda" else _host_memory_bytes()
        rd_train = cache_on_device(train_loader, dtype=input_dtype, num_workers=workers,
                                   device=dev, device_bytes=budget)
        if min(train_batch, rd_train.n) % world:
            raise ValueError(f"resident training: the step batch {min(train_batch, rd_train.n)} "
                             f"must divide by {world} ranks")
        res_plan_fn, res_segment_fn = make_train_epoch_segmented(
            batch_size=train_batch, stateful=stateful, augment_fn=augment_fn, mesh=mesh)
        val_batches = None
        if int(getattr(val_loader, "num_samples", len(val_loader)) or 0):
            rd_val = cache_on_device(val_loader, dtype=input_dtype, num_workers=workers,
                                     device=dev, device_bytes=budget)
            # padded to a multiple of the ranks; each rank takes its columns
            res_val_b = -(-val_static_b // world) * world
            val_batches = batch_val_cache(rd_val, res_val_b, mesh=mesh)
            val_epoch_metrics = make_val_epoch(mesh=mesh)
            val_epoch_plain = make_val_epoch(with_metrics=False, mesh=mesh)

    scheduler = lr_controller or ReduceLROnPlateau(lr, factor=plateau_factor,
                                                   patience=plateau_patience)
    set_learning_rate(state, scheduler.lr)

    best_val_loss = float("inf")
    best_params = best_model_state = None
    if resume_from is not None:
        # the run's existing best_model is the bar: without it the first
        # epoch after the resume would always "improve" on inf and
        # overwrite a better checkpoint
        best_dir = os.path.join(output_dir, "best_model")
        # over several ranks only rank 0 reads (output_dir may be its local
        # disk); the bar and its trees are broadcast below
        if is_host0 and os.path.isdir(best_dir):
            def shapes(tree):
                return {k: np.shape(v) for k, v in flatten_tree(tree).items()}

            try:
                prev_item, prev_meta = restore_checkpoint(best_dir)
                prev_val = prev_meta.get("val_loss")
                prev_ms = prev_item.get("model_state", {})
                if (shapes(prev_item["params"]) != shapes(export_jax_params(model))
                        or shapes(prev_ms) != shapes(model_state())):
                    print(f"Resume: existing best_model in {best_dir} has a different "
                          "parameter structure (different --model?); best-model tracking "
                          "restarts")
                elif prev_val is not None and np.isfinite(prev_val):
                    best_val_loss, best_params = float(prev_val), prev_item["params"]
                    best_model_state = prev_ms
                    print(f"Resume: keeping existing best_model (val loss "
                          f"{best_val_loss:.4f}) as the bar")
            except (OSError, ValueError, KeyError) as e:  # corrupt best: start afresh
                print(f"Resume: could not read {best_dir} ({e}); best-model tracking "
                      "restarts")
        if world > 1:
            best_val_loss, best_params, best_model_state = _broadcast_best(
                best_val_loss, best_params, best_model_state, export_jax_params(model),
                model_state(), mesh)
    epochs_without_improvement = resumed_stale_epochs
    warned_no_val = False
    history = {"train_loss": [], "val_loss": []}

    def _resume_extra():
        # a collective over several ranks: every rank reaches each save
        extra = {"lr_state": scheduler.state_dict(), "step": int(state.step),
                 "rng": state.generator.get_state().tolist(),
                 "epochs_without_improvement": epochs_without_improvement}
        if world > 1:
            extra["rng_by_rank"] = all_gather_array(
                state.generator.get_state().numpy(), mesh).tolist()
        return extra

    def _save(name, *, val, extra):
        return save_checkpoint(os.path.join(output_dir, name),
                               params=export_jax_params(model),
                               opt_state=export_jax_opt_state(state.optimizer, model, clip=clip),
                               model_state=model_state(), epoch=epoch, val_loss=val,
                               extra=extra)

    def _save_preempt(epoch_step=None):
        extra = _resume_extra()
        if epoch_step is not None:
            # the mode stamp: a streaming skip counts loader batches, a
            # resident one positions in the device permutation
            extra.update(mid_epoch=True, epoch_step=int(epoch_step), resident=bool(resident))
        path = _save("preempt_checkpoint", val=best_val_loss, extra=extra)
        if guard is not None:
            guard.preempt_checkpoint = path
        say(f"Preempted: exact state saved to {path} — continue with --resume {path}",
            flush=True)

    guard = preempt_guard
    own_guard = False
    if guard is None and handle_preemption:
        guard = PreemptionGuard().__enter__()
        own_guard = True
    preempted = False
    epoch = start_epoch
    try:
        for epoch in range(start_epoch, epochs):
            # ------------------------------------------------------ train
            t0 = time.time()
            skip = resume_skip_steps if epoch == resume_mid_epoch else 0
            # a trace of the first epoch's hot loop (the reference has no profiler)
            prof = (start_trace(profile_dir)
                    if profile_dir is not None and profile_steps > 0 and epoch == start_epoch
                    else None)
            if resident:
                # the epoch's plan, drawn once from (seed, epoch) and run in
                # segments; a resume slices it from the saved boundary
                idx = res_plan_fn(seed, epoch, rd_train.n, dev)
                steps = int(idx.shape[0])
                seg_len = -(-steps // max(1, min(resident_segments, steps)))
                s, parts, mid_step = min(skip, steps), [], 0
                while s < steps:
                    e = min(s + seg_len, steps)
                    state, seg_losses = res_segment_fn(state, rd_train.x, rd_train.y, idx[s:e])
                    with span("train.fetch"):  # one fetch per segment
                        parts.append(_global_losses(seg_losses, mesh))
                    s = e
                    if s < steps and guard is not None:
                        # every rank reaches a segment boundary in lock step
                        trig = guard.triggered
                        if world > 1:
                            trig = preemption_agreed(trig, mesh)
                        if trig:
                            preempted, mid_step = True, s
                            break
                if prof is not None:
                    stop_trace(prof, profile_dir)
                    prof = None
                if preempted:
                    _save_preempt(mid_step)
                    break
                losses_np = torch.cat(parts).numpy() if parts else np.zeros(0)
                n_seen = losses_np.size * min(train_batch, rd_train.n)
                train_loss = float(losses_np.mean()) if losses_np.size else 0.0
            else:
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                # mid-epoch resume: skip the trained batches in the loader's
                # plan (no decode, no copy), or drop them in the loop for a
                # loader without the hook
                plan_skip = skip if skip and hasattr(train_loader, "set_skip_batches") else 0
                if plan_skip:
                    train_loader.set_skip_batches(plan_skip)
                try:
                    planned_steps = len(train_loader) - (0 if plan_skip else skip)
                except TypeError:
                    planned_steps = None
                it = _waited(DevicePrefetcher(train_loader, device=dev, prefetch=prefetch,
                                              input_dtype=input_dtype))
                if progress and is_host0:
                    try:
                        from tqdm import tqdm

                        it = tqdm(it, total=len(train_loader),
                                  desc=f"Epoch {epoch + 1}/{epochs} [Train]")
                    except ImportError:
                        pass
                step_losses: list = []
                step_sizes: list[int] = []
                mid_step = 0
                for i, (x, y) in enumerate(it):
                    if not plan_skip and skip and i < skip:
                        continue  # trained before the preemption snapshot
                    state, loss = train_step(state, x, y)
                    step_losses.append(loss)
                    step_sizes.append(x.shape[0])
                    if prof is not None and i + 1 >= profile_steps:
                        stop_trace(prof, profile_dir)
                        prof = None
                    # one process reacts after every step; several agree at the
                    # epoch's end (preemption_agreed), where all arrive together
                    if guard is not None and guard.triggered and world == 1:
                        preempted = True
                        mid_step = plan_skip + i + 1  # counted from the epoch's start
                        break
                if plan_skip:  # one-shot: later epochs iterate in full
                    train_loader.set_skip_batches(0)
                if prof is not None:  # the epoch was shorter than profile_steps
                    stop_trace(prof, profile_dir)
                    prof = None
                if preempted:
                    _save_preempt(mid_step)
                    break
                if planned_steps is not None and len(step_sizes) != planned_steps:
                    raise RuntimeError(
                        f"epoch {epoch}: trained {len(step_sizes)} steps but the loader planned "
                        f"{planned_steps} (skip={skip}, plan_skip={bool(plan_skip)}) — the "
                        f"loader's set_skip_batches len/iter contract is violated or batches "
                        f"were dropped")
                n_seen = sum(step_sizes) * world  # every rank steps on as many rows
                if step_losses:  # one fetch per epoch, not one sync per step
                    with span("train.fetch"):
                        losses_np = _global_losses(torch.stack(step_losses), mesh).numpy()
                    running = float(losses_np @ np.asarray(step_sizes, np.float64)) * world
                else:
                    running = 0.0
                train_loss = running / max(n_seen, 1)
            history["train_loss"].append(train_loss)
            train_secs = time.time() - t0
            train_ips = n_seen / train_secs if train_secs > 0 else 0.0

            # -------------------------------------------------------- val
            calc_metrics = ((epoch + 1) % validation_metrics_every == 0 or epoch == 0
                            or epoch == epochs - 1)
            log_images = logger is not None and (
                (epoch + 1) % log_images_every == 0 or epoch == 0 or epoch == epochs - 1)
            first_val = None
            vs = None
            if resident:
                if val_batches is not None:
                    val_epoch = val_epoch_metrics if calc_metrics else val_epoch_plain
                    vs = global_val_rows(val_epoch(model, *val_batches).double().cpu().numpy(),
                                         mesh)
                    if log_images:
                        x, y = val_batches[0][0], val_batches[1][0]
                        first_val = (x, y, val_step_plain(model, x, y, val_batches[2][0])[3])
            else:
                val_step = val_step_metrics if calc_metrics else val_step_plain
                val_stats: list = []
                for batch_idx, (x, y, mask) in enumerate(
                        DevicePrefetcher(padded_val, device=dev, prefetch=prefetch,
                                         input_dtype=input_dtype)):
                    loss, psnr, ssim, out = val_step(model, x, y, mask)
                    val_stats.append(val_row(loss, psnr, ssim, mask, mesh=mesh))
                    if log_images and batch_idx == 0:
                        first_val = (x, y, out)  # this rank's rows
                if val_stats:
                    vs = global_val_rows(torch.stack(val_stats).double().cpu().numpy(), mesh)
            if first_val is not None:
                x, y, out = first_val
                k = min(2, out.shape[0])
                out_np = out[:k].cpu().numpy()
                x_np = x[:k].float().cpu().numpy()
                y_np = y[:k].float().cpu().numpy()
                imgs = {}
                for j in range(k):
                    imgs[f"input_{j}"] = x_np[j, ..., 0]
                    imgs[f"prediction_{j}"] = np.clip(out_np[j, ..., 0], 0, 1)
                    imgs[f"target_{j}"] = y_np[j, ..., 0]
                logger.log_images("val", imgs, step=epoch + 1)
            if vs is not None:
                val_seen = float(vs[:, 3].sum())
                val_loss = float(vs[:, 0] @ vs[:, 3]) / max(val_seen, 1.0)
                val_psnr = float(vs[:, 1].mean())
                val_ssim = float(vs[:, 2].mean())
            else:
                # no validation data: the train loss drives the plateau and
                # the early stop (a constant 0.0 would stop after patience)
                val_loss = train_loss
                val_psnr = val_ssim = 0.0
                if not warned_no_val:
                    warned_no_val = True
                    say("Warning: validation loader is empty — using the train loss for "
                          "LR scheduling, early stopping, and best-model tracking")
            history["val_loss"].append(val_loss)

            # ------------------------------------ schedule / log / save
            new_lr = scheduler.step(val_loss)
            set_learning_rate(state, new_lr)

            msg = (f"Epoch {epoch + 1}/{epochs}: Train Loss: {train_loss:.4f}, "
                   f"Val Loss: {val_loss:.4f}")
            if calc_metrics:
                msg += f", PSNR: {val_psnr:.2f}, SSIM: {val_ssim:.4f}"
            msg += f", LR: {new_lr:.6f} ({time.time() - t0:.1f}s)"
            say(msg, flush=True)

            if logger is not None:
                rec = {"epoch": epoch + 1, "train_loss": train_loss, "val_loss": val_loss,
                       "learning_rate": new_lr, "train_images_per_sec": train_ips}
                if calc_metrics:
                    rec["val_psnr"] = val_psnr
                    rec["val_ssim"] = val_ssim
                logger.log(rec, step=epoch + 1)
                if watch_every > 0 and (epoch + 1) % watch_every == 0:
                    logger.log_histograms(export_jax_params(model), step=epoch + 1,
                                          prefix="params")

            if val_loss < best_val_loss:
                epochs_without_improvement = 0
                best_val_loss = val_loss
                best_params, best_model_state = export_jax_params(model), model_state()
                _save("best_model", val=val_loss, extra=_resume_extra())
                say(f"New best model with validation loss: {val_loss:.4f}")
                if logger is not None:
                    summary = {"best_val_loss": best_val_loss, "best_epoch": epoch + 1}
                    if calc_metrics:
                        summary["best_val_psnr"] = val_psnr
                        summary["best_val_ssim"] = val_ssim
                    logger.set_summary(**summary)
                    logger.save(os.path.join(output_dir, "best_model"))
            else:
                epochs_without_improvement += 1
                say(f"No improvement for {epochs_without_improvement} epochs "
                      f"(best: {best_val_loss:.4f}, current: {val_loss:.4f})")
                if logger is not None:
                    logger.log({"epochs_without_improvement": epochs_without_improvement},
                               step=epoch + 1)

            # after the bookkeeping: the extras carry this epoch's counter
            if (epoch + 1) % save_every == 0:
                path = _save(f"checkpoint_epoch_{epoch + 1}", val=val_loss,
                             extra=_resume_extra())
                if logger is not None:
                    logger.save(path)

            if epochs_without_improvement >= patience:
                say(f"Early stopping triggered after {patience} epochs without improvement")
                if logger is not None:
                    logger.set_summary(early_stopped=True, early_stopping_epoch=epoch + 1)
                break

            # a signal that landed outside the step loop (val, checkpoints),
            # and over several ranks the only check: uniform on every rank
            if guard is not None and preemption_agreed(guard.triggered, mesh):
                guard.triggered = True
                preempted = True
                _save_preempt()
                break
    finally:
        if own_guard:
            guard.__exit__(None, None, None)
    if is_host0:
        _plot_losses(history, output_dir)
    if best_params is None:
        best_params, best_model_state = export_jax_params(model), model_state()
    return best_params, best_model_state, best_val_loss, state


def _waited(batches):
    """``batches`` with each wait for the next one in a ``train.data_wait``
    span."""
    it = iter(batches)
    while True:
        with span("train.data_wait"):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def _global_losses(losses: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's per-step mean losses -> the global batches' (the mean of
    the ranks' means: equal rows per rank), float64 on the host."""
    if mesh is not None and mesh.world > 1:
        from ..parallel.mesh import all_reduce_sum

        losses = all_reduce_sum(losses.double().clone(), mesh) / mesh.world
    return losses.double().cpu()


def _broadcast_best(val: float, params, model_state, params_template: dict,
                    state_template: dict, mesh):
    """Rank 0's best-model bar (its val loss, params and statistics, or
    none) on every rank, over the current model's trees."""
    from ..parallel.mesh import broadcast_arrays, broadcast_bytes

    have = mesh.rank == 0 and params is not None
    head = json.loads(broadcast_bytes(
        json.dumps([have, val if have else None]).encode() if mesh.rank == 0 else None, mesh))
    if not head[0]:
        return float("inf"), None, None
    out = []
    for tree, tmpl in ((params, params_template), (model_state, state_template)):
        names = sorted(flatten_tree(tmpl))
        src = flatten_tree(tree) if mesh.rank == 0 else None
        leaves = broadcast_arrays([src[k] for k in names] if src is not None else None,
                                  [flatten_tree(tmpl)[k] for k in names], mesh)
        out.append(unflatten_tree(dict(zip(names, leaves))) if names else {})
    return float(head[1]), out[0], out[1]


def _plot_losses(history: dict, output_dir: str) -> None:
    """loss_plot.png with the train/val curves, where matplotlib is installed."""
    if not history["train_loss"]:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig = plt.figure(figsize=(10, 5))
    plt.plot(history["train_loss"], label="Training Loss")
    plt.plot(history["val_loss"], label="Validation Loss")
    plt.xlabel("Epoch")
    plt.ylabel("L1 Loss")
    plt.title("Training and Validation Losses")
    plt.legend()
    plt.grid(True)
    fig.savefig(os.path.join(output_dir, "loss_plot.png"))
    plt.close(fig)
