"""Hyperparameter sweeps, on one card or with the trial axis over ranks.

Counterpart of ``image_enhancement_deglaring_tpu.parallel.sweep``. The
reference runs a W&B Bayesian sweep with Hyperband early termination, one
trial at a time (reference: sweep.py:41-91, :241 — batch_size in
{4,8,16,32}, lr ~ logU[1e-4,1e-2], wd ~ logU[1e-6,1e-3]; fixed AMP,
grad-clip 1.0, image 512, 'basic' model). Here, as in the JAX package:

- trials with the same batch size train in one **lock-step group**: their
  parameters, BatchNorm buffers and AdamW moments are stacked on a leading
  trial axis (``torch.func.stack_module_state``), one trial's forward
  (``functional_call``, float32 L1) runs under ``torch.func.vmap`` over
  that axis, and one backward of the summed losses gives every trial its
  gradients. Every trial sees the same batch and, with
  ``randomness="same"``, the same augmentation and dropout draws. The
  clip (optax's rule) and AdamW then update the stacked tensors with each
  trial's lr and wd from (K,) tensors on the device, so a plateau's LR
  change rebuilds nothing. Under ``vmap`` torch runs each conv of the K
  trials as one grouped conv (groups = K);
- search: random sampling or a TPE-style sampler over log-uniform lr/wd and
  categorical batch size, in waves that refit on every finished trial;
- early termination: successive halving at Hyperband rungs, per-trial
  patience; a journal of finished groups makes a preempted sweep resume to
  the identical result; W&B mirroring and the server-driven agent mode.

With ``mesh=`` (a ``parallel.mesh.DataMesh``: one process per device in a
process group) a group's trial axis is split over the ranks, as the JAX
package shards it over its mesh: the physical axis is padded to a multiple
of the world size (padded slots train a copy of trial 0), rank ``r`` holds
slots ``[r * k, (r + 1) * k)``, every rank trains its slots on the same
batches (the data is replicated) and the losses are all-gathered, so every
rank runs the same seeded proposer, ranking and halving. Rank 0 alone
writes the journal, the results, the best trial's parameters and the W&B
mirror.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.func import functional_call, stack_module_state, vmap

from ..data.dataset import DevicePrefetcher
from ..modelio.params_import import _export_tree
from ..models.model_utils import get_model_size_mb
from ..ops.conv_blocks import highest_precision
from ..ops.metrics import l1_loss
from ..train.loop import _host_memory_bytes
from ..train.lr_control import ReduceLROnPlateau
from ..train.preempt import preemption_agreed
from ..train.resident import _make_segment_fn, batch_val_cache, cache_on_device, epoch_batch_plan
from ..utils.pytree import flatten_tree
from .mesh import all_gather_rows, broadcast_bytes, broadcast_from, run_device

# AdamW as the trainer's ClippedAdamW (train.loop) builds it
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8

# --------------------------------------------------------------------- space


@dataclass
class SearchSpace:
    batch_sizes: tuple = (4, 8, 16, 32)
    lr_min: float = 1e-4
    lr_max: float = 1e-2
    wd_min: float = 1e-6
    wd_max: float = 1e-3


@dataclass
class Trial:
    trial_id: int
    batch_size: int
    lr: float
    wd: float
    val_losses: list = field(default_factory=list)
    stopped_at: int | None = None  # epoch where it stopped early (if ever)
    # why it stopped: "halving" (dropped at a rung — provably worse than a
    # survivor) vs "patience" (plateaued — may still be the best trial);
    # None while running / ran to max_epochs
    stop_reason: str | None = None

    @property
    def best_val_loss(self) -> float:
        return min(self.val_losses) if self.val_losses else float("inf")


def sample_random(rng: np.random.Generator, n: int, space: SearchSpace,
                  start_id: int = 0) -> list[Trial]:
    trials = []
    for i in range(n):
        trials.append(Trial(
            trial_id=start_id + i,
            batch_size=int(rng.choice(space.batch_sizes)),
            lr=float(np.exp(rng.uniform(np.log(space.lr_min), np.log(space.lr_max)))),
            wd=float(np.exp(rng.uniform(np.log(space.wd_min), np.log(space.wd_max)))),
        ))
    return trials


def sample_tpe(rng: np.random.Generator, n: int, space: SearchSpace,
               history: list[Trial], gamma: float = 0.25,
               n_candidates: int = 64) -> list[Trial]:
    """TPE-style sampling: fit 'good' vs 'bad' KDEs over log(lr), log(wd) of
    completed trials, draw candidates from the good density, keep those
    maximizing good/bad likelihood ratio. Falls back to random until enough
    history exists."""
    # diverged trials (all-NaN losses) must not enter the good/bad split:
    # NaN keys silently misorder sorted() (NaN comparisons are all False)
    done = [t for t in history
            if t.val_losses and math.isfinite(t.best_val_loss)]
    # ids continue after EVERY trial ever sampled (not just finite ones) so a
    # random fallback wave can never collide with wave-1 trial_ids
    base_id = (max((t.trial_id for t in history), default=-1)) + 1
    if len(done) < 4:
        return sample_random(rng, n, space, start_id=base_id)
    done = sorted(done, key=lambda t: t.best_val_loss)
    n_good = max(1, int(math.ceil(gamma * len(done))))
    good, bad = done[:n_good], done[n_good:] or done[:n_good]

    def kde_logpdf(x, samples, lo, hi):
        samples = np.asarray(samples)
        bw = max((hi - lo) / 6.0, 1e-3) / max(len(samples) ** 0.2, 1.0)
        d = (x[:, None] - samples[None, :]) / bw
        return np.log(np.mean(np.exp(-0.5 * d * d), axis=1) / (bw * np.sqrt(2 * np.pi)) + 1e-12)

    lo_lr, hi_lr = np.log(space.lr_min), np.log(space.lr_max)
    lo_wd, hi_wd = np.log(space.wd_min), np.log(space.wd_max)
    out = []
    for i in range(n):
        cand_lr = rng.uniform(lo_lr, hi_lr, n_candidates)
        cand_wd = rng.uniform(lo_wd, hi_wd, n_candidates)
        score = (
            kde_logpdf(cand_lr, [np.log(t.lr) for t in good], lo_lr, hi_lr)
            - kde_logpdf(cand_lr, [np.log(t.lr) for t in bad], lo_lr, hi_lr)
            + kde_logpdf(cand_wd, [np.log(t.wd) for t in good], lo_wd, hi_wd)
            - kde_logpdf(cand_wd, [np.log(t.wd) for t in bad], lo_wd, hi_wd)
        )
        k = int(np.argmax(score))
        # categorical batch size: sample proportional to good-trial counts
        counts = np.array([
            sum(1 for t in good if t.batch_size == b) + 0.5
            for b in space.batch_sizes
        ])
        bs = int(rng.choice(space.batch_sizes, p=counts / counts.sum()))
        out.append(Trial(trial_id=base_id + i, batch_size=bs,
                         lr=float(np.exp(cand_lr[k])), wd=float(np.exp(cand_wd[k]))))
    return out


# --------------------------------------------------------------- trial group


def _epoch_seed(seed: int, epoch: int) -> int:
    """The 63-bit generator seed of one group epoch's augmentation and
    dropout draws, from (seed, epoch) alone: a group that re-runs (resume)
    draws the same stream."""
    return int(np.random.SeedSequence([seed, epoch, 1]).generate_state(1, np.uint64)[0] >> 1)


class VmappedTrialGroup:
    """Train N same-batch-size trials in lock step on one device (or, over
    a mesh, this rank's share of them): their state stacked on a trial
    axis, one trial's forward under ``vmap``.

    Every trial starts from ``model``'s own parameters and buffers (the
    factory's seeded module: the JAX group starts every trial from
    ``model.init(PRNGKey(seed))``). ``augment_fn(generator, x, y) -> (x,
    y)``: device augmentation (``ops.augment_device``) of the SHARED batch,
    one draw per step, in the per-step and the resident epoch alike; pair it
    with non-augmenting loaders. Augmentation and dropout draw from
    ``self.generator``, reseeded from (seed, epoch) at each epoch.

    ``lrs``/``wds`` are (K,) float64 tensors on the device: the update
    forms ``1 - lr * wd`` and ``lr / (1 - beta1^t)`` in float64 and applies
    them in float32, as ``torch.optim.AdamW`` does with its Python floats,
    so a group of one equals the trainer's ``ClippedAdamW`` step.

    ``mesh``: a ``parallel.mesh.DataMesh``; this rank holds K = (the trial
    count padded to a multiple of its world) / world slots (see the module
    docstring), the epochs return every live trial's value on every rank,
    and ``snapshot_of`` is a collective."""

    def __init__(self, model, trials: list[Trial], *, clip_grad_norm: float = 1.0,
                 mesh=None, seed: int = 42, plateau_patience: int = 5,
                 plateau_factor: float = 0.5, augment_fn=None, prefetch: int = 2,
                 device=None):
        self.trials = trials
        self.batch_size = trials[0].batch_size
        if any(t.batch_size != self.batch_size for t in trials):
            raise ValueError("VmappedTrialGroup trials must share one batch size")
        self.mesh = mesh
        self.device = run_device(device, mesh)
        self.model = model.to(self.device)
        self._world = mesh.world if mesh is not None else 1
        self._rank = mesh.rank if mesh is not None else 0
        # the physical trial axis, padded to a multiple of the world (padded
        # slots train trial 0's lr/wd and are never read back); this rank's
        # slots are [_first, _first + _k); live trial i sits in _slots[i]
        n = len(trials)
        self._set_layout(-(-n // self._world) * self._world)
        self._slots = list(range(n))
        pad = self._n_phys - n
        self._lrs_full = np.array([t.lr for t in trials] + [trials[0].lr] * pad, np.float64)
        self._wds_full = np.array([t.wd for t in trials] + [trials[0].wd] * pad, np.float64)
        self.seed = seed
        self.clip = float(clip_grad_norm)
        self.augment_fn = augment_fn
        self._prefetch = prefetch
        # bf16 models (the reference sweep fixes mixed precision on): inputs
        # ship in the compute dtype (the model's first op is this cast),
        # targets stay float32 for the loss
        dtype = getattr(model, "dtype", torch.float32)
        self._input_dtype = torch.bfloat16 if dtype == torch.bfloat16 else None
        self._exact = dtype == torch.float32
        params, buffers = stack_module_state([self.model] * self._k)
        self.params = {k: v.detach() for k, v in params.items()}
        # non-trainable state (EnhancedUNet's BatchNorm statistics) travels
        # stacked per trial, as the JAX group's model_state
        self.model_state = {k: v.detach() for k, v in buffers.items()}
        self.stateful = bool(self.model_state)
        self.opt_state = {"exp_avg": {k: torch.zeros_like(v) for k, v in self.params.items()},
                          "exp_avg_sq": {k: torch.zeros_like(v)
                                         for k, v in self.params.items()}}
        self.step = 0  # AdamW's count: every slot steps together
        self.lrs, self.wds = self._local(self._lrs_full), self._local(self._wds_full)
        self.schedulers = [
            ReduceLROnPlateau(t.lr, factor=plateau_factor, patience=plateau_patience)
            for t in trials
        ]
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        module, stateful, gen = self.model, self.stateful, self.generator

        def trial_loss(p, buffers, x, y):
            # the training forward writes BatchNorm's running statistics in
            # place: into this trial's fresh copies, returned as its new state
            new_buffers = {k: v.clone() for k, v in buffers.items()}
            kwargs = {"train": True, "generator": gen} if stateful else {}
            out = functional_call(module, (p, new_buffers), (x,), kwargs)
            return l1_loss(out, y), new_buffers

        def trial_val(p, buffers, x, y):
            return l1_loss(functional_call(module, (p, buffers), (x,)), y)

        def trial_val_masked_sum(p, buffers, x, y, mask):
            out = functional_call(module, (p, buffers), (x,)).float()
            per = torch.mean(torch.abs(out - y.float()), dim=(1, 2, 3))
            return torch.sum(per * mask)

        # the batch (and the generator, closed over) is shared: in_dims None.
        # The gradients come from one ordinary backward of the summed
        # losses (trials are independent, so each slot gets its own): the
        # torch.func.grad transform keeps the forward's saved tensors and
        # records its backward for higher derivatives (create_graph), which
        # doubled the step's peak memory on the card (PERF.md §6)
        self._losses = vmap(trial_loss, in_dims=(0, 0, None, None), randomness="same")
        self._val = vmap(trial_val, in_dims=(0, 0, None, None))
        self._val_masked = vmap(trial_val_masked_sum, in_dims=(0, 0, None, None, None))
        self._segment = _make_segment_fn(lambda g, x, y: (g, g._train_step(x, y)))

    def _set_layout(self, n_phys: int) -> None:
        self._n_phys = n_phys
        self._k = n_phys // self._world
        self._first = self._rank * self._k

    def _local(self, full: np.ndarray) -> torch.Tensor:
        """This rank's slots of a host (n_phys,) array, float64 on the device."""
        return torch.tensor(full[self._first:self._first + self._k], dtype=torch.float64,
                            device=self.device)

    def _live(self, local: torch.Tensor) -> np.ndarray:
        """Every live trial's value, from each rank's (K,) per-slot values
        (one all-gather over a mesh)."""
        return all_gather_rows(local, self.mesh).cpu().numpy()[self._slots]

    def _precision(self):
        """float32 models train at full precision (TF32 off), as the trainer."""
        return highest_precision() if self._exact else contextlib.nullcontext()

    def _loss_and_grads(self, x: torch.Tensor, y: torch.Tensor):
        """Every slot's forward on the shared batch and its gradients:
        ((K,) losses, {name: (K, ...) gradient}, the new model_state)."""
        self.model.train()
        with self._precision():
            leaves = {k: v.detach().requires_grad_() for k, v in self.params.items()}
            losses, new_state = self._losses(leaves, self.model_state, x, y)
            grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
        return losses.detach(), dict(zip(leaves, grads)), new_state

    def _train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One step of every slot on the shared batch; (K,) losses on the
        device."""
        if self.augment_fn is not None:
            x, y = self.augment_fn(self.generator, x, y)
        losses, grads, self.model_state = self._loss_and_grads(x, y)
        with torch.no_grad():
            self._update(grads)
        return losses

    def _update(self, grads: dict) -> None:
        """Per slot, optax's clip_by_global_norm (``train.loop.clip_grad_norm_``)
        then torch's AdamW step, on the stacked tensors."""
        k = int(self.lrs.shape[0])

        def per_slot(v, like):
            return v.reshape((k,) + (1,) * (like.ndim - 1))

        if self.clip > 0:
            norm = torch.sqrt(sum(torch.sum(torch.square(g.float()), dim=tuple(range(1, g.ndim)))
                                  for g in grads.values()))
            clipping = norm >= self.clip
            grads = {n: torch.where(per_slot(clipping, g), (g / per_slot(norm, g)) * self.clip, g)
                     for n, g in grads.items()}
        self.step += 1
        bc1 = 1 - BETA1 ** self.step
        bc2_sqrt = (1 - BETA2 ** self.step) ** 0.5
        decay = (1 - self.lrs * self.wds).float()
        neg_step = (-(self.lrs / bc1)).float()
        m_all, v_all = self.opt_state["exp_avg"], self.opt_state["exp_avg_sq"]
        for n, g in grads.items():
            p = self.params[n] * per_slot(decay, g)
            m = m_all[n].lerp(g, 1 - BETA1)
            v = torch.addcmul(v_all[n] * BETA2, g, g, value=1 - BETA2)
            denom = v.sqrt() / bc2_sqrt + EPS
            self.params[n] = p + per_slot(neg_step, g) * m / denom
            m_all[n], v_all[n] = m, v

    def train_epoch(self, train_loader, epoch: int) -> np.ndarray:
        """One epoch from a host loader; each trial's mean batch loss. The
        per-step losses stay on the device and are fetched once."""
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        self.generator.manual_seed(_epoch_seed(self.seed, epoch))
        per_batch = [self._train_step(x, y) for x, y in
                     DevicePrefetcher(train_loader, device=self.device, prefetch=self._prefetch,
                                      input_dtype=self._input_dtype)]
        if not per_batch:
            return np.zeros(len(self.trials))
        return self._live(torch.stack(per_batch).mean(dim=0))

    def val_epoch(self, val_loader) -> np.ndarray:
        """Each trial's sample-weighted mean L1 over ragged host batches."""
        per_batch, weights = [], []
        with torch.no_grad(), self._precision():
            for x, y in DevicePrefetcher(val_loader, device=self.device,
                                         prefetch=self._prefetch,
                                         input_dtype=self._input_dtype):
                per_batch.append(self._val(self.params, self.model_state, x, y))
                weights.append(x.shape[0])
        if not per_batch:
            return np.zeros(len(self.trials))
        w = torch.tensor(weights, dtype=torch.float32, device=self.device)
        return self._live(torch.stack(per_batch).T @ w / w.sum())

    def train_epoch_resident(self, data, epoch: int, *, shuffle: bool = True) -> np.ndarray:
        """One epoch over a device-resident cache (``train.resident``
        ``ResidentData``): the plan of ``epoch_batch_plan(seed, epoch)``,
        each row gathered on the device and stepped, one fetch of the
        losses. Every trial sees the same shuffled (and, with
        ``augment_fn``, identically augmented) stream."""
        idx = epoch_batch_plan(self.seed, epoch, data.n, self.batch_size, shuffle=shuffle,
                               device=data.x.device)
        self.generator.manual_seed(_epoch_seed(self.seed, epoch))
        _, losses = self._segment(self, data.x, data.y, idx)
        return self._live(losses.mean(dim=0))

    def val_epoch_resident(self, val_batches, n_real: int) -> np.ndarray:
        """The validation set from ``train.resident.batch_val_cache``'s
        padded batches: each trial's mean L1 over the ``n_real`` real
        samples, the sample-weighted mean ``val_epoch`` takes."""
        xb, yb, masks = val_batches
        acc = torch.zeros(int(self.lrs.shape[0]), dtype=torch.float32, device=self.device)
        with torch.no_grad(), self._precision():
            for x, y, m in zip(xb, yb, masks):
                acc = acc + self._val_masked(self.params, self.model_state, x, y, m)
        return self._live(acc) / max(n_real, 1)

    def step_schedulers(self, val_losses: np.ndarray) -> None:
        self._lrs_full[self._slots] = [s.step(float(v))
                                       for s, v in zip(self.schedulers, val_losses)]
        self.lrs = self._local(self._lrs_full)

    def keep(self, indices: list[int], *, mode: str = "compact") -> None:
        """Drop all but ``indices`` (halving, patience).

        ``mode="mask"`` retires slots without moving any state: the dropped
        ones keep training, unread. ``mode="compact"`` gathers the
        survivors' parameters, buffers and AdamW moments into smaller
        stacked tensors, padded again to a multiple of the world (over a
        mesh every rank gathers every slot, then takes its new ones).
        Trials are independent (their own clip, BatchNorm statistics and
        AdamW state; one shared batch and random draw whatever the group's
        size), so a survivor trains on as it would beside the dropped
        trials either way, up to the rounding of a grouped conv of another
        size."""
        survivors = [self._slots[i] for i in indices]
        self.trials = [self.trials[i] for i in indices]
        self.schedulers = [self.schedulers[i] for i in indices]
        if mode == "mask":
            self._slots = survivors
            return
        n_new = -(-len(survivors) // self._world) * self._world
        order = survivors + survivors[:1] * (n_new - len(survivors))
        self._set_layout(n_new)
        mine = torch.tensor(order[self._first:self._first + self._k], dtype=torch.long,
                            device=self.device)

        def take(tree: dict) -> dict:
            return {k: all_gather_rows(v, self.mesh).index_select(0, mine)
                    for k, v in tree.items()}

        self.params = take(self.params)
        self.model_state = take(self.model_state)
        self.opt_state = {k: take(v) for k, v in self.opt_state.items()}
        self._lrs_full, self._wds_full = self._lrs_full[order], self._wds_full[order]
        self.lrs, self.wds = self._local(self._lrs_full), self._local(self._wds_full)
        self._slots = list(range(len(survivors)))

    def _slot_tree(self, tree: dict, i: int) -> dict:
        """Trial ``i``'s slot of a stacked tree as the JAX package's tree of
        float32 numpy arrays; over a mesh the rank holding it broadcasts it
        (a collective)."""
        owner, local = divmod(self._slots[i], self._k)
        if self._world == 1:
            return _export_tree((k, v[local]) for k, v in tree.items())
        # the other ranks pass their first slot as the shape to receive into
        at = local if self._rank == owner else 0
        return _export_tree((k, broadcast_from(v[at], owner, self.mesh)) for k, v in tree.items())

    def params_of(self, i: int) -> dict:
        """Trial ``i``'s parameters as the JAX package's tree of float32
        numpy arrays."""
        return self._slot_tree(self.params, i)

    def snapshot_of(self, i: int) -> dict:
        """Host snapshot of trial ``i``'s weights. Stateless models return
        the bare params tree (the flat-npz artifact convention); stateful
        ones bundle the BatchNorm statistics alongside — ``{"params": ...,
        "batch_stats": ...}`` — the layout ``eval.harness`` reads for
        EnhancedUNet."""
        params = self.params_of(i)
        if not self.stateful:
            return params
        return {"params": params, "batch_stats": self._slot_tree(self.model_state, i)}


# --------------------------------------------------------------------- sweep


class WandbSweepMirror:
    """Mirrors finished trials to Weights & Biases as one run per trial —
    the reference's sweep lives inside W&B with exactly that shape
    (wandb.sweep + wandb.agent spawn a run per trial,
    reference: sweep.py:231-241). Trials here train lock-step in groups, so
    each trial's run is created when the trial finishes (dropped at a
    halving rung or fully trained) and its epoch history is replayed.

    Mirroring is best-effort: a wandb/network failure never kills the
    sweep (local JSONL + sweep_results.json stay the source of truth)."""

    def __init__(self, project: str | None = None, group: str | None = None,
                 entity: str | None = None):
        import time

        import wandb  # caller gates on importability

        self._wandb = wandb
        self.project = project
        self.entity = entity
        self.group = group or f"sweep-{int(time.time())}"
        self.mirrored: list[int] = []
        # set once by run_sweep from the first trial group's parameter
        # shapes; the reference logs the trained model's size into every
        # trial run (reference: sweep.py:209-210)
        self.model_size_mb: float | None = None
        # set by register_sweep when the W&B server accepts a first-class
        # sweep object; None = offline/local, fall back to grouped runs
        self.sweep_id: str | None = None

    def register_sweep(self, *, method: str, min_iter: int, eta: int,
                       space: SearchSpace, extra_config: dict | None = None) -> str | None:
        """Register a FIRST-CLASS W&B sweep object (wandb.sweep), mirroring
        the reference's server-side sweep entity (reference:
        sweep.py:228-235). Trial runs mirrored afterwards attach to the
        returned sweep id. Best-effort: offline or API failure leaves
        ``sweep_id`` None and the grouped-runs fallback carries the same
        telemetry."""
        config = sweep_server_config(method, min_iter, eta, space)
        if extra_config:
            config.update(extra_config)
        try:
            self.sweep_id = self._wandb.sweep(config, project=self.project, entity=self.entity)
        except Exception:  # offline/unauthenticated: grouped-runs fallback
            self.sweep_id = None
        return self.sweep_id

    def mirror_trial(self, trial: Trial) -> None:
        try:
            # attach to the registered sweep the way wandb's own agent
            # does — the SDK reads the sweep id from the environment at
            # init time (there is no public init kwarg for it)
            prev = os.environ.get("WANDB_SWEEP_ID")
            if self.sweep_id is not None:
                os.environ["WANDB_SWEEP_ID"] = self.sweep_id
            try:
                run = self._wandb.init(
                    project=self.project, entity=self.entity, group=self.group,
                    name=f"trial_{trial.trial_id}", reinit=True,
                    config={"batch_size": trial.batch_size, "lr": trial.lr,
                            "weight_decay": trial.wd},
                )
            finally:
                if self.sweep_id is not None:
                    if prev is None:
                        os.environ.pop("WANDB_SWEEP_ID", None)
                    else:
                        os.environ["WANDB_SWEEP_ID"] = prev
            for epoch, v in enumerate(trial.val_losses):
                run.log({"val_loss": v}, step=epoch)
            run.summary["best_val_loss"] = trial.best_val_loss
            if self.model_size_mb is not None:
                run.summary["final_model_size_mb"] = self.model_size_mb
            if trial.stopped_at is not None:
                run.summary["stopped_at_epoch"] = trial.stopped_at
                run.summary["stop_reason"] = trial.stop_reason
            run.finish()
            self.mirrored.append(trial.trial_id)
        except Exception:  # pragma: no cover - network/SaaS failure path
            pass


def _journal_bytes(path: str, mesh=None) -> bytes | None:
    """The sweep journal's bytes, None when there is none. Over a mesh rank
    0 reads the file and broadcasts its bytes (the JAX package's
    ``_journal_bytes_all_hosts``): a per-rank read of a rank-local or
    lagging file system would replay different histories on the ranks of
    one lock-step sweep."""
    payload = None
    if mesh is None or mesh.rank == 0:
        if os.path.exists(path):
            with open(path, "rb") as f:
                payload = f.read()
    if mesh is None or mesh.world == 1:
        return payload
    return broadcast_bytes(payload or b"", mesh) or None


def hyperband_rungs(min_iter: int, max_epochs: int, eta: int = 3) -> list[int]:
    """Rung epochs: min_iter, min_iter*eta, ... capped at max_epochs."""
    if min_iter <= 0 or eta <= 1:
        # r would never grow: the while-loop below appends forever (OOM)
        raise ValueError(
            f"hyperband needs min_iter >= 1 and eta >= 2 "
            f"(got min_iter={min_iter}, eta={eta})")
    rungs = []
    r = min_iter
    while r < max_epochs:
        rungs.append(r)
        r *= eta
    rungs.append(max_epochs)
    return rungs


def run_sweep(model_factory, loader_factory, *, n_trials: int = 20,
              max_epochs: int = 50, min_iter: int = 10, eta: int = 3,
              method: str = "tpe", seed: int = 42, mesh=None,
              output_dir: str = "./sweep_out", space: SearchSpace | None = None,
              logger=None, max_parallel_trials: int = 0,
              wandb_mirror: WandbSweepMirror | None = None,
              resident: bool = False, augment_fn=None,
              halving: str = "compact", early_stop_patience: int = 0,
              prefetch: int = 2, preempt_guard=None,
              resume: bool = False, fingerprint: dict | None = None,
              device=None) -> dict:
    """Run a sweep; returns {'best': Trial-dict, 'trials': [...],
    'preempted': bool}, and writes ``sweep_results.json``,
    ``sweep_journal.jsonl`` and ``best_trial_params.npz`` (JAX names) into
    ``output_dir``, as the JAX package's ``run_sweep`` does.

    Args:
        model_factory: () -> a module of the port's model families; every
            trial of a group starts from the returned module's parameters.
        loader_factory: (batch_size) -> (train_loader, val_loader).
        mesh: a ``parallel.mesh.DataMesh``; every rank calls ``run_sweep``
            with the same arguments, each group's trial axis is split over
            the ranks, and rank 0 alone writes the files and mirrors to
            W&B. Over more than one rank halving is forced to "mask", as the
            JAX package forces it over several processes.
        max_parallel_trials: cap on how many trials train simultaneously in
            one group (bounds the stacked state's and activations' device
            memory); 0 = the whole same-batch-size group at once.
        wandb_mirror: optional WandbSweepMirror; each finished trial is
            mirrored to W&B as its own run (reference sweep semantics).
        resident: cache the decoded dataset on the device ONCE for the whole
            sweep (it is batch-size independent) and run every train/val
            epoch from it (``VmappedTrialGroup.train_epoch_resident``).
            Loaders must not host-augment (build them with augment='none');
            pass ``augment_fn`` to keep augmenting on the device.
        augment_fn: device augmentation (generator, x, y) -> (x, y) of the
            shared stream, in the resident and the per-step epoch (pair with
            non-augmenting loaders either way).
        halving: "compact" (default) or "mask", the JAX package's modes,
            pinned in the journal. One process compacts the group at each
            rung for either (``VmappedTrialGroup.keep``), over ranks it
            masks: the results are the same.
        early_stop_patience: per-trial early stopping — a trial whose val
            loss has not improved for this many consecutive epochs is
            retired (0 = off), as the reference's train_model inside each
            trial (reference: sweep.py:35 -> optimized_train.py:351-356).
            Retired trials stay eligible for best-trial selection — unlike
            halving drops, a plateaued trial can still be the best.
        prefetch: DevicePrefetcher depth for the group's loaders.
        preempt_guard: optional :class:`train.preempt.PreemptionGuard`. When
            a SIGTERM lands, the sweep stops at the next epoch boundary of
            the current trial group, abandons that group (its trials are
            NOT journaled and re-run on resume),
            and returns with ``preempted=True`` and no results file.
        resume: continue a journaled sweep in ``output_dir``. The sweep is
            REPLAYED from ``seed``: sampling reproduces the trial schedule,
            groups whose results are in ``sweep_journal.jsonl`` restore
            without training, the first unjournaled group onward trains
            live. The journal header pins every schedule-determining
            argument and ``fingerprint``; resuming with different ones
            fails loudly. A re-run group reaches the journaled losses on
            the CPU; on the card only under deterministic algorithms
            (``torch.use_deterministic_algorithms``), which cli.sweep turns
            on.
        fingerprint: optional JSON-able dict of RESULT-determining caller
            context (model family, data dir, image size, compute dtype…)
            pinned into the journal header (cli.sweep passes one).
        device: the torch device every group trains on; CUDA (default)
            raises without a card unless "cpu" is passed. A mesh owns the
            choice (``parallel.mesh.run_device``).
    """
    dev = run_device(device, mesh)
    space = space or SearchSpace()
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    world = mesh.world if mesh is not None else 1
    is_host0 = mesh is None or mesh.rank == 0
    if world > 1 and halving == "compact":
        if is_host0:
            print("multi-host sweep: forcing halving='mask' (compact would recompile each rung "
                  "on every host)")
        halving = "mask"
    # one process compacts at every drop; over ranks the slots stay put
    keep_mode = "mask" if world > 1 else "compact"
    if not is_host0:
        wandb_mirror = None

    rungs = hyperband_rungs(min_iter, max_epochs, eta)
    all_trials: list[Trial] = []
    best: Trial | None = None
    preempted = False

    def _should_stop() -> bool:
        """Preemption check at every epoch boundary of a live group and
        between groups. Once True, stays True."""
        nonlocal preempted
        if preempt_guard is None or preempted:
            return preempted
        if preemption_agreed(bool(preempt_guard.triggered), mesh):
            preempted = True
        return preempted

    # ---------------------------------------------------------- journal
    # Every finished trial group appends one line to sweep_journal.jsonl
    # (after the best-params npz, so a journaled group implies its artifacts
    # landed). The header pins every argument that determines the trial
    # schedule, so a resume with drifted flags fails loudly.
    journal_path = os.path.join(output_dir, "sweep_journal.jsonl")
    journal_meta = {
        "n_trials": n_trials, "max_epochs": max_epochs,
        "min_iter": min_iter, "eta": eta, "method": method, "seed": seed,
        "max_parallel_trials": max_parallel_trials, "halving": halving,
        "early_stop_patience": early_stop_patience,
        "space": {"batch_sizes": list(space.batch_sizes),
                  "lr_min": space.lr_min, "lr_max": space.lr_max,
                  "wd_min": space.wd_min, "wd_max": space.wd_max},
        "fingerprint": fingerprint,
    }
    journal_restore: list[list[dict]] = []  # FIFO of finished-group records
    if resume:
        raw = _journal_bytes(journal_path, mesh)
        if raw is None:
            raise FileNotFoundError(f"resume requested but no sweep journal at {journal_path}")
        raw_lines = [ln for ln in raw.decode().splitlines() if ln.strip()]
        lines, valid_raw = [], []
        for i, ln in enumerate(raw_lines):
            try:
                lines.append(json.loads(ln))
                valid_raw.append(ln)
            except json.JSONDecodeError:
                if i == len(raw_lines) - 1:
                    # torn trailing write — what an ungraceful kill
                    # (SIGKILL/OOM) mid-append leaves behind. Drop it: that
                    # group re-runs deterministically. Anything torn EARLIER
                    # is real corruption and must not be papered over.
                    break
                raise ValueError(
                    f"corrupt sweep journal at {journal_path}: line {i + 1} "
                    f"is unparseable but is not the final line")
        if not lines or "meta" not in lines[0]:
            raise ValueError(f"corrupt sweep journal at {journal_path}")
        if len(valid_raw) != len(raw_lines) and is_host0:
            # truncate the torn tail NOW: this run appends the re-run group
            # after it, and a torn line mid-file would read as corruption
            # to the next resume
            with open(journal_path, "w") as f:
                f.write("\n".join(valid_raw) + "\n")
        if lines[0]["meta"] != journal_meta:
            raise ValueError(
                "sweep journal was written with different flags — resume "
                f"must replay the identical schedule.\n  journal: "
                f"{lines[0]['meta']}\n  now:     {journal_meta}")
        journal_restore = [rec["group"] for rec in lines[1:]]
    elif is_host0:
        with open(journal_path, "w") as f:
            f.write(json.dumps({"meta": journal_meta}) + "\n")

    def _restore_group(group_trials: list[Trial], rec: list[dict]) -> None:
        """Adopt a journaled group's results: no training, same appended
        order as the original run (TPE refits see an identical history)."""
        nonlocal best
        by_id = {t.trial_id: t for t in group_trials}
        for r in rec:
            t = by_id[r["trial_id"]]
            if (t.batch_size != r["batch_size"]
                    or not math.isclose(t.lr, r["lr"], rel_tol=1e-12)
                    or not math.isclose(t.wd, r["wd"], rel_tol=1e-12)):
                raise ValueError(
                    f"journaled trial {t.trial_id} hyperparameters do not "
                    "match the replayed sample — the resume run's "
                    "seed/space/flags differ from the original sweep")
            t.val_losses = list(r["val_losses"])
            t.stopped_at = r["stopped_at"]
            t.stop_reason = r["stop_reason"]
            all_trials.append(t)
            # halving-dropped trials stay ineligible for best (provably
            # worse than a survivor when dropped), matching the live path
            if (t.stop_reason != "halving"
                    and any(math.isfinite(v) for v in t.val_losses)
                    and (best is None or t.best_val_loss < best.best_val_loss)):
                # best_trial_params.npz from the original run still holds
                # this trial's weights (journal lines land after the npz)
                best = t

    if wandb_mirror is not None:
        # first-class W&B sweep object (reference: sweep.py:231-235); the
        # grouped-runs fallback inside the mirror covers offline mode
        wandb_mirror.register_sweep(method=method, min_iter=min_iter, eta=eta, space=space)

    # resident caches: decoded once per sweep (per-sample, so shared by
    # every batch size); val batches re-batched per group batch size. Only
    # the CURRENT batch size's re-batched copy is kept — each is a full
    # padded replica of the val set that cache_on_device's capacity gate
    # never accounted for; rebuilding on a batch-size switch is one pad and
    # reshape on the device
    res: dict = {"train": None, "val": None, "val_bs": None, "val_batches": None}

    def resident_data(train_loader, val_loader, bs: int):
        if res["train"] is None:
            budget = None if dev.type == "cuda" else _host_memory_bytes()
            # bf16 models: cache the train INPUTS in the compute dtype; the
            # targets stay float32
            probe = model_factory()
            cache_dtype = (torch.bfloat16 if getattr(probe, "dtype", None) == torch.bfloat16
                           else None)
            res["train"] = cache_on_device(train_loader, dtype=cache_dtype, device=dev,
                                           device_bytes=budget)
            n_val = int(getattr(val_loader, "num_samples", len(val_loader)) or 0)
            if n_val:
                res["val"] = cache_on_device(val_loader, device=dev, device_bytes=budget)
        rd_val = res["val"]
        if rd_val is not None and res["val_bs"] != bs:
            res["val_batches"] = None  # free the old copy before allocating
            res["val_batches"] = batch_val_cache(rd_val, min(bs, rd_val.n))
            res["val_bs"] = bs
        return res["train"], rd_val, res["val_batches"]

    def run_trial_batch(trials: list[Trial]) -> None:
        nonlocal best
        by_bs: dict[int, list[Trial]] = {}
        for t in trials:
            by_bs.setdefault(t.batch_size, []).append(t)
        for bs, bs_trials in sorted(by_bs.items()):
            train_loader, val_loader = loader_factory(bs)
            if int(getattr(val_loader, "num_samples", len(val_loader)) or 0) == 0:
                # a sweep has no per-trial train-loss plumbing for ranking:
                # every trial would be ranked on a constant 0.0
                raise ValueError(
                    "run_sweep: the validation set is empty — trials would "
                    "be ranked on a constant 0.0 val loss. Lower val_split "
                    "or provide more data.")
            chunk = max_parallel_trials if max_parallel_trials > 0 else len(bs_trials)
            for g0 in range(0, len(bs_trials), chunk):
                group_trials = bs_trials[g0: g0 + chunk]
                # resume fast path: the schedule replays deterministically
                # (groups are visited in the same sorted bs/chunk/wave
                # order), so finished groups come from the journal FIFO; a
                # head-of-queue mismatch means the schedule diverged
                if journal_restore:
                    rec = journal_restore.pop(0)
                    if {r["trial_id"] for r in rec} != {t.trial_id for t in group_trials}:
                        raise ValueError(
                            "sweep journal does not match the replayed "
                            "trial schedule — resume flags/seed/data "
                            "differ from the original sweep")
                    _restore_group(group_trials, rec)
                    continue
                if _should_stop():
                    return
                if resident:
                    # built lazily, so a resume whose prefix is fully
                    # journaled never ships the dataset to the device
                    rd_train, rd_val, val_batches = resident_data(train_loader, val_loader, bs)
                group = VmappedTrialGroup(model_factory(), group_trials, mesh=mesh, seed=seed,
                                          augment_fn=augment_fn, prefetch=prefetch,
                                          device=dev)
                if wandb_mirror is not None and wandb_mirror.model_size_mb is None:
                    # one trial's parameters: axis 0 is the trial axis
                    wandb_mirror.model_size_mb = get_model_size_mb(
                        {k: v[0] for k, v in group.params.items()})
                epoch = 0
                # host snapshot of each trial's weights at its BEST epoch —
                # end-of-training weights can be worse than the best loss
                # the results file reports
                best_snap: dict[int, dict] = {}
                # per-trial early stopping: finite-aware best + stale
                # counters, persisted across rungs
                stale: dict[int, int] = {}
                fin_best: dict[int, float] = {}
                retired: list[Trial] = []
                # trials finished within this group, in chronological order
                # (patience/halving drops interleaved, survivors last).
                # Global state (all_trials, W&B mirror, journal) is updated
                # ONLY at group end, so a preemption mid-group abandons the
                # group atomically — resume re-runs it deterministically.
                finished: list[Trial] = []
                for rung_idx, rung in enumerate(rungs):
                    while epoch < rung and group.trials:
                        if _should_stop():
                            return  # abandon this group; journal has the rest
                        if resident:
                            group.train_epoch_resident(rd_train, epoch)
                            val_losses = (group.val_epoch_resident(val_batches, rd_val.n)
                                          if val_batches is not None
                                          else np.zeros(len(group.trials)))
                        else:
                            group.train_epoch(train_loader, epoch)
                            val_losses = group.val_epoch(val_loader)
                        group.step_schedulers(val_losses)
                        for i, (t, v) in enumerate(zip(group.trials, val_losses)):
                            v = float(v)
                            if v < t.best_val_loss:
                                best_snap[t.trial_id] = group.snapshot_of(i)
                            t.val_losses.append(v)
                            if logger is not None:
                                # the scheduler's CURRENT lr: plateau decays show
                                logger.log({f"trial_{t.trial_id}/val_loss": v,
                                            f"trial_{t.trial_id}/lr": group.schedulers[i].lr},
                                           step=epoch)
                        epoch += 1
                        if early_stop_patience > 0:
                            keep_idx = []
                            for i, t in enumerate(group.trials):
                                v = t.val_losses[-1]
                                b = fin_best.get(t.trial_id, float("inf"))
                                if np.isfinite(v) and v < b:
                                    fin_best[t.trial_id] = v
                                    stale[t.trial_id] = 0
                                else:
                                    stale[t.trial_id] = stale.get(t.trial_id, 0) + 1
                                if stale[t.trial_id] < early_stop_patience:
                                    keep_idx.append(i)
                            if len(keep_idx) < len(group.trials):
                                kept = set(keep_idx)
                                for i, t in enumerate(group.trials):
                                    if i in kept:
                                        continue
                                    t.stopped_at = epoch
                                    t.stop_reason = "patience"
                                    retired.append(t)
                                    finished.append(t)
                                group.keep(keep_idx, mode=keep_mode)  # keep([]) is safe
                    if rung_idx < len(rungs) - 1 and len(group.trials) > 1:
                        order = np.argsort([t.best_val_loss for t in group.trials])
                        n_keep = max(1, len(group.trials) // eta)
                        dropped = [group.trials[i] for i in order[n_keep:]]
                        for t in dropped:
                            t.stopped_at = epoch
                            t.stop_reason = "halving"
                            finished.append(t)
                        group.keep([int(i) for i in order[:n_keep]], mode=keep_mode)
                finished.extend(group.trials)
                all_trials.extend(finished)
                if wandb_mirror is not None:
                    # mirrored only at group end: a preempted mid-group run
                    # must not leave half a group's runs a resume duplicates
                    for t in finished:
                        wandb_mirror.mirror_trial(t)
                # patience-retired trials compete for best too: a plateaued
                # trial can hold the group's best loss
                for t in retired + group.trials:
                    snap = best_snap.get(t.trial_id)
                    if snap is None:
                        # every val loss was non-finite (diverged): no usable
                        # weights, it cannot be "best"
                        continue
                    if best is None or t.best_val_loss < best.best_val_loss:
                        best = t
                        if is_host0:  # the snapshots above were the collectives
                            np.savez(os.path.join(output_dir, "best_trial_params.npz"),
                                     **flatten_tree(snap))
                # journaled AFTER the npz write: a journaled group's
                # artifacts are on disk, so resume never points "best" at
                # weights that were never saved
                if is_host0:
                    with open(journal_path, "a") as f:
                        f.write(json.dumps({"group": [
                            {"trial_id": t.trial_id, "batch_size": t.batch_size, "lr": t.lr,
                             "wd": t.wd, "val_losses": t.val_losses,
                             "stopped_at": t.stopped_at, "stop_reason": t.stop_reason}
                            for t in finished]}) + "\n")

    if method == "tpe":
        # multi-wave TPE: an exploratory random wave builds the history the
        # good/bad density split needs; every later wave RE-FITS the
        # densities on all trials run so far (completed and halving-dropped)
        wave = min(n_trials, max(4, n_trials // 4))
        run_trial_batch(sample_random(rng, wave, space))
        while not preempted and len(all_trials) < n_trials:
            k = min(wave, n_trials - len(all_trials))
            run_trial_batch(sample_tpe(rng, k, space, all_trials))
    else:
        run_trial_batch(sample_random(rng, n_trials, space))

    result = {
        "best": _trial_dict(best),
        "trials": [_trial_dict(t) for t in sorted(all_trials, key=lambda t: t.trial_id)],
        "preempted": preempted,
    }
    # a preempted sweep writes NO results file: sweep_results.json means
    # "the sweep ran to completion" to every consumer (the lifecycle); the
    # journal holds the partial state
    if is_host0 and not preempted:
        with open(os.path.join(output_dir, "sweep_results.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def run_sweep_from_config(model_factory, loader_factory, cfg, *, mesh=None,
                          output_dir: str = "./sweep_out", logger=None,
                          method: str = "tpe",
                          wandb_mirror: WandbSweepMirror | None = None,
                          resident: bool = False, augment_fn=None,
                          halving: str = "compact", preempt_guard=None,
                          resume: bool = False, fingerprint: dict | None = None,
                          device=None) -> dict:
    """Run a sweep driven by a :class:`utils.config.SweepConfig`."""
    space = SearchSpace(batch_sizes=tuple(cfg.batch_sizes), lr_min=cfg.lr_min,
                        lr_max=cfg.lr_max, wd_min=cfg.wd_min, wd_max=cfg.wd_max)
    return run_sweep(
        model_factory, loader_factory, n_trials=cfg.sweep_count,
        max_epochs=cfg.max_epochs, min_iter=cfg.hyperband_min_iter,
        eta=cfg.eta, method=method, seed=cfg.seed, mesh=mesh,
        output_dir=output_dir, space=space, logger=logger,
        max_parallel_trials=cfg.parallel_trials, wandb_mirror=wandb_mirror,
        resident=resident, augment_fn=augment_fn, halving=halving,
        early_stop_patience=cfg.early_stop_patience,
        preempt_guard=preempt_guard, resume=resume, fingerprint=fingerprint,
        device=device,
    )


def sweep_server_config(method: str, min_iter: int, eta: int, space: SearchSpace) -> dict:
    """The W&B sweep-server config both the mirror and the online agent mode
    register, built in one place so the server always sees the same search
    space as the local samplers (reference: sweep.py:41-94)."""
    return {
        # W&B only knows bayes/grid/random; TPE is a Bayesian method, so it
        # maps to 'bayes' like the reference's (:44)
        "method": "bayes" if method in ("tpe", "wandb") else method,
        "metric": {"name": "val_loss", "goal": "minimize"},
        "early_terminate": {"type": "hyperband", "min_iter": min_iter, "eta": eta},
        "parameters": {
            "batch_size": {"values": list(space.batch_sizes)},
            "learning_rate": {"distribution": "log_uniform_values",
                              "min": space.lr_min, "max": space.lr_max},
            "weight_decay": {"distribution": "log_uniform_values",
                             "min": space.wd_min, "max": space.wd_max},
        },
    }


def run_wandb_agent_sweep(model_factory, loader_factory, *,
                          n_trials: int = 20, max_epochs: int = 50,
                          min_iter: int = 10, eta: int = 3, seed: int = 42,
                          mesh=None, output_dir: str = "./sweep_out",
                          space: SearchSpace | None = None, logger=None,
                          project: str | None = None,
                          entity: str | None = None,
                          early_stop_patience: int = 0, prefetch: int = 2,
                          sweep_id: str | None = None,
                          wandb_module=None, device=None) -> dict:
    """ONLINE controller mode: the W&B *server* proposes every trial's
    hyperparameters and owns early termination — the reference's sweep
    semantics (reference: sweep.py:94-241: ``wandb.agent`` pulls
    server-side Bayes proposals, Hyperband stops runs server-side, state
    persists on the server so agents can rejoin by sweep id).

    Server proposals arrive ONE AT A TIME, so trials run sequentially, each
    a group of one. Offline or unauthenticated, ``wandb.sweep``/
    ``wandb.agent`` raise and the CLI exits with a pointer at ``--method
    tpe``. ``sweep_id``: attach to an EXISTING server-side sweep instead of
    registering a new one (reference: sweep.py:241). ``wandb_module``:
    injection point for tests; default imports wandb.

    ``mesh``: a ``parallel.mesh.DataMesh``. Rank 0 alone talks to W&B: it
    runs the agent and broadcasts each proposal (its JSON) and each
    server-side stop to the other ranks, which train the same group of one,
    padded to the world as the JAX group pads it, and end on an empty
    proposal. Rank 0 alone writes the files."""
    dev = run_device(device, mesh)
    world = mesh.world if mesh is not None else 1
    is_host0 = mesh is None or mesh.rank == 0
    space = space or SearchSpace()
    os.makedirs(output_dir, exist_ok=True)
    if is_host0:
        wandb = wandb_module
        if wandb is None:
            import wandb  # noqa: F811 — ImportError surfaces to the CLI
        if sweep_id is None:
            sweep_id = wandb.sweep(sweep_server_config("wandb", min_iter, eta, space),
                                   project=project, entity=entity)
    if world > 1:
        sweep_id = broadcast_bytes(sweep_id.encode() if is_host0 else None, mesh).decode()

    trials: list[Trial] = []
    best: Trial | None = None

    def agreed(flag: bool) -> bool:
        """Rank 0's decision on every rank."""
        if world == 1:
            return flag
        return broadcast_bytes(b"1" if is_host0 and flag else b"0", mesh) == b"1"

    def train_one(c: dict, run) -> None:
        """One proposal's trial; ``run`` is rank 0's W&B run (None elsewhere)."""
        nonlocal best
        t = Trial(trial_id=len(trials), batch_size=int(c["batch_size"]),
                  lr=float(c["learning_rate"]), wd=float(c["weight_decay"]))
        train_loader, val_loader = loader_factory(t.batch_size)
        if not int(getattr(val_loader, "num_samples", len(val_loader)) or 0):
            # same refusal as run_sweep: the server would rank every run on
            # a constant 0.0 val loss
            raise ValueError(
                "run_wandb_agent_sweep: the validation set is empty — "
                "trials would be ranked on a constant 0.0 val loss. "
                "Lower val_split or provide more data.")
        group = VmappedTrialGroup(model_factory(), [t], mesh=mesh, seed=seed, prefetch=prefetch,
                                  device=dev)
        best_snap = None
        stale, fin_best = 0, float("inf")
        for epoch in range(max_epochs):
            group.train_epoch(train_loader, epoch)
            v = float(group.val_epoch(val_loader)[0])
            group.step_schedulers(np.asarray([v]))
            if np.isfinite(v) and v < t.best_val_loss:
                best_snap = group.snapshot_of(0)
            t.val_losses.append(v)
            if run is not None:
                run.log({"val_loss": v}, step=epoch)
            if logger is not None:
                logger.log({f"trial_{t.trial_id}/val_loss": v,
                            f"trial_{t.trial_id}/lr": group.schedulers[0].lr}, step=epoch)
            # server-side Hyperband: the agent exposes the stop decision on
            # the run (best-effort — older SDKs lack it, and then only the
            # local patience below terminates early)
            should_stop = getattr(run, "should_stop", None)
            if agreed(callable(should_stop) and should_stop()):
                t.stopped_at = epoch + 1
                t.stop_reason = "server"
                break
            if early_stop_patience > 0:
                if np.isfinite(v) and v < fin_best:
                    fin_best, stale = v, 0
                else:
                    stale += 1
                if stale >= early_stop_patience:
                    t.stopped_at = epoch + 1
                    t.stop_reason = "patience"
                    break
        if run is not None:
            run.summary["best_val_loss"] = t.best_val_loss
            if t.stopped_at is not None:
                run.summary["stopped_at_epoch"] = t.stopped_at
                run.summary["stop_reason"] = t.stop_reason
            run.finish()
        trials.append(t)
        if best_snap is not None and (best is None or t.best_val_loss < best.best_val_loss):
            best = t
            if is_host0:
                np.savez(os.path.join(output_dir, "best_trial_params.npz"),
                         **flatten_tree(best_snap))

    def agent_trial() -> None:
        """The agent's callback on rank 0: the SERVER's proposal for this
        trial, sent to the other ranks, then trained."""
        run = wandb.init()
        c = {k: run.config[k] for k in ("batch_size", "learning_rate", "weight_decay")}
        if world > 1:
            broadcast_bytes(json.dumps(c).encode(), mesh)
        train_one(c, run)

    if is_host0:
        wandb.agent(sweep_id, function=agent_trial, count=n_trials)
        if world > 1:
            broadcast_bytes(b"", mesh)  # no more proposals
    else:
        while proposal := broadcast_bytes(None, mesh):
            train_one(json.loads(proposal), None)

    result = {
        "best": _trial_dict(best),
        "trials": [_trial_dict(t) for t in trials],
        "preempted": False,
        "sweep_id": sweep_id,
    }
    if is_host0:
        with open(os.path.join(output_dir, "sweep_results.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def _trial_dict(t: Trial | None) -> dict | None:
    if t is None:
        return None
    return {
        "trial_id": t.trial_id,
        "batch_size": t.batch_size,
        "lr": t.lr,
        "wd": t.wd,
        "best_val_loss": t.best_val_loss,
        "epochs_run": len(t.val_losses),
        "stopped_at": t.stopped_at,
        "stop_reason": t.stop_reason,
    }
