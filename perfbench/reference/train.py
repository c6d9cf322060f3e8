"""The first training steps, in plain PyTorch: the batch plan, device
augmentation, the forward, L1, backward, the global-norm clip and AdamW.

The draws follow the trainer's stream: the epoch's plan is a
``torch.randperm`` from a device generator seeded from (seed, epoch), and
each step draws its augmentation (flip, pixel op, which op, alpha, beta,
noise variance, then the noise) and then the model's dropout masks from
one device generator, in that order.
"""

from __future__ import annotations

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def plan(seed: int, epoch: int, n: int, batch: int, device) -> torch.Tensor:
    """(steps, batch) rows of the epoch: a permutation of ``[0, n)``."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(state >> np.uint64(1)))
    perm = torch.randperm(n, generator=gen, device=device)
    steps = n // batch
    return perm[:steps * batch].reshape(steps, batch)


def augment(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor):
    """(B, H, W, 1) float32 images and targets in [0, 1]: a horizontal flip
    of both (p .5), then on the image alone (p .5) brightness/contrast
    (p .8; x * U(.8, 1.2) + U(-.2, .2)) or Gaussian noise of variance
    U(10, 50) / 255^2, clipped to [0, 1]."""
    b, dev = x.shape[0], x.device

    def draw(*shape, normal=False):
        fn = torch.randn if normal else torch.rand
        return fn(*shape, generator=gen, device=dev, dtype=torch.float32)

    col = lambda v: v[:, None, None, None]  # noqa: E731
    flip, pixel, pick_bc = col(draw(b) < 0.5), col(draw(b) < 0.5), col(draw(b) < 0.8)
    alpha = col(1.0 + (draw(b) * 0.4 - 0.2))
    beta = col(draw(b) * 0.4 - 0.2)
    var = col((10.0 + 40.0 * draw(b)) / 255.0 ** 2)
    noise = draw(*x.shape, normal=True) * torch.sqrt(var)
    x = torch.where(flip, x.flip(2), x)
    y = torch.where(flip, y.flip(2), y)
    changed = torch.where(pick_bc, (x * alpha + beta).clamp(0.0, 1.0), (x + noise).clamp(0.0, 1.0))
    return torch.where(pixel, changed, x), y


def clip_(grads: list, max_norm: float) -> torch.Tensor:
    """optax's clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm reaches max_norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


def adamw_(params: list, grads: list, moments: list, step: int, lr: float, wd: float):
    """One decoupled AdamW update in place (torch's form)."""
    b1, b2 = BETAS
    for p, g, (m, v) in zip(params, grads, moments):
        p.mul_(1.0 - lr * wd)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).add_(g * g, alpha=1.0 - b2)
        denom = (v / (1.0 - b2 ** step)).sqrt() + EPS
        p.sub_(lr / (1.0 - b1 ** step) * m / denom)


def first_steps(forward, params: dict, x_u8: torch.Tensor, y_u8: torch.Tensor,
                rows: torch.Tensor, gen: torch.Generator, *, lr: float, wd: float,
                clip: float, stateful: bool, input_dtype=torch.float32) -> dict:
    """Train ``params`` (name -> float32 tensor, copied) on the batches
    ``rows`` of the uint8 (N, H, W) pages, the inputs held in
    ``input_dtype`` as the resident cache holds them (the targets in
    float32); ``forward(p, x_nchw, generator)`` is the model. Returns each step's loss, the first clipped gradient and
    every leaf's norm of it, and every leaf's norm of its change over all
    the steps."""
    names = sorted(params)
    p = {k: params[k].detach().clone().float().requires_grad_(True) for k in names}
    start = {k: v.detach().clone() for k, v in p.items()}
    moments = [(torch.zeros_like(p[k]), torch.zeros_like(p[k])) for k in names]
    losses, first_grad = [], None
    for step, idx in enumerate(rows, start=1):
        x = (x_u8.index_select(0, idx).float()[..., None] / 255.0).to(input_dtype).float()
        y = y_u8.index_select(0, idx).float()[..., None] / 255.0
        x, y = augment(gen, x, y)
        out = forward(p, x.permute(0, 3, 1, 2), gen if stateful else None)
        loss = (out - y.permute(0, 3, 1, 2)).abs().mean()
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        grads = [g.detach().clone() for g in grads]
        if clip > 0:
            clip_(grads, clip)
        if first_grad is None:
            first_grad = dict(zip(names, grads))
        with torch.no_grad():
            adamw_([p[k] for k in names], grads, moments, step, lr, wd)
        losses.append(float(loss.detach()))
    change = {k: float((p[k].detach() - start[k]).norm()) for k in names}
    return {"losses": losses, "grads": first_grad,
            "grad_norms": {k: float(g.norm()) for k, g in first_grad.items()},
            "change_norms": change}
