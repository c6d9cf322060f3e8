"""Faults planted inside a model's forward on the timed path, for the
tests and the readings that show ``correct`` turns false where a serving
cell's model computes something else: ``unnormalised`` runs Restormer's
channel attention without the L2 normalisation of q and k over the pixels
(``softmax(q k^T * temperature)`` on the raw products), and
``wrong_axis`` takes its softmax over the query's axis instead of the
key's. The fault is in place only while the engine's step launches.

    from perfbench import harness, model_faults
    harness.run_cell(root, cell, ..., run_class=model_faults.run_class("unnormalised"))
"""

from __future__ import annotations

import torch

from .harness import Run

FAULTS = ("unnormalised", "wrong_axis")


def _attention(fault: str):
    def attention(q, k, v, temperature, heads, *, eps=1e-12):
        n, h, w, c = q.shape
        ch = c // heads
        q2, k2, v2 = (t.reshape(n, h * w, c) for t in (q, k, v))
        parts = [slice(i * ch, (i + 1) * ch) for i in range(heads)]
        gram = torch.stack([torch.bmm(q2[:, :, s].transpose(1, 2), k2[:, :, s])
                            for s in parts], 1).float()
        if fault != "unnormalised":
            nq = torch.linalg.vector_norm(q2, dim=1, dtype=torch.float32).clamp_min(eps)
            nk = torch.linalg.vector_norm(k2, dim=1, dtype=torch.float32).clamp_min(eps)
            gram = gram / (nq.reshape(n, heads, ch, 1) * nk.reshape(n, heads, 1, ch))
        logits = gram * temperature.float().reshape(1, heads, 1, 1)
        attn = torch.softmax(logits, dim=-2 if fault == "wrong_axis" else -1).to(v.dtype)
        outs = [torch.bmm(v2[:, :, s], attn[:, i].transpose(1, 2)) for i, s in enumerate(parts)]
        return (outs[0] if heads == 1 else torch.cat(outs, dim=-1)).reshape(n, h, w, c)
    return attention


class ModelFaultRun(Run):
    fault: str | None = None

    def patch_engine(self, engine):
        from image_enhancement_deglaring_tpu_torch.models import restormer

        step, broken = engine._step, _attention(self.fault)

        def faulty(batch):
            sound = restormer.transposed_attention
            restormer.transposed_attention = broken
            try:
                return step(batch)
            finally:
                restormer.transposed_attention = sound
        engine._step = faulty


def run_class(fault: str):
    """A :class:`harness.Run` with ``fault`` planted in the served model."""
    if fault not in FAULTS:
        raise ValueError(f"unknown model fault {fault!r}; known: {FAULTS}")
    return type(f"ModelFaultRun_{fault}", (ModelFaultRun,), {"fault": fault})
