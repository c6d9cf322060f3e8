"""Faults planted under the timed path, for the tests and the readings
that show ``correct`` turns false: an answer altered where it is produced
(``rolled``: each answer of a bucket handed to the request beside it),
half of the batch left out (``half``: serving answers the second half of
a bucket blank; training steps on half of each planned batch, the loss
the mean of the rest), and a step that leaves its state unchanged
(``frozen``: AdamW's update skipped)."""

from __future__ import annotations

import torch

from .harness import Run

SERVING = ("rolled", "half")
TRAINING = ("frozen", "half")


class FaultyRun(Run):
    fault: str | None = None

    def patch_engine(self, engine):
        step = engine._step
        if self.fault == "rolled":
            engine._step = lambda batch: tuple(torch.roll(y, 1, 0) for y in step(batch))
        elif self.fault == "half":
            def half(batch):
                h = max(1, batch.shape[0] // 2)
                return tuple(torch.cat([y[:h], torch.zeros_like(y[h:])]) for y in step(batch))
            engine._step = half

    def patch_segment(self, segment, state):
        if self.fault == "frozen":
            state.optimizer.step = lambda *a, **k: None
        elif self.fault == "half":
            return lambda st, x, y, idx: segment(st, x, y, idx[:, : max(1, idx.shape[1] // 2)])
        return segment


def run_class(fault: str):
    """A :class:`harness.Run` with ``fault`` planted."""
    return type(f"FaultyRun_{fault}", (FaultyRun,), {"fault": fault})
