"""Preemption-safe training.

Counterpart of ``image_enhancement_deglaring_tpu.train.preempt``: SIGTERM
or SIGINT sets a flag instead of killing the process; the train loop
checks it after every step, writes a mid-epoch checkpoint with the exact
step position (``epoch_step``), and returns, so ``resume_from`` that
checkpoint continues as if nothing had happened. Over several processes
the signal may reach one rank only, so the loop asks
:func:`preemption_agreed` at epoch (and resident segment) boundaries,
where every rank arrives in lock step.
"""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that set ``triggered`` instead of
    killing the process; restores the previous handlers on exit.

    Installation only succeeds in the main thread (``signal.signal``
    raises elsewhere); the guard then stays inert. A second SIGINT while
    already triggered raises ``KeyboardInterrupt``."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, signals=SIGNALS):
        self._signals = signals
        self._prev: dict = {}
        self.triggered = False
        # set by the train loop when it writes the preemption checkpoint: a
        # signal can land where none follows (the early-stopping epoch's
        # teardown), so callers check this, not ``triggered``
        self.preempt_checkpoint: str | None = None

    def _handle(self, signum, frame):
        if self.triggered and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.triggered = True

    def __enter__(self):
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
        except ValueError:  # not the main thread: stay inert
            for s, h in self._prev.items():
                signal.signal(s, h)
            self._prev.clear()
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False


def preemption_agreed(local: bool, mesh=None) -> bool:
    """True on every rank if any rank saw a signal: a MAX all-reduce of the
    local flags over ``mesh`` (by default the process group's mesh). One
    process: its own flag. A collective: every rank must call it at the
    same point."""
    from ..parallel.distributed import process_count

    if process_count() == 1:
        return bool(local)
    from ..parallel.mesh import all_reduce_max, make_mesh

    return all_reduce_max(1.0 if local else 0.0, mesh or make_mesh()) > 0.0
