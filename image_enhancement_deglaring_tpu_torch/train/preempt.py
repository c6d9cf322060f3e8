"""Preemption-safe training, single process.

Counterpart of ``image_enhancement_deglaring_tpu.train.preempt``: SIGTERM
or SIGINT sets a flag instead of killing the process; the train loop
checks it after every step, writes a mid-epoch checkpoint with the exact
step position (``epoch_step``), and returns, so ``resume_from`` that
checkpoint continues as if nothing had happened. The host-uniform
decision of a multi-process run comes with the port's multi-GPU part.
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


def preemption_agreed(local: bool) -> bool:
    """The preemption decision of all processes. One process: its own flag."""
    return local
