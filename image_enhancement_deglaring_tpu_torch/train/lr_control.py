"""Host-side LR controller: ReduceLROnPlateau with torch's semantics.

Counterpart of ``image_enhancement_deglaring_tpu.train.lr_control``:
mode 'min', threshold 1e-4 in 'rel' mode (an improvement is ``metric <
best * (1 - 1e-4)``), cooldown 0, min_lr 0. The train loop feeds it the
epoch's validation loss and writes the LR it returns into the optimizer's
``param_groups``, so a reduction rebuilds nothing.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, init_lr: float, *, factor: float = 0.5, patience: int = 5,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Feed the epoch's val loss; returns the (possibly reduced) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
