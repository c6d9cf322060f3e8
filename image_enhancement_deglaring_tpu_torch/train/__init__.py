"""The port's trainer: step, loop, LR control, checkpoints, preemption."""

from .checkpoint import restore_checkpoint, restore_params, save_checkpoint
from .loop import (
    ClippedAdamW,
    TrainState,
    clip_grad_norm_,
    make_optimizer,
    make_train_step,
    make_val_step,
    set_learning_rate,
    train_model,
)
from .lr_control import ReduceLROnPlateau
from .preempt import PreemptionGuard
