"""Hyperparameter sweeps on one card (``parallel.sweep``). The JAX
package's ``parallel`` also holds the device mesh and the multi-process
runtime; those come with ROADMAP Queue 1 item 13."""

from .sweep import (
    SearchSpace,
    Trial,
    VmappedTrialGroup,
    WandbSweepMirror,
    hyperband_rungs,
    run_sweep,
    run_sweep_from_config,
    run_wandb_agent_sweep,
    sample_random,
    sample_tpe,
    sweep_server_config,
)

__all__ = [
    "SearchSpace",
    "Trial",
    "VmappedTrialGroup",
    "WandbSweepMirror",
    "hyperband_rungs",
    "run_sweep",
    "run_sweep_from_config",
    "run_wandb_agent_sweep",
    "sample_random",
    "sample_tpe",
    "sweep_server_config",
]
