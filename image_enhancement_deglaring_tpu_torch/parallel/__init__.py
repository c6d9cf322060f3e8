"""Data parallelism and hyperparameter sweeps.

- ``parallel.mesh``: the 1-D data mesh over the ranks of a
  ``torch.distributed`` group (one process per device) and its
  collectives;
- ``parallel.distributed``: joining the group (``initialize``), the
  per-rank loader slice, and ``launch_local`` for N ranks from one command;
- ``parallel.sweep``: hyperparameter sweeps on one card (the trial axis
  over several cards is ROADMAP Queue 1 item 13b).
"""

from .mesh import batch_sharding, make_mesh, replicate, replicated_sharding, shard_batch
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
    "make_mesh",
    "replicate",
    "shard_batch",
    "batch_sharding",
    "replicated_sharding",
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
