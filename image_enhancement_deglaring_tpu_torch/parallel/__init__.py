"""Data parallelism, the serving mesh and hyperparameter sweeps.

- ``parallel.mesh``: the 1-D data mesh over the ranks of a
  ``torch.distributed`` group (one process per device) and its
  collectives, and the serving mesh (``LocalMesh``: the local cards of
  one process, one model replica each);
- ``parallel.distributed``: joining the group (``initialize``), the
  per-rank loader slice, and ``launch_local`` for N ranks from one command;
- ``parallel.sweep``: hyperparameter sweeps, the trial axis of a group
  split over the ranks of a data mesh.
"""

from .mesh import LocalMesh, batch_sharding, make_local_mesh, make_mesh, replicate
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
    "LocalMesh",
    "make_local_mesh",
    "make_mesh",
    "replicate",
    "batch_sharding",
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
