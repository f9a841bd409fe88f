"""The voxel-grid layer on torch.distributed: device mesh, sharded and
time-sharded grid fits, resumable grid sweeps.

Counterpart of llckbdm_tpu/parallel/: data-parallel row partitioning of
MRSI voxel batches across GPUs, the amplitude-RHS exchange of the
time-sharded refinement, and resumable pod-scale sweeps (BASELINE.json:5).
"""
from .mesh import auto_mesh, make_mesh, distributed_init
from .grid import (fit_and_refine_grid, fit_grid, fit_grid_sharded,
                   refine_grid, refine_grid_timesharded)
from .checkpoint import GridRunner, shard_manifest

__all__ = [
    "auto_mesh", "make_mesh", "distributed_init",
    "fit_grid", "refine_grid", "fit_grid_sharded", "refine_grid_timesharded",
    "fit_and_refine_grid", "GridRunner", "shard_manifest",
]
