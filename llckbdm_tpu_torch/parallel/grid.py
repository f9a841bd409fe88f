"""Voxel-grid fitting on torch.distributed (BASELINE configs 4-5).

Counterpart of llckbdm_tpu/parallel/grid.py, on a mesh from
:func:`parallel.mesh.make_mesh` with one rank per device:

* :func:`fit_grid`, :func:`refine_grid` — the local calls (config 4 on one
  device).
* :func:`fit_grid_sharded` — this rank fits its contiguous 'data' row block
  on its own device, with zero collectives.  Config 5's 256x256 grid path.
* :func:`refine_grid_timesharded` — the Gauss-Newton refinement with the
  signal's time axis also split over 'time': one all-reduce of the normal
  matrix and the right-hand side per step (solver.refine's sharded mode).
* :func:`fit_and_refine_grid` — the two chained.

The JAX package returns sharded global arrays; here each rank keeps its
rows, as the sharded arrays did, and each sharded call returns them with
their global ``(start, stop)``.  The signals go in whole, as a host array
(or tensor), and each rank copies its block to its device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..pipeline.llckbdm import LlcKbdmConfig, llc_kbdm_fit
from ..signals import LineList
from ..solver.refine import RefineConfig, RefinedLines, refine_lines


def fit_grid(c: torch.Tensor, dwell: float, cfg: LlcKbdmConfig):
    """LL-KBDM over a voxel batch c (..., N) complex64 on its device."""
    return llc_kbdm_fit(c, dwell, cfg)


def refine_grid(c: torch.Tensor, lines: LineList, dwell: float,
                cfg: RefineConfig = RefineConfig()) -> RefinedLines:
    """Gauss-Newton refinement over a voxel batch on its device (the
    gate-meeting stage; used per shard by parallel.checkpoint when the
    runner is given a RefineConfig)."""
    return refine_lines(c, lines, dwell, cfg)


def _axis(mesh: DeviceMesh, name: str) -> tuple[int, int]:
    """(size, this rank's index) along the named mesh axis."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(dim)


def _device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current CUDA device on a 'cuda' mesh, else
    the mesh's device type.  What binds the card is
    :func:`parallel.mesh.distributed_init`, which makes the rank's
    ``cuda:<local index>`` the current device (and NCCL's ``device_id``)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _row_block(v: int, mesh: DeviceMesh) -> tuple[int, int]:
    ndata, i = _axis(mesh, "data")
    if v % ndata:
        raise ValueError(f"voxel count {v} not divisible by data={ndata}")
    rows = v // ndata
    return i * rows, (i + 1) * rows


def _time_block(n: int, mesh: DeviceMesh) -> tuple[int, int]:
    ntime, i = _axis(mesh, "time")
    if n % ntime:
        raise ValueError(f"signal length {n} not divisible by time={ntime}")
    chunk = n // ntime
    return i * chunk, (i + 1) * chunk


def fit_grid_sharded(c, dwell: float, cfg: LlcKbdmConfig, mesh: DeviceMesh):
    """LL-KBDM over this rank's block of a (V, N) voxel batch.

    c : (V, N) complex signals (numpy or tensor), the whole grid; V must be
        divisible by the 'data' axis size.  Ranks that differ only along
        'time' fit the same rows.
    Returns ((consolidated, pooled, counts, stats), (start, stop)): this
    rank's rows [start, stop) of the grid, on its device.
    """
    start, stop = _row_block(c.shape[0], mesh)
    c_loc = torch.as_tensor(c[start:stop]).to(_device(mesh), torch.complex64)
    return fit_grid(c_loc, dwell, cfg), (start, stop)


def refine_grid_timesharded(c, lines: LineList, dwell: float,
                            mesh: DeviceMesh,
                            cfg: RefineConfig = RefineConfig()):
    """Refine this rank's voxel rows with the time axis split over
    mesh['time'] and the voxels over mesh['data'].

    c     : (V, N) complex signals (numpy or tensor; pass the float64 data),
            the whole grid; N divisible by the 'time' axis size.
    lines : LineList (V / data, C) initial values of this rank's rows (e.g.
            fit_grid_sharded's output), bitwise equal on the ranks of a
            'time' group.
    Returns (RefinedLines (V / data, C), (start, stop)), equal on the ranks
    of a 'time' group.
    """
    v, n = c.shape
    t0, t1 = _time_block(n, mesh)
    start, stop = _row_block(v, mesh)
    if lines.mask.shape[0] != stop - start:
        raise ValueError(f"lines hold {lines.mask.shape[0]} rows, this "
                         f"rank's block [{start}, {stop}) has {stop - start}")
    dev = _device(mesh)
    c_loc = torch.as_tensor(c[start:stop, t0:t1]).to(dev, torch.complex128)
    lines = LineList(*(x.to(dev) for x in lines))
    refined = refine_lines(c_loc, lines, dwell, cfg,
                           group=mesh.get_group("time"), t_offset=t0)
    return refined, (start, stop)


def fit_and_refine_grid(c_np: np.ndarray, dwell: float, cfg: LlcKbdmConfig,
                        mesh: DeviceMesh,
                        refine_cfg: RefineConfig = RefineConfig()):
    """Full config-5 step: sharded LL-KBDM fit + time-sharded refinement.

    c_np : (V, N) complex128 host array of voxel signals.
    Every consolidated slot is refined: the (2C, 2C) normal equations go to
    the chol_solve kernel on a GPU, which takes 2C <= 64, so C <= 32 there.
    The first rank of each 'time' group fits the group's rows and broadcasts
    the consolidated lines and counts over the group, so that every rank
    refines from the same bits.
    Returns ((refined: RefinedLines (V / data, C), counts (V / data, C)),
    (start, stop)).
    """
    v, n = c_np.shape
    start, stop = _row_block(v, mesh)
    _time_block(n, mesh)                         # fail before the fit
    _, ti = _axis(mesh, "time")
    group = mesh.get_group("time")
    if ti == 0:
        (cons, _pooled, counts, _stats), _ = fit_grid_sharded(c_np, dwell,
                                                              cfg, mesh)
        buf = torch.stack([*cons, counts.to(torch.float32)])
    else:
        buf = torch.empty((6, stop - start, cfg.max_clusters),
                          dtype=torch.float32, device=_device(mesh))
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    refined, rows = refine_grid_timesharded(c_np, LineList(*buf[:5]), dwell,
                                            mesh, refine_cfg)
    return (refined, buf[5].to(torch.int64)), rows
