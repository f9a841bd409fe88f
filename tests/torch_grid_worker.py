"""Rank bodies for the port's multi-process grid tests (not a test module).

Spawned with ``torch.multiprocessing`` by tests/test_torch_parallel.py,
tests/test_torch_checkpoint.py and tests/test_torch_cuda.py.  Imports torch
and numpy only, never JAX, so a child process costs one torch import.  Each
body writes what it computed to ``out_dir/rank{r}.npz``; the parent checks.
Ranks meet by ``file://`` rendezvous in the test's own directory, so tests
running side by side under pytest-xdist never share a port.
"""
from __future__ import annotations

import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def start(fn, nprocs: int, *args):
    """Start fn(rank, *args) in nprocs spawned processes."""
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def join(ctx, timeout: float) -> None:
    """Wait for every rank: a failed rank raises (and the others are
    killed); ranks still running after `timeout` seconds are killed and
    TimeoutError is raised."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


def load(out_dir, nprocs: int) -> list[dict]:
    """What each rank saved, by rank."""
    return [dict(np.load(pathlib.Path(out_dir) / f"rank{r}.npz"))
            for r in range(nprocs)]


def _save(out_dir, rank: int, **arrays) -> None:
    path = pathlib.Path(out_dir) / f"rank{rank}.npz"
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)


def _error(fn) -> str:
    """The message of the ValueError fn raises ('' if it raises none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _refined(prefix: str, refined) -> dict:
    return {f"{prefix}_z": refined.z.cpu().numpy(),
            f"{prefix}_d": refined.d.cpu().numpy(),
            f"{prefix}_mask": refined.mask.cpu().numpy(),
            f"{prefix}_gn_step": refined.gn_step.cpu().numpy()}


def grid_ranks(rank: int, world: int, rdv: str, out_dir: str, device: str,
               axes: dict, sigs: np.ndarray, lines: tuple, dwell: float,
               cfg, rcfg) -> None:
    """One rank of the mesh ``axes``: the error cases, the time-sharded
    refinement of ``lines`` (the whole grid's initial LineList as numpy
    arrays), fit_grid_sharded, and fit_and_refine_grid, each saved with this
    rank's rows."""
    from llckbdm_tpu_torch.ops import _build
    from llckbdm_tpu_torch.parallel import (auto_mesh, distributed_init,
                                            fit_and_refine_grid,
                                            fit_grid_sharded, make_mesh,
                                            refine_grid_timesharded)
    from llckbdm_tpu_torch.signals import LineList

    torch.set_num_threads(1)
    distributed_init(f"file://{rdv}", world, rank, backend="gloo",
                     device=device)
    try:
        mesh = make_mesh(axes, device.split(":")[0])
        dev = torch.device(device)
        out = {
            "err_mesh_too_big": _error(
                lambda: make_mesh({"data": 2 * world}, "cpu")),
            "err_auto_mesh": _error(
                lambda: auto_mesh(world + 1, device_type="cpu")),
            "err_fit_v": _error(
                lambda: fit_grid_sharded(sigs[:-1], dwell, cfg, mesh)),
            "err_chain_n": _error(
                lambda: fit_and_refine_grid(sigs[:, :-1], dwell, cfg, mesh,
                                            rcfg)),
        }
        v = sigs.shape[0]
        ndata = axes["data"]
        rows = v // ndata
        i = mesh.get_local_rank("data")
        block = LineList(*(torch.as_tensor(x[i * rows:(i + 1) * rows])
                           .to(dev) for x in lines))
        out["err_refine_n"] = _error(
            lambda: refine_grid_timesharded(sigs[:, :-1], block, dwell, mesh,
                                            rcfg))

        _build.reset_counts()
        refined, (start, stop) = refine_grid_timesharded(sigs, block, dwell,
                                                         mesh, rcfg)
        out.update(_refined("ts", refined), rows=np.array([start, stop]),
                   ts_gn_normal=np.array(_build.LAUNCHES["gn_normal"]),
                   ts_gn_normal_plain=np.array(
                       _build.PLAIN_ON_CUDA["gn_normal"]))

        (cons, _pooled, counts, _stats), _ = fit_grid_sharded(sigs, dwell,
                                                              cfg, mesh)
        out.update({f"fit_{k}": x.cpu().numpy()
                    for k, x in zip(LineList._fields, cons)},
                   fit_counts=counts.cpu().numpy())

        (refined, counts), _ = fit_and_refine_grid(sigs, dwell, cfg, mesh,
                                                   rcfg)
        out.update(_refined("chain", refined),
                   chain_counts=counts.cpu().numpy())
        _save(out_dir, rank, **out)
    finally:
        dist.destroy_process_group()


def runner_ranks(rank: int, world: int, grid_dir: str, out_dir: str,
                 device: str, sigs: np.ndarray, dwell: float, cfg,
                 shard_size: int, rcfg) -> None:
    """One process of a GridRunner sweep shared by ``world`` processes over
    one grid_dir (no process group: the files are the only shared state);
    saves the number of shards it computed."""
    from llckbdm_tpu_torch.parallel import GridRunner

    torch.set_num_threads(1)
    runner = GridRunner(grid_dir, dwell, cfg, device, shard_size=shard_size,
                        process_index=rank, num_processes=world, refine=rcfg)
    _save(out_dir, rank, done=np.array(runner.run(sigs)))
