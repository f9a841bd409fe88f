"""Data-parallel scaling and the time-sharded refine's collective cost.

Counterpart of the JAX package's ``tools/scaling_bench.py``, on spawned
torch.distributed ranks (``file://`` rendezvous) instead of virtual XLA
devices: on the card, rank r on cuda:(r mod device count), over NCCL where
every rank has its own card and over gloo where ranks share one; with
``--cpu`` gloo ranks on the CPU.

1. ``dp_scaling``: ``fit_grid_sharded`` on 1, 2, 4 and 8 ranks (one spawn
   each, mesh {'data': n}), V=16 voxels of N=256 (the JAX tool's shapes):
   the wall time (the slowest rank's, host clock around a synchronise,
   median of 3 after a warm-up), fits per second, and the collectives each
   rank issued.  torch has no compiled program to read, so the count wraps
   the ``torch.distributed`` calls while the port runs; the JAX tool's
   claim is that this path issues none.
2. ``overlap_probe``, in the largest spawn (mesh {'data': n/2, 'time': 2}):
   ``refine_grid_timesharded`` (2 GN iterations, one all-reduce of the
   normal equations each) against the same per-rank
   ``refine_lines(..., t_offset=...)`` with ``group=None``, i.e. without
   the all-reduce.  The difference is the un-hidden collective time.

It prints its results and one JSON line, or writes the JSON to ``--out``.

    python -m llckbdm_tpu_torch.tools.scaling_bench [--ranks 1 2 4 8]
    python -m llckbdm_tpu_torch.tools.scaling_bench --cpu --ranks 1 2 --voxels 4

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import oracle
from ..entry import rank_backend, require_device, spawn_ranks
from ..pipeline.llckbdm import LlcKbdmConfig
from ..solver.kbdm import KbdmConfig
from ..solver.refine import RefineConfig
from .timing import device_label

N, DWELL = 256, 5e-4
# the torch.distributed calls counted as collectives
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "gather", "scatter", "send", "recv", "isend", "irecv",
               "barrier", "broadcast_object_list")
DP_CFG = LlcKbdmConfig(m_values=(64, 80, 96), eps=5e-4, min_samples=4,
                       max_clusters=8, kbdm=KbdmConfig(p=8))
OVERLAP_CFG = LlcKbdmConfig(m_values=(64, 96, 128), eps=5e-4, min_samples=2,
                            max_clusters=8, kbdm=KbdmConfig(p=8))
OVERLAP_RCFG = RefineConfig(iters=2)


def make_grid(v: int) -> np.ndarray:
    """The JAX tool's grid: three lines with frequency jitter, from
    default_rng(0), noiseless."""
    rng = np.random.default_rng(0)
    base = np.array([[1.0, 0.05, -120.0, 0.1], [0.8, 0.08, -40.0, 0.0],
                     [1.2, 0.03, 15.0, -0.2]])
    sigs = np.empty((v, N), np.complex128)
    for i in range(v):
        p = base.copy()
        p[:, 2] += rng.normal(scale=2.0, size=3)
        sigs[i] = oracle.sample_signal(p, N, DWELL)
    return sigs


@contextlib.contextmanager
def counting_collectives():
    """Count the calls of each ``torch.distributed`` collective made inside
    the block (by module attribute, as the port calls them); yields the
    Counter.  It replaces the module's functions for the block's duration,
    so only one thread of the process may run it at a time."""
    counts: collections.Counter = collections.Counter()
    saved = {name: getattr(dist, name) for name in COLLECTIVES
             if hasattr(dist, name)}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _timed(fn, device: str, reps: int = 3):
    """fn's result, its median wall ms over ``reps`` runs after a warm-up
    (every rank starting together, the slowest rank's time taken) and the
    collectives one call of fn issued; the barriers and the max around the
    timed calls are neither timed nor counted."""
    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize()

    times = []
    for rep in range(reps + 1):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        with counting_collectives() as counts:
            out = fn()
        sync()
        ms = torch.tensor([(time.perf_counter() - t0) * 1e3],
                          dtype=torch.float64, device=device)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        if rep:
            times.append(ms.item())
    return out, float(np.median(times)), dict(counts)


def _rank(rank: int, n: int, rdv: str, out_dir: str, device: str,
          backend: str, voxels: int, overlap: bool) -> None:
    """One rank: fit_grid_sharded on a {'data': n} mesh, then (when
    ``overlap``) the time-sharded refine with and without its all-reduce.
    On a card, rank r takes ``cuda:{r % device_count}``: every rank is
    spawned on this host, so that index is the card's local one, which
    distributed_init binds."""
    from ..ops import _build
    from ..parallel import (distributed_init, fit_grid_sharded, make_mesh,
                            refine_grid_timesharded)
    from ..signals import LineList
    from ..solver.refine import refine_lines

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        device = f"cuda:{rank % torch.cuda.device_count()}"
    else:
        torch.set_num_threads(1)
    distributed_init(f"file://{rdv}", n, rank, backend=backend, device=device)
    try:
        dev_type = torch.device(device).type
        sigs = make_grid(voxels)
        mesh = make_mesh({"data": n}, dev_type)
        _build.reset_counts()
        _, ms, counts = _timed(lambda: fit_grid_sharded(sigs, DWELL, DP_CFG,
                                                         mesh), device)
        out = {"dp_ms": ms, "dp_collectives": counts}
        if overlap:
            mesh = make_mesh({"data": n // 2, "time": 2}, dev_type)
            group = mesh.get_group("time")
            (cons, _, _, _), (start, stop) = fit_grid_sharded(
                sigs, DWELL, OVERLAP_CFG, mesh)
            # every rank of a time group refines from its first rank's bits
            buf = torch.stack(list(cons))
            dist.broadcast(buf, src=dist.get_global_rank(group, 0),
                           group=group)
            lines = LineList(*buf)
            t0, t1 = (mesh.get_local_rank("time") * (N // 2),
                      (mesh.get_local_rank("time") + 1) * (N // 2))
            c_loc = torch.as_tensor(sigs[start:stop, t0:t1]).to(
                device, torch.complex128)
            _, with_ms, with_counts = _timed(lambda: refine_grid_timesharded(
                sigs, lines, DWELL, mesh, OVERLAP_RCFG), device)
            _, without_ms, without_counts = _timed(lambda: refine_lines(
                c_loc, lines, DWELL, OVERLAP_RCFG, group=None, t_offset=t0),
                device)
            out.update(with_ms=with_ms, without_ms=without_ms,
                       with_collectives=with_counts,
                       without_collectives=without_counts)
        out.update(launches=dict(_build.LAUNCHES),
                   plain=dict(_build.PLAIN_ON_CUDA))
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run(ranks=(1, 2, 4, 8), device="cuda", voxels: int = 16,
        timeout: float = 600.0, verbose: bool = True) -> dict:
    """dp_scaling on each rank count of ``ranks`` and overlap_probe in the
    largest even one.  Returns the results with each rank's collective
    counts, kernel launches and plain versions run on a CUDA tensor."""
    dev = require_device(device)
    if dev.type == "cuda":
        from ..ops import _build
        _build.library()
    overlap_n = max((n for n in ranks if n % 2 == 0), default=None)
    if verbose:
        print(f"# {device_label(device)}; V={voxels} N={N}; wall of the "
              f"slowest rank, median of 3 after a warm-up", flush=True)
        print("| ranks | backend | time (ms) | fits/s | wall vs 1 rank | "
              "collectives per rank |")
        print("|---|---|---|---|---|---|", flush=True)
    dp, overlap, t_one = [], None, None
    for n in ranks:
        if voxels % n:
            raise ValueError(f"{voxels} voxels not divisible by {n} ranks")
        backend = rank_backend(n, dev)
        with tempfile.TemporaryDirectory() as tmp:
            spawn_ranks(_rank, n, (n, str(pathlib.Path(tmp) / "rdv"), tmp,
                                   dev.type, backend, voxels, n == overlap_n),
                        timeout)
            outs = [json.loads((pathlib.Path(tmp) / f"rank{r}.json")
                               .read_text()) for r in range(n)]
        ms = outs[0]["dp_ms"]
        t_one = t_one or ms
        ncoll = [sum(o["dp_collectives"].values()) for o in outs]
        dp.append({"ranks": n, "backend": backend, "ms": ms,
                   "fits_per_s": voxels / ms * 1e3, "collectives": ncoll,
                   "launches": [o["launches"] for o in outs],
                   "plain": [o["plain"] for o in outs]})
        if verbose:
            print(f"| {n} | {backend} | {ms:.3f} | {voxels / ms * 1e3:.1f} | "
                  f"{ms / t_one:.2f}x | {ncoll} |", flush=True)
        if n == overlap_n:
            w, wo = outs[0]["with_ms"], outs[0]["without_ms"]
            overlap = {"mesh": {"data": n // 2, "time": 2},
                       "backend": backend, "gn_iters": OVERLAP_RCFG.iters,
                       "with_allreduce_ms": w, "compute_only_ms": wo,
                       "unhidden_ms": w - wo,
                       "with_collectives": [o["with_collectives"]
                                            for o in outs],
                       "without_collectives": [o["without_collectives"]
                                               for o in outs]}
            if verbose:
                print(f"\ntime-sharded refine (mesh {overlap['mesh']}, "
                      f"V={voxels}, N={N}, {OVERLAP_RCFG.iters} GN "
                      f"iterations, {backend}):\n  with the all-reduce "
                      f"{w:8.3f} ms (collectives per rank "
                      f"{overlap['with_collectives'][0]})\n  compute only "
                      f"      {wo:8.3f} ms (collectives per rank "
                      f"{overlap['without_collectives'][0]})\n  un-hidden "
                      f"collective time {w - wo:.3f} ms "
                      f"({(w - wo) / w * 100:.1f}% of the total)", flush=True)
    return {"device": device_label(device), "voxels": voxels,
            "dp_scaling": dp, "overlap_probe": overlap}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--voxels", type=int, default=16)
    ap.add_argument("--out", help="write the JSON here instead of printing it")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (plain versions)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("scaling_bench: needs a CUDA device (or --cpu)", file=sys.stderr)
        return 2
    res = run(tuple(args.ranks), "cpu" if args.cpu else "cuda", args.voxels)
    text = json.dumps(res)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
