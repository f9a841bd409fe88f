"""Entry points: the single-device forward step and a multi-rank dry run.

Counterpart of the JAX package's ``__graft_entry__.py``:

    python -m llckbdm_tpu_torch.entry [--cpu]             # entry()
    python -m llckbdm_tpu_torch.entry dryrun [N] [--cpu]  # dryrun_multichip(N)

entry()              — the config-1 KBDM fit (5-peak family, N=512, m=180,
                       KbdmConfig(p=16)) and its example input.
dryrun_multichip(n)  — n spawned ranks on a {'data': n/2, 'time': 2} mesh
                       run one fit_and_refine_grid step (the sharded LL-KBDM
                       fit and the time-sharded Gauss-Newton refinement with
                       its all-reduce) on tiny shapes.

Both run on the card unless the caller asks for the CPU (``device="cpu"``,
``--cpu``); without a CUDA device they raise, and the command exits 2.
"""
from __future__ import annotations

import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

DWELL = 5e-4


def require_device(device) -> torch.device:
    """The device, after checking that a CUDA device exists where one is
    asked for (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device (pass "
                           f"device='cpu' to run on the CPU)")
    return dev


def entry(device="cuda"):
    """Return (fn, example_args): the config-1 kbdm_fit step and the (512,)
    complex64 signal ``__graft_entry__.entry`` draws from default_rng(0),
    each part rounded to float32 as there, on ``device``."""
    from .solver.kbdm import KbdmConfig, kbdm_fit

    dev = require_device(device)
    cfg = KbdmConfig(p=16)
    rng = np.random.default_rng(0)
    sig = rng.standard_normal(512) + 1j * rng.standard_normal(512)

    def fn(c):
        return kbdm_fit(c, DWELL, 180, cfg)

    return fn, (torch.as_tensor(sig).to(dev, torch.complex64),)


def mesh_axes(n: int) -> dict:
    """__graft_entry__.py's mesh: {'data': n/2, 'time': 2}, with time=1 where
    n is odd or 1."""
    time_shards = 2 if n % 2 == 0 and n > 1 else 1
    return {"data": n // time_shards, "time": time_shards}


def dryrun_config():
    """__graft_entry__.py's tiny but structurally real shapes: N=64, three
    m values, 4 clusters, one GN iteration."""
    from .pipeline.llckbdm import LlcKbdmConfig
    from .solver.kbdm import KbdmConfig
    from .solver.refine import RefineConfig

    cfg = LlcKbdmConfig(
        m_values=(16, 24, 32), eps=5e-3, min_samples=2, max_clusters=4,
        kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1,
                        eigh_sweeps=4, eig_sweeps=6))
    return cfg, RefineConfig(iters=1)


def dryrun_signals(v: int, n: int = 64) -> np.ndarray:
    """(v, n) complex128 Gaussian signals from default_rng(0), as
    __graft_entry__.py draws them."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((v, n)) + 1j * rng.standard_normal((v, n))


def rank_backend(n: int, dev: torch.device) -> str:
    """NCCL where every rank has its own card; gloo where ranks share one
    (NCCL refuses two ranks on one card) and on the CPU."""
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _dryrun_rank(rank: int, n: int, rdv: str, out_dir: str, device: str,
                 backend: str) -> None:
    """One rank of the dry run; saves its rows to out_dir/rank{rank}.npz.
    On a card, rank r takes ``cuda:{r % device_count}``: every rank is
    spawned on this host, so that index is the card's local one, which
    distributed_init binds."""
    import torch.distributed as dist

    from .ops import _build
    from .parallel import distributed_init, fit_and_refine_grid, make_mesh

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        device = f"cuda:{rank % torch.cuda.device_count()}"
    else:
        torch.set_num_threads(1)
    distributed_init(f"file://{rdv}", n, rank, backend=backend, device=device)
    try:
        axes = mesh_axes(n)
        mesh = make_mesh(axes, torch.device(device).type)
        cfg, rcfg = dryrun_config()
        sigs = dryrun_signals(2 * axes["data"])
        _build.reset_counts()
        (refined, counts), (start, stop) = fit_and_refine_grid(
            sigs, DWELL, cfg, mesh, rcfg)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        if refined.z.shape != (stop - start, cfg.max_clusters):
            raise RuntimeError(f"rank {rank}: refined {tuple(refined.z.shape)}"
                               f" for rows [{start}, {stop})")
        names = sorted(set(_build.LAUNCHES) | set(_build.PLAIN_ON_CUDA))
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz",
                 z=refined.z.cpu().numpy(), d=refined.d.cpu().numpy(),
                 mask=refined.mask.cpu().numpy(),
                 counts=counts.cpu().numpy(), rows=np.array([start, stop]),
                 time_rank=np.array(mesh.get_local_rank("time")),
                 names=np.array(names, dtype=str),
                 launches=np.array([_build.LAUNCHES[k] for k in names]),
                 plain=np.array([_build.PLAIN_ON_CUDA[k] for k in names]))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, args: tuple, timeout: float) -> None:
    """fn(rank, *args) in n spawned processes; a failed rank raises (the
    others are killed), as do ranks still running after ``timeout`` s."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
                proc.join()
            raise TimeoutError(f"ranks still running after {timeout} s")


def dryrun_multichip(n: int = 8, device="cuda", timeout: float = 600.0) -> dict:
    """Spawn n ranks (rank r on cuda:(r mod device count), or all on the
    CPU with ``device="cpu"``), build the __graft_entry__.py mesh and run
    one fit_and_refine_grid step on V = 2 * data voxels of N=64.

    The parent builds the kernel library first, so that the ranks load it
    and none starts nvcc.  Ranks meet by ``file://`` rendezvous in a
    temporary directory.  Returns the gathered result: ``mesh``,
    ``backend``, the refined ``z``, ``d``, ``mask`` and cluster ``counts``
    of all V rows (from the ranks of time index 0, which fit), and per rank
    its index along 'time' (``time_ranks``), its kernel ``launches`` and
    the plain versions it ran on a CUDA tensor (``plain``).
    """
    dev = require_device(device)
    if n < 1:
        raise ValueError(f"dryrun_multichip: n={n}")
    if dev.type == "cuda":
        from .ops import _build
        _build.library()
    backend = rank_backend(n, dev)
    axes = mesh_axes(n)
    cfg, _ = dryrun_config()
    v = 2 * axes["data"]
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_dryrun_rank, n, (n, str(pathlib.Path(tmp) / "rdv"),
                                      tmp, dev.type, backend), timeout)
        outs = [dict(np.load(pathlib.Path(tmp) / f"rank{r}.npz"))
                for r in range(n)]
    heads = sorted((o for o in outs if int(o["time_rank"]) == 0),
                   key=lambda o: int(o["rows"][0]))
    result = {key: np.concatenate([o[key] for o in heads])
              for key in ("z", "d", "mask", "counts")}
    result.update(
        mesh=axes, backend=backend, grid=(v, 64),
        time_ranks=[int(o["time_rank"]) for o in outs],
        launches=[dict(zip(o["names"].tolist(), o["launches"].tolist()))
                  for o in outs],
        plain=[dict(zip(o["names"].tolist(), o["plain"].tolist()))
               for o in outs])
    if result["z"].shape != (v, cfg.max_clusters):
        raise RuntimeError(f"dryrun_multichip: refined lines "
                           f"{result['z'].shape}, want {(v, cfg.max_clusters)}")
    print(f"dryrun_multichip OK: mesh={axes} backend={backend} "
          f"grid=({v},64) -> lines {result['z'].shape}", flush=True)
    return result


def main(argv: list[str]) -> int:
    cpu = "--cpu" in argv
    args = [a for a in argv if a != "--cpu"]
    if not cpu and not torch.cuda.is_available():
        print("entry: needs a CUDA device (or --cpu)", file=sys.stderr)
        return 2
    device = "cpu" if cpu else "cuda"
    if args and args[0] == "dryrun":
        dryrun_multichip(int(args[1]) if len(args) > 1 else 8, device)
        return 0
    fn, example = entry(device)
    out = fn(*example)
    print(f"entry OK: {tuple(out.amplitude.shape)} line slots on {device}, "
          f"{int(out.mask.sum().item())} valid")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
