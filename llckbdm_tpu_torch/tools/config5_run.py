"""Config 5: a 256x256 = 65,536-voxel grid through the checkpointed
GridRunner on one device.

Counterpart of the JAX package's ``tools/config5_run.py``: the same signal
family (the config-1 lines with per-voxel jitter of amplitude and
frequency, plus complex noise 1e-4, from seed 0), the north star's
LL-KBDM configuration, the top 16 clusters refined with 6 Gauss-Newton
iterations, shards written to ``--out``.  It prints the wall time and
throughput of the shards computed in this run (host copies and .npz writes
included) and how many were resumed from ``--out``, then gathers the grid
and asserts the 1e-8 oracle gate on ``--gate-voxels`` random voxels.

Resuming: kill the run mid-grid (each shard file is written atomically, so
every completed shard survives) and run the same command again: the
completed shards are skipped ("resumed") and the gather assembles the
whole grid.

    python -m llckbdm_tpu_torch.tools.config5_run [--voxels 65536] [--shard 512] [--out DIR]
    python -m llckbdm_tpu_torch.tools.config5_run --cpu --voxels 4 --shard 2 --out DIR

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..parallel import GridRunner
from ..solver.refine import RefineConfig, RefinedLines, refined_to_np
from . import five_peak
from .timing import device_label

GATE = 1e-8


def make_grid_signals(v: int, chunk: int = 4096):
    """The JAX tool's signals (its config5_run.py:29-52), the same draws
    from seed 0: the config-1 lines with per-voxel jitter of amplitude (5%)
    and frequency (2 Hz), plus complex noise 1e-4.  Returns (signals (v, N)
    complex128, truths (v, 5, 4)).  The lines are summed ``chunk`` voxels
    at a time; the vectorised form holds a (v, 5, N) complex array, ~2.7 GB
    at v = 65,536."""
    base, n, dwell = five_peak.FIVE_PEAK, five_peak.N, five_peak.DWELL
    rng = np.random.default_rng(0)
    amp = base[:, 0] * (1.0 + rng.normal(scale=0.05, size=(v, 5)))
    t2 = np.broadcast_to(base[:, 1], (v, 5))
    freq = base[:, 2] + rng.normal(scale=2.0, size=(v, 5))
    ph = np.broadcast_to(base[:, 3], (v, 5))
    noise = 1e-4 * (rng.standard_normal((v, n))
                    + 1j * rng.standard_normal((v, n)))
    t = np.arange(n) * dwell
    sigs = np.empty((v, n), np.complex128)
    for s in range(0, v, chunk):
        z = (2j * np.pi * freq[s:s + chunk, :, None]
             - 1.0 / t2[s:s + chunk, :, None]) * t
        sigs[s:s + chunk] = np.sum(amp[s:s + chunk, :, None]
                                   * np.exp(1j * ph[s:s + chunk, :, None] + z),
                                   axis=1)
    sigs += noise
    return sigs, np.stack([amp, t2, freq, ph], axis=-1)


def refined_rows(res: dict, i: int) -> np.ndarray:
    """Voxel i's stored refined poles and amplitudes in a gathered grid ->
    refined_to_np's float64 (A, T2, f, phase) rows sorted by frequency."""
    z, d, mask = (torch.from_numpy(np.asarray(res[k][i]))
                  for k in ("refined_z", "refined_d", "refined_mask"))
    return refined_to_np(RefinedLines(z=z, d=d, mask=mask, lines=None,
                                      gn_step=None), five_peak.DWELL)


def run(voxels: int = 256 * 256, shard: int = 512, out: str | None = None,
        device="cuda", gn_iters: int = 6, gate_voxels: int = 8,
        f32_only: bool = False, verbose: bool = True) -> dict:
    """Run (or resume) the grid into ``out`` and gather it.  Returns the
    shard counts, the wall time and throughput of this run's shards, the
    gathered grid and, unless ``f32_only``, the gate on ``gate_voxels``
    random voxels (raising RuntimeError where it misses 1e-8)."""
    out = out or os.path.join(tempfile.gettempdir(), "llckbdm_config5")
    cfg = five_peak.north_star_config()
    rcfg = None if f32_only else RefineConfig(iters=gn_iters)

    def say(msg):
        if verbose:
            print(f"# {msg}", flush=True)

    t0 = time.perf_counter()
    sigs, truths = make_grid_signals(voxels)
    say(f"synthesized {voxels} voxels in {time.perf_counter() - t0:.1f} s "
        f"({sigs.nbytes / 2 ** 20:.0f} MiB)")
    runner = GridRunner(out, five_peak.DWELL, cfg, device, shard_size=shard,
                        refine=rcfg,
                        refine_clusters=five_peak.REFINE_CLUSTERS)
    total = -(-voxels // shard)
    todo = runner.pending(voxels)
    pending, todo_voxels = len(todo), sum(e - s for s, e in todo)
    say(f"{device_label(device)}; shards: {total} total, {pending} pending "
        f"({total - pending} resumed); out {out}")
    t0 = time.perf_counter()
    computed = runner.run(sigs)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fits = todo_voxels / wall if computed else 0.0
    say(f"computed {computed} shards ({todo_voxels} voxels) in "
        f"{wall:.3f} s -> {fits:.1f} fits/s (host copies and .npz writes "
        f"included); resumed {total - pending}")
    res = runner.gather(voxels)
    found = (res["mask"] > 0.5).sum(axis=1)
    say(f"gather OK: {res['amplitude'].shape[0]} voxels; lines per voxel "
        f"min {found.min()} median {np.median(found):.0f} max {found.max()}")
    result = dict(total=total, pending=pending, resumed=total - pending,
                  computed=computed, wall_s=wall, fits_per_s=fits,
                  grid=res, gate=None)
    if rcfg is not None and gate_voxels:
        gate_voxels = min(gate_voxels, voxels)
        sample = np.random.default_rng(1).choice(voxels, size=gate_voxels,
                                                 replace=False)
        gate = max(five_peak.gate_error(refined_rows(res, i), truths[i],
                                        sigs[i], truths[i]) for i in sample)
        if not gate < GATE:
            raise RuntimeError(f"config 5: the refined grid missed the 1e-8 "
                               f"oracle gate on sampled voxels: {gate:.3e}")
        say(f"gate: max rel err vs the float64 oracle on {gate_voxels} "
            f"sampled voxels {gate:.2e} (< 1e-8)")
        result["gate"] = gate
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voxels", type=int, default=256 * 256)
    ap.add_argument("--shard", type=int, default=512)
    ap.add_argument("--out", help="shard directory (default: config5 under "
                                  "the temporary directory)")
    ap.add_argument("--f32-only", action="store_true",
                    help="skip the Gauss-Newton refinement")
    ap.add_argument("--gn-iters", type=int, default=6)
    ap.add_argument("--gate-voxels", type=int, default=8,
                    help="random voxels held to the 1e-8 oracle gate (0: "
                         "none)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("config5_run: needs a CUDA device (or --cpu)", file=sys.stderr)
        return 2
    run(args.voxels, args.shard, args.out, "cpu" if args.cpu else "cuda",
        args.gn_iters, args.gate_voxels, args.f32_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
