"""The Jacobi sweep budgets against measured production convergence.

Counterpart of the JAX package's ``tools/tune_sweeps.py``.  The two
sequential kernels of the sweep are eig_cs (``KbdmConfig.eig_sweeps``,
default 10) and gram_svd (``eigh_sweeps``, default 7).  This tool:

1. measures the production eig_cs off-diagonal counter
   (``kbdm_sweep(..., with_diag=True)``) against eig_sweeps on the north
   star's noisy voxels (the matrices that matter), at p=16;
2. runs the two committed accuracy gates at each (eig_sweeps, eigh_sweeps)
   pair, the port's default (10, 7) first:
     - config 1 noiseless, m=180, 3 GN iterations (tests/test_tpu.py's chip
       gate, which pinned the f32 stage's quality);
     - noise 1e-4, m = 120..256 step 4, the top 16 clusters with 6 GN
       iterations, 3 voxels (the bench's gate);
   each within 1e-8 of the port's float64 oracle (``oracle.refine``, 20
   iterations);
3. times the sweep at V=512 at each pair (host clock around a synchronise,
   median of 3).

A pair that misses a gate prints FAIL; so does a counter at the default
eig_sweeps of 1e-2 or more (the bench's convergence gate).

    python -m llckbdm_tpu_torch.tools.tune_sweeps
    python -m llckbdm_tpu_torch.tools.tune_sweeps --cpu --counter-voxels 1 --time-voxels 1 --sweeps 10 --pairs 10,7

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import oracle
from ..pipeline.llckbdm import LlcKbdmConfig, llc_kbdm_fit
from ..signals import LineList
from ..solver.kbdm import KbdmConfig, kbdm_sweep
from ..solver.refine import RefineConfig, refine_lines, refined_to_np
from . import five_peak
from .timing import device_label, host_ms

SWEEPS = (4, 5, 6, 7, 8, 10)
PAIRS = ((10, 7), (10, 8), (8, 6), (6, 6), (6, 5), (5, 4))
GATE, COUNTER_GATE = 1e-8, 1e-2


def counter_vs_sweeps(voxels: int = 32, sweeps=SWEEPS, device="cuda") -> dict:
    """eig_sweeps -> the largest relative off-diagonal norm eig_cs leaves on
    the sweep's reduced matrices (noise 1e-4, the bench's signals)."""
    sigs, _ = five_peak.signals(voxels, 1e-4)
    c = torch.as_tensor(sigs).to(device, torch.complex64)
    out = {}
    for s in sweeps:
        _, diag = kbdm_sweep(c, five_peak.DWELL, five_peak.M_VALUES,
                             KbdmConfig(p=16, eig_sweeps=s), with_diag=True)
        out[s] = diag["eig_offdiag_rel"].max().item()
    return out


def _gate(refined, sigs, truths, i) -> float:
    """Voxel i's gate error; inf where its refined lines are not finite."""
    est = refined_to_np(refined._replace(z=refined.z[i], d=refined.d[i],
                                         mask=refined.mask[i]),
                        five_peak.DWELL)
    if not np.isfinite(est).all():
        return float("inf")
    return five_peak.gate_error(est, truths[i], sigs[i], truths[i])


def gate_at(eig_sweeps: int, eigh_sweeps: int, device="cuda",
            time_voxels: int = 512, mxu_precision: str = "highest",
            subspace_bf16: bool = True) -> dict:
    """The two gates' errors and the sweep's ms at V=time_voxels, with the
    solver's precision fields as given (KbdmConfig's defaults otherwise)."""
    kb = KbdmConfig(p=16, eig_sweeps=eig_sweeps, eigh_sweeps=eigh_sweeps,
                    mxu_precision=mxu_precision, subspace_bf16=subspace_bf16)
    dwell = five_peak.DWELL

    # gate 1: config 1 noiseless, one m, every cluster refined, 3 iterations
    sig = oracle.sample_signal(five_peak.FIVE_PEAK, five_peak.N, dwell)
    c1 = torch.as_tensor(sig[None]).to(device)
    cfg1 = LlcKbdmConfig(m_values=(180,), eps=2e-4, min_samples=1,
                         max_clusters=16, kbdm=kb)
    cons, _, _, _ = llc_kbdm_fit(c1.to(torch.complex64), dwell, cfg1)
    ref = refine_lines(c1, cons, dwell, RefineConfig(iters=3))
    err1 = _gate(ref, sig[None], five_peak.FIVE_PEAK[None], 0)

    # gate 2: the bench's noisy voxels, the top 16 refined, 6 iterations
    sigs, truths = five_peak.signals(3, 1e-4)
    cb = torch.as_tensor(sigs).to(device)
    cfgb = five_peak.north_star_config(kb)
    consb, _, _, _ = llc_kbdm_fit(cb.to(torch.complex64), dwell, cfgb)
    top = LineList(*(x[..., :five_peak.REFINE_CLUSTERS] for x in consb))
    refb = refine_lines(cb, top, dwell, RefineConfig(iters=6))
    err2 = max(_gate(refb, sigs, truths, i) for i in range(3))

    sigs_t, _ = five_peak.signals(time_voxels, 1e-4)
    ct = torch.as_tensor(sigs_t).to(device, torch.complex64)
    ms = host_ms(lambda: kbdm_sweep(ct, dwell, cfgb.m_values, kb), device).ms
    return {"noiseless_iters3": err1, "noisy_iters6": err2, "sweep_ms": ms}


def run(device="cuda", counter_voxels: int = 32, time_voxels: int = 512,
        sweeps=SWEEPS, pairs=PAIRS, verbose: bool = True) -> dict:
    """The counter curve and the gates at every pair.  ``ok`` is False where
    the tool prints FAIL at the defaults: the counter at the default
    eig_sweeps, or either gate at the default pair."""
    default = (KbdmConfig().eig_sweeps, KbdmConfig().eigh_sweeps)
    if verbose:
        print(f"# {device_label(device)}", flush=True)
        print(f"eig_sweeps -> production max offdiag_rel (V={counter_voxels},"
              f" noise 1e-4, p=16):", flush=True)
    counter = counter_vs_sweeps(counter_voxels, sweeps, device)
    ok = counter.get(default[0], 0.0) < COUNTER_GATE
    if verbose:
        for s, r in counter.items():
            flag = ("" if s != default[0] else
                    " [PASS]" if r < COUNTER_GATE else " [FAIL]")
            print(f"  eig_sweeps={s:2d}: {r:.3e}{flag}", flush=True)
        print(f"\n(eig_sweeps, eigh_sweeps) -> gates (< {GATE:g}) + "
              f"V={time_voxels} sweep ms:", flush=True)
    gates = {}
    for es, eh in pairs:
        g = gate_at(es, eh, device, time_voxels)
        g["pass"] = g["noiseless_iters3"] < GATE and g["noisy_iters6"] < GATE
        gates[(es, eh)] = g
        if (es, eh) == default:
            ok = ok and g["pass"]
        if verbose:
            print(f"  ({es:2d}, {eh}): noiseless iters=3 "
                  f"{g['noiseless_iters3']:.2e} "
                  f"[{'PASS' if g['noiseless_iters3'] < GATE else 'FAIL'}]  "
                  f"noisy iters=6 {g['noisy_iters6']:.2e} "
                  f"[{'PASS' if g['noisy_iters6'] < GATE else 'FAIL'}]  "
                  f"sweep {g['sweep_ms']:8.2f} ms", flush=True)
    passing = [p for p, g in gates.items() if g["pass"]]
    smallest = min(passing, key=lambda p: (p[0] + p[1], p)) if passing else None
    if verbose:
        print(f"# smallest pair passing both gates: {smallest}", flush=True)
    return {"counter": counter, "gates": gates, "smallest_passing": smallest,
            "ok": ok}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counter-voxels", type=int, default=32)
    ap.add_argument("--time-voxels", type=int, default=512)
    ap.add_argument("--sweeps", type=int, nargs="*", default=list(SWEEPS))
    ap.add_argument("--pairs", nargs="*", default=[f"{a},{b}" for a, b in PAIRS],
                    help="(eig_sweeps, eigh_sweeps) pairs as a,b")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("tune_sweeps: needs a CUDA device (or --cpu)", file=sys.stderr)
        return 2
    pairs = tuple(tuple(int(x) for x in p.split(",")) for p in args.pairs)
    res = run("cpu" if args.cpu else "cuda", args.counter_voxels,
              args.time_voxels, tuple(args.sweeps), pairs)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
