"""Where does the 1e-8 agreement with the float64 oracle break with noise?

Counterpart of the JAX package's ``tools/noise_gate_sweep.py``.  At each
complex noise level (1e-4 .. 1e-2) on the config-1 family, the pipeline's
refined lines (the north star's sweep and clustering, the top 16 clusters
refined with ``--gn-iters`` Gauss-Newton iterations) against the float64
oracle's Gauss-Newton fixed point of the same noisy signal
(``oracle.refine(truth, signal, iters=30)``): both solve one estimation
problem, so the comparison isolates basin and conditioning effects from the
noise itself.

Per level: the largest and the median over voxels of each voxel's largest
line-parameter error, and the voxels whose refined lines hold all 5 true
ones.  Signals are drawn from default_rng(3), as the JAX tool draws them.
The production level, 1e-4 (the bench's noise), prints FAIL if a voxel
lacks a line or misses 1e-8 there; the other levels report.

    python -m llckbdm_tpu_torch.tools.noise_gate_sweep [--voxels 8] [--gn-iters 8]
    python -m llckbdm_tpu_torch.tools.noise_gate_sweep --cpu --voxels 1 --levels 1e-4

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..pipeline.llckbdm import llc_kbdm_fit
from ..signals import LineList
from ..solver.refine import RefineConfig, refine_lines, refined_to_np
from . import five_peak
from .timing import device_label

LEVELS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2)
PRODUCTION_NOISE, GATE = 1e-4, 1e-8


def level(noise: float, voxels: int, gn_iters: int, device) -> dict:
    """The refined lines' errors against the oracle at one noise level."""
    sigs, truths = five_peak.signals(voxels, noise, seed=3)
    c = torch.as_tensor(sigs).to(device)
    cons, _, _, _ = llc_kbdm_fit(c.to(torch.complex64), five_peak.DWELL,
                                 five_peak.north_star_config())
    top = LineList(*(x[..., :five_peak.REFINE_CLUSTERS] for x in cons))
    ref = refine_lines(c, top, five_peak.DWELL, RefineConfig(iters=gn_iters))
    errs = []
    for i in range(voxels):
        est = refined_to_np(ref._replace(z=ref.z[i], d=ref.d[i],
                                         mask=ref.mask[i]), five_peak.DWELL)
        try:
            errs.append(five_peak.gate_error(est, truths[i], sigs[i],
                                             truths[i], iters=30))
        except ValueError:                    # fewer than 5 refined lines
            errs.append(np.inf)
    errs = np.asarray(errs)
    return {"max": float(errs.max()), "median": float(np.median(errs)),
            "five_lines": int(np.isfinite(errs).sum()), "voxels": voxels}


def run(voxels: int = 8, gn_iters: int = 8, levels=LEVELS, device="cuda",
        verbose: bool = True) -> dict:
    """Every level's row; ``ok`` is False where the production level fails."""
    if verbose:
        print(f"# {device_label(device)}; V={voxels}, GN iters={gn_iters}")
        print("| noise sigma | max rel err | median rel err | voxels w/ 5 "
              "lines |")
        print("|---|---|---|---|", flush=True)
    rows, ok = {}, True
    for noise in levels:
        r = level(noise, voxels, gn_iters, device)
        rows[noise] = r
        flag = ""
        if noise == PRODUCTION_NOISE:
            good = r["max"] < GATE and r["five_lines"] == voxels
            ok = ok and good
            flag = " PASS" if good else " FAIL"
        if verbose:
            print(f"| {noise:.0e} | {r['max']:.2e} | {r['median']:.2e} | "
                  f"{r['five_lines']}/{voxels} |{flag}", flush=True)
    breakpt = next((nz for nz, r in rows.items() if not r["max"] < GATE), None)
    if verbose:
        print("# 1e-8 agreement holds at every level" if breakpt is None
              else f"# first level where the max error reaches 1e-8: "
                   f"{breakpt:.0e}", flush=True)
    return {"levels": rows, "first_failing_level": breakpt, "ok": ok}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voxels", type=int, default=8)
    ap.add_argument("--gn-iters", type=int, default=8)
    ap.add_argument("--levels", type=float, nargs="*", default=list(LEVELS))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("noise_gate_sweep: needs a CUDA device (or --cpu)",
              file=sys.stderr)
        return 2
    res = run(args.voxels, args.gn_iters, tuple(args.levels),
              "cpu" if args.cpu else "cuda")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
