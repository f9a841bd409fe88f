"""The solver's precision settings against the committed accuracy gates.

Counterpart of the JAX package's ``tools/precision_gate.py``, which ran
``Precision.HIGH`` (bf16x3 on a TPU) against ``HIGHEST`` at the sweep's
float32 stages.  Here both precision fields of ``KbdmConfig`` are varied:

* ``mxu_precision``: "highest" (full float32) and "high" (TF32 on a card:
  the counterpart of HIGH, which JAX also runs as TF32 on an NVIDIA GPU);
* ``subspace_bf16``: the bfloat16 power iterations (the default, on a
  card) and the float32 ones.

For each of the four, ``tools.tune_sweeps.gate_at`` at the default sweep
budgets runs the two committed gates (config 1 noiseless with 3 GN
iterations; the bench's noisy voxels with 6), each within 1e-8 of the
float64 oracle, and times the sweep at V=512.  A gate error of inf means
non-finite refined lines.  It exits 1 only where the default ("highest",
bfloat16) fails a gate.

    python -m llckbdm_tpu_torch.tools.precision_gate
    python -m llckbdm_tpu_torch.tools.precision_gate --cpu --time-voxels 1

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.  On
the CPU every combination computes in float32 (a CPU tensor takes the
float32 power iterations, and TF32 is a card's).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..solver.kbdm import KbdmConfig
from .timing import device_label
from .tune_sweeps import GATE, gate_at

SETTINGS = (("highest", True), ("highest", False), ("high", True),
            ("high", False))
DEFAULT = (KbdmConfig().mxu_precision, KbdmConfig().subspace_bf16)


def run(device="cuda", time_voxels: int = 512, settings=SETTINGS,
        verbose: bool = True) -> dict:
    """Each (mxu_precision, subspace_bf16)'s gates and sweep ms.  ``ok`` is
    False where the default setting misses a gate."""
    cfg = KbdmConfig()
    if verbose:
        print(f"# {device_label(device)}; eig_sweeps {cfg.eig_sweeps}, "
              f"eigh_sweeps {cfg.eigh_sweeps}; V={time_voxels} sweep",
              flush=True)
    rows, ok = {}, True
    for prec, bf16 in settings:
        g = gate_at(cfg.eig_sweeps, cfg.eigh_sweeps, device, time_voxels,
                    mxu_precision=prec, subspace_bf16=bf16)
        g["pass"] = g["noiseless_iters3"] < GATE and g["noisy_iters6"] < GATE
        rows[(prec, bf16)] = g
        if (prec, bf16) == DEFAULT:
            ok = g["pass"]
        if verbose:
            print(f"  {prec:8s} {'bf16' if bf16 else 'f32 '} power "
                  f"iterations: noiseless iters=3 "
                  f"{g['noiseless_iters3']:.2e} "
                  f"[{'PASS' if g['noiseless_iters3'] < GATE else 'FAIL'}]  "
                  f"noisy iters=6 {g['noisy_iters6']:.2e} "
                  f"[{'PASS' if g['noisy_iters6'] < GATE else 'FAIL'}]  "
                  f"sweep {g['sweep_ms']:8.2f} ms", flush=True)
    return {"gates": rows, "ok": ok}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time-voxels", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("precision_gate: needs a CUDA device (or --cpu)",
              file=sys.stderr)
        return 2
    res = run("cpu" if args.cpu else "cuda", args.time_voxels)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
