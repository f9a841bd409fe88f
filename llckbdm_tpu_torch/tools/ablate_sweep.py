"""The in-context cost of each kbdm_sweep stage, with its work model.

Counterpart of the JAX package's ``tools/ablate_sweep.py``: each prefix of
the real sweep (``kbdm_sweep(..., _stop=stage)``: hankel, powiter, basis,
m_small, takagi, reduced, eig, then the whole sweep as "lines") runs on the
north star's signals, reduced to one scalar on the device, and is timed by
the host clock around ``torch.cuda.synchronize()`` (median of ``--reps``
after a warm-up call).  Consecutive differences are each stage's marginal
cost in context.

Beside each stage: its operations and its bytes, from the shapes (the part
of the JAX ``tools/profile_stages.py`` model that carries over to the
port), and the least time the card could take for them at
``tools.bounds``' peaks.  The bytes count every operand a stage streams
through device memory once per use: the (V, m, m) Hankel operator per
apply, and each (V, m, S, k) block once per read and once per write, since
none of them fits the 50 MB L2.  The power iterations take the branch the
sweep takes (``solver.kbdm.bf16_power_iterations``, printed): on the
bfloat16 branch their blocks and operator are 2 bytes a real, the applies
run at the tensor cores' bfloat16 peak and the float32 Gram and mix
products of each CholeskyQR pass at the float32 one.

    python -m llckbdm_tpu_torch.tools.ablate_sweep [--voxels 512] [--reps 5]
    python -m llckbdm_tpu_torch.tools.ablate_sweep --cpu --voxels 2

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import torch

from ..solver.kbdm import KbdmConfig, bf16_power_iterations, kbdm_sweep
from . import bounds, five_peak
from .timing import device_label, host_ms

STAGES = ("hankel", "powiter", "basis", "m_small", "takagi", "reduced", "eig",
          "lines")


class Stage(NamedTuple):
    name: str
    cum_ms: float           # the prefix up to and including this stage
    ms: float               # marginal: cum_ms minus the previous prefix's
    flops: float
    bytes: float
    bound_ms: float
    bound_by: str


def scalarize(out) -> torch.Tensor:
    """Every floating tensor of a stage's output summed into one float32
    scalar on its device (a complex tensor as its real pairs), so that
    nothing but a scalar leaves the device."""
    if isinstance(out, torch.Tensor):
        if out.is_complex():
            out = torch.view_as_real(out)
        return out.to(torch.float32).sum()
    return sum(scalarize(x) for x in out if isinstance(x, (torch.Tensor,
                                                           tuple)))


def stage_model(v: int, n: int, m_values, cfg: KbdmConfig,
                bf16: bool = False) -> dict:
    """(flops, bytes) of each stage's own work at these shapes, real flops
    (a complex multiply-add is 8); ``bf16``: the power iterations' bfloat16
    branch."""
    s, m = len(m_values), max(m_values)
    p, k = cfg.p, cfg.p + cfg.oversample
    hank = v * m * m * 8                    # the operator, complex64
    blk = v * m * s * k * 8                 # one (V, m, S, k) block
    blk_p = blk * p / k                     # one (V, m, S, p) block
    apply = 8.0 * m * m * s * k * v         # one Hankel apply
    gram = 8.0 * m * k * k * s * v          # one Gram or mix einsum
    chol = bounds.cholqr_rinv(s * v, k)
    orth = (2 * gram + chol.flops, 3 * blk + chol.bytes)
    svd = bounds.gram_svd(s * v, k, cfg.eigh_sweeps)
    eig = bounds.eig_cs(s * v, p, cfg.eig_sweeps)
    chunks = -(-n // cfg.rhs_chunk)
    solve = bounds.chol_solve(s * v, p)
    it = cfg.subspace_iters
    # the sketch's apply writes a block; each later one reads one too
    powiter = ((1 + it) * apply + it * orth[0],
               (1 + it) * hank + (1 + 2 * it) * blk + it * orth[1])
    if bf16:
        # the (2m, 2m) bfloat16 operator (as many bytes as the complex64
        # one) built from h0; each pass reads its pairs for the Gram and
        # the mix and writes its result as pairs (the operations as above)
        blk_bf = blk / 2
        powiter = ((1 + it) * apply + it * orth[0],
                   2 * hank + (1 + it) * hank + (1 + 2 * it) * blk_bf
                   + it * (3 * blk_bf + chol.bytes))
    return {
        "hankel": (0.0, v * n * 8 + hank),
        "powiter": powiter,
        "basis": (cfg.final_orth_passes * orth[0],
                  cfg.final_orth_passes * orth[1]),
        # t0 = U0 conj(q), then q^H t0
        "m_small": (apply + gram, hank + 4 * blk),
        "takagi": (svd.flops, svd.bytes),
        # u_p = q w_p and U0 conj(u_p) = t0 conj(w_p) (k -> p mixes), the
        # shifted rows and the correction row, then u_p^H t (p x p)
        "reduced": (2 * 8.0 * m * k * p * s * v + 8.0 * m * p * (p + 1) * s * v,
                    2 * blk + 6 * blk_p),
        "eig": (eig.flops, eig.bytes),
        # the factored right-hand side, the geometric Gram and its solve
        "lines": (s * v * (chunks * cfg.rhs_chunk * p * 14 + 60 * p * p)
                  + solve.flops, v * n * 8 + s * v * p * (8 + 5 * 4)
                  + solve.bytes),
    }


def powiter_bf16_peak(v: int, m_values, cfg: KbdmConfig) -> float:
    """The bfloat16 branch's power iterations at their own peaks, as one
    rate: the applies at the tensor cores' bfloat16 peak, the float32 Gram
    and mix products and the Cholesky kernel at the float32 one."""
    s, m, k = len(m_values), max(m_values), cfg.p + cfg.oversample
    it = cfg.subspace_iters
    applies = (1 + it) * 8.0 * m * m * s * k * v
    orth = it * (2 * 8.0 * m * k * k * s * v
                 + bounds.cholqr_rinv(s * v, k).flops)
    return (applies + orth) / (applies / bounds.PEAK_BF16
                               + orth / bounds.PEAK_FLOPS)


def run(voxels: int = 512, reps: int = 5, device="cuda",
        cfg: KbdmConfig = KbdmConfig(p=16), m_values=five_peak.M_VALUES,
        verbose: bool = True) -> list[Stage]:
    """Time every prefix of the sweep on ``voxels`` of the north star's
    noiseless signals (the JAX tool's: frequency jitter, default_rng(0))."""
    sigs, _ = five_peak.signals(voxels, amp_jitter=False)
    c = torch.as_tensor(sigs).to(device, torch.complex64)
    n = c.shape[-1]
    bf16 = bf16_power_iterations(c, cfg)
    model = stage_model(voxels, n, m_values, cfg, bf16)
    peaks = {"powiter": powiter_bf16_peak(voxels, m_values, cfg)} if bf16 else {}
    if verbose:
        print(f"# {device_label(device)}; V={voxels} N={n} S={len(m_values)} "
              f"p={cfg.p} k={cfg.p + cfg.oversample}; power iterations "
              f"{'bfloat16' if bf16 else 'float32'}; host clock around a "
              f"synchronise, median of {reps}", flush=True)
        print(f"{'stage':8s} {'cum ms':>10s} {'marginal':>10s} {'GFLOP':>9s} "
              f"{'GB':>8s} {'bound ms':>9s} {'binds':>10s} {'x bound':>8s}")
    rows, prev = [], 0.0
    for name in STAGES:
        stop = None if name == "lines" else name

        def prefix(stop=stop):
            return scalarize(kbdm_sweep(c, five_peak.DWELL, m_values, cfg,
                                        _stop=stop)).item()

        cum = host_ms(prefix, device, reps).ms
        flops, nbytes = model[name]
        bnd = bounds.bound(flops, nbytes, peaks.get(name, bounds.PEAK_FLOPS))
        row = Stage(name, cum, cum - prev, flops, nbytes, bnd.ms, bnd.by)
        rows.append(row)
        prev = cum
        if verbose:
            print(f"{name:8s} {cum:10.3f} {row.ms:10.3f} {flops / 1e9:9.2f} "
                  f"{nbytes / 1e9:8.3f} {bnd.ms:9.4f} {bnd.by:>10s} "
                  f"{row.ms / bnd.ms if bnd.ms else float('nan'):8.2f}",
                  flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voxels", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("ablate_sweep: needs a CUDA device (or --cpu)", file=sys.stderr)
        return 2
    run(args.voxels, args.reps, "cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
