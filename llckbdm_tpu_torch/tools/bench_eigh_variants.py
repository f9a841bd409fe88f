"""Per-pair costs of the Hermitian Jacobi cost probe (``csrc/eigh_probe.cu``)
on one NVIDIA GPU.  Counterpart of ``tools/bench_eigh_variants.py``.

    python -m llckbdm_tpu_torch.tools.bench_eigh_variants

The same inputs (n=24, 4480 matrices, seeds 0 and 1, symmetric real and
antisymmetric imaginary parts) and the same six runs: coefficients only,
+ rows, + column writes, full, one sweep, and a second matrices-per-block
value; then rows + V, the one switch setting those runs leave out.  The inputs are made as the TPU tool made them, padded to a multiple
of 512 matrices, and the first 4480 are kept: the kernel needs no padding.
Each run checks the probe's invariants (|V|_F = |A|_F, and |S|_F = |A|_F
unless columns are written) and finite w, and prints milliseconds per launch
(``tools.timing.cuda_ms``).  Needs CUDA; exits with 2 when there is none.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..convert import batch_from_lanes
from ..ops.cuda_probes import EIGH_VARIANTS, PER_BLOCK, EighProbe, eigh_probe
from .timing import Timing, cuda_ms

N, BATCH, SWEEPS, PAD = 24, 4480, 8, 512
INVARIANT_TOL = 1e-5

# the TPU tool's six runs, by name (its b_blk=256 run becomes per_block=2),
# and rows + V
RUNS = {
    **{name: EIGH_VARIANTS[name] for name in ("coef", "rows", "rows+cols", "full")},
    "full sweeps=1": dict(sweeps=1),                  # fixed overhead probe
    "full per_block=2": dict(per_block=2),
    "rows+v": EIGH_VARIANTS["rows+v"],                # not among the TPU tool's
}


def make_inputs(n: int = N, batch: int = BATCH, device=None) -> torch.Tensor:
    """The TPU tool's inputs as (batch, n, n) complex64: real part a + a^T
    (seed 0), imaginary part b - b^T (seed 1), drawn in the lane layout
    (n, n, batch padded to a multiple of 512)."""
    bpad = -(-batch // PAD) * PAD
    a = np.random.default_rng(0).standard_normal((n, n, bpad)).astype(np.float32)
    a = a + np.swapaxes(a, 0, 1)
    ai = np.random.default_rng(1).standard_normal((n, n, bpad)).astype(np.float32)
    ai = ai - np.swapaxes(ai, 0, 1)
    z = a.astype(np.complex64)
    z.imag = ai
    return batch_from_lanes(z[..., :batch], device)


def make_block_diagonal(n: int, batch: int, device=None) -> torch.Tensor:
    """(batch, n, n) complex64 Hermitian matrices of Gaussian (seed 2) 4 x 4
    diagonal blocks, for elementwise checks at any width: the round-robin
    pairs that cross blocks read b = 0 and skip, and no step fills a
    cross-block entry, so one sweep takes each block through only its own
    6 pair steps, too few for the chain to grow float32 rounding
    differences past 1e-5 (one sweep at n = 40 on dense inputs does)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((batch, n, n))
         + 1j * rng.standard_normal((batch, n, n)))
    blk = np.arange(n) // 4
    a = (x + np.conj(np.swapaxes(x, 1, 2))) * (blk[:, None] == blk[None, :])
    return torch.from_numpy(a.astype(np.complex64)).to(device)


def invariant_errors(a: torch.Tensor, out: EighProbe, do_rows: bool,
                     do_cols: bool) -> dict:
    """max |norm / |A|_F - 1| of the norms the probe keeps: |V|_F always
    (each row step is unitary, and V = A without do_v), |S|_F unless the
    columns were written."""
    fro = torch.linalg.matrix_norm(a.to(torch.complex128))
    errs = {"v": (out.v_norm.double() / fro - 1).abs().max().item()}
    if not (do_rows and do_cols):
        errs["s"] = (out.s_norm.double() / fro - 1).abs().max().item()
    return errs


def run(n: int = N, batch: int = BATCH, sweeps: int = SWEEPS,
        per_block: int = PER_BLOCK, do_rows: bool = True, do_cols: bool = True,
        do_v: bool = True) -> Timing:
    """One run on the GPU: check, then time the kernel.  Raises on a failed
    check."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_eigh_variants: needs a CUDA device")
    a = make_inputs(n, batch, "cuda")

    def probe():
        return eigh_probe(a, sweeps, do_rows, do_cols, do_v, per_block)

    out = probe()
    errs = invariant_errors(a, out, do_rows, do_cols)
    finite = bool(torch.isfinite(out.w).all())
    switches = f"do_rows={do_rows} do_cols={do_cols} do_v={do_v}"
    if not (finite and max(errs.values()) <= INVARIANT_TOL):
        raise RuntimeError(f"eigh_probe {switches}: finite w {finite}, "
                           f"invariants {errs}")
    t = cuda_ms(probe)
    print(f"n={n} batch={batch} sweeps={sweeps} per_block={per_block} "
          f"{switches}: {t}; invariants {errs}", flush=True)
    return t


def run_all() -> dict[str, Timing]:
    """The seven runs of :data:`RUNS`, in order."""
    return {name: run(**kw) for name, kw in RUNS.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_eigh_variants: needs a CUDA device", file=sys.stderr)
        return 2
    run_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
