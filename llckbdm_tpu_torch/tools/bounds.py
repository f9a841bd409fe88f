"""The least time an NVIDIA H100 SXM could take for each kernel's work.

For each of the six kernels, the floating-point operations and the device
memory bytes of one call, from its shapes and sweep counts: each input read
once, each output written once, whatever the kernel reads again.  The bound
is the larger of operations over the float32 peak outside the tensor cores
and bytes over the memory rate, at the card's full 700 W (the published
peaks of the H100 SXM data sheet), and ``by`` says which of the two binds.

Operation counts, real flops (a complex multiply-add is 8):

* eig_cs: per rotation 28n for the two rotated rows (lane-parallel) and
  ~200 for the rotation parameters and the 2x2 entry fix; sweeps (n-1) n/2
  rotations per matrix, and 3n^2 for the off-diagonal counter.
* gram_svd: per pair step 16k for the four pairwise Gram sums, 36k for the
  rotation of two rows of F^T and two of V^T, and ~32 for the parameters;
  sweeps (k-1) k/2 pair steps per matrix, and 4k^2 for the final norms.
* cholqr_rinv: the Cholesky factor (4k^3/3) and the triangular inverse
  (4k^3/3).
* chol_solve: the Cholesky factor (4k^3/3) and two triangular solves (8k^2
  each).
* row_probe: per step 6n for the two rows and 3 for (c, s).
* eigh_probe: per pair ~25 for the coefficients, 18n for the two rows of S
  and 18n for the two of V (each only in the variants that rotate them),
  and 8n^2 for the two norms.
* gn_normal, per voxel of C slots and N samples, as the kernel computes:
  in float64 the powers (one complex multiply a (k, n) from anchors 64
  samples apart, each ~2 log2 N multiplies), the model 8CN, the residual
  2N and the rhs sums 12CN; in float32 the three Hermitian moments, 16
  flops a (k <= l, n), and the scaling of G's blocks 24C^2.  The bound is
  the largest of the float32 operations at the float32 peak, the float64
  ones at the float64 peak and the bytes.
* orth_pass, the sweep's CholeskyQR pass over one (m, k) block: its Gram's
  Hermitian half, 8 flops a (j <= l, row), the Cholesky factor and its
  triangular inverse (cholqr_rinv's 8k^3/3) and the product with the
  upper-triangular R^-1, 8 flops a (j <= l, row).  Its bytes are the block
  read once and its result written once, in the block's storage (complex64
  or bfloat16 pairs): G, the shift and R^-1 are a pass's own intermediates,
  and the kernels reading the block twice is their cost, not the work's.

The two Cholesky kernels are compiled at a few sizes (cholqr_rinv 16, 24,
32, 64; chol_solve 16, 32, 48, 64) and run any other k padded up inside
the kernel;
the counts here are those of the caller's k, since the padding is the
implementation's cost and not the work's.

Pure arithmetic on shapes: runs on any machine.
"""
from __future__ import annotations

import math
from typing import NamedTuple

PEAK_FLOPS = 67e12      # float32 outside the tensor cores, H100 SXM
PEAK_BF16 = 989e12      # dense bfloat16 on the tensor cores, H100 SXM
PEAK_F64 = 34e12        # float64 outside the tensor cores, H100 SXM
PEAK_BYTES = 3.35e12    # HBM3, H100 SXM
C64, F32, I32, C128 = 8, 4, 4, 16  # bytes per element


class Bound(NamedTuple):
    flops: float
    bytes: float
    ms: float           # max(flops / PEAK_FLOPS, bytes / PEAK_BYTES) in ms
    by: str             # "operations" or "bytes": the term that binds
                        # (gn_normal: also "float64 operations")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> Bound:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return Bound(float(flops), float(nbytes), 1e3 * max(t_ops, t_bytes), by)


def _rounds(n: int, sweeps: int) -> int:
    """Pair steps per matrix: sweeps rounds of n - 1, each of n/2 pairs."""
    return sweeps * (n - 1) * (n // 2)


def eig_cs(batch: int, n: int, sweeps: int) -> Bound:
    """(batch, n, n) complex64 in; mu (batch, n) complex64 and the counter
    (batch,) float32 out."""
    flops = batch * (_rounds(n, sweeps) * (28 * n + 200) + 3 * n * n)
    return bound(flops, batch * (n * n * C64 + n * C64 + F32))


def gram_svd(batch: int, k: int, sweeps: int) -> Bound:
    """(batch, k, k) complex64 in; s (batch, k) float32 and V (batch, k, k)
    complex64 out."""
    flops = batch * (_rounds(k, sweeps) * (52 * k + 32) + 4 * k * k)
    return bound(flops, batch * (2 * k * k * C64 + k * F32))


def cholqr_rinv(batch: int, k: int) -> Bound:
    """G (batch, k, k) complex64 and the shift (batch,) in; R^-1 out."""
    return bound(batch * 8 * k ** 3 / 3, batch * (2 * k * k * C64 + F32))


def chol_solve(batch: int, k: int) -> Bound:
    """G (batch, k, k), b (batch, k) and the shift (batch,) in; x out."""
    flops = batch * (4 * k ** 3 / 3 + 16 * k * k)
    return bound(flops, batch * (k * k * C64 + 2 * k * C64 + F32))


def row_probe(batch: int, n: int, steps: int) -> Bound:
    """(batch, n, n) float32 and a (steps, 2) int32 schedule in; (batch, n,
    n) float32 out."""
    return bound(batch * steps * (6 * n + 3),
                 batch * 2 * n * n * F32 + steps * 2 * I32)


def eigh_probe(batch: int, n: int, sweeps: int, do_rows: bool = True,
               do_v: bool = True) -> Bound:
    """(batch, n, n) complex64 in; w (batch, n) and three checksums (batch,
    3) float32 out."""
    per_pair = 25 + (18 * n if do_rows else 0) + (18 * n if do_rows and do_v
                                                  else 0)
    flops = batch * (_rounds(n, sweeps) * per_pair + 8 * n * n)
    return bound(flops, batch * (n * n * C64 + n * F32 + 3 * F32))


def gn_normal(batch: int, c: int, n: int) -> Bound:
    """c (batch, n), z and d (batch, c) complex128 in; G (batch, 2c, 2c)
    complex64 and the rhs (batch, 2c) complex128 out.  ``flops`` is the float32 and float64 operations
    together."""
    bits = max(1, math.ceil(math.log2(max(n, 2))))
    anchors = -(-n // 64) * 2 * bits
    f64 = batch * (6 * c * (n + anchors) + 8 * c * n + 2 * n + 12 * c * n)
    f32 = batch * (16 * c * (c + 1) // 2 * n + 24 * c * c)
    nbytes = batch * (n * C128 + 2 * c * C128 + 4 * c * c * C64
                      + 2 * c * C128)
    t32, t64, tb = f32 / PEAK_FLOPS, f64 / PEAK_F64, nbytes / PEAK_BYTES
    by = max((t32, "operations"), (t64, "float64 operations"),
             (tb, "bytes"))[1]
    return Bound(float(f32 + f64), float(nbytes), 1e3 * max(t32, t64, tb), by)


ORTH_STORAGE = {"complex64": C64, "bf16": 2 * 2}  # bytes an entry


def orth_pass(batch: int, m: int, k: int, storage: str) -> Bound:
    """batch (m, k) blocks in ``storage`` ("complex64", or "bf16": bfloat16
    real pairs) in; the orthonormalized blocks out, in the same storage."""
    if storage not in ORTH_STORAGE:
        raise ValueError(f"orth_pass: storage {storage!r}, not one of "
                         f"{sorted(ORTH_STORAGE)}")
    half = k * (k + 1) // 2
    flops = batch * (2 * 8 * half * m + 8 * k ** 3 / 3)
    return bound(flops, batch * 2 * m * k * ORTH_STORAGE[storage])
