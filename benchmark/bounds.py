"""The least time an NVIDIA H100 SXM could take for the kernels whose
roofline the benchmark reads: a frozen copy of the counts of
``llckbdm_tpu_torch/tools/bounds.py`` (``benchmark/tests/
test_benchmark_frozen.py`` holds them equal).

For each kernel, the floating-point operations and the device memory bytes
of one call, from its shapes and sweep counts: each input read once, each
output written once, whatever the kernel reads again.  The bound is the
larger of operations over the float32 peak outside the tensor cores and
bytes over the memory rate, at the card's full 700 W (the published peaks
of the H100 SXM data sheet), and ``by`` says which of the two binds.

Operation counts, real flops (a complex multiply-add is 8):

* eig_cs: per rotation 28n for the two rotated rows and ~200 for the
  rotation parameters and the 2x2 entry fix; sweeps (n-1) n/2 rotations
  per matrix, and 3n^2 for the off-diagonal counter.
* gram_svd: per pair step 16k for the four pairwise Gram sums, 36k for the
  rotation of two rows of F^T and two of V^T, and ~32 for the parameters;
  sweeps (k-1) k/2 pair steps per matrix, and 4k^2 for the final norms.

The kernels run a fixed number of sweeps, so the configured sweeps are the
work these inputs need.
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = 67e12      # float32 outside the tensor cores, H100 SXM
PEAK_BYTES = 3.35e12    # HBM3, H100 SXM
C64, F32 = 8, 4         # bytes per element


class Bound(NamedTuple):
    flops: float
    bytes: float
    ms: float           # max(flops / PEAK_FLOPS, bytes / PEAK_BYTES) in ms
    by: str             # "operations" or "bytes": the term that binds


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
