"""Takagi factorization and the Tikhonov-Cholesky Hermitian solve.

Counterpart of the TPU branches of llckbdm_tpu/ops/linalg.py: Takagi on the
one-sided Jacobi SVD kernel (ops.cuda_linalg.gram_svd) plus the phase fix,
and the Hermitian solve by the shifted Cholesky kernel
(ops.cuda_linalg.chol_solve).  The eigh-based CPU formulations of the JAX
package are not ported: the port runs the TPU algorithm on every device.
"""
from __future__ import annotations

import contextlib

import torch

from . import cuda_linalg


PRECISIONS = ("highest", "high")


@contextlib.contextmanager
def matmul_precision(precision: str = "highest"):
    """Run float32 matmuls inside the block at ``precision``, the
    counterpart of the JAX package's ``jax.lax.Precision`` at its sites:

    * "highest": full float32, no TF32 (``Precision.HIGHEST``);
    * "high": torch's "high", TF32 on an H100's tensor cores
      (``Precision.HIGH``).  JAX documents HIGH as "3 bfloat16 passes, or
      tensorfloat32 where available": on an NVIDIA GPU it is TF32, and
      torch's "high" makes the same promise.  On a CPU both compute in
      float32.

    Any other value raises ValueError (the JAX package reads every string
    but "highest" as HIGH).  Inside the block bfloat16 products also reduce
    in float32 (no reduced-precision split-K reduction in cuBLAS), as the
    JAX package's ``preferred_element_type=float32`` asks.

    It sets ``torch.set_float32_matmul_precision`` and cuBLAS's bfloat16
    reduction switch, process-wide settings, and restores the previous
    values on exit: for as long as the block runs, every thread of the
    process sees them, and a thread that changes them meanwhile changes
    them for the block too.  The port starts no thread of its own; a caller
    that runs it beside its own TF32 work in another thread shares the one
    setting."""
    if precision not in PRECISIONS:
        raise ValueError(f"matmul precision {precision!r}: only "
                         f"{' or '.join(map(repr, PRECISIONS))}")
    bf16 = torch.backends.cuda.matmul
    prev = torch.get_float32_matmul_precision()
    prev_bf16 = bf16.allow_bf16_reduced_precision_reduction
    torch.set_float32_matmul_precision(precision)
    bf16.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        bf16.allow_bf16_reduced_precision_reduction = prev_bf16


def takagi_small(m: torch.Tensor, sweeps: int = 8):
    """Takagi factorization of complex-symmetric m (..., k, k), complex64.

    Returns (w, s): unitary w (..., k, k) and singular values s (..., k)
    sorted descending with m ~= w diag(s) w^T.  The singular vectors u of
    m m^H come from gram_svd; for each simple singular value m conj(u) = t u
    with |t| = s, and rotating u by exp(i angle(t) / 2) makes t real
    positive, which is the Takagi condition.
    """
    s, u = cuda_linalg.gram_svd(m, sweeps=sweeps)
    # t_k = u_k^H m conj(u_k)
    t = torch.sum(u.conj() * (m @ u.conj()), dim=-2)
    phase = torch.polar(torch.ones_like(s), 0.5 * torch.angle(t))
    return u * phase[..., None, :], s


def hermitian_solve(h: torch.Tensor, b: torch.Tensor, ridge=0.0,
                    rcond: float = 1e-12) -> torch.Tensor:
    """Solve (h + shift I) x = b for Hermitian PSD h (..., k, k), b (..., k).

    shift = ridge + rcond * mean|diag(h)|: a Tikhonov shift that keeps the
    solve bounded for near-singular h (e.g. duplicate poles).  ridge may be
    a float or a tensor broadcastable to the batch shape, possibly with a
    trailing singleton axis.
    """
    hsym = 0.5 * (h + h.transpose(-1, -2).conj())
    r = torch.as_tensor(ridge, dtype=torch.float32, device=h.device)
    if r.ndim == b.ndim:                 # (..., 1)-shaped relative ridge
        r = r[..., 0]
    mean_diag = torch.mean(torch.abs(torch.diagonal(hsym, dim1=-2, dim2=-1).real),
                           dim=-1)
    return cuda_linalg.chol_solve(hsym, b, r + rcond * mean_diag)
