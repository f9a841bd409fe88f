"""Batched KBDM solver (counterpart of llckbdm_tpu/solver/kbdm.py).

The same math as the JAX solver's TPU path, on native complex tensors:

* the truncated SVD of the m x m Hankel U0 by randomized subspace iteration,
  each basis orthonormalized by shifted CholeskyQR (on the card one
  hand-written pass over the block as stored, its R^-1 by the cholqr_rinv
  kernel), then a Rayleigh-Ritz Takagi step on the k x k projection (the
  gram_svd kernel);
* the reduced p x p matrix formed without building U1 (Hankel shift
  structure), its eigenvalues by complex-symmetric Jacobi (the eig_cs kernel);
* Vandermonde least-squares amplitudes from the closed-form geometric Gram
  matrix and a factored right-hand side, solved by the shifted Cholesky
  kernel (chol_solve);
* the whole multi-m sweep as one batched pass over one m_max Hankel operator,
  each entry selecting its leading m x m block by row/col masks.

The power iterations run in bfloat16 on a CUDA tensor (the JAX package's
TPU branch, ``KbdmConfig.subspace_bf16``) and in float32 on a CPU tensor
(its CPU branch); every other float32 matmul runs in full float32, or in
TF32 at the JAX package's four ``mxu_precision`` sites when asked.
Everything is fixed-shape and masked: slots beyond the numerical rank
carry mask=0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops import cuda_jacobi, cuda_linalg
from ..ops.hankel import hankel_matrices
from ..ops.linalg import (PRECISIONS, hermitian_solve, matmul_precision,
                          takagi_small)
from ..ops.powers import cpow_fixed, cpowers
from ..signals import LineList
from ..spans import LINES, POWITER, SWEEP, span, spanned


@dataclass(frozen=True)
class KbdmConfig:
    """Solver configuration: the JAX package's fields and defaults, each
    default pinned there by a measured accuracy gate (kbdm.py:47-120).

    ``subspace_bf16`` (default True) runs the power iterations in bfloat16
    where the JAX package does on its accelerator: here on a CUDA tensor
    (``bf16_power_iterations``).  A CPU tensor takes the float32 branch
    whatever its value, as the JAX package does on a CPU.  The bfloat16
    branch is the JAX package's algorithm, and so is its limit: past p=16
    on noisy signals (the north star's, noise 1e-4) its reduced matrices
    stay unconverged in eig_sweeps and the lines are lost, as in the JAX
    package's own accelerator path (ROADMAP.md section 3).  There pass
    ``subspace_bf16=False``: the float32 branch holds to p=56.

    ``mxu_precision`` is "highest" (full float32) or "high" (TF32 on a
    card; see ``ops.linalg.matmul_precision``), and applies where the JAX
    package applies it: the sweep's float32 Hankel applies, its Gram and
    mix products and the reduced matrix's correction row.  The Takagi step,
    the amplitudes and the refinement run at "highest" whatever it says.
    Any other value raises ValueError; the JAX package reads every string
    but "highest" as "high".
    """

    p: int = 24                  # truncation rank / line capacity per run
    oversample: int = 8          # extra subspace dims (k = p + oversample)
    subspace_iters: int = 2      # power iterations
    eigh_sweeps: int = 7         # Jacobi sweeps of gram_svd
    eig_sweeps: int = 10         # Jacobi sweeps of the complex-symmetric eig
    final_orth_passes: int = 2   # CholeskyQR passes for the final basis
    rank_tol: float = 1e-6       # sigma truncation relative to sigma_max
    mu_log_max: float = 30.0     # clamp |mu|^N <= e^this (oracle parity)
    t2_min: float = 0.0          # keep lines with T2 > t2_min
    amp_min: float = 0.0         # keep lines with A >= amp_min
    gram_rcond: float = 1e-7     # Tikhonov shift of the amplitude solve,
                                 # relative to the Gram's mean diagonal
    rhs_chunk: int = 128         # time-axis chunk for the V^H c factoring
    subspace_bf16: bool = True   # bf16 power iterations on a CUDA tensor
    mxu_precision: str = "highest"  # "highest" (float32) or "high" (TF32)
    seed: int = 0                # seed of the Gaussian sketch


def _poles_to_lines(mu: torch.Tensor, keep: torch.Tensor, c: torch.Tensor,
                    dwell: float, n: int, cfg: KbdmConfig) -> LineList:
    """Shared tail of every KBDM variant: poles -> (A, T2, f, phase) list.

    mu   : (..., p) complex64 poles (masked slots are ~0)
    keep : (..., p) bool validity from rank truncation
    c    : (..., n) complex64 signal (for the amplitude RHS), broadcastable
    """
    dt = float(np.float32(dwell))
    mu_abs = torch.abs(mu)
    valid = keep & (mu_abs > 1e-12)

    # clamp |mu| so |mu|^n never overflows (the oracle does the same;
    # clamped poles keep T2 < 0 and are filtered)
    mu_max = float(np.float32(np.exp(cfg.mu_log_max / n)))
    scale = torch.where(mu_abs > mu_max,
                        mu_max / torch.clamp(mu_abs, min=1e-30), 1.0)
    mu = mu * scale
    mu_abs = torch.clamp(mu_abs, max=mu_max)

    freq = torch.angle(mu) / float(np.float32(2.0 * np.pi)) / dt
    log_abs = torch.log(torch.clamp(mu_abs, min=1e-30))
    t2 = -dt / torch.where(torch.abs(log_abs) > 1e-12, log_abs, -1e-12)

    # growing poles (|mu|^n > e) are left out of the amplitude solve: their
    # geometric Gram entries reach ~1e26 and swamp the genuine poles' f32
    # directions; they keep their (f, T2 < 0) and get amplitude 0
    amp_valid = valid & (mu_abs <= float(np.float32(np.exp(1.0 / n))))
    pair_valid = amp_valid[..., :, None] & amp_valid[..., None, :]

    # --- Vandermonde least squares ------------------------------------
    # Gram: G[j, l] = sum_n (conj(mu_j) mu_l)^n = (1 - z^N) / (1 - z)
    z = mu.conj()[..., :, None] * mu[..., None, :]              # (..., p, p)
    zsafe = torch.where(pair_valid, z, 0.0)
    nonzero = torch.abs(zsafe) > 1e-30
    zn = torch.where(nonzero, cpow_fixed(torch.where(nonzero, zsafe, 1.0), n),
                     0.0)
    num = 1.0 - zn
    den = 1.0 - zsafe
    near1 = torch.abs(den) < 1e-6
    den_safe = torch.where(near1, 1.0, den)
    g_ratio = num * den_safe.conj() / (den_safe.real ** 2 + den_safe.imag ** 2)
    g = torch.where(near1, float(n), g_ratio)
    # masked slots: identity row/col so the solve stays well-posed
    eye = torch.eye(mu.shape[-1], dtype=mu.dtype, device=mu.device)
    g = torch.where(pair_valid, g, eye)

    # RHS: b_j = sum_n conj(mu_j)^n c_n, factored over time chunks:
    #   mu^(i*chunk + k) = step^i * base_k  with  step = mu^chunk
    chunk = cfg.rhs_chunk
    n_chunks = (n + chunk - 1) // chunk
    c_pad = torch.nn.functional.pad(c, (0, n_chunks * chunk - n))
    c_resh = c_pad.reshape(*c_pad.shape[:-1], n_chunks, chunk)
    # masked slots use mu = 1 so every power stays finite
    mu_for_pow = torch.where(amp_valid, mu, 1.0)
    base = cpowers(mu_for_pow, chunk)                # (..., p, chunk)
    step = cpow_fixed(mu_for_pow, chunk)             # (..., p)
    # t[j, i] = sum_k conj(base[j, k]) c[i, k]       -> (..., p, n_chunks)
    t = base.conj() @ c_resh.transpose(-1, -2)
    carr = cpowers(step, n_chunks)                   # (..., p, n_chunks)
    b = torch.sum(carr.conj() * t, dim=-1)
    b = torch.where(amp_valid, b, 0.0)

    d = hermitian_solve(g, b, rcond=cfg.gram_rcond)
    amp = torch.abs(d)
    phase = torch.angle(d)

    final = valid & (t2 > cfg.t2_min) & (amp >= cfg.amp_min)
    return LineList(
        amplitude=torch.where(final, amp, 0.0),
        t2=torch.where(final, t2, 1.0),
        frequency=torch.where(final, freq, 0.0),
        phase=torch.where(final, phase, 0.0),
        mask=final.to(torch.float32),
    )


def _gram_sk(a: torch.Tensor, b: torch.Tensor,
             precision: str = "highest") -> torch.Tensor:
    """a^H b contracting m: (..., m, S, j1), (..., m, S, j2) -> (..., S, j1, j2)."""
    with matmul_precision(precision):
        return torch.einsum("...msk,...msl->...skl", a.conj(), b)


def _mix_sk(a: torch.Tensor, w: torch.Tensor,
            precision: str = "highest") -> torch.Tensor:
    """a @ w per sweep entry: (..., m, S, j1) @ (..., S, j1, j2) -> (..., m, S, j2)."""
    with matmul_precision(precision):
        return torch.einsum("...msk,...skl->...msl", a, w)


# LAYOUT: sweep blocks live at (..., m_max, S, k) so every Hankel apply is
# ONE matmul per voxel over (m_max, S*k) columns.
# MEMORY: a (..., m_max, S, k) block is the sweep's unit of memory (3.28 GiB
# at V=2048, S=35, k=24 in complex64).  Each one is freed as soon as its
# last reader is done and masks are applied in place, so that no more than
# the current block, its successor and one einsum's operand copies are
# alive at once.  The arithmetic is that of the out-of-place form,
# operation for operation.

def _apply(h0: torch.Tensor, x: torch.Tensor, mk: torch.Tensor,
           precision: str) -> torch.Tensor:
    """Hankel apply to x (..., m, S, j) -> (..., m, S, j), input and output
    masked by mk (m, S, 1); x may omit the batch dims (the sketch)."""
    # the masked input, contiguous in x's logical layout, so that its
    # flattening is a view (x may be an einsum's permuted output)
    xm = torch.empty(x.shape, dtype=torch.complex64, device=h0.device)
    torch.mul(x, mk, out=xm)
    ns, j = xm.shape[-2:]
    with matmul_precision(precision):
        y = h0 @ xm.reshape(*xm.shape[:-2], ns * j)
    del xm
    return y.reshape(*y.shape[:-1], ns, j).mul_(mk)


def _orth_pass(y: torch.Tensor, shift_rel: float, precision: str = "highest",
               conj: bool = False) -> torch.Tensor:
    """One shifted CholeskyQR pass over the k columns of every (m, S) block
    of y, with a diagonal shift of shift_rel times the Gram's mean
    diagonal, in y's storage: complex64 (..., m, S, k) or bfloat16 real
    pairs (..., 2m, S, k); the result's conjugate where ``conj``.  On a
    CUDA tensor at "highest" the hand-written pass (``cuda_linalg.
    orth_pass``: the block read and written as stored); else the JAX
    package's einsums at ``precision``, a pair block widened to complex64
    and the result rounded back.  The caller rebinds its name to the
    result, which frees the input."""
    if y.is_cuda and precision == "highest":
        return cuda_linalg.orth_pass(y, shift_rel, conj)
    pairs = y.dtype == torch.bfloat16
    q = cuda_linalg.from_pairs(y) if pairs else y
    g = _gram_sk(q, q, precision)
    g = 0.5 * (g + g.transpose(-1, -2).conj())
    shift = shift_rel * torch.mean(
        torch.abs(torch.diagonal(g, dim1=-2, dim2=-1).real), dim=-1)
    q = _mix_sk(q, cuda_linalg.cholqr_rinv(g, shift), precision)
    if conj:
        q = q.conj()
    return cuda_linalg.to_pairs(q) if pairs else q.resolve_conj()


# Power iterations take one CholeskyQR pass each: the basis only has to
# span the dominant subspace, so a bounded condition number suffices.
# Their blocks are numerically rank-deficient (a few lines in a k-wide
# block), and at the final passes' 3e-6 shift, which the JAX package's
# float32 TPU branch uses here too (llckbdm_tpu/solver/kbdm.py:345-348),
# the float32 Cholesky's rounding (~k eps |G|) drives pivots negative and
# the block to NaN on 74 of 2048 north-star voxels on an H100 (one or two
# sweep entries each; chip_smoke.py's f32_shift_record).  On a CPU none of
# the 74 breaks down, in the port or in the JAX package's float32 TPU
# branch (tests/test_torch_precision.py, slow): the card's float32 sums,
# not the algorithm.  The float32 branch takes the 1e-4 shift of the JAX
# package's bf16 branch (:390).
F32_POWITER_SHIFT = 1e-4
# the bf16 branch's shift: bf16 Gram noise is ~1e-2 relative (JAX :389-390)
BF16_POWITER_SHIFT = 1e-4
FINAL_SHIFT = 3e-6


def bf16_power_iterations(c: torch.Tensor, cfg: "KbdmConfig") -> bool:
    """Whether the sweep of signal ``c`` runs its power iterations in
    bfloat16: ``cfg.subspace_bf16`` on a CUDA tensor.  The counterpart of
    the JAX package's ``cfg.subspace_bf16 and jacobi._tpu_backend()``
    (kbdm.py:354): the card plays the TPU's part, and a CPU tensor takes
    the float32 branch, as the JAX package does on its CPU."""
    return cfg.subspace_bf16 and c.is_cuda


def _power_iterations_f32(h0, x0, mk, cfg) -> torch.Tensor:
    """The float32 branch: the sketch's apply, then per iteration one
    CholeskyQR pass and the apply of the conjugate basis, every product at
    cfg.mxu_precision.  Returns the last (..., m, S, k) complex64 block."""
    prec = cfg.mxu_precision
    y = _apply(h0, x0.to(torch.complex64), mk, prec)
    for _ in range(cfg.subspace_iters):
        y = _orth_pass(y, F32_POWITER_SHIFT, prec)
        y = _apply(h0, y.conj(), mk, prec)
    return y


def _power_iterations_bf16(h0, x0, mk, cfg) -> torch.Tensor:
    """The bfloat16 branch (the JAX package's kbdm.py:354-410): bfloat16
    storage of the blocks and of the Hankel operator, products with float32
    accumulation.  torch has no complex bfloat16, so a block is stored as
    real pairs (..., 2m, S, k), real parts over imaginary ones, and the
    operator as the real (2m, 2m) block [[Re, -Im], [Im, Re]]: one bfloat16
    GEMM per apply, accumulated in float32 and rounded to bfloat16 once,
    as the JAX program's ``(mmf(re, re) - mmf(im, im)).astype(bf16)``.
    Each CholeskyQR pass (``_orth_pass`` on the pairs) forms the Gram in
    float32 from the pairs widened exactly (exact products of bfloat16
    values, float32 sums), with the 1e-4 shift, R^-1 by the cholqr_rinv
    kernel, and the product with R^-1 in float32, rounded to bfloat16 once
    (the JAX program states it in float32: bf16 times float32 promotes; the
    TPU ran it as one bfloat16 pass).  Always at "highest", whatever
    cfg.mxu_precision says, as in the JAX package.  Returns the last block
    upcast to complex64."""
    m = h0.shape[-1]
    ns, bf = mk.shape[1], torch.bfloat16
    op = torch.empty((*h0.shape[:-2], 2 * m, 2 * m), dtype=bf,
                     device=h0.device)
    op[..., :m, :m].copy_(h0.real)
    op[..., :m, m:].copy_(h0.imag).neg_()
    op[..., m:, :m].copy_(h0.imag)
    op[..., m:, m:].copy_(h0.real)
    # the mask on both halves of an apply's output
    mk2 = torch.cat([mk, mk]).to(bf)

    def apply(xb):
        """op xb, masked; xb already masked (and conjugated where it is a
        pass's result): a product with the conjugate's mask [mk, -mk]
        would leave each of its bits as it is (its rows past m are
        zeros)."""
        j = xb.shape[-1]
        y = op @ xb.reshape(*xb.shape[:-2], ns * j)
        return y.reshape(*y.shape[:-1], ns, j).mul_(mk2)

    # the sketch is masked already (x0 = omega mk)
    x0b = torch.cat([x0, torch.zeros_like(x0)]).to(bf)
    yb = apply(x0b)
    del x0b
    for _ in range(cfg.subspace_iters):
        qb = _orth_pass(yb, BF16_POWITER_SHIFT, conj=True)
        del yb
        yb = apply(qb)
        del qb
    del op
    return cuda_linalg.from_pairs(yb)


@matmul_precision()
@spanned(SWEEP)
def kbdm_sweep(c: torch.Tensor, dwell: float, m_values: Sequence[int],
               cfg: KbdmConfig, with_diag: bool = False,
               _stop: str | None = None, omega: torch.Tensor | None = None):
    """Batched multi-m KBDM: c (..., N) complex64 -> LineList (..., S, p).

    One batched pass for the whole sweep: the m_max Hankel operator is
    materialized once; each sweep entry applies row/col masks selecting its
    leading m x m block.  The power iterations run in bfloat16 where
    ``bf16_power_iterations(c, cfg)`` says so (cfg.subspace_bf16 on a CUDA
    tensor), else in float32; the final CholeskyQR2 basis and everything
    after it run in float32 on either branch.

    with_diag=True additionally returns a dict with ``eig_offdiag_rel``
    (..., S): the final Jacobi off-diagonal Frobenius norm of each reduced
    matrix relative to its own Frobenius norm (the convergence counter).

    omega: the (m_max, k) float32 Gaussian sketch.  When absent it is drawn
    on the host from ``torch.Generator().manual_seed(cfg.seed)`` and copied
    to c's device, so one seed gives one sketch on every device (a CUDA
    generator draws other numbers from the same seed).

    _stop: profiling hook — return the named intermediate ("hankel" |
    "powiter" | "basis" | "m_small" | "takagi" | "reduced" | "eig") instead
    of the line list.  "powiter" is the last power iteration's block as
    complex64 on either branch.
    """
    if cfg.mxu_precision not in PRECISIONS:
        raise ValueError(f"mxu_precision={cfg.mxu_precision!r}: only "
                         f"{' or '.join(map(repr, PRECISIONS))}")
    if c.dtype != torch.complex64:
        raise TypeError(f"kbdm_sweep: need a complex64 signal, got {c.dtype}")
    m_values = tuple(int(m) for m in m_values)
    m_max = max(m_values)
    n = c.shape[-1]
    if n < 2 * m_max:
        raise ValueError(f"need N >= 2*m_max: N={n}, m_max={m_max}")
    p, k = cfg.p, cfg.p + cfg.oversample
    ns = len(m_values)
    dev = c.device
    prec = cfg.mxu_precision

    h0 = hankel_matrices(c, m_max)            # (..., m_max, m_max)
    if _stop == "hankel":
        return h0
    masks = np.zeros((m_max, ns), np.float32)
    for s, m in enumerate(m_values):
        masks[:m, s] = 1.0
    mk = torch.as_tensor(masks, device=dev)[:, :, None]    # (m_max, S, 1)

    if omega is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        omega = torch.randn((m_max, k), generator=gen,
                            dtype=torch.float32).to(dev)
    if omega.shape != (m_max, k):
        raise ValueError(f"omega: need shape {(m_max, k)}, got "
                         f"{tuple(omega.shape)}")

    x0 = omega[:, None, :] * mk               # (m, S, k) float32
    powiter = (_power_iterations_bf16 if bf16_power_iterations(c, cfg)
               else _power_iterations_f32)
    with span(POWITER):
        y = powiter(h0, x0, mk, cfg)          # (..., m, S, k) complex64
    del x0
    if _stop == "powiter":
        return y
    q = y
    del y
    for _ in range(cfg.final_orth_passes):
        q = _orth_pass(q, FINAL_SHIFT, prec)
    if _stop == "basis":
        return q

    # Rayleigh-Ritz Takagi on the k x k projected Hankel
    t0 = _apply(h0, q.conj(), mk, prec)       # (..., m, S, k)
    m_small = _gram_sk(q, t0, prec)           # (..., S, k, k)
    m_small = 0.5 * (m_small + m_small.transpose(-1, -2))
    if _stop == "m_small":
        return m_small
    w, sig = takagi_small(m_small, sweeps=cfg.eigh_sweeps)
    if _stop == "takagi":
        return w, sig
    w_p = w[..., :p]
    u_p = _mix_sk(q, w_p, prec)               # (..., m, S, p)
    del q
    sig_p = sig[..., :p]                      # (..., S, p)
    keep_s = sig_p > sig[..., :1] * cfg.rank_tol
    s_isq = torch.where(keep_s, torch.rsqrt(torch.clamp(sig_p, min=1e-30)), 0.0)

    # reduced matrix  U~ = S^-1/2 U_p^H U1 conj(U_p) S^-1/2 without U1: per
    # sweep entry s with order m_s,
    #   (U1 x)_i = (U0 x)_{i+1}  for i <= m_s - 2,
    #   (U1 x)_{m_s-1} = sum_{j<m_s} c[m_s+j] x_j  (one new row),
    # and U0 conj(u_p) = t0 conj(w_p) already exists.
    t0w = _mix_sk(t0, w_p.conj(), prec)       # = U0 conj(u_p)
    del t0
    t = torch.nn.functional.pad(t0w[..., 1:, :, :], (0, 0, 0, 0, 0, 1))
    del t0w
    idx = np.empty((m_max, ns), np.int64)
    for s_i, m_s in enumerate(m_values):
        idx[:, s_i] = np.minimum(m_s + np.arange(m_max), n - 1)
    cshift = c[..., torch.as_tensor(idx, device=dev)] * mk[..., 0]
    with matmul_precision(prec):
        corr = torch.einsum("...ms,...msp->...sp", cshift, u_p.conj())
    row_sel = np.zeros((m_max, ns, 1), np.float32)
    for s_i, m_s in enumerate(m_values):
        row_sel[m_s - 1, s_i, 0] = 1.0
    rs = torch.as_tensor(row_sel, device=dev)
    t.mul_(mk).add_(rs * corr[..., None, :, :])
    ut = _gram_sk(u_p, t, prec)               # (..., S, p, p)
    ut = ut * (s_isq[..., :, None] * s_isq[..., None, :])
    ut = 0.5 * (ut + ut.transpose(-1, -2))
    if _stop == "reduced":
        return ut
    mu_s, eig_resid = cuda_jacobi.eig_cs_resid(ut, sweeps=cfg.eig_sweeps)
    if _stop == "eig":
        return mu_s

    with span(LINES):
        lines = _poles_to_lines(mu_s, keep_s, c[..., None, :], dwell, n, cfg)
    if with_diag:
        fro = torch.sqrt(torch.sum(ut.real ** 2 + ut.imag ** 2, dim=(-1, -2)))
        return lines, {"eig_offdiag_rel": eig_resid / torch.clamp(fro, min=1e-30)}
    return lines


def kbdm_fit(c: torch.Tensor, dwell: float, m: int, cfg: KbdmConfig,
             omega: torch.Tensor | None = None) -> LineList:
    """Single-m KBDM fit: c (..., N) -> LineList (..., p).

    Oracle counterpart: oracle.reference.kbdm(data, dwell, m, p).
    """
    lines = kbdm_sweep(c, dwell, (m,), cfg, omega=omega)
    return LineList(*(x[..., 0, :] for x in lines))
