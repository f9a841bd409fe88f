"""Complex-symmetric Jacobi eigenvalues: CUDA kernel and its plain version.

Counterpart of ``llckbdm_tpu/ops/pallas_jacobi.py`` (``eig_cs``,
``eig_cs_resid``).  The kernel is ``csrc/eig_cs.cu``.  The wrappers send a
CUDA tensor to the kernel and a CPU tensor to :func:`eig_cs_resid_plain`,
which runs the kernel's algorithm in PyTorch: the same round-robin pair order
with its (i, j) orientation, rotations applied one pair at a time, the same
skip rules and guards.  It is the CPU path and the reference the kernel is
held against; it is not a library eigensolver.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# The kernel's size limit (lane t owns columns t and t + 32: two matrices per
# warp up to n = 16, then one); the plain version takes any n.
MAX_N = 64


def _rr_pair(r: int, k: int, n: int) -> tuple[int, int]:
    """Round-robin pairing of slot k in round r (pallas_jacobi._rr_pair)."""
    m = n - 1
    if k == 0:
        return n - 1, r
    return (r + k) % m, (r - k + m) % m


def _prepare(a: torch.Tensor) -> torch.Tensor:
    """(..., n, n) complex64 -> (B, n_even, n_even), odd n zero-padded."""
    if a.dtype != torch.complex64:
        raise TypeError(f"eig_cs: need complex64, got {a.dtype}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2] or a.shape[-1] < 1:
        raise ValueError(f"eig_cs: need (..., n, n), got {tuple(a.shape)}")
    n = a.shape[-1]
    flat = a.reshape(-1, n, n)
    if n % 2:
        flat = F.pad(flat, (0, 1, 0, 1))
    return flat.contiguous()


def _finish(a: torch.Tensor, mu: torch.Tensor, resid: torch.Tensor):
    batch_shape, n = a.shape[:-2], a.shape[-1]
    return mu[:, :n].reshape(*batch_shape, n), resid.reshape(batch_shape)


def _launch(flat: torch.Tensor, sweeps: int):
    batch, n = flat.shape[0], flat.shape[-1]
    mu = torch.empty((batch, n), dtype=torch.complex64, device=flat.device)
    resid = torch.empty((batch,), dtype=torch.float32, device=flat.device)
    lib = _build.library()
    with torch.cuda.device(flat.device):
        err = lib.llck_eig_cs(flat.data_ptr(), mu.data_ptr(), resid.data_ptr(),
                              batch, n, sweeps,
                              torch.cuda.current_stream().cuda_stream)
    _build.check("llck_eig_cs", err)
    _build.LAUNCHES["eig_cs"] += 1
    return mu, resid


def eig_cs_resid(a: torch.Tensor, sweeps: int = 10):
    """Eigenvalues of complex-symmetric a = a^T (NOT Hermitian), batched.

    a : (..., n, n) complex64 (the kernel takes n <= 64).  Returns (mu,
    resid): mu (..., n) complex64 eigenvalues (unordered) and resid (...,)
    float32, the final off-diagonal Frobenius norm of each matrix (the
    convergence counter).
    """
    flat = _prepare(a)
    if _build.use_kernel("eig_cs", flat):
        n = a.shape[-1]
        if n > MAX_N:
            raise ValueError(f"eig_cs: the CUDA kernel takes n <= {MAX_N}, "
                             f"got n={n}; lower KbdmConfig.p")
        if flat.shape[0] >= 2 ** 31:
            raise ValueError("eig_cs: batch too large for one launch")
        mu, resid = _launch(flat, sweeps)
    else:
        mu, resid = _eig_cs_flat(flat, sweeps)
    return _finish(a, mu, resid)


def eig_cs(a: torch.Tensor, sweeps: int = 10) -> torch.Tensor:
    """:func:`eig_cs_resid` without the convergence counter."""
    return eig_cs_resid(a, sweeps)[0]


def eig_cs_resid_plain(a: torch.Tensor, sweeps: int = 10):
    """The plain PyTorch version of the kernel, on any device.  Same
    contract as :func:`eig_cs_resid`."""
    flat = _prepare(a)
    _build.count_plain("eig_cs", flat)
    return _finish(a, *_eig_cs_flat(flat, sweeps))


# --- the kernel's arithmetic, on (B,) complex tensors ----------------------

def _abs(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.real * x.real + x.imag * x.imag)


def _cdiv(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = y.real * y.real + y.imag * y.imag + 1e-38
    return torch.complex((x.real * y.real + x.imag * y.imag) / d,
                         (x.imag * y.real - x.real * y.imag) / d)


def _csqrt(x: torch.Tensor) -> torch.Tensor:
    r = _abs(x)
    re = torch.sqrt(torch.clamp(0.5 * (r + x.real), min=0.0))
    im = torch.sqrt(torch.clamp(0.5 * (r - x.real), min=0.0))
    return torch.complex(re, torch.where(x.imag < 0, -im, im))


def _eig_cs_flat(a: torch.Tensor, sweeps: int):
    """(B, n, n), n even -> (mu (B, n), resid (B,))."""
    s = a.clone()
    n = s.shape[-1]
    one = torch.ones(s.shape[0], dtype=s.dtype, device=s.device)
    zero = torch.zeros_like(one)
    for step in range(sweeps * (n - 1)):
        r = step % (n - 1)
        for k in range(n // 2):
            i, j = _rr_pair(r, k, n)
            av, dv, bv = s[:, i, i], s[:, j, j], s[:, i, j]
            dscale = torch.sqrt(av.real * av.real + av.imag * av.imag
                                + dv.real * dv.real + dv.imag * dv.imag) + 1e-30
            skip = _abs(bv) <= 1e-7 * dscale
            tau = _cdiv(dv - av, 2.0 * bv)
            root = _csqrt(tau * tau + 1.0)
            p1, p2 = tau + root, tau - root
            t = _cdiv(one, torch.where(_abs(p1) >= _abs(p2), p1, p2))
            ct2 = t * t + 1.0
            skip = skip | (_abs(ct2) < 1e-12)
            c = _cdiv(one, _csqrt(ct2))
            sn = c * t
            c = torch.where(skip, one, c)
            sn = torch.where(skip, zero, sn)

            b00 = c * av - sn * bv
            b01 = c * bv - sn * dv
            b10 = sn * av + c * bv
            b11 = sn * bv + c * dv
            nii = c * b00 - sn * b01
            nij = sn * b00 + c * b01
            njj = sn * b10 + c * b11

            ri, rj = s[:, i, :], s[:, j, :]
            ni = c[:, None] * ri - sn[:, None] * rj
            nj = sn[:, None] * ri + c[:, None] * rj
            ni[:, i], ni[:, j] = nii, nij
            nj[:, j], nj[:, i] = njj, nij
            s[:, i, :] = ni
            s[:, j, :] = nj
            s[:, :, i] = ni
            s[:, :, j] = nj
    mu = torch.diagonal(s, dim1=-2, dim2=-1).clone()
    offmask = ~torch.eye(n, dtype=torch.bool, device=s.device)
    off = torch.sum((s.real * s.real + s.imag * s.imag) * offmask, dim=(-2, -1))
    return mu, torch.sqrt(torch.clamp(off, min=0.0))
