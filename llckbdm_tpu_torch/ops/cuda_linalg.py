"""Small batched dense linear algebra: CUDA kernels and their plain versions.

Counterpart of ``llckbdm_tpu/ops/pallas_linalg.py``:

* :func:`gram_svd`    — one-sided Jacobi SVD of F = m^H (``csrc/gram_svd.cu``);
* :func:`cholqr_rinv` — R^{-1} of the shifted Cholesky G + shift I = R^H R
                        (``csrc/chol.cu``);
* :func:`chol_solve`  — (G + shift I) x = b by the same Cholesky
                        (``csrc/chol.cu``);
* :func:`gn_normal`   — the Gauss-Newton normal equations of one exact
                        refine step (``csrc/gn_normal.cu``), which no TPU
                        kernel has: the JAX package leaves them to XLA;
* :func:`orth_pass`   — the sweep's shifted CholeskyQR pass over a block as
                        stored, complex64 or bfloat16 pairs: its Gram
                        (:func:`orth_gram`) and mix (:func:`orth_mix`) in
                        ``csrc/orth_pass.cu`` around :func:`cholqr_rinv`;
                        no TPU kernel either (XLA's einsums there).

Each wrapper sends a CUDA tensor to its kernel and a CPU tensor to its plain
version (``*_plain``), which runs the kernel's algorithm in PyTorch — the
same pair order and skip rules, the same pivot guards — and is the reference
the kernel is held against.  None of them is a ``torch.linalg`` routine.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .cuda_jacobi import _rr_pair
from .powers import cpow_fixed, cpowers

# The kernels' size limits (the JAX package's kernels stop at 64 too, where
# their smallest block fills a v5e's default scoped VMEM); the plain versions
# take any size.
MAX_K = 64        # gram_svd: two lanes a pair, two warps at k > 32;
                  # cholqr_rinv: two columns a lane, four warps at k > 32
MAX_K_SOLVE = 64  # chol_solve: two columns a lane, four warps at k > 32
MAX_C_NORMAL = 32  # gn_normal: slots, as far as the refine's chol_solve
# What a caller lowers to stay inside a kernel's limit.
_FIELD = {"gram_svd": "KbdmConfig.p + oversample",
          "cholqr_rinv": "KbdmConfig.p + oversample",
          "orth_pass": "KbdmConfig.p + oversample",
          "chol_solve": "the number of refined clusters C (2C <= 64), or "
                        "KbdmConfig.p",
          "gn_normal": "the number of refined clusters C"}


def _check_square(name: str, g: torch.Tensor) -> int:
    """The dtype and shape every version needs; returns k."""
    if g.dtype != torch.complex64:
        raise TypeError(f"{name}: need complex64, got {g.dtype}")
    if g.ndim < 2 or g.shape[-1] != g.shape[-2] or g.shape[-1] < 1:
        raise ValueError(f"{name}: need (..., k, k), got {tuple(g.shape)}")
    return g.shape[-1]


def _launchable(name: str, flat: torch.Tensor, k: int, max_k: int) -> bool:
    """True where ``flat`` goes to the kernel (a CUDA tensor), after checking
    that the kernel takes its size; a CPU tensor takes the plain version at
    any size."""
    if not _build.use_kernel(name, flat):
        return False
    if k > max_k:
        raise ValueError(f"{name}: the CUDA kernel takes k <= {max_k}, got "
                         f"k={k}; lower {_FIELD[name]}")
    if flat.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: batch too large for one launch")
    return True


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# One-sided Jacobi SVD of F = m^H
# ---------------------------------------------------------------------------

def _gram_svd_prepare(m: torch.Tensor):
    kk = _check_square("gram_svd", m)
    flat = m.reshape(-1, kk, kk)
    if kk % 2:
        flat = F.pad(flat, (0, 1, 0, 1))
    return flat.contiguous(), kk


def _gram_svd_finish(m, sig, vt, kk):
    """Stable descending sort of s and of V's columns (the TPU wrapper's
    one-hot rank with index tie-break), then drop the odd-size padding."""
    order = torch.sort(sig, dim=-1, descending=True, stable=True).indices
    sig = torch.gather(sig, -1, order)[:, :kk]
    v = vt.transpose(-1, -2)                       # v[b, r, c] = vt[b, c, r]
    v = torch.gather(v, -1, order[:, None, :].expand_as(v))[:, :kk, :kk]
    batch_shape = m.shape[:-2]
    return sig.reshape(*batch_shape, kk), v.reshape(*batch_shape, kk, kk)


def gram_svd(m: torch.Tensor, sweeps: int = 10):
    """Eigendecomposition of m m^H via one-sided Jacobi on F = m^H.

    m : (..., k, k) complex64 (the kernel takes k <= 64).  Returns (s, v):
    singular values of m (..., k) float32 sorted descending and unitary v
    (..., k, k) complex64 with m m^H ~= v diag(s^2) v^H.
    """
    flat, kk = _gram_svd_prepare(m)
    if _launchable("gram_svd", flat, kk, MAX_K):
        batch, k = flat.shape[0], flat.shape[-1]
        sig = torch.empty((batch, k), dtype=torch.float32, device=flat.device)
        vt = torch.empty_like(flat)
        lib = _build.library()
        with torch.cuda.device(flat.device):
            err = lib.llck_gram_svd(flat.data_ptr(), sig.data_ptr(),
                                    vt.data_ptr(), batch, k, sweeps, _stream())
        _build.check("llck_gram_svd", err)
        _build.LAUNCHES["gram_svd"] += 1
    else:
        sig, vt = _gram_svd_flat(flat, sweeps)
    return _gram_svd_finish(m, sig, vt, kk)


def gram_svd_plain(m: torch.Tensor, sweeps: int = 10):
    """The plain PyTorch version of the kernel, on any device."""
    flat, kk = _gram_svd_prepare(m)
    _build.count_plain("gram_svd", flat)
    return _gram_svd_finish(m, *_gram_svd_flat(flat, sweeps), kk)


def _gram_svd_flat(m: torch.Tensor, sweeps: int):
    """(B, k, k), k even -> (sig (B, k) unsorted, vt (B, k, k) = V^T).

    The pairs of a round touch disjoint rows, so they are rotated together:
    the result is the same as the TPU kernel's one-pair-at-a-time loop."""
    k = m.shape[-1]
    ft = m.conj().clone()                          # F^T rows = F's columns
    vt = torch.eye(k, dtype=m.dtype, device=m.device).expand_as(m).clone()
    for step in range(sweeps * (k - 1)):
        r = step % (k - 1)
        pairs = [_rr_pair(r, q, k) for q in range(k // 2)]
        ii = torch.tensor([p[0] for p in pairs], device=m.device)
        jj = torch.tensor([p[1] for p in pairs], device=m.device)
        fi, fj = ft[:, ii, :], ft[:, jj, :]        # (B, k/2, k)
        gii = torch.sum(fi.real * fi.real + fi.imag * fi.imag, dim=-1)
        gjj = torch.sum(fj.real * fj.real + fj.imag * fj.imag, dim=-1)
        gr = torch.sum(fi.real * fj.real + fi.imag * fj.imag, dim=-1)
        gi = torch.sum(fi.real * fj.imag - fi.imag * fj.real, dim=-1)
        babs = torch.sqrt(gr * gr + gi * gi)
        skip = babs <= 1e-7 * torch.sqrt(gii * gjj) + 1e-30
        safe_b = torch.where(skip, 1.0, babs)
        wr = torch.where(skip, 1.0, gr / safe_b)
        wi = torch.where(skip, 0.0, gi / safe_b)
        # |w| must be exactly 1 or the rotation scales the columns
        wn = torch.rsqrt(wr * wr + wi * wi)
        w = torch.complex(wr * wn, wi * wn)
        tau = (gjj - gii) / (2.0 * safe_b)
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        c = torch.rsqrt(1.0 + t * t)
        s = c * t
        c = torch.where(skip, 1.0, c)[..., None]
        s = torch.where(skip, 0.0, s)[..., None]
        wc = w.conj()[..., None]
        wfj = wc * fj
        ft[:, ii, :] = c * fi - s * wfj
        ft[:, jj, :] = s * fi + c * wfj
        vi, vj = vt[:, ii, :], vt[:, jj, :]
        wvj = wc * vj
        vt[:, ii, :] = c * vi - s * wvj
        vt[:, jj, :] = s * vi + c * wvj
    sig = torch.sqrt(torch.sum(ft.real * ft.real + ft.imag * ft.imag, dim=-1))
    return sig, vt


# ---------------------------------------------------------------------------
# Shifted Cholesky: R^{-1} and the solve
# ---------------------------------------------------------------------------

def _shift_flat(shift, g: torch.Tensor) -> torch.Tensor:
    batch_shape = g.shape[:-2]
    sh = torch.as_tensor(shift, dtype=torch.float32, device=g.device)
    return torch.broadcast_to(sh, batch_shape).reshape(-1).contiguous()


def chol_kernel_resources(kernel: str, k: int) -> dict:
    """What the instantiation of ``csrc/chol.cu`` that size k runs in takes
    of an SM, as the CUDA runtime reports it: the compiled size K (k is
    padded up to it inside the kernel), registers per thread, shared and
    local (spill and stack) bytes, threads per block, resident blocks and
    warps per SM.  kernel: "cholqr_rinv" or "chol_solve".  Needs a GPU."""
    limits = {"cholqr_rinv": MAX_K, "chol_solve": MAX_K_SOLVE}
    if kernel not in limits or not 1 <= k <= limits[kernel]:
        raise ValueError(f"chol_kernel_resources: no {kernel!r} at k={k}")
    out = (ctypes.c_int * 6)()
    err = _build.library().llck_chol_resources(
        int(kernel == "chol_solve"), k, ctypes.addressof(out))
    _build.check("llck_chol_resources", err)
    big_k, regs, shared, local, threads, blocks = out
    return {"kernel": kernel, "K": big_k, "registers": regs,
            "shared_bytes": shared, "local_bytes": local, "threads": threads,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}


def _chol_inplace(s: torch.Tensor, shift: torch.Tensor) -> None:
    """Upper Cholesky G + shift I = R^H R in place on (B, k, k); entries
    below the diagonal are garbage afterwards (never read)."""
    k = s.shape[-1]
    diag = torch.diagonal(s, dim1=-2, dim2=-1)
    diag.real.add_(shift[:, None])
    for i in range(k):
        dinv = torch.rsqrt(torch.clamp(s[:, i, i].real, min=1e-30))
        ri = s[:, i, :] * dinv[:, None]
        s[:, i, :] = ri
        # rows r > i:  row_r -= conj(R[i, r]) * R[i, :]
        s[:, i + 1:, :] -= ri[:, i + 1:, None].conj() * ri[:, None, :]


def cholqr_rinv(g: torch.Tensor, shift) -> torch.Tensor:
    """R^{-1} (upper) with G + shift I = R^H R, batched.

    g : (..., k, k) complex64 Hermitian PSD (the kernel takes k <= 64);
    shift : (...,) per matrix diagonal shift (absolute).  Returns (..., k,
    k) complex64 upper-triangular R^{-1}; Q = y R^{-1} orthonormalizes y
    when G = y^H y.
    """
    k = _check_square("cholqr_rinv", g)
    flat = g.reshape(-1, k, k).contiguous()
    sh = _shift_flat(shift, g)
    if _launchable("cholqr_rinv", flat, k, MAX_K):
        out = torch.empty_like(flat)
        lib = _build.library()
        with torch.cuda.device(flat.device):
            err = lib.llck_cholqr_rinv(flat.data_ptr(), sh.data_ptr(),
                                       out.data_ptr(), flat.shape[0], k,
                                       _stream())
        _build.check("llck_cholqr_rinv", err)
        _build.LAUNCHES["cholqr_rinv"] += 1
    else:
        out = _cholqr_flat(flat, sh)
    return out.reshape(g.shape)


def cholqr_rinv_plain(g: torch.Tensor, shift) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    k = _check_square("cholqr_rinv", g)
    flat = g.reshape(-1, k, k)
    _build.count_plain("cholqr_rinv", flat)
    return _cholqr_flat(flat, _shift_flat(shift, g)).reshape(g.shape)


def _cholqr_flat(g: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    s = g.clone()
    _chol_inplace(s, shift)
    k = s.shape[-1]
    # X[i, :] = (e_i - sum_{p>i} R[i, p] X[p, :]) / R[i, i], bottom row first
    x = torch.zeros_like(s)
    eye = torch.eye(k, dtype=s.dtype, device=s.device)
    for i in range(k - 1, -1, -1):
        dinv = 1.0 / torch.clamp(s[:, i, i].real, min=1e-30)
        acc = eye[i] - torch.sum(s[:, i, i + 1:, None] * x[:, i + 1:, :], dim=1)
        x[:, i, :] = acc * dinv[:, None]
    return x


def chol_solve(g: torch.Tensor, b: torch.Tensor, shift) -> torch.Tensor:
    """Solve (G + shift I) x = b for Hermitian PSD G, batched.

    g : (..., k, k) complex64 (the kernel takes k <= 64);  b : (..., k)
    complex64;  shift : (...,) absolute diagonal shift (Tikhonov).  Returns
    (..., k) complex64.
    """
    k = _check_square("chol_solve", g)
    if b.dtype != torch.complex64 or b.shape != g.shape[:-1]:
        raise ValueError(f"chol_solve: b must be complex64 {tuple(g.shape[:-1])}, "
                         f"got {b.dtype} {tuple(b.shape)}")
    flat = g.reshape(-1, k, k).contiguous()
    bf = b.reshape(-1, k).contiguous()
    sh = _shift_flat(shift, g)
    if _launchable("chol_solve", flat, k, MAX_K_SOLVE):
        x = torch.empty_like(bf)
        lib = _build.library()
        with torch.cuda.device(flat.device):
            err = lib.llck_chol_solve(flat.data_ptr(), bf.data_ptr(),
                                      sh.data_ptr(), x.data_ptr(),
                                      flat.shape[0], k, _stream())
        _build.check("llck_chol_solve", err)
        _build.LAUNCHES["chol_solve"] += 1
    else:
        x = _chol_solve_flat(flat, bf, sh)
    return x.reshape(b.shape)


def chol_solve_plain(g: torch.Tensor, b: torch.Tensor, shift) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    k = _check_square("chol_solve", g)
    flat = g.reshape(-1, k, k)
    _build.count_plain("chol_solve", flat)
    return _chol_solve_flat(flat, b.reshape(-1, k),
                            _shift_flat(shift, g)).reshape(b.shape)


def _chol_solve_flat(g, b, shift):
    s = g.clone()
    _chol_inplace(s, shift)
    k = s.shape[-1]
    dinv = 1.0 / torch.clamp(torch.diagonal(s, dim1=-2, dim2=-1).real,
                             min=1e-30)
    # forward: R^H y = b:  y[i] = (b[i] - sum_{p<i} conj(R[p, i]) y[p]) / R[i, i]
    y = torch.zeros_like(b)
    for i in range(k):
        acc = b[:, i] - torch.sum(s[:, :i, i].conj() * y[:, :i], dim=-1)
        y[:, i] = acc * dinv[:, i]
    # backward: R x = y:  x[i] = (y[i] - sum_{p>i} R[i, p] x[p]) / R[i, i]
    x = torch.zeros_like(b)
    for i in range(k - 1, -1, -1):
        acc = y[:, i] - torch.sum(s[:, i, i + 1:] * x[:, i + 1:], dim=-1)
        x[:, i] = acc * dinv[:, i]
    return x


# ---------------------------------------------------------------------------
# The Gauss-Newton normal equations of one exact refine step
# ---------------------------------------------------------------------------

def _block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_n conj(a[k, n]) b[l, n] -> (..., k, l)."""
    return a.conj() @ b.transpose(-1, -2)


def normal_equations(p32: torch.Tensor, dj: torch.Tensor, r: torch.Tensor):
    """G = J^H J (..., 2C, 2C) in float32 and rhs = J^H r (..., 2C) in the
    residual's precision, for J = [P; D] given as its complex64 blocks p32
    and dj (..., C, N) and the residual r (..., N).  G is Hermitian: its
    (d, v) block is the conjugate transpose of the (v, d) block."""
    gvv = _block(p32, p32)
    gvd = _block(p32, dj)
    gdd = _block(dj, dj)
    g = torch.cat([torch.cat([gvv, gvd], dim=-1),
                   torch.cat([gvd.transpose(-1, -2).conj(), gdd], dim=-1)],
                  dim=-2)
    jac = torch.cat([p32, dj], dim=-2).to(r.dtype)
    rhs = (jac.conj() @ r[..., None])[..., 0]
    return g, rhs


def _powers_residual(c: torch.Tensor, z: torch.Tensor, d: torch.Tensor,
                     t0: int):
    """P[k, n] = z_k^(t0 + n) (..., C, N) and r = c - sum_k d_k P[k]
    (..., N), both complex128."""
    p = cpowers(z, c.shape[-1])
    if t0:
        # shift the local block to global time: P <- z^t0 * P
        p = cpow_fixed(z, t0)[..., None] * p
    return p, c - torch.sum(d[..., None] * p, dim=-2)


def doz_of(z: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """doz_k = d_k / z_k, the scale of the Jacobian's second block, in
    float32 from z and d rounded to complex64: d conj(z) / max(|z|^2,
    1e-20); 0 for a masked slot (z = d = 0)."""
    z32, d32 = z.to(torch.complex64), d.to(torch.complex64)
    zabs2 = z32.real * z32.real + z32.imag * z32.imag
    return d32 * z32.conj() * (1.0 / torch.clamp(zabs2, min=1e-20))


def _gn_normal_torch(c, z, d, t0):
    p, r = _powers_residual(c, z, d, t0)
    p32 = p.to(torch.complex64)
    ns = (t0 + torch.arange(c.shape[-1], device=c.device)).to(torch.float32)
    return normal_equations(p32, doz_of(z, d)[..., None] * (ns * p32), r)


def _check_normal(c, z, d, t0) -> None:
    for name, x in (("c", c), ("z", z), ("d", d)):
        if x.dtype != torch.complex128:
            raise TypeError(f"gn_normal: {name} must be complex128, got "
                            f"{x.dtype}")
    if not (z.shape == d.shape and z.ndim >= 1 and z.shape[-1] >= 1
            and c.shape[:-1] == z.shape[:-1] and c.shape[-1] >= 1):
        raise ValueError(f"gn_normal: need c (..., N), z, d (..., C); got "
                         f"{tuple(c.shape)}, {tuple(z.shape)}, "
                         f"{tuple(d.shape)}")
    if t0 < 0:
        raise ValueError(f"gn_normal: t0 must be >= 0, got {t0}")


def gn_normal_run(nc: int, n: int) -> int:
    """The samples a sample group of ``csrc/gn_normal.cu`` walks from one
    anchor, for nc slots and n samples: 64, halved to 8 at the least while
    the block's sample groups (16 at nc <= 16, else 8) would not all have
    a run."""
    groups = 16 if nc <= 16 else 8
    run = 64
    while run > 8 and -(-n // run) < groups:
        run //= 2
    return run


def gn_normal(c: torch.Tensor, z: torch.Tensor, d: torch.Tensor,
              t0: int = 0):
    """The normal equations of one exact Gauss-Newton step of
    ``solver/refine.py``: G = J^H J (..., 2C, 2C) complex64 and rhs = J^H r
    (..., 2C) complex128, before the rhs is rounded, for J = [P; D],
    P[k, n] = z_k^(t0 + n), D[k, n] = doz_k (t0 + n) P[k, n] (doz from
    :func:`doz_of`) and the residual r = c - sum_k d_k P[k].

    c : (..., N) complex128;  z, d : (..., C) complex128, masked slots 0;
    t0 : the block's global start (time-sharded mode).  The powers,
    residual and rhs are float64 and G and doz float32 in both versions.  A
    CUDA tensor goes to the kernel, which writes no per-sample tensor and
    takes C <= 32 (past it a ValueError names the field to lower); a CPU
    tensor runs the PyTorch code (:func:`gn_normal_plain`'s) at any C."""
    _check_normal(c, z, d, t0)
    nc, n = z.shape[-1], c.shape[-1]
    cf = c.reshape(-1, n)
    if not _launchable("gn_normal", cf, nc, MAX_C_NORMAL):
        return _gn_normal_torch(c, z, d, t0)
    if t0 + n >= 2 ** 31:
        raise ValueError("gn_normal: time axis too large for one launch")
    batch = z.shape[:-1]
    cf = cf.contiguous()
    zf, df = (x.reshape(-1, nc).contiguous() for x in (z, d))
    v = cf.shape[0]
    dev = cf.device
    g = torch.empty((v, 2 * nc, 2 * nc), dtype=torch.complex64, device=dev)
    rhs = torch.empty((v, 2 * nc), dtype=torch.complex128, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.llck_gn_normal(
            cf.data_ptr(), zf.data_ptr(), df.data_ptr(), g.data_ptr(),
            rhs.data_ptr(), v, nc, n, t0, gn_normal_run(nc, n), _stream())
    _build.check("llck_gn_normal", err)
    _build.LAUNCHES["gn_normal"] += 1
    return (g.reshape(*batch, 2 * nc, 2 * nc), rhs.reshape(*batch, 2 * nc))


def gn_normal_plain(c: torch.Tensor, z: torch.Tensor, d: torch.Tensor,
                    t0: int = 0):
    """The plain PyTorch version of the kernel, on any device: the powers by
    ``cpowers`` (and ``cpow_fixed`` for t0), the residual, and G's three
    blocks and the rhs as three products and one matvec, each a tensor of
    the whole batch."""
    _check_normal(c, z, d, t0)
    _build.count_plain("gn_normal", c)
    return _gn_normal_torch(c, z, d, t0)


# ---------------------------------------------------------------------------
# The sweep's CholeskyQR pass over a (..., m, S, k) block as stored
# ---------------------------------------------------------------------------

def to_pairs(q: torch.Tensor) -> torch.Tensor:
    """(..., m, S, j) complex64 -> (..., 2m, S, j) bfloat16 real pairs, the
    real parts over the imaginary ones, each rounded once."""
    m = q.shape[-3]
    out = torch.empty((*q.shape[:-3], 2 * m, *q.shape[-2:]),
                      dtype=torch.bfloat16, device=q.device)
    out[..., :m, :, :].copy_(q.real)
    out[..., m:, :, :].copy_(q.imag)
    return out


def from_pairs(yb: torch.Tensor) -> torch.Tensor:
    """(..., 2m, S, j) bfloat16 real pairs -> (..., m, S, j) complex64
    (exact)."""
    m = yb.shape[-3] // 2
    y = torch.empty((*yb.shape[:-3], m, *yb.shape[-2:]),
                    dtype=torch.complex64, device=yb.device)
    yr = torch.view_as_real(y)
    yr[..., 0].copy_(yb[..., :m, :, :])
    yr[..., 1].copy_(yb[..., m:, :, :])
    return y


def orth_gram_groups(k: int) -> int:
    """The row groups of ``csrc/orth_pass.cu``'s Gram at k columns: 4, 2 or
    1, as many as fit a 256-thread block with one 4 x 4 tile of the upper
    triangle of G a thread (k <= 40: 4; k <= 56: 2; 64: 1).  Group g sums
    the rows r = g mod groups; the partial sums are added by a tree."""
    nb = -(-k // 4)
    tiles = nb * (nb + 1) // 2
    for groups in (4, 2):
        if groups * tiles <= 256:
            return groups
    return 1


def _orth_check(name: str, y: torch.Tensor) -> tuple[bool, int]:
    """The storage a pass takes: (pairs, m) for complex64 (..., m, S, k) or
    bfloat16 pairs (..., 2m, S, k)."""
    if y.ndim < 3 or min(y.shape[-3:]) < 1:
        raise ValueError(f"{name}: need (..., m, S, k), got {tuple(y.shape)}")
    if y.dtype == torch.complex64:
        return False, y.shape[-3]
    if y.dtype == torch.bfloat16:
        if y.shape[-3] % 2:
            raise ValueError(f"{name}: bfloat16 pairs need an even row count, "
                             f"got {y.shape[-3]}")
        return True, y.shape[-3] // 2
    raise TypeError(f"{name}: need complex64 or bfloat16 pairs, got {y.dtype}")


def _orth_strides(t: torch.Tensor, pairs: bool, m: int):
    """A (V, rows, S, k) block's strides {sv, sr, ss, si} (si: the
    imaginary parts' offset, m rows, for pairs) as a ctypes array."""
    sv, sr, ss = t.stride(0), t.stride(1), t.stride(2)
    return (ctypes.c_longlong * 4)(sv, sr, ss, m * sr if pairs else 0)


def _orth_vec(pairs: bool, *blocks) -> int:
    """The entries a load or store of the kernels moves: the largest that
    divides k, every block's strides and its base's alignment."""
    for vec in ((8, 4, 2) if pairs else (2,)):
        if all(b.shape[-1] % vec == 0 and all(x % vec == 0 for x in st)
               and b.data_ptr() % (vec * b.element_size()) == 0
               for b, st in blocks):
            return vec
    return 1


def _orth_block(y: torch.Tensor) -> torch.Tensor:
    """y as the kernels read it: (V, rows, S, k), its last axis
    contiguous."""
    y4 = y.reshape(-1, *y.shape[-3:])
    return y4 if y4.stride(-1) == 1 else y4.contiguous()


def _orth_complex(y: torch.Tensor, pairs: bool) -> torch.Tensor:
    return from_pairs(y) if pairs else y


def orth_gram(y: torch.Tensor, shift_rel: float):
    """G = Y^H Y of every (m, k) block of y, Hermitian with a real diagonal,
    and the shift shift_rel x mean_j |G[j, j]|.

    y : complex64 (..., m, S, k) or bfloat16 pairs (..., 2m, S, k), the
    real parts over the imaginary ones, in any layout whose last axis is
    contiguous.  Returns G (..., S, k, k) complex64 and the shift (..., S)
    float32.  A CUDA tensor goes to ``csrc/orth_pass.cu``'s Gram (k <= 64,
    past it a ValueError names the field to lower; its launch counts with
    the pass's in ``LAUNCHES["orth_pass"]`` where :func:`orth_pass` calls
    it); a CPU tensor to the plain version."""
    pairs, m = _orth_check("orth_gram", y)
    s_, k = y.shape[-2:]
    if not _launchable("orth_pass", y, k, MAX_K):
        return _orth_gram_torch(_orth_complex(y, pairs), shift_rel)
    y4 = _orth_block(y)
    strides = _orth_strides(y4, pairs, m)
    nv = y4.shape[0]
    g = torch.empty((nv, s_, k, k), dtype=torch.complex64, device=y.device)
    shift = torch.empty((nv, s_), dtype=torch.float32, device=y.device)
    lib = _build.library()
    with torch.cuda.device(y.device):
        err = lib.llck_orth_gram(y4.data_ptr(), ctypes.addressof(strides),
                                 int(pairs), _orth_vec(pairs, (y4, strides)),
                                 nv, m, s_, k, orth_gram_groups(k),
                                 float(shift_rel), g.data_ptr(),
                                 shift.data_ptr(), _stream())
    _build.check("llck_orth_gram", err)
    batch = y.shape[:-3]
    return g.reshape(*batch, s_, k, k), shift.reshape(*batch, s_)


def _orth_out(y4: torch.Tensor, pairs: bool) -> torch.Tensor:
    """The mix's output for a (V, rows, S, k) block, in the layout the
    sweep's readers take: pairs contiguous (the layout ``to_pairs`` gives,
    which the bfloat16 branch's Hankel apply flattens), complex64 with each
    entry's rows together, (V, S, m, k) in memory (the layout of the
    einsum the pass replaces, whose later products take it as it is)."""
    nv, rows, s_, k = y4.shape
    if pairs:
        return torch.empty(y4.shape, dtype=y4.dtype, device=y4.device)
    return torch.empty((nv, s_, rows, k), dtype=y4.dtype,
                       device=y4.device).transpose(1, 2)


def orth_mix(y: torch.Tensor, x: torch.Tensor,
             conj: bool = False) -> torch.Tensor:
    """Q = Y X per (m, k) block, in y's storage (bfloat16 pairs rounded
    once, to nearest even), or its conjugate where ``conj``; laid out as
    the sweep's readers take it (:func:`_orth_out`).  y as for
    :func:`orth_gram`; x (..., S, k, k) complex64 upper triangular.  A
    CUDA tensor goes to ``csrc/orth_pass.cu``'s mix, a CPU tensor to the
    plain version."""
    pairs, m = _orth_check("orth_mix", y)
    s_, k = y.shape[-2:]
    if x.dtype != torch.complex64 or x.shape != (*y.shape[:-3], s_, k, k):
        raise ValueError(f"orth_mix: x must be complex64 "
                         f"{(*y.shape[:-3], s_, k, k)}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not _launchable("orth_pass", y, k, MAX_K):
        q = _mix_torch(_orth_complex(y, pairs), x)
        if conj:
            q = q.conj()
        return to_pairs(q) if pairs else q.resolve_conj()
    y4 = _orth_block(y)
    q = _orth_out(y4, pairs)
    strides, out_strides = (_orth_strides(t, pairs, m) for t in (y4, q))
    xf = x.reshape(-1, k, k).contiguous()
    lib = _build.library()
    with torch.cuda.device(y.device):
        err = lib.llck_orth_mix(
            y4.data_ptr(), ctypes.addressof(strides), q.data_ptr(),
            ctypes.addressof(out_strides), int(pairs),
            _orth_vec(pairs, (y4, strides), (q, out_strides)), int(conj),
            y4.shape[0], m, s_, k, xf.data_ptr(), _stream())
    _build.check("llck_orth_mix", err)
    return q.reshape(y.shape)


def orth_pass(y: torch.Tensor, shift_rel: float,
              conj: bool = False) -> torch.Tensor:
    """One shifted CholeskyQR pass over the k columns of every (m, S) block
    of y, in y's storage: Q = Y R^-1 with G + shift I = R^H R, G = Y^H Y
    and the shift shift_rel x G's mean diagonal (:func:`orth_gram`,
    :func:`cholqr_rinv`, :func:`orth_mix`), or Q's conjugate where
    ``conj``.  y : complex64 (..., m, S, k) or bfloat16 pairs (..., 2m, S,
    k).  On a CUDA tensor three launches, counted once in
    ``LAUNCHES["orth_pass"]`` (and cholqr_rinv's in its own); on a CPU
    tensor the plain versions."""
    g, shift = orth_gram(y, shift_rel)
    q = orth_mix(y, cholqr_rinv(g, shift), conj)
    if y.is_cuda:
        _build.LAUNCHES["orth_pass"] += 1
    return q


def orth_pass_plain(y: torch.Tensor, shift_rel: float) -> torch.Tensor:
    """The plain PyTorch version of the pass, on any device: the kernels'
    algorithm (pairs widened exactly, the row groups' Grams added by the
    tree, the upper triangle mirrored with a real diagonal, the product
    with R^-1 rounded back to pairs once)."""
    pairs, _ = _orth_check("orth_pass", y)
    _build.count_plain("orth_pass", y)
    yc = _orth_complex(y, pairs)
    g, shift = _orth_gram_torch(yc, shift_rel)
    q = _mix_torch(yc, _cholqr_flat(g.reshape(-1, *g.shape[-2:]),
                                    shift.reshape(-1)).reshape(g.shape))
    return to_pairs(q) if pairs else q


def _orth_gram_torch(yc: torch.Tensor, shift_rel: float):
    """The Gram's algorithm on a complex64 block: per row group (rows g mod
    groups) a float32 product, the groups added by the tree, the strict
    upper triangle mirrored, the diagonal's real part."""
    groups = orth_gram_groups(yc.shape[-1])
    parts = [torch.einsum("...msk,...msl->...skl", yc[..., g::groups, :, :]
                          .conj(), yc[..., g::groups, :, :])
             for g in range(groups)]
    while len(parts) > 1:
        h = len(parts) // 2
        parts = [parts[i] + parts[i + h] for i in range(h)]
    upper = torch.triu(parts[0], 1)
    d = torch.diagonal(parts[0], dim1=-2, dim2=-1).real
    g = upper + upper.transpose(-1, -2).conj() + torch.diag_embed(
        d.to(torch.complex64))
    return g, shift_rel * torch.mean(torch.abs(d), dim=-1)


def _mix_torch(yc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...msk,...skl->...msl", yc, x)
