"""The two tool kernels: the row-access probe and the Hermitian Jacobi cost
probe, each with its plain PyTorch version.

Counterparts of ``tools/pallas_smoke.py::kernel`` (``row_probe``, kernel
``csrc/row_probe.cu``) and ``tools/bench_eigh_variants.py::make_kernel``
(``eigh_probe``, kernel ``csrc/eigh_probe.cu``).  Neither is on the
pipeline's path: the tools ``llckbdm_tpu_torch.tools.kernel_smoke`` and
``llckbdm_tpu_torch.tools.bench_eigh_variants`` drive them.  As in
``ops/cuda_jacobi.py``, the wrappers send a CUDA tensor to the kernel and a
CPU tensor to the plain version, which runs the kernel's arithmetic in
PyTorch one step at a time and is the reference the kernel is held against.

The row probe takes its schedule from the host, as the TPU kernel took it
into SMEM: a CPU int32 tensor, checked on the host and handed to the kernel
as a launch parameter, so a call never waits on the device.

The eigh probe is a cost probe, not an eigensolver (see ``csrc/eigh_probe.cu``):
its ``w`` is not the spectrum of A, and past one sweep its rotation chain is
chaotic, so float32 rounding differences grow to O(1).  Elementwise parity
holds over one sweep; the norms in :class:`EighProbe` hold at any length.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .cuda_jacobi import _rr_pair

MAX_N = 64           # one warp per matrix, lane t owns columns t and t + 32
MAX_STEPS = 2048     # the row probe's schedule, a launch parameter
MAX_PER_BLOCK = 8    # eigh probe: matrices (warps) per block
PER_BLOCK = 4

# the eigh probe's five distinct switch settings (do_cols and do_v act only
# with do_rows)
EIGH_VARIANTS = {
    "coef": dict(do_rows=False, do_cols=False, do_v=False),
    "rows": dict(do_rows=True, do_cols=False, do_v=False),
    "rows+cols": dict(do_rows=True, do_cols=True, do_v=False),
    "rows+v": dict(do_rows=True, do_cols=False, do_v=True),
    "full": dict(do_rows=True, do_cols=True, do_v=True),
}


class EighProbe(NamedTuple):
    """What the eigh probe returns, per matrix of the batch."""
    w: torch.Tensor         # (B, n) float32, the real diagonal of S
    s_norm: torch.Tensor    # (B,) float32, |S|_F after the rotations
    v_norm: torch.Tensor    # (B,) float32, |V|_F (V starts as A)
    coef_sum: torch.Tensor  # (B,) float32, the sum of c + s over all pairs


# --- the row-access probe ----------------------------------------------------

def _row_probe_args(sched: torch.Tensor, a: torch.Tensor):
    if a.dtype != torch.float32 or a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"row_probe: need (B, n, n) float32, got "
                         f"{tuple(a.shape)} {a.dtype}")
    n = a.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"row_probe: n={n} outside [1, {MAX_N}]")
    if a.shape[0] >= 2 ** 31:
        raise ValueError("row_probe: batch too large for one launch")
    if sched.dtype != torch.int32 or sched.ndim != 2 or sched.shape[1] != 2:
        raise ValueError(f"row_probe: need a (steps, 2) int32 schedule, got "
                         f"{tuple(sched.shape)} {sched.dtype}")
    if sched.shape[0] > MAX_STEPS:
        raise ValueError(f"row_probe: {sched.shape[0]} steps, at most "
                         f"{MAX_STEPS}")
    if sched.device.type != "cpu":
        raise ValueError(f"row_probe: the schedule is read on the host; pass "
                         f"it as a CPU tensor, not on {sched.device}")
    if sched.numel():
        lo, hi = int(sched.min()), int(sched.max())
        if lo < 0 or hi >= n:
            raise ValueError(f"row_probe: schedule entries in [{lo}, {hi}], "
                             f"need [0, {n})")
    return sched.contiguous(), a.contiguous()


def row_probe(sched: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Apply the schedule's row steps to every matrix of a batch.

    sched : (steps, 2) int32 row pairs (i, j), each in [0, n), a CPU tensor
    whatever a's device (a schedule on another device raises ValueError).
    a : (B, n, n) float32, n <= 64.  Per step, from the matrix before it:
    c = a[i, j] / 4, s = 1 - c^2; row i = c row_i - s row_j, then row j =
    s row_i + c row_j, then a[i, j] = c.  Returns a new (B, n, n) tensor.

    The schedule is checked on the host and reaches the kernel as a launch
    parameter: a call on a CUDA tensor does not synchronise with the device.
    """
    sched, a = _row_probe_args(sched, a)
    if not _build.use_kernel("row_probe", a):
        return _row_probe_flat(sched, a)
    out = torch.empty_like(a)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.llck_row_probe(sched.data_ptr(), a.data_ptr(), out.data_ptr(),
                                 a.shape[0], a.shape[-1], sched.shape[0],
                                 torch.cuda.current_stream().cuda_stream)
    _build.check("llck_row_probe", err)
    _build.LAUNCHES["row_probe"] += 1
    return out


def empty_launch() -> None:
    """Launch one empty kernel on the current CUDA stream through the
    library's ctypes path: the launch floor :func:`row_probe` is timed
    against.  Needs a GPU."""
    err = _build.library().llck_empty(torch.cuda.current_stream().cuda_stream)
    _build.check("llck_empty", err)


def row_probe_plain(sched: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`row_probe`, on any device (the
    schedule on the CPU, as there)."""
    sched, a = _row_probe_args(sched, a)
    _build.count_plain("row_probe", a)
    return _row_probe_flat(sched, a)


def _row_probe_flat(sched: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    out = a.clone()
    for i, j in sched.tolist():
        ri, rj = out[:, i, :].clone(), out[:, j, :].clone()
        c = out[:, i, j:j + 1] * 0.25
        s = 1.0 - c * c
        out[:, i, :] = c * ri - s * rj
        out[:, j, :] = s * ri + c * rj
        out[:, i, j] = c[:, 0]
    return out


# --- the Hermitian Jacobi cost probe -------------------------------------------

def _eigh_probe_args(a: torch.Tensor, sweeps: int) -> torch.Tensor:
    if a.dtype != torch.complex64 or a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"eigh_probe: need (B, n, n) complex64, got "
                         f"{tuple(a.shape)} {a.dtype}")
    n = a.shape[-1]
    if n % 2 or not 2 <= n <= MAX_N:
        raise ValueError(f"eigh_probe: n={n}, need an even n in [2, {MAX_N}] "
                         f"(the round-robin pairs all n indices only for even n)")
    if a.shape[0] >= 2 ** 31:
        raise ValueError("eigh_probe: batch too large for one launch")
    if sweeps < 0:
        raise ValueError(f"eigh_probe: sweeps={sweeps} < 0")
    return a.contiguous()


def eigh_probe(a: torch.Tensor, sweeps: int = 8, do_rows: bool = True,
               do_cols: bool = True, do_v: bool = True,
               per_block: int = PER_BLOCK) -> EighProbe:
    """The Hermitian Jacobi cost probe of tools/bench_eigh_variants.py.

    a : (B, n, n) complex64, n even, n <= 64.  sweeps * (n - 1) rounds of
    n/2 row rotations of S (which starts as A); ``do_cols`` (copy each
    rotated row's conjugate into its column) and ``do_v`` (rotate V, which
    starts as A, too) act only with ``do_rows``.  ``per_block`` is the
    kernel's matrices per block, in [1, 8] (it takes fewer where they do not
    fit in a block's shared memory: at n = 64 with ``do_v``, 3); the result
    does not depend on it.  An odd n raises ValueError: the probe is not padded, because a
    padded row would change its pair schedule.
    """
    a = _eigh_probe_args(a, sweeps)
    if not 1 <= per_block <= MAX_PER_BLOCK:
        raise ValueError(f"eigh_probe: per_block={per_block} outside "
                         f"[1, {MAX_PER_BLOCK}]")
    if not _build.use_kernel("eigh_probe", a):
        return _eigh_probe_flat(a, sweeps, do_rows, do_cols, do_v)
    batch, n = a.shape[0], a.shape[-1]
    w = torch.empty((batch, n), dtype=torch.float32, device=a.device)
    chk = torch.empty((batch, 3), dtype=torch.float32, device=a.device)
    variant = int(do_rows) | int(do_cols) << 1 | int(do_v) << 2
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.llck_eigh_probe(a.data_ptr(), w.data_ptr(), chk.data_ptr(),
                                  batch, n, sweeps, per_block, variant,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check("llck_eigh_probe", err)
    _build.LAUNCHES["eigh_probe"] += 1
    return EighProbe(w, chk[:, 0], chk[:, 1], chk[:, 2])


def eigh_probe_plain(a: torch.Tensor, sweeps: int = 8, do_rows: bool = True,
                     do_cols: bool = True, do_v: bool = True) -> EighProbe:
    """The plain PyTorch version of :func:`eigh_probe`, on any device."""
    a = _eigh_probe_args(a, sweeps)
    _build.count_plain("eigh_probe", a)
    return _eigh_probe_flat(a, sweeps, do_rows, do_cols, do_v)


def _eigh_probe_flat(a: torch.Tensor, sweeps: int, do_rows: bool,
                     do_cols: bool, do_v: bool) -> EighProbe:
    """make_kernel's body on real and imaginary planes, one pair at a time."""
    sr, si = a.real.clone(), a.imag.clone()
    vr, vi = sr.clone(), si.clone()
    n = a.shape[-1]
    coef = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for step in range(sweeps * (n - 1)):
        r = step % (n - 1)
        for k in range(n // 2):
            i, j = _rr_pair(r, k, n)
            aii, ajj = sr[:, i, i], sr[:, j, j]     # views: read before any write
            br, bi = sr[:, i, j], si[:, i, j]
            babs = torch.sqrt(br * br + bi * bi)
            dscale = torch.sqrt(aii * aii + ajj * ajj) + 1e-30
            skip = babs <= 1e-7 * dscale
            safe_b = torch.where(skip, 1.0, babs)
            wr = torch.where(skip, 1.0, br / safe_b)[:, None]
            wi = torch.where(skip, 0.0, bi / safe_b)[:, None]
            tau = (ajj - aii) / (2.0 * safe_b)
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            c = torch.rsqrt(1.0 + t * t)
            s = c * t
            c = torch.where(skip, 1.0, c)
            s = torch.where(skip, 0.0, s)
            coef = coef + (c + s)
            if not do_rows:
                continue
            c, s = c[:, None], s[:, None]
            ri_r, ri_i = sr[:, i, :].clone(), si[:, i, :].clone()
            rj_r, rj_i = sr[:, j, :].clone(), si[:, j, :].clone()
            wrj_r = wr * rj_r - wi * rj_i
            wrj_i = wr * rj_i + wi * rj_r
            ni_r, ni_i = c * ri_r - s * wrj_r, c * ri_i - s * wrj_i
            nj_r, nj_i = s * ri_r + c * wrj_r, s * ri_i + c * wrj_i
            sr[:, i, :], si[:, i, :] = ni_r, ni_i
            sr[:, j, :], si[:, j, :] = nj_r, nj_i
            if do_cols:
                sr[:, :, i], si[:, :, i] = ni_r, -ni_i
                sr[:, :, j], si[:, :, j] = nj_r, -nj_i
            if do_v:
                vi_r2, vi_i2 = vr[:, i, :].clone(), vi[:, i, :].clone()
                vj_r2, vj_i2 = vr[:, j, :].clone(), vi[:, j, :].clone()
                wvj_r = wr * vj_r2 + wi * vj_i2
                wvj_i = wr * vj_i2 - wi * vj_r2
                vr[:, i, :] = c * vi_r2 - s * wvj_r
                vi[:, i, :] = c * vi_i2 - s * wvj_i
                vr[:, j, :] = s * vi_r2 + c * wvj_r
                vi[:, j, :] = s * vi_i2 + c * wvj_i
    w = torch.diagonal(sr, dim1=-2, dim2=-1).clone()

    def fro(x_r, x_i):
        return torch.sqrt(torch.sum(x_r * x_r + x_i * x_i, dim=(-2, -1)))

    return EighProbe(w, fro(sr, si), fro(vr, vi), coef)
