"""Gauss-Newton (VARPRO-style) pole refinement to the 1e-8 oracle gate.

Counterpart of llckbdm_tpu/solver/refine.py.  The f32 KBDM pipeline gives
poles to ~1e-4 relative; this stage solves the separable nonlinear least
squares

    min_{z, d}  sum_n | c_n - sum_k d_k z_k^n |^2

by Gauss-Newton.  The JAX package keeps z, d and the residual in
double-float pairs because its device has no float64; here they are
complex128, which the card has natively.  What must not cancel is in f64:

* the state (z, d), the powers z^n and the residual r = c - model;
* the right-hand side J^H r, formed in f64 and then rounded to f32.

The normal matrix G = J^H J and the solve stay float32, as in the JAX
package (the correction direction only needs f32 accuracy), so the solve is
the f32 chol_solve kernel on the (2C, 2C) normal equations.  With a few
iterations the poles converge to the float64 least-squares fixed point.
On the card G and the rhs of an exact step come from one kernel,
``ops.cuda_linalg.gn_normal``, which keeps these precisions and writes no
(..., C, N) tensor.

Time-sharded mode (``group``/``t_offset``) is the counterpart of the JAX
package's ``axis_name``/``t_offset``: each rank of a ``torch.distributed``
process group holds one contiguous block of the time axis, and G and the
right-hand side are summed over the group by one all-reduce.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import cuda_linalg
from ..ops.linalg import hermitian_solve, matmul_precision
from ..ops.powers import cpowers
from ..signals import LineList
from ..spans import REFINE, STEP, span, spanned


class RefinedLines(NamedTuple):
    """Refined poles/amplitudes in complex128, plus an f32 LineList view."""

    z: torch.Tensor         # (..., C) complex128 poles
    d: torch.Tensor         # (..., C) complex128 complex amplitudes
    mask: torch.Tensor      # (..., C) float32
    lines: LineList         # f32 view
    gn_step: torch.Tensor   # (..., C) |delta z| of the LAST GN iteration


@dataclass(frozen=True)
class RefineConfig:
    """Gauss-Newton settings: the JAX package's fields and defaults.

    ``eigh_sweeps`` is read by nothing: the solve is the shifted Cholesky
    kernel, which has no sweeps.  It is kept so that a JAX configuration
    converts field for field.
    """

    iters: int = 3
    f32_iters: int = 0           # cheap plain-f32 GN iterations run BEFORE
                                 # the `iters` f64-residual ones: the early
                                 # steps only need a descent direction.
                                 # Ignored in time-sharded mode.
    ridge: float = 1e-12         # relative Tikhonov in the GN solve
    max_step: float = 0.1        # clip on |delta z| per iteration
    eigh_sweeps: int = 10        # kept for parity with the JAX config; the
                                 # Cholesky solve has no sweeps


def _sum_over_group(g: torch.Tensor, rhs: torch.Tensor, group):
    """Sum this rank's partial G (complex64) and rhs (complex128) over the
    group by ONE all-reduce of a float64 buffer.  The rhs is summed before
    it is rounded to complex64, which keeps at least what the JAX package's
    (hi, lo) psum keeps; G's float32 partials are summed in float64 and
    rounded once."""
    g_re = torch.view_as_real(g).to(torch.float64)
    r_re = torch.view_as_real(rhs)
    buf = torch.cat([g_re.reshape(-1), r_re.reshape(-1)])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    k = g_re.numel()
    g = torch.view_as_complex(buf[:k].reshape(g_re.shape).to(torch.float32))
    return g, torch.view_as_complex(buf[k:].reshape(r_re.shape))


@matmul_precision()
@spanned(REFINE)
def refine_lines(c: torch.Tensor, lines: LineList, dwell: float,
                 cfg: RefineConfig = RefineConfig(), *, group=None,
                 t_offset: int | None = None) -> RefinedLines:
    """Polish a consolidated LineList against the signal.

    c     : (..., N) complex signal (cast to complex128; pass the float64
            data, not its complex64 rounding)
    lines : LineList (..., C) f32 initial values (masked slots ignored)

    Time-sharded mode: ``c`` is this rank's block of the time axis and
    ``t_offset`` its global start index; ``group`` is the
    ``torch.distributed`` process group over the time blocks, whose ranks
    hold the same voxels and bitwise-equal ``lines``.  The powers are
    taken at global time (z^(t0 + n), in complex128), G and the rhs are
    summed over the group, and the ridge is taken from the summed G, so
    every rank takes the same steps.  ``cfg.f32_iters`` is ignored in this
    mode, as in the JAX package.
    """
    c = c.to(torch.complex128)
    n = c.shape[-1]
    dt = float(np.float32(dwell))
    mask = lines.mask > 0.5
    mask2 = torch.cat([mask, mask], dim=-1)
    cc = mask.shape[-1]

    # initial z = exp((i 2 pi f - 1/T2) dt), d = A e^{i phase} in f32, as
    # the JAX package forms them, then widened
    decay = torch.exp(-dt / torch.clamp(lines.t2, min=1e-9))
    theta = 2.0 * np.pi * lines.frequency * dt
    z = torch.where(mask, torch.polar(decay, theta), 0.0).to(torch.complex128)
    d = torch.where(mask, torch.polar(lines.amplitude, lines.phase),
                    0.0).to(torch.complex128)
    t0 = 0 if t_offset is None else int(t_offset)
    ns = (t0 + torch.arange(n, device=c.device)).to(torch.float32)

    def gn_step(z, d, exact):
        # Jacobian blocks J = [P; D], D[k, n] = (d_k / z_k) * n * P[k, n]
        if exact:
            # f64 powers and residual, G = J^H J in f32, rhs = J^H r in f64
            g, rhs = cuda_linalg.gn_normal(c, z, d, t0)
        else:
            # f32 warm-start iteration: plain-f32 powers, model, residual
            z32, d32 = z.to(torch.complex64), d.to(torch.complex64)
            p32 = cpowers(z32, n)
            r = c.to(torch.complex64) - (d32[..., None, :] @ p32)[..., 0, :]
            g, rhs = cuda_linalg.normal_equations(
                p32, cuda_linalg.doz_of(z, d)[..., None] * (ns * p32), r)
        # the rhs is summed in the residual's precision (over the time
        # blocks too), then f32
        if group is not None:
            g, rhs = _sum_over_group(g, rhs, group)
        rhs = rhs.to(torch.complex64)

        # masked slots: identity rows
        pair = mask2[..., :, None] & mask2[..., None, :]
        eye = torch.eye(2 * cc, dtype=g.dtype, device=g.device)
        g = torch.where(pair, g, eye)
        rhs = torch.where(mask2, rhs, 0.0)

        # relative Tikhonov: cfg.ridge scaled by the mean diagonal magnitude,
        # with NO eigenvalue truncation (close line pairs need the small
        # directions of G)
        tr = torch.sum(torch.abs(torch.diagonal(g, dim1=-2, dim2=-1).real),
                       dim=-1, keepdim=True)
        ridge = float(np.float32(cfg.ridge)) * tr / (2 * cc)
        delta = hermitian_solve(g, rhs, ridge=ridge, rcond=1e-14)

        dd, dz = delta[..., :cc], delta[..., cc:]
        step = torch.abs(dz)
        clip = torch.where(step > cfg.max_step,
                           cfg.max_step / torch.clamp(step, min=1e-30), 1.0)
        dz = dz * clip
        z = z + torch.where(mask, dz, 0.0).to(torch.complex128)
        d = d + torch.where(mask, dd, 0.0).to(torch.complex128)
        return z, d, torch.where(mask, step, 0.0)

    gn_step_norm = torch.zeros_like(lines.amplitude)
    sharded = group is not None or t_offset is not None
    for _ in range(0 if sharded else cfg.f32_iters):
        with span(STEP):
            z, d, gn_step_norm = gn_step(z, d, exact=False)
    for _ in range(cfg.iters):
        with span(STEP):
            z, d, gn_step_norm = gn_step(z, d, exact=True)

    # f32 view
    z32, d32 = z.to(torch.complex64), d.to(torch.complex64)
    zabs = torch.abs(z32)
    freq = torch.angle(z32) / (2.0 * float(np.float32(np.pi)) * dt)
    t2 = -dt / torch.log(torch.clamp(torch.where(mask, zabs, 0.5), min=1e-30))
    fmask = mask.to(torch.float32)
    view = LineList(
        amplitude=torch.where(mask, torch.abs(d32), 0.0),
        t2=torch.where(mask, t2, 1.0),
        frequency=torch.where(mask, freq, 0.0),
        phase=torch.where(mask, torch.angle(d32), 0.0),
        mask=fmask,
    )
    return RefinedLines(z=z, d=d, mask=fmask, lines=view, gn_step=gn_step_norm)


def refined_to_np(ref: RefinedLines, dwell: float) -> np.ndarray:
    """float64 (A, T2, f, phase) rows of one voxel's valid lines, sorted by
    frequency — the array compared against the scipy oracle."""
    z = ref.z.detach().cpu().numpy()
    d = ref.d.detach().cpu().numpy()
    mask = ref.mask.detach().cpu().numpy() > 0.5
    z, d = z[mask], d[mask]
    freq = np.angle(z) / (2.0 * np.pi * dwell)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(z))
    out = np.stack([np.abs(d), t2, freq, np.angle(d)], axis=1)
    return out[np.argsort(out[:, 2])]
