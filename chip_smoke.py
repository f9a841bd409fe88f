#!/usr/bin/env python3
"""Drive the PyTorch port's refined LL-KBDM pipeline once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

1. Device and build: needs CUDA (exits non-zero otherwise), turns TF32 off,
   prints the card's name and power limit, builds the CUDA kernels of
   ``llckbdm_tpu_torch/csrc`` with nvcc.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (eig_cs on the production reduced matrices of the V=2048
   sweep) and once more at an odd size (gram_svd also at k=32; cholqr_rinv
   and chol_solve at every compiled size, at sizes padded up inside the
   kernel, and chol_solve at the 64 x 64 Gauss-Newton solve of 32
   clusters; gn_normal, the refine's normal equations, at the main path's
   (2048, 16, 512) and the brain cell's (1024, 32, 2048), a single
   spectrum, 24 slots and a time block at t0 > 0, G on unmasked pairs
   within 1e-5 and the rhs within 1e-6), timed with CUDA
   events (``llckbdm_tpu_torch.tools.timing.cuda_ms``: median of 5 windows
   of up to 200 launches or 100 ms; a call over 100 ms is timed once),
   beside the card's least time for the same work
   (``llckbdm_tpu_torch.tools.bounds``) and, where one PyTorch call
   computes the same function, that call's time (``LIBRARY``: linalg's
   eigvals, svd and solve, yardsticks the port never calls).  chol_solve is
   timed at three shapes: the amplitudes, and the 32 x 32 and 64 x 64
   Gauss-Newton solves.  cholqr_rinv is also held, beside its plain
   version, to its contract R^-H (G + shift I) R^-1 = I in float64 on the
   production Gram matrices of the V=2048 sweep, which are rank-deficient:
   the second power iteration's at its 1e-4 shift and the two final
   passes' at 3e-6.  What each instantiation of the two Cholesky kernels
   takes of an SM (registers, shared and local bytes, resident warps) is
   printed from the CUDA runtime.  The sweep's CholeskyQR pass
   (``orth_pass``: csrc/orth_pass.cu's Gram and mix around cholqr_rinv, on
   the block as stored) against its plain version at the benchmark cells'
   shapes (the five-peak power iterations' bfloat16 pairs and final
   passes' complex64 at (2048, 256, 35, 24), the brain cell's (1024, 300,
   46, 32)), timed beside its bound; its own G and R^-1 held to the same
   contract on the production blocks.  After the main path, the kernels
   are printed in the order a redesign should take them.
3. The main path at the bench's north-star size (V=2048 voxels, N=512,
   m = 120..256 step 4, p=16): llc_kbdm_fit, then refine_lines on the top
   16 clusters with 6 Gauss-Newton iterations, at the card's default, the
   bfloat16 power iterations (KbdmConfig.subspace_bf16, the JAX package's
   accelerator default; the branch is printed).  Every kernel must have
   been launched by that run (gn_normal once per GN iteration, orth_pass
   once per CholeskyQR pass: subspace_iters + final_orth_passes) and no
   plain version handed a CUDA tensor.
4. Gates: the Jacobi off-diagonal counter below 1e-2 on 32 voxels, and the
   refined lines within 1e-8 of the float64 oracle's Gauss-Newton polish on
   the 8 voxels with the largest last GN step.  The same path and gates
   once more on the float32 power iterations (subspace_bf16=False), with
   cholqr_rinv held to its contract on that branch's Grams too; both
   branches' fit and refine ms and peak memory are printed beside the
   card's name and power limit.  A record, not a gate: the north-star
   voxels whose float32 power iterations go non-finite at the JAX
   package's 3e-6 shift (the port keeps 1e-4).  Then one more run of the
   main path under torch.profiler: the device's busy time, its idle share
   of the unprofiled run's wall time, the largest consumers, and each
   hand-written kernel's device time per launch (the 32 x 32 Gauss-Newton
   solve is too short for an event window to show its device time).
   Then the port's benchmark and stage profiler, each through its entry
   point: ``llckbdm_tpu_torch.bench.main(["--json-only"])`` at V=2048 (its
   JSON line printed; it exits 0, its own RuntimeErrors uncaught, with the
   gate below 1e-8 and the Jacobi counter below 1e-2; its fit and refine
   launch all four main-path kernels and its eigensolve eig_cs, no plain
   version on a CUDA tensor; its fit time within a factor of 1.5 of the
   main path's above), ``bench.main(["--saturation"])`` (its five rates
   printed) and ``tools.profile_stages`` at V=512 (its rows and
   pipeline_pct_of_light printed, and nvidia-smi's clocks.sm, power.draw,
   power.limit and temperature.gpu from just before and just after it;
   its JSON written to
   chiprun_out/profile_stages.json).
5. The spec-scale gates the JAX package proved on its chip, each a path
   driven once with the launch counts set to 0 before and read after (every
   main-path kernel launched, no plain version on a CUDA tensor), each gate
   asserted: config 2 (the brain signal of data/params_brain_sim.csv,
   N=2048, kbdm_fit at m=512 with p=24, so k=32; 10 GN iterations; all 16
   lines in f32, refined within 1e-8 of oracle.kbdm), config 3 (the 46-entry
   sweep m=120..300 step 4, min_samples 10, all 32 slots refined: 64 x 64
   solves; within 1e-8 of the truth), config 1 noiseless with 3 GN
   iterations (within 1e-8 of oracle.kbdm) and the llc_kbdm entry point
   (refine_iters 6, within 1e-8 of the truth); the Jacobi counter at p=24
   on the config-2 and config-3 sweeps; cholqr_rinv held to its contract on
   their Grams.  Then the north star with damping_weight=1.0 (the O(n^2)
   dbscan on 2-D features; every voxel keeps >= 5 refined lines, the 8
   voxels with the largest last GN step meet the 1e-8 gate), and dbscan
   against dbscan_1d on the main path's pooled lines: labels equal on every
   voxel but those with an exact eps tie, each timed at V=2048 with its
   peak memory.  Last, each main-path kernel at the widths of configs 2 and
   3 (eig_cs n=24, gram_svd and cholqr_rinv k=32, chol_solve 24, 48 and 64)
   on a batch of 2048, and gn_normal at the brain cell's (1024, 32, 2048),
   against its plain version, timed beside its bound and library call.
   Then the wide phase, on the float32 power iterations (WIDE_BF16: past
   p=16 the JAX package's accelerator algorithm, which the card's default
   runs, loses the noisy north star's lines; a record prints the default
   at p = 24, 32 and 56): the north star at KbdmConfig(p=32) (k=40) and
   KbdmConfig(p=56) (k=64, the kernels' limit, eig_cs n=56), each driven
   once with the launch counts set to 0 before and read after (every
   main-path kernel launched, no plain version on a CUDA tensor), with its
   fit and refine ms, peak memory, the Jacobi counter, and the 1e-8 oracle
   gate on its 8 voxels with the largest last GN step, missed only where
   the CPU plain path misses it too and 20 GN iterations on the card meet
   it (each in one pass of the 2048 voxels, at most WIDE_PEAK_GIB = 60 GiB
   at p=56); then gram_svd at
   k=40, 48 and 64 (on the north star's projected matrices at p = k - 8),
   cholqr_rinv at the same k (well-conditioned Grams) and eig_cs at n=40
   and 56 (on its reduced matrices at p = n, matched eigenvalue sets where
   both versions converged) on a batch of 2048, against their plain
   versions, timed beside bound and library call.
6. The two tool kernels, each through its tool's path with the launch
   counts set to 0 before and read after: ``tools.kernel_smoke.run``
   (row_probe against its numpy loop) and ``tools.bench_eigh_variants``'
   seven runs (eigh_probe's invariants and finite w at (4480, 24, 24), 8
   sweeps, timed).  Then row_probe against its plain version, with and
   without i == j in the schedule (which stays on the host), timed beside
   the launch floor (an empty kernel through the same ctypes path) and its
   bound, and eigh_probe against its plain version over one sweep in all
   five variants, at n=8 and on 4 x 4 block-diagonal inputs at n=40 and 64;
   the plain eigh probe at the tool's size is timed over one call.
7. The grid layer (``llckbdm_tpu_torch.parallel``) at config-5 size: a
   GridRunner sweep of 256x256 = 65,536 voxels of tools/config5_run.py's
   signal family in 32 shards of 2048, refined (top 16 clusters, 6 GN
   iterations), with its wall time (host copies and .npz writes included)
   and peak device memory.  All four main-path kernels must have been
   launched by GridRunner.run and no plain version handed a CUDA tensor;
   every voxel keeps >= 5 refined lines; the 8 voxels with the largest last
   GN step meet the 1e-8 oracle gate.  Then 3 shard files are deleted: the
   rerun computes exactly 3 shards and gathers bit for bit what the first
   run gathered.
8. Two ranks on the one card over gloo (spawned processes, file://
   rendezvous): with mesh data=1, time=2, the time-sharded refinement of
   the main path's lines against the single-process refinement (z within
   5e-9, d within 5e-8), timed beside it and beside the same per-rank
   compute without its all-reduce, and fit_and_refine_grid on the
   V=2048 signals at the configuration's max_clusters=32 (64 x 64 GN
   solves) against the single-process refinement of the same 32 slots
   (the same bounds, the 1e-8 oracle gate on its 8 worst voxels; on each
   rank, counted from 0 just before it, chol_solve launched at least 6
   times, gn_normal exactly 6, and no plain version handed a CUDA tensor;
   on rank 0, which fits, every main-path kernel launched); with
   data=2, time=1, fit_grid_sharded's two row blocks against the main
   path's fit (counts and masks exact, lines within 1e-4).  A failed child
   fails the script.
9. The entry points and the measuring tools, each phase printing its wall
   time: ``entry()``'s config-1 kbdm_fit on the card (16 finite line slots,
   every main-path kernel launched, no plain version on a CUDA tensor);
   ``dryrun_multichip(8)``, eight gloo ranks on the one card (mesh data=4 x
   time=2), refined (8, 4), every rank's launches read; the stage profiler
   ``tools.ablate_sweep`` at V=2048 on each power-iteration branch, whose
   whole-sweep time must lie within 10% of kbdm_sweep's timed in the same
   call; the implicit FFT Hankel
   apply against the dense one (2e-6) and ``tools.bench_fft_hankel`` at
   its two shapes; ``tools.tune_sweeps``, ``tools.noise_gate_sweep`` and
   ``tools.scaling_bench`` (1, 2 and 4 ranks of the one card) at their
   defaults, each failing the script where it prints FAIL at the
   production defaults, the data-parallel fit issuing no collective and
   the time-sharded refine one all-reduce per GN iteration; a one-rank
   NCCL group made by ``distributed_init(None, backend="nccl",
   device="cuda:0")`` in a spawned child, bound to cuda:0
   (``bound_device_id``), one all-reduce on it, and no "Guessing device
   ID" in the child's stderr; then the three
   tools ported last: ``tools.precision_gate`` at its defaults (the two
   gates and the V=512 sweep at mxu_precision "highest" and "high", on
   both power-iteration branches; failing the script only where the
   default fails), ``tools.config5_run`` on 8,192 voxels run twice into one
   temporary --out (the rerun resumes every shard and gathers bit for
   bit) and ``tools.trace_capture`` of one fit at V=256.

The float64 oracle is the port's own (``llckbdm_tpu_torch/oracle.py``,
numpy and scipy only): nothing of JAX or of the JAX package is loaded.  The
script exits with 2 where there is no CUDA device or no package beside it.
Nothing catches a failure of the port.  The last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
N, DWELL, VOXELS = 512, 5e-4, 2048
M_VALUES = tuple(range(120, 257, 4))
REFINE_CLUSTERS, GN_ITERS, GATE_VOXELS = 16, 6, 8
CLOCKS_QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"
# the kernels of a fit, and of a fit and its refinement
FIT_KERNELS = ("eig_cs", "gram_svd", "cholqr_rinv", "chol_solve")
MAIN_KERNELS = FIT_KERNELS + ("gn_normal",)
# the sweep's CholeskyQR pass (one LAUNCHES count a pass: its Gram and mix
# kernels around cholqr_rinv), timed at the benchmark cells' shapes:
# (label, V, m_max, S, k, storage); entry i keeps m_max - 4 (S - 1 - i) rows
ORTH_KERNELS = ("orth_gram", "orth_mix")
ORTH_TIMED = (("five-peak power iterations", VOXELS, 256, 35, 24, "bf16"),
              ("five-peak final passes", VOXELS, 256, 35, 24, "complex64"),
              ("brain", 1024, 300, 46, 32, "complex64"))
GRID_SIDE, GRID_SHARD, GRID_DELETE = 256, 2048, 3
CONFIG5_VOXELS = 8192       # tools.config5_run's grid, cut to 4 shards
BRAIN_N, BRAIN_DWELL, SPEC_GN_ITERS, SPEC_BATCH = 2048, 2.5e-4, 10, 2048
# the wide phase: KbdmConfig.p past one warp's 32 lanes (k = p + 8 = 40 and
# 64, the kernels' limit); the kernels alone at these widths
WIDE_P, WIDE_K, WIDE_N = (32, 56), (40, 48, 64), (40, 56)
# the wide phase's peak device memory at p=56: one pass of the sweep over
# the 2048 voxels at k=64, whose (V, m, S, k) basis is 8.75 GiB a copy
WIDE_PEAK_GIB = 60.0
# The wide phase runs the float32 power iterations: past p=16 the JAX
# package's TPU algorithm (both its branches: bfloat16, and float32 at a
# 3e-6 shift) leaves the reduced matrices of the noisy north star
# unconverged and loses the genuine lines, on the card as in the JAX package
# itself run on the CPU (ROADMAP.md section 3; wide_default_record prints
# the default branch there).  The port's float32 branch (1e-4) holds.
WIDE_BF16 = False
# p of the record of the default branch past p=16 (24: KbdmConfig's default)
RECORD_P = (24, 32, 56)
# GN iterations that must polish a wide voxel that misses the gate at
# GN_ITERS (as the oracle's own polish takes 20)
POLISH_ITERS = 20
# gn_normal against its plain version, (voxels, slots, samples, t0): the
# main path's refine, a single spectrum (one block on the card), 24 slots
# (padded inside the 32-wide kernel) and a time block at t0 > 0; then the
# brain cell's refine and its single spectrum at the widths of configs 2-4
GN_SHAPES = ((VOXELS, REFINE_CLUSTERS, N, 0), (1, REFINE_CLUSTERS, N, 0),
             (256, 24, N, 0), (16, 32, N, 300))
GN_SPEC_SHAPES = ((1024, 32, BRAIN_N, 0), (1, 32, BRAIN_N, 0))
BASE_LINES = np.array([
    [1.0, 0.05, -120.0, 0.1],
    [0.8, 0.08, -40.0, 0.0],
    [1.2, 0.03, 15.0, -0.2],
    [0.5, 0.10, 90.0, 0.3],
    [0.9, 0.06, 200.0, 0.0],
])
# The library yardsticks: for each kernel that one PyTorch call computes, that
# call's name and the call.  timed() runs it beside the kernel on the same
# inputs; nothing else calls it, and the port never does.
LIBRARY = {
    "eig_cs": ("torch.linalg.eigvals", lambda a: torch.linalg.eigvals(a)),
    "gram_svd": ("torch.linalg.svd(full_matrices=False)",
                 lambda m: torch.linalg.svd(m, full_matrices=False)),
    "chol_solve": ("torch.linalg.solve on G + shift I",
                   lambda g_shifted, rhs: torch.linalg.solve(g_shifted,
                                                             rhs[..., None])),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rows_of(z, d, mask) -> np.ndarray:
    """One voxel's refined poles and amplitudes (numpy) -> refined_to_np's
    float64 (A, T2, f, phase) rows sorted by frequency."""
    from llckbdm_tpu_torch.solver.refine import RefinedLines, refined_to_np

    z, d, mask = (torch.from_numpy(np.asarray(x)) for x in (z, d, mask))
    return refined_to_np(RefinedLines(z=z, d=d, mask=mask, lines=None,
                                      gn_step=None), DWELL)


def gate_errors(voxels, sigs, truths, init_of, est_of) -> list:
    """Per voxel, the largest error of the refined lines against the float64
    oracle's Gauss-Newton polish (20 iterations) from init_of(i)."""
    from llckbdm_tpu_torch.tools.five_peak import gate_error

    return [gate_error(est_of(i), init_of(i), sigs[i], truths[i])
            for i in voxels]


def largest_step_voxels(gn_step: np.ndarray) -> list:
    """The GATE_VOXELS voxels with the largest last GN step."""
    return np.argsort(-gn_step.max(axis=-1), kind="stable")[:GATE_VOXELS].tolist()


def yardstick(name: str, *args) -> tuple:
    """(call's name, fn): LIBRARY's call for kernel ``name`` on ``args``."""
    call, fn = LIBRARY[name]
    return call, lambda: fn(*args)


def timed(label: str, kernel, plain, bnd, library: tuple) -> dict:
    """Kernel and plain times by ``cuda_ms``, printed with their spread,
    beside the card's least time ``bnd`` (tools/bounds.py) for the same
    work and, where one PyTorch call computes the same function, that
    call's time: ``library`` is ``yardstick(...)`` or (None, why there is
    none).  ``plain`` may instead be the Timing of a call already made."""
    from llckbdm_tpu_torch.tools.timing import Timing, cuda_ms

    t_k = cuda_ms(kernel)
    t_p = plain if isinstance(plain, Timing) else cuda_ms(plain)
    out = dict(ms=t_k.ms, plain_ms=t_p.ms, ms_range=[t_k.lo, t_k.hi],
               plain_ms_range=[t_p.lo, t_p.hi], bound_ms=bnd.ms,
               bound_by=bnd.by, flops=bnd.flops, bytes=bnd.bytes)
    call, fn = library
    if call is None:
        out.update(library_call=None, library_ms=None, library_null_reason=fn)
        lib = f"no library call ({fn})"
    else:
        t_l = cuda_ms(fn)
        out.update(library_call=call, library_ms=t_l.ms,
                   library_ms_range=[t_l.lo, t_l.hi])
        lib = f"{call} {t_l}"
    print(f"{label}: kernel {t_k}; plain {t_p}; bound {bnd.ms:.4f} ms "
          f"({bnd.by}: {bnd.flops:.4g} flop, {bnd.bytes:.4g} B); library "
          f"{lib}", flush=True)
    return out


def matched_eig_err(mu_a: torch.Tensor, mu_b: torch.Tensor) -> torch.Tensor:
    """Per matrix, the largest distance of a greedy one-to-one matching of
    two unordered eigenvalue sets (B, n) -> (B,)."""
    d = (mu_a[:, :, None] - mu_b[:, None, :]).abs()
    n = d.shape[-1]
    worst = torch.zeros(d.shape[0], device=d.device, dtype=d.dtype)
    rows = torch.arange(d.shape[0], device=d.device)
    for _ in range(n):
        best = d.reshape(d.shape[0], -1).min(dim=-1)
        i, j = best.indices // n, best.indices % n
        worst = torch.maximum(worst, best.values)
        d[rows, i, :] = float("inf")
        d[rows, :, j] = float("inf")
    return worst


def crandn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.complex(torch.randn(*shape, generator=gen, device=DEVICE),
                         torch.randn(*shape, generator=gen, device=DEVICE))


def gram(gen: torch.Generator, b: int, k: int) -> torch.Tensor:
    """Well-conditioned Hermitian PD Gram matrices y^H y, y (b, rows, k)
    with rows = max(64, 2k) (a square y would make G ill-conditioned)."""
    y = crandn(gen, b, max(64, 2 * k), k)
    return y.conj().transpose(-1, -2) @ y


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().amax() / b.abs().amax()).item()


def contract_error(x: torch.Tensor, g: torch.Tensor, sh: torch.Tensor,
                   chunk: int = 8192) -> float:
    """max |X^H (G + shift I) X - I| in float64 over a batch of k x k
    matrices: 0 for X = R^-1 of the Cholesky factor G + shift I = R^H R."""
    k = g.shape[-1]
    eye = torch.eye(k, dtype=torch.complex128, device=g.device)
    worst = 0.0
    for s0 in range(0, g.shape[0], chunk):
        x64 = x[s0:s0 + chunk].to(torch.complex128)
        gs = (g[s0:s0 + chunk].to(torch.complex128)
              + sh[s0:s0 + chunk].double()[:, None, None] * eye)
        worst = max(worst, (x64.conj().transpose(-1, -2) @ gs @ x64
                            - eye).abs().amax().item())
    return worst


def production_gram_checks(c32: torch.Tensor, dwell: float, m_values, kcfg,
                           source: str) -> dict:
    """cholqr_rinv and its plain version on the Gram matrices a sweep of
    the signals ``c32`` hands the kernel.  They are numerically
    rank-deficient (a few lines in a k-wide block), some pivots are of the
    size of the shift, and another summation order changes them; so the two
    are not compared entry by entry but each held to the contract R^-H (G +
    shift I) R^-1 = I in float64, to 0.2 k eps / shift_rel (the bound of the
    rank-5 tests in tests/test_torch_kernels.py), with finite outputs.  On
    the bfloat16 branch the power iterations' Grams are those of its
    upcast blocks, which ``_stop="powiter"`` returns and which are formed
    here as the sweep forms them.  The pass itself (``orth_pass``) is held
    to the same contract: its own G and shift (``orth_gram``, on the block
    in the storage the pass reads: the bfloat16 branch's pairs in its power
    iterations) and the R^-1 cholqr_rinv forms from them ("pass")."""
    from llckbdm_tpu_torch import kbdm_sweep
    from llckbdm_tpu_torch.ops import cuda_linalg
    from llckbdm_tpu_torch.solver import kbdm

    k = kcfg.p + kcfg.oversample
    bf16 = kbdm.bf16_power_iterations(c32, kcfg)
    powiter_shift = (kbdm.BF16_POWITER_SHIFT if bf16
                     else kbdm.F32_POWITER_SHIFT)
    cases = (
        ("power iteration 2", powiter_shift, "powiter",
         dataclasses.replace(kcfg, subspace_iters=kcfg.subspace_iters - 1)),
        ("final pass 1", kbdm.FINAL_SHIFT, "powiter", kcfg),
        ("final pass 2", kbdm.FINAL_SHIFT, "basis",
         dataclasses.replace(kcfg, final_orth_passes=1)),
    )
    out = {}
    for label, shift_rel, stop, case_cfg in cases:
        y = kbdm_sweep(c32, dwell, m_values, case_cfg, _stop=stop)
        pairs = bf16 and label == "power iteration 2"
        g_pass, sh_pass = cuda_linalg.orth_gram(
            cuda_linalg.to_pairs(y) if pairs else y, shift_rel)
        g_pass, sh_pass = g_pass.reshape(-1, k, k), sh_pass.reshape(-1)
        g = torch.einsum("vmsk,vmsl->vskl", y.conj(), y)
        del y
        g = (0.5 * (g + g.transpose(-1, -2).conj())).reshape(-1, k, k)
        sh = shift_rel * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
        bound = 0.2 * k * float(np.finfo(np.float32).eps) / shift_rel
        errs = {}
        for name, fn, gg, ss in (
                ("kernel", cuda_linalg.cholqr_rinv, g, sh),
                ("plain", cuda_linalg.cholqr_rinv_plain, g, sh),
                ("pass", cuda_linalg.cholqr_rinv, g_pass, sh_pass)):
            x = fn(gg, ss)
            check(bool(torch.isfinite(torch.view_as_real(x)).all()),
                  f"cholqr_rinv {name}: non-finite R^-1 on the production "
                  f"Grams of {label}")
            errs[name] = contract_error(x, gg, ss)
        print(f"cholqr_rinv on {source}'s Grams, {label} {tuple(g.shape)}, "
              f"shift {shift_rel:g} x mean diagonal: |R^-H (G + shift I) "
              f"R^-1 - I| kernel {errs['kernel']:.3e}, plain "
              f"{errs['plain']:.3e}, the pass's own G "
              f"({'bfloat16 pairs' if pairs else 'complex64'}) "
              f"{errs['pass']:.3e} (< {bound:.3e}); all finite", flush=True)
        check(max(errs.values()) < bound,
              f"cholqr_rinv misses its contract on {source}'s Grams of "
              f"{label}: {errs}")
        out[label] = dict(shift_rel=shift_rel, bound=bound, **errs)
        del g, x, g_pass
    return out


def orth_pass_checks() -> dict:
    """The sweep's CholeskyQR pass (``cuda_linalg.orth_pass``:
    csrc/orth_pass.cu's Gram and mix around cholqr_rinv) against its plain
    version at the benchmark cells' shapes (ORTH_TIMED), on Gaussian blocks
    masked as the sweep masks them (entry i keeps its rows below the cell's
    m_i): G Hermitian bit for bit, masked rows exactly 0, Q within float32
    rounding (1e-5 of its largest entry) or one bfloat16 step; timed beside
    its bound and the plain version (no library call forms a shifted
    CholeskyQR pass).  Returns the first row, the others under
    "shapes"."""
    from llckbdm_tpu_torch.ops import cuda_linalg
    from llckbdm_tpu_torch.tools import bounds

    rows = []
    for label, v, m, s, k, storage in ORTH_TIMED:
        gen = torch.Generator(device=DEVICE).manual_seed(m + k)
        y = torch.randn((v, m, s, k), generator=gen, dtype=torch.complex64,
                        device=DEVICE)
        keep = torch.arange(m - 4 * (s - 1), m + 1, 4, device=DEVICE)
        y *= (torch.arange(m, device=DEVICE)[:, None] < keep)[..., None]
        x = cuda_linalg.to_pairs(y) if storage == "bf16" else y
        del y
        g, _ = cuda_linalg.orth_gram(x, 1e-4)
        check(torch.equal(g, g.transpose(-1, -2).conj()),
              f"orth_pass {label}: G is not Hermitian")
        del g
        q, q_p = (fn(x, 1e-4) for fn in (cuda_linalg.orth_pass,
                                         cuda_linalg.orth_pass_plain))
        qc, qc_p = (cuda_linalg.from_pairs(t) if storage == "bf16" else t
                    for t in (q, q_p))
        scale = qc_p.abs().max().item()
        if storage == "bf16":
            a, b = q.float(), q_p.float()
            ok = bool(((a - b).abs() <= torch.maximum(a.abs(), b.abs())
                       * 2.0 ** -7 + 64 * 2.0 ** -23 * scale).all())
            err = (a - b).abs().max().item() / scale
        else:
            err = (qc - qc_p).abs().max().item() / scale
            ok = err < 1e-5
        zero = all(bool((qc[:, mm:, i, :] == 0).all())
                   for i, mm in enumerate(keep.tolist()))
        print(f"orth_pass {label} {(v, m, s, k)} {storage}: |Q - plain| "
              f"{err:.3e} of its largest entry; masked rows 0: {zero}",
              flush=True)
        check(ok and zero, f"orth_pass {label} disagrees with its plain "
              f"version ({err:.3e}, masked rows 0: {zero})")
        del q, q_p, qc, qc_p
        rows.append(dict(label=label, shape=[v, m, s, k], storage=storage,
                         rel_err=err, **timed(
                             f"orth_pass {label} ({v}, {m}, {s}, {k}) "
                             f"{storage}",
                             lambda: cuda_linalg.orth_pass(x, 1e-4),
                             lambda: cuda_linalg.orth_pass_plain(x, 1e-4),
                             bounds.orth_pass(v * s, m, k, storage),
                             (None, "no library call forms a shifted "
                                    "CholeskyQR pass"))))
        del x
    return {**rows[0], "shapes": rows[1:]}


def kernel_checks(ut: torch.Tensor, ut_odd: torch.Tensor, cfg) -> dict:
    """Each kernel against its plain version on the same CUDA inputs."""
    from llckbdm_tpu_torch.ops import cuda_jacobi, cuda_linalg
    from llckbdm_tpu_torch.tools import bounds

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    out = {}

    # eig_cs_resid on production reduced matrices (and at odd p): both sides
    # run the same float32 algorithm, but complex-orthogonal rotations are
    # not norm-preserving, so rounding differences (FMA contraction,
    # reduction order) grow along the rotation chain.  Matched eigenvalues
    # must agree to 3e-3 of the matrix's Frobenius norm, the bound the TPU
    # kernel's own tests hold this f32 algorithm to
    # (tests/test_pallas_kernels.py).
    sweeps = cfg.eig_sweeps
    worst = 0.0
    for a in (ut, ut_odd):
        n = a.shape[-1]
        mu_k, res_k = cuda_jacobi.eig_cs_resid(a, sweeps)
        mu_p, res_p = cuda_jacobi.eig_cs_resid_plain(a, sweeps)
        err = matched_eig_err(mu_k.reshape(-1, n), mu_p.reshape(-1, n))
        fro = torch.sqrt(torch.sum(a.abs() ** 2, dim=(-1, -2))).reshape(-1)
        rel = (err / fro).double()
        q = torch.quantile(rel, torch.tensor([0.5, 0.999], device=DEVICE,
                                             dtype=torch.float64))
        print(f"eig_cs {tuple(a.shape)}: matched |dmu|/|A|_F median "
              f"{q[0].item():.3e} p99.9 {q[1].item():.3e} max "
              f"{rel.max().item():.3e}; resid/|A|_F max kernel "
              f"{(res_k.reshape(-1) / fro).max().item():.3e} plain "
              f"{(res_p.reshape(-1) / fro).max().item():.3e}")
        check(bool(torch.isfinite(mu_k).all()), "eig_cs: non-finite eigenvalues")
        check(rel.max().item() < 3e-3, f"eig_cs n={n} disagrees: "
              f"{rel.max().item():.3e}")
        worst = max(worst, err.max().item())
    n = ut.shape[-1]
    out["eig_cs"] = dict(
        max_abs_err=worst, tol="matched |dmu| <= 3e-3 |A|_F",
        shape=list(ut.shape), sweeps=sweeps,
        **timed(f"eig_cs {tuple(ut.shape)}",
                lambda: cuda_jacobi.eig_cs_resid(ut, sweeps),
                lambda: cuda_jacobi.eig_cs_resid_plain(ut, sweeps),
                bounds.eig_cs(ut.numel() // (n * n), n, sweeps),
                yardstick("eig_cs", ut)))

    # gram_svd: singular values to f32 rounding; V is unique only up to a
    # phase per column (the w phase of a converged pair is rounding noise),
    # so V is checked through m m^H = V diag(s^2) V^H.
    batch = ut.shape[0] * ut.shape[1]
    k, es = cfg.p + cfg.oversample, cfg.eigh_sweeps
    worst = 0.0
    for kk, b in ((k, batch), (k - 1, 4096), (32, 4096)):
        m = crandn(gen, b, kk, kk)
        s_k, v_k = cuda_linalg.gram_svd(m, es)
        s_p, v_p = cuda_linalg.gram_svd_plain(m, es)
        mm = m @ m.conj().transpose(-1, -2)
        rec = ((v_k * (s_k * s_k)[:, None, :]) @ v_k.conj().transpose(-1, -2)
               - mm).abs().amax() / mm.abs().amax()
        ds = rel_err(s_k, s_p)
        print(f"gram_svd ({b}, {kk}, {kk}): |ds|/s_max {ds:.3e}, "
              f"reconstruction {rec.item():.3e}")
        check(ds < 1e-5 and rec.item() < 1e-4, f"gram_svd k={kk} disagrees")
        worst = max(worst, (s_k - s_p).abs().max().item())
    m = crandn(gen, batch, k, k)
    out["gram_svd"] = dict(
        max_abs_err=worst, tol="|ds| <= 1e-5 s_max; reconstruction <= 1e-4",
        shape=[batch, k, k], sweeps=es,
        **timed(f"gram_svd ({batch}, {k}, {k})",
                lambda: cuda_linalg.gram_svd(m, es),
                lambda: cuda_linalg.gram_svd_plain(m, es),
                bounds.gram_svd(batch, k, es), yardstick("gram_svd", m)))

    # cholqr_rinv and chol_solve on well-conditioned Gram matrices: the same
    # f32 operations in another summation order, so 1e-5 relative
    # (the kernel is compiled at 16, 24, 32 and 64; any other size is
    # padded up inside it: 23 and 20 run in the 24-wide one, 31 in the
    # 32-wide)
    worst = 0.0
    for kk, b in ((k, batch), (k - 1, 4096), (16, 4096), (20, 4096),
                  (32, 4096), (31, 4096)):
        g = gram(gen, b, kk)
        sh = 3e-6 * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
        x_k = cuda_linalg.cholqr_rinv(g, sh)
        x_p = cuda_linalg.cholqr_rinv_plain(g, sh)
        e = rel_err(x_k, x_p)
        # and the contract itself, in float64: R^-H (G + shift I) R^-1 = I
        orth = contract_error(x_k, g, sh)
        print(f"cholqr_rinv ({b}, {kk}, {kk}): max rel err {e:.3e}, "
              f"|R^-H G R^-1 - I| {orth:.3e}")
        check(e < 1e-5 and orth < 1e-4, f"cholqr_rinv k={kk} disagrees")
        check(not bool(x_k.tril(-1).any()),
              f"cholqr_rinv k={kk}: R^-1 is not zero below the diagonal")
        worst = max(worst, (x_k - x_p).abs().max().item())
    g = gram(gen, batch, k)
    sh = 3e-6 * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
    out["cholqr_rinv"] = dict(
        max_abs_err=worst, tol="1e-5 relative", shape=[batch, k, k],
        **timed(f"cholqr_rinv ({batch}, {k}, {k})",
                lambda: cuda_linalg.cholqr_rinv(g, sh),
                lambda: cuda_linalg.cholqr_rinv_plain(g, sh),
                bounds.cholqr_rinv(batch, k),
                (None, "no single call gives R^-1 of the shifted Cholesky "
                       "factor: cholesky and then a triangular inverse are "
                       "two")))

    worst = 0.0
    timing = {}
    p, v = cfg.p, ut.shape[0]
    gn, wide = 2 * REFINE_CLUSTERS, cuda_linalg.MAX_K_SOLVE
    for kk, b in ((p, batch), (gn, v), (wide, v), (p - 1, 4096),
                  (gn - 1, 4096), (wide - 1, 4096), (20, 4096), (40, 4096)):
        g = gram(gen, b, kk)
        rhs = crandn(gen, b, kk)
        sh = 1e-7 * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
        x_k = cuda_linalg.chol_solve(g, rhs, sh)
        x_p = cuda_linalg.chol_solve_plain(g, rhs, sh)
        e = rel_err(x_k, x_p)
        # and the solve itself, in float64: |(G + shift I) x - b| / |b|
        eye = torch.eye(kk, dtype=torch.complex128, device=DEVICE)
        gs = g.to(torch.complex128) + sh.double()[:, None, None] * eye
        res = ((gs @ x_k.to(torch.complex128)[..., None])[..., 0]
               - rhs.to(torch.complex128)).abs().amax() / rhs.abs().amax()
        print(f"chol_solve ({b}, {kk}, {kk}): max rel err {e:.3e}, "
              f"residual {res.item():.3e}")
        check(e < 1e-5 and res.item() < 1e-4, f"chol_solve k={kk} disagrees")
        worst = max(worst, (x_k - x_p).abs().max().item())
        if kk in (p, gn, wide):
            g_shifted = g + sh[:, None, None] * torch.eye(
                kk, dtype=g.dtype, device=DEVICE)
            timing[kk] = timed(
                f"chol_solve ({b}, {kk}, {kk})",
                lambda: cuda_linalg.chol_solve(g, rhs, sh),
                lambda: cuda_linalg.chol_solve_plain(g, rhs, sh),
                bounds.chol_solve(b, kk),
                yardstick("chol_solve", g_shifted, rhs))
    out["gn_normal"] = gn_normal_checks(GN_SHAPES)
    # amplitudes; the main path's GN (16 clusters); the configuration's own
    # GN (max_clusters=32: fit_and_refine_grid in the two-rank phase)
    out["chol_solve"] = dict(
        max_abs_err=worst, tol="1e-5 relative", shape=[batch, p, p],
        **timing[p], shape_gn=[v, gn, gn],
        **{f"{key}_gn": val for key, val in timing[gn].items()},
        shape_gn64=[v, wide, wide],
        **{f"{key}_gn64": val for key, val in timing[wide].items()})
    # what each compiled size of the two Cholesky kernels takes of an SM
    for name, sizes in (("cholqr_rinv", (16, k, 32, cuda_linalg.MAX_K)),
                        ("chol_solve", (p, gn, 48, wide))):
        out[name]["resources"] = [cuda_linalg.chol_kernel_resources(name, kk)
                                  for kk in sizes]
        for res in out[name]["resources"]:
            print(f"{name}<{res['K']}>: {res['registers']} registers a "
                  f"thread, {res['shared_bytes']} B shared a block of "
                  f"{res['threads']} threads, {res['local_bytes']} B local "
                  f"a thread, {res['blocks_per_sm']} blocks = "
                  f"{res['warps_per_sm']} warps resident an SM")
            check(res["local_bytes"] == 0, f"{name}<{res['K']}> spills")
    return out


def gn_normal_checks(shapes) -> dict:
    """gn_normal against its plain version at each of ``shapes``: G on pairs
    of unmasked slots within 1e-5 of its largest entry there, the rhs on
    unmasked rows within 1e-6 of each half's largest (the powers, residual
    and rhs are float64 on both sides, G float32 summed in another order);
    the first shape timed beside its bound."""
    from llckbdm_tpu_torch.ops import cuda_linalg
    from llckbdm_tpu_torch.tools import bounds
    from llckbdm_tpu_torch.tools.normal_checks import (normal_errors,
                                                       normal_inputs)

    rows = []
    for v, nc, n, t0 in shapes:
        c, z, d, mask = normal_inputs(v, nc, n, t0, seed=nc + t0,
                                      device=DEVICE)
        g, rhs = cuda_linalg.gn_normal(c, z, d, t0)
        g_p, rhs_p = cuda_linalg.gn_normal_plain(c, z, d, t0)
        eg, er = normal_errors(g, rhs, g_p, rhs_p, mask)
        run = cuda_linalg.gn_normal_run(nc, n)
        print(f"gn_normal ({v}, {nc}, {n}) t0={t0}, runs of {run}: G "
              f"{eg:.3e} of its largest entry, rhs {er:.3e}", flush=True)
        check(bool(torch.isfinite(torch.view_as_real(g)).all())
              and eg <= 1e-5 and er <= 1e-6,
              f"gn_normal ({v}, {nc}, {n}) t0={t0} disagrees: {eg}, {er}")
        rows.append(dict(shape=[v, nc, n], t0=t0, g_err=eg, rhs_err=er,
                         run=run))
        del c, z, d, g, rhs, g_p, rhs_p
    v, nc, n, t0 = shapes[0]
    c, z, d, _ = normal_inputs(v, nc, n, t0, device=DEVICE)
    return dict(shape=[v, nc, n], checks=rows,
                tol="G 1e-5 of its largest unmasked entry; rhs 1e-6",
                **timed(f"gn_normal ({v}, {nc}, {n})",
                        lambda: cuda_linalg.gn_normal(c, z, d, t0),
                        lambda: cuda_linalg.gn_normal_plain(c, z, d, t0),
                        bounds.gn_normal(v, nc, n),
                        (None, "no single call forms the normal equations "
                               "of a Gauss-Newton step")))


def spec_kernel_checks(oracle) -> dict:
    """Each main-path kernel at the widths of configs 2 and 3 (p=24, k=32),
    against its plain version and timed beside its bound and library call,
    at a batch of SPEC_BATCH: a shard of config-2 voxels (one sweep entry
    each).  eig_cs takes config 3's reduced matrices of the brain signal
    (46 a voxel, repeated to the batch); gram_svd, cholqr_rinv and
    chol_solve take the generators of kernel_checks.  chol_solve at 24
    (the amplitude solve, in the 32-wide kernel), 48 (the GN solve of 24
    lines, in the 64-wide) and 64 (32 refined clusters); gn_normal at
    GN_SPEC_SHAPES (32 slots of N=2048)."""
    from llckbdm_tpu_torch import KbdmConfig, kbdm_sweep
    from llckbdm_tpu_torch.ops import cuda_jacobi, cuda_linalg
    from llckbdm_tpu_torch.tools import bounds

    kcfg = KbdmConfig(p=24)
    p, k, b = kcfg.p, kcfg.p + kcfg.oversample, SPEC_BATCH
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    sig, _ = brain_signal(oracle)
    ut = kbdm_sweep(torch.as_tensor(sig[None], device=DEVICE)
                    .to(torch.complex64), BRAIN_DWELL, tuple(range(120, 301, 4)),
                    kcfg, _stop="reduced").reshape(-1, p, p)
    ut = ut.repeat(-(-b // ut.shape[0]), 1, 1)[:b].contiguous()
    out = {}

    mu_k, res_k = cuda_jacobi.eig_cs_resid(ut, kcfg.eig_sweeps)
    mu_p, res_p = cuda_jacobi.eig_cs_resid_plain(ut, kcfg.eig_sweeps)
    # where both versions converged (counter below 1e-3 |A|_F), matched
    # eigenvalues within 3e-3 |A|_F, as in tests/test_torch_cuda.py
    fro = torch.sqrt(torch.sum(ut.abs() ** 2, dim=(-1, -2)))
    err = matched_eig_err(mu_k, mu_p)
    both = (res_k / fro < 1e-3) & (res_p / fro < 1e-3)
    rel = (err / fro)[both]
    print(f"eig_cs {tuple(ut.shape)} (config 3's reduced matrices): both "
          f"converged on {both.float().mean().item():.4f}; there matched "
          f"|dmu|/|A|_F max {rel.max().item():.3e}; resid/|A|_F max kernel "
          f"{(res_k / fro).max().item():.3e} plain "
          f"{(res_p / fro).max().item():.3e}", flush=True)
    check(both.float().mean().item() >= 0.9 and rel.max().item() < 3e-3,
          f"eig_cs n={p} disagrees")
    out["eig_cs"] = dict(
        shape=list(ut.shape), max_abs_err=err[both].max().item(),
        **timed(f"eig_cs {tuple(ut.shape)}",
                lambda: cuda_jacobi.eig_cs_resid(ut, kcfg.eig_sweeps),
                lambda: cuda_jacobi.eig_cs_resid_plain(ut, kcfg.eig_sweeps),
                bounds.eig_cs(b, p, kcfg.eig_sweeps), yardstick("eig_cs", ut)))

    m = crandn(gen, b, k, k)
    s_k, _ = cuda_linalg.gram_svd(m, kcfg.eigh_sweeps)
    s_p, _ = cuda_linalg.gram_svd_plain(m, kcfg.eigh_sweeps)
    check(rel_err(s_k, s_p) < 1e-5, f"gram_svd k={k} disagrees")
    out["gram_svd"] = dict(
        shape=[b, k, k], max_abs_err=(s_k - s_p).abs().max().item(),
        **timed(f"gram_svd ({b}, {k}, {k})",
                lambda: cuda_linalg.gram_svd(m, kcfg.eigh_sweeps),
                lambda: cuda_linalg.gram_svd_plain(m, kcfg.eigh_sweeps),
                bounds.gram_svd(b, k, kcfg.eigh_sweeps),
                yardstick("gram_svd", m)))

    g = gram(gen, b, k)
    sh = 3e-6 * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
    x_k = cuda_linalg.cholqr_rinv(g, sh)
    x_p = cuda_linalg.cholqr_rinv_plain(g, sh)
    check(rel_err(x_k, x_p) < 1e-5, f"cholqr_rinv k={k} disagrees")
    out["cholqr_rinv"] = dict(
        shape=[b, k, k], max_abs_err=(x_k - x_p).abs().max().item(),
        **timed(f"cholqr_rinv ({b}, {k}, {k})",
                lambda: cuda_linalg.cholqr_rinv(g, sh),
                lambda: cuda_linalg.cholqr_rinv_plain(g, sh),
                bounds.cholqr_rinv(b, k),
                (None, "no single call gives R^-1 of the shifted Cholesky "
                       "factor: cholesky and then a triangular inverse are "
                       "two")))

    out["chol_solve"] = []
    for kk in (p, 2 * p, cuda_linalg.MAX_K_SOLVE):
        g = gram(gen, b, kk)
        rhs = crandn(gen, b, kk)
        sh = 1e-7 * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
        x_k = cuda_linalg.chol_solve(g, rhs, sh)
        x_p = cuda_linalg.chol_solve_plain(g, rhs, sh)
        check(rel_err(x_k, x_p) < 1e-5, f"chol_solve k={kk} disagrees")
        g_shifted = g + sh[:, None, None] * torch.eye(kk, dtype=g.dtype,
                                                      device=DEVICE)
        out["chol_solve"].append(dict(
            shape=[b, kk, kk], max_abs_err=(x_k - x_p).abs().max().item(),
            **timed(f"chol_solve ({b}, {kk}, {kk})",
                    lambda: cuda_linalg.chol_solve(g, rhs, sh),
                    lambda: cuda_linalg.chol_solve_plain(g, rhs, sh),
                    bounds.chol_solve(b, kk),
                    yardstick("chol_solve", g_shifted, rhs))))
    out["gn_normal"] = gn_normal_checks(GN_SPEC_SHAPES)
    return out


def wide_phase(sigs, truths, c32, c64, cfg, rcfg) -> dict:
    """The north star at the widths past one warp, on the float32 power
    iterations (WIDE_BF16): for each p of WIDE_P
    (KbdmConfig(p=32): k = 40, eig_cs n = 32; KbdmConfig(p=56): k = 64, the
    kernels' limit, n = 56), llc_kbdm_fit and refine_lines on the top 16
    clusters, in one pass of the VOXELS voxels, driven once with the launch
    counts set to 0 just before and read just after (every main-path kernel
    launched, no plain version on a CUDA tensor).  The 1e-8 oracle gate on
    the 8 voxels with the largest last GN step, asserted at p = 32.  At
    p = 56 a voxel may miss it only where the CPU plain path (the same
    voxels fitted and refined on CPU tensors) misses it too, with as many
    refined lines, and where
    POLISH_ITERS GN iterations on the card's own lines meet it: at p = 56 a
    noise line can join a voxel's five, on the card and the CPU alike, and
    six iterations do not polish a model that holds it (PERF.md section 6).
    The Jacobi counter on 32
    voxels, printed (at n = 56 ten sweeps leave some noise-pole matrices
    unconverged, on the CPU as here).  Host clock
    around synchronised fit and refine, and peak device memory (at most
    WIDE_PEAK_GIB at p = 56).  Returns the results and, for the kernel
    checks, SPEC_BATCH of the sweep's own inputs to each wide kernel: the
    projected k x k matrices gram_svd takes at each k of WIDE_K (p = k - 8)
    and the reduced n x n matrices eig_cs takes at each n of WIDE_N
    (p = n)."""
    from llckbdm_tpu_torch import (KbdmConfig, LineList, kbdm_sweep,
                                   line_list_to_np, llc_kbdm_fit,
                                   refine_lines, refined_to_np)

    out = {}
    voxels_for = -(-SPEC_BATCH // len(M_VALUES))    # voxels of SPEC_BATCH entries
    for p in WIDE_P:
        wcfg = dataclasses.replace(cfg, kbdm=KbdmConfig(
            p=p, subspace_bf16=WIDE_BF16))

        def drive():
            t0 = time.perf_counter()
            cons, _, _, _ = llc_kbdm_fit(c32, DWELL, wcfg)
            top = LineList(*(x[..., :REFINE_CLUSTERS] for x in cons))
            del cons
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            refined = refine_lines(c64, top, DWELL, rcfg)
            torch.cuda.synchronize()
            return top, refined, (t1 - t0, time.perf_counter() - t1)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches, (top, refined, (t_fit, t_refine)) = counted_path(
            f"wide north star, p={p}", drive)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check(peak_gb <= WIDE_PEAK_GIB, f"wide p={p}: peak {peak_gb:.2f} GiB "
              f"> {WIDE_PEAK_GIB} GiB")
        live = refined.mask > 0.5
        n_lines = live.sum(-1)
        check(bool(torch.isfinite(refined.z[live]).all()),
              f"wide p={p}: non-finite refined lines")
        check(bool((n_lines >= 5).all()), f"wide p={p}: a voxel lost a line")
        voxels = largest_step_voxels(refined.gn_step.cpu().numpy())

        def gate_of(vox, tp, ref, row):
            # each voxel's refined lines and gate error; row[i]: i's row
            lines = {i: refined_to_np(ref._replace(
                z=ref.z[row[i]], d=ref.d[row[i]], mask=ref.mask[row[i]]),
                DWELL) for i in vox}
            errs = gate_errors(
                vox, sigs, truths,
                lambda i: line_list_to_np(LineList(*(x[row[i]] for x in tp))),
                lambda i: lines[i])
            return lines, dict(zip(vox, errs))

        lines, errs = gate_of(voxels, top, refined, {i: i for i in voxels})
        gate = max(errs.values())
        missed = [i for i in voxels if errs[i] >= 1e-8]
        # within one warp's widths the gate holds everywhere, as on the CPU
        # (tests/test_torch_wide.py)
        check(not missed or p > 32, f"wide p={p} missed the 1e-8 oracle gate "
              f"on voxels {missed}: {gate:.3e}")
        cpu_errs, polished = {}, {}
        if missed:
            # the card may miss the gate only where the CPU plain path, the
            # same algorithm in the CPU's arithmetic, misses it too, with
            # the same model (as many refined lines)
            cons, _, _, _ = llc_kbdm_fit(c32[missed].cpu(), DWELL, wcfg)
            tp = LineList(*(x[..., :REFINE_CLUSTERS] for x in cons))
            row = {i: j for j, i in enumerate(missed)}
            cpu_lines, cpu_errs = gate_of(
                missed, tp, refine_lines(c64[missed].cpu(), tp, DWELL, rcfg),
                row)
            # and more GN iterations on the card's own lines must polish it
            top_m = LineList(*(x[missed] for x in top))
            _, polished = gate_of(missed, top_m, refine_lines(
                c64[missed], top_m, DWELL,
                dataclasses.replace(rcfg, iters=POLISH_ITERS)), row)
            for i in missed:
                print(f"wide p={p}, voxel {i}: gate {errs[i]:.3e} with "
                      f"{len(lines[i])} refined lines at f "
                      f"{np.round(lines[i][:, 2], 2).tolist()}; the CPU "
                      f"plain path {cpu_errs[i]:.3e} with "
                      f"{len(cpu_lines[i])} at f "
                      f"{np.round(cpu_lines[i][:, 2], 2).tolist()}; "
                      f"{POLISH_ITERS} GN iterations on the card "
                      f"{polished[i]:.3e}", flush=True)
                check(cpu_errs[i] >= 1e-8,
                      f"wide p={p}, voxel {i}: the card misses the 1e-8 gate "
                      f"({errs[i]:.3e}) where the CPU plain path meets it "
                      f"({cpu_errs[i]:.3e})")
                check(len(lines[i]) == len(cpu_lines[i]),
                      f"wide p={p}, voxel {i}: {len(lines[i])} refined "
                      f"lines on the card, {len(cpu_lines[i])} on the CPU")
                check(polished[i] < 1e-8,
                      f"wide p={p}, voxel {i}: {POLISH_ITERS} GN iterations "
                      f"miss the gate ({polished[i]:.3e})")
        counter = jacobi_counter(c32[:32], DWELL, cfg.m_values, wcfg.kbdm)
        print(f"wide north star V={VOXELS} in one pass, p={p} (k="
              f"{p + wcfg.kbdm.oversample}): fit "
              f"{t_fit * 1e3:.1f} ms, refine {t_refine * 1e3:.1f} ms; peak "
              f"{peak_gb:.2f} GiB; refined lines per voxel min "
              f"{n_lines.min().item()} max {n_lines.max().item()}; oracle "
              f"gate {gate:.3e} on voxels {voxels} (< 1e-8 where the CPU "
              f"plain path meets it; missed on {missed}); Jacobi "
              f"off-diagonal (32 voxels) {counter:.3e}", flush=True)
        out[f"p{p}"] = dict(
            launches=launches, fit_ms=t_fit * 1e3,
            refine_ms=t_refine * 1e3, peak_gib=peak_gb, gate=gate,
            gate_voxels=voxels, gate_per_voxel=[errs[i] for i in voxels],
            missed_voxels=missed,
            cpu_plain_gate=[cpu_errs[i] for i in missed],
            polished_gate=[polished[i] for i in missed],
            jacobi_offdiag_rel=counter)
        del top, refined

    def sweep_inputs(p, stop, n):
        x = kbdm_sweep(c32[:voxels_for], DWELL, cfg.m_values,
                       KbdmConfig(p=p, subspace_bf16=WIDE_BF16), _stop=stop)
        return x.reshape(-1, n, n)[:SPEC_BATCH].contiguous()

    inputs = {"m_small": {k: sweep_inputs(k - 8, "m_small", k) for k in WIDE_K},
              "reduced": {n: sweep_inputs(n, "reduced", n) for n in WIDE_N}}
    return out, inputs


def wide_default_record(sigs, truths, c32, cfg) -> dict:
    """A record, not a gate: the north star at each p of RECORD_P on the
    card's default, the bfloat16 power iterations (the JAX package's
    accelerator algorithm): how many of the VOXELS voxels keep a
    consolidated line within 1 Hz of each of their five true lines, and
    the Jacobi counter on 32 voxels."""
    from llckbdm_tpu_torch import KbdmConfig, llc_kbdm_fit

    out = {}
    for p in RECORD_P:
        kcfg = KbdmConfig(p=p)
        cons, _, _, _ = llc_kbdm_fit(c32, DWELL, dataclasses.replace(
            cfg, kbdm=kcfg))
        f = cons.frequency[:, :REFINE_CLUSTERS].cpu().numpy()
        live = cons.mask[:, :REFINE_CLUSTERS].cpu().numpy() > 0.5
        near = (np.abs(f[:, None, :] - truths[:, :, 2, None]) < 1.0) \
            & live[:, None, :]
        kept = int(near.any(-1).all(-1).sum())
        counter = jacobi_counter(c32[:32], DWELL, cfg.m_values, kcfg)
        print(f"record (not a gate): the north star at p={p} on the default "
              f"bfloat16 power iterations keeps all five lines on {kept} of "
              f"{len(truths)} voxels; Jacobi off-diagonal (32 voxels) "
              f"{counter:.3e}", flush=True)
        out[f"p{p}"] = dict(voxels_with_five_lines=kept,
                            jacobi_offdiag_rel=counter)
        del cons
    return out


def wide_kernel_checks(inputs: dict) -> dict:
    """Each kernel that the wide widths reach, against its plain version on
    the card at a batch of SPEC_BATCH, with spec_kernel_checks' tolerances,
    timed beside its bound and library call.  gram_svd at k = 40, 48 and 64
    (two warps a matrix) on the projected matrices the north star's sweeps
    give it at p = k - 8 (``inputs["m_small"]``): on Gaussian matrices seven
    sweeps leave the algorithm itself unconverged from k = 48 on (in
    float64 too), which no kernel can agree about.  cholqr_rinv at the same
    k (four warps; 40 and 48 in the 64-wide instance) on kernel_checks'
    well-conditioned Grams.  eig_cs at n = 40 and 56 on the sweeps' reduced
    matrices at p = n (``inputs["reduced"]``), compared as matched
    eigenvalue sets where both versions converged (on 90% of those the
    plain version converges on; the kernel converging as often)."""
    from llckbdm_tpu_torch.ops import cuda_jacobi, cuda_linalg
    from llckbdm_tpu_torch.tools import bounds

    from llckbdm_tpu_torch import KbdmConfig
    from llckbdm_tpu_torch.tools.timing import Timing

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    b = SPEC_BATCH
    es, eig_sweeps = KbdmConfig().eigh_sweeps, KbdmConfig().eig_sweeps
    out = {"gram_svd": [], "cholqr_rinv": [], "eig_cs": []}
    for k in WIDE_K:
        m = inputs["m_small"][k]
        bm = m.shape[0]
        s_k, v_k = cuda_linalg.gram_svd(m, es)
        s_p, _ = cuda_linalg.gram_svd_plain(m, es)
        mm = m @ m.conj().transpose(-1, -2)
        rec = (((v_k * (s_k * s_k)[:, None, :]) @ v_k.conj().transpose(-1, -2)
                - mm).abs().amax() / mm.abs().amax()).item()
        ds = rel_err(s_k, s_p)
        print(f"gram_svd ({bm}, {k}, {k}) (the north star's projected "
              f"matrices at p={k - 8}): |ds|/s_max {ds:.3e}, reconstruction "
              f"{rec:.3e}", flush=True)
        check(ds < 1e-5 and rec < 1e-4, f"gram_svd k={k} disagrees")
        out["gram_svd"].append(dict(
            shape=[bm, k, k], sweeps=es,
            max_abs_err=(s_k - s_p).abs().max().item(),
            **timed(f"gram_svd ({bm}, {k}, {k})",
                    lambda: cuda_linalg.gram_svd(m, es),
                    lambda: cuda_linalg.gram_svd_plain(m, es),
                    bounds.gram_svd(bm, k, es), yardstick("gram_svd", m))))

        g = gram(gen, b, k)
        sh = 3e-6 * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
        x_k = cuda_linalg.cholqr_rinv(g, sh)
        x_p = cuda_linalg.cholqr_rinv_plain(g, sh)
        e, orth = rel_err(x_k, x_p), contract_error(x_k, g, sh)
        print(f"cholqr_rinv ({b}, {k}, {k}): max rel err {e:.3e}, "
              f"|R^-H G R^-1 - I| {orth:.3e}", flush=True)
        check(e < 1e-5 and orth < 1e-4, f"cholqr_rinv k={k} disagrees")
        check(not bool(x_k.tril(-1).any()),
              f"cholqr_rinv k={k}: R^-1 is not zero below the diagonal")
        out["cholqr_rinv"].append(dict(
            shape=[b, k, k], max_abs_err=(x_k - x_p).abs().max().item(),
            resources=cuda_linalg.chol_kernel_resources("cholqr_rinv", k),
            **timed(f"cholqr_rinv ({b}, {k}, {k})",
                    lambda: cuda_linalg.cholqr_rinv(g, sh),
                    lambda: cuda_linalg.cholqr_rinv_plain(g, sh),
                    bounds.cholqr_rinv(b, k),
                    (None, "no single call gives R^-1 of the shifted Cholesky "
                           "factor: cholesky and then a triangular inverse "
                           "are two"))))
        del m, mm, g, x_k, x_p

    for n, ut in inputs["reduced"].items():
        mu_k, res_k = cuda_jacobi.eig_cs_resid(ut, eig_sweeps)
        # the plain version takes 30-60 s a call here: this one call is its
        # timing too (cuda_ms would time one call after a warm-up call)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        mu_p, res_p = cuda_jacobi.eig_cs_resid_plain(ut, eig_sweeps)
        end.record()
        end.synchronize()
        t_plain = start.elapsed_time(end)
        t_plain = Timing(t_plain, t_plain, t_plain, 1, 1)
        fro = torch.sqrt(torch.sum(ut.abs() ** 2, dim=(-1, -2)))
        err = matched_eig_err(mu_k, mu_p)
        conv_k, conv_p = res_k / fro < 1e-3, res_p / fro < 1e-3
        both = conv_k & conv_p
        rel = (err / fro)[both]
        print(f"eig_cs {tuple(ut.shape)} (the north star's reduced matrices "
              f"at p={n}): converged kernel {conv_k.float().mean().item():.4f}"
              f", plain {conv_p.float().mean().item():.4f}, both "
              f"{both.float().mean().item():.4f}; there matched |dmu|/|A|_F "
              f"max {rel.max().item():.3e}; resid/|A|_F max kernel "
              f"{(res_k / fro).max().item():.3e} plain "
              f"{(res_p / fro).max().item():.3e}", flush=True)
        # spec_kernel_checks' 3e-3; its coverage (both converged on 90%)
        # taken of what the plain version converges on: at n = 56 ten sweeps
        # leave ~12% of these matrices unconverged in either version.  The
        # kernel must converge as often as the plain version, to 1%.
        check(both.float().mean().item()
              >= 0.9 * conv_p.float().mean().item()
              and conv_k.float().mean().item()
              >= conv_p.float().mean().item() - 0.01
              and rel.max().item() < 3e-3, f"eig_cs n={n} disagrees")
        out["eig_cs"].append(dict(
            shape=list(ut.shape), sweeps=eig_sweeps,
            max_abs_err=err[both].max().item(),
            converged=dict(kernel=conv_k.float().mean().item(),
                           plain=conv_p.float().mean().item()),
            **timed(f"eig_cs {tuple(ut.shape)}",
                    lambda: cuda_jacobi.eig_cs_resid(ut, eig_sweeps),
                    t_plain, bounds.eig_cs(ut.shape[0], n, eig_sweeps),
                    yardstick("eig_cs", ut))))
    return out


def counted_path(label: str, drive, kernels=MAIN_KERNELS) -> tuple:
    """Drive one path with the launch counts set to 0 just before and read
    just after: every kernel of ``kernels`` must have been launched and no
    plain version handed a CUDA tensor.  Returns (launches, what drive
    gave)."""
    from llckbdm_tpu_torch.ops import _build

    _build.reset_counts()
    result = drive()
    torch.cuda.synchronize()
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_ON_CUDA)
    print(f"{label}: launches {launches}; plain on CUDA {plain}", flush=True)
    for name in kernels:
        check(launches.get(name, 0) > 0, f"{name} was not launched by {label}")
    check(not any(plain.values()), f"a plain version ran on CUDA: {plain}")
    return launches, result


def tool_path(name: str, drive) -> tuple[int, object]:
    """Drive one tool's path with the launch counts set to 0 just before and
    read just after; returns the kernel's launch count and what drive gave."""
    launches, result = counted_path(f"{name}'s tool path", drive, (name,))
    return launches[name], result


def brain_signal(oracle) -> tuple:
    """Config 2's signal: the 16 metabolite lines of
    data/params_brain_sim.csv, N=2048, noiseless, from the port's oracle."""
    truth = np.loadtxt(ROOT / "data" / "params_brain_sim.csv", delimiter=",",
                       skiprows=1, usecols=(1, 2, 3, 4))
    return oracle.sample_signal(truth, BRAIN_N, BRAIN_DWELL), truth


def first_voxel(ref):
    return ref._replace(z=ref.z[0], d=ref.d[0], mask=ref.mask[0])


def jacobi_counter(c32, dwell, m_values, kcfg) -> float:
    """The largest relative off-diagonal norm eig_cs leaves on the sweep's
    reduced matrices (the convergence counter)."""
    from llckbdm_tpu_torch import kbdm_sweep

    _, diag = kbdm_sweep(c32, dwell, m_values, kcfg, with_diag=True)
    return diag["eig_offdiag_rel"].max().item()


def spec_phases(oracle) -> dict:
    """The JAX package's spec-scale and chip gates, each a path driven once
    with the launch counts set to 0 before and read after (every main-path
    kernel launched, no plain version on a CUDA tensor), each gate
    asserted."""
    from llckbdm_tpu_torch import (KbdmConfig, LineList, LlcKbdmConfig,
                                   RefineConfig, kbdm_fit, line_list_to_np,
                                   llc_kbdm, llc_kbdm_fit, refine_lines,
                                   refined_to_np)

    out = {}
    sig, truth = brain_signal(oracle)
    c64 = torch.as_tensor(sig[None], device=DEVICE)
    c32 = c64.to(torch.complex64)
    kcfg = KbdmConfig(p=24)

    # config 2: one fit at m=512 (k=32), 10 GN iterations (24 lines: 48 x 48
    # solves in the 64-wide kernel); tests/test_spec_scale.py:26-48
    def config2():
        lines = kbdm_fit(c32, BRAIN_DWELL, 512, kcfg)
        return lines, refine_lines(c64, lines, BRAIN_DWELL,
                                   RefineConfig(iters=SPEC_GN_ITERS))
    launches, (lines, ref) = counted_path("config 2", config2)
    n32 = len(line_list_to_np(LineList(*(x[0] for x in lines))))
    check(n32 >= len(truth), f"config 2: the f32 stage found {n32} lines")
    olines, _ = oracle.kbdm(sig, BRAIN_DWELL, m=512, p=24)
    olines = olines[oracle.match_lines(olines, truth)]
    est = refined_to_np(first_voxel(ref), BRAIN_DWELL)
    gate = oracle.line_errors(est[oracle.match_lines(est, truth)],
                              olines).max()
    counter = jacobi_counter(c32, BRAIN_DWELL, (512,), kcfg)
    print(f"config 2 (brain, N={BRAIN_N}, m=512, p=24): {n32} f32 lines; "
          f"refined vs oracle.kbdm max err {gate:.3e} (< 1e-8); Jacobi "
          f"off-diagonal at p=24 {counter:.3e}", flush=True)
    check(gate < 1e-8, f"config 2 missed the 1e-8 gate: {gate:.3e}")
    out["config2"] = dict(launches=launches, f32_lines=n32, gate=gate,
                          jacobi_offdiag_rel=counter)
    # the first brain Grams under the power iterations' and final passes'
    # shifts, kernel beside plain version
    out["config2"]["production_grams"] = production_gram_checks(
        c32, BRAIN_DWELL, (512,), kcfg, "config 2")

    # config 3: the 46-entry sweep, all 32 slots refined (64 x 64 solves);
    # tests/test_spec_scale.py:52-75
    cfg3 = LlcKbdmConfig(m_values=tuple(range(120, 301, 4)), eps=2e-4,
                         min_samples=10, max_clusters=32, kbdm=kcfg)

    def config3():
        cons, _, counts, _ = llc_kbdm_fit(c32, BRAIN_DWELL, cfg3)
        return counts, refine_lines(c64, cons, BRAIN_DWELL,
                                    RefineConfig(iters=SPEC_GN_ITERS))
    launches, (counts, ref) = counted_path("config 3", config3)
    est = refined_to_np(first_voxel(ref), BRAIN_DWELL)
    est = est[np.abs(est[:, 0]) > 0.1]                 # drop empty slots
    check(len(est) >= len(truth), f"config 3 refined {len(est)} lines")
    gate = oracle.line_errors(est[oracle.match_lines(est, truth)],
                              truth).max()
    counter = jacobi_counter(c32, BRAIN_DWELL, cfg3.m_values, kcfg)
    print(f"config 3 (brain, m=120..300 step 4, min_samples 10, p=24): "
          f"{int((counts > 0).sum())} clusters; refined vs truth max err "
          f"{gate:.3e} (< 1e-8); Jacobi off-diagonal at p=24 {counter:.3e}",
          flush=True)
    check(gate < 1e-8, f"config 3 missed the 1e-8 gate: {gate:.3e}")
    out["config3"] = dict(launches=launches, gate=gate,
                          clusters=int((counts > 0).sum()),
                          jacobi_offdiag_rel=counter)
    out["config3"]["production_grams"] = production_gram_checks(
        c32, BRAIN_DWELL, cfg3.m_values, kcfg, "config 3")

    # config 1 noiseless, 3 GN iterations: the gate that pinned the solver's
    # defaults (tests/test_tpu.py:31-48)
    sig1 = oracle.sample_signal(BASE_LINES, N, DWELL)
    c1 = torch.as_tensor(sig1[None], device=DEVICE)

    def config1():
        lines = kbdm_fit(c1.to(torch.complex64), DWELL, 180, KbdmConfig(p=16))
        return refine_lines(c1, lines, DWELL, RefineConfig(iters=3))
    launches, ref = counted_path("config 1, 3 GN iterations", config1)
    olines, _ = oracle.kbdm(sig1, DWELL, m=180, p=16)
    olines = olines[oracle.match_lines(olines, BASE_LINES)]
    est = refined_to_np(first_voxel(ref), DWELL)
    gate = oracle.line_errors(est[oracle.match_lines(est, BASE_LINES)],
                              olines).max()
    print(f"config 1 noiseless, m=180, p=16, 3 GN iterations: vs "
          f"oracle.kbdm max err {gate:.3e} (< 1e-8)", flush=True)
    check(gate < 1e-8, f"config 1 (3 iterations) missed the gate: {gate:.3e}")
    out["config1_iters3"] = dict(launches=launches, gate=gate)

    # the NumPy entry point with its refinement (tests/test_tpu.py:102-112)
    def wrapper():
        return llc_kbdm(sig1, DWELL, range(120, 181, 10), p=16, eps=2e-4,
                        min_samples=5, refine_iters=6, device=DEVICE)
    launches, (cons, pooled, _) = counted_path("llc_kbdm", wrapper)
    check(len(cons) >= 5 and len(pooled) > len(cons),
          f"llc_kbdm: {len(cons)} lines of {len(pooled)} pooled")
    gate = oracle.line_errors(cons[oracle.match_lines(cons, BASE_LINES)],
                              BASE_LINES).max()
    print(f"llc_kbdm (m=120..180 step 10, min_samples 5, refine_iters 6): "
          f"{len(cons)} lines vs truth max err {gate:.3e} (< 1e-8)",
          flush=True)
    check(gate < 1e-8, f"llc_kbdm missed the 1e-8 gate: {gate:.3e}")
    out["llc_kbdm"] = dict(launches=launches, gate=gate)
    return out


def damping_phase(sigs, truths, c32, c64, cfg, rcfg) -> dict:
    """The north star with damping_weight=1.0 (the O(n^2) dbscan on the 2-D
    features), top 16 clusters refined: every voxel keeps >= 5 lines and
    the 8 voxels with the largest last GN step meet the 1e-8 oracle gate."""
    from llckbdm_tpu_torch import (LineList, line_list_to_np, llc_kbdm_fit,
                                   refine_lines, refined_to_np)

    dcfg = dataclasses.replace(cfg, damping_weight=1.0)

    def drive():
        cons, _, counts, _ = llc_kbdm_fit(c32, DWELL, dcfg)
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        top = LineList(*(x[..., :REFINE_CLUSTERS] for x in cons))
        return top, counts, refine_lines(c64, top, DWELL, rcfg), t_mid

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches, (top, counts, refined, t_mid) = counted_path(
        "north star, damping_weight=1.0", drive)
    t_fit, t_refine = t_mid - t0, time.perf_counter() - t_mid
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    live = refined.mask > 0.5
    n_lines = live.sum(-1)
    check(bool(torch.isfinite(refined.z[live]).all()),
          "damping: non-finite refined lines")
    check(bool((n_lines >= 5).all()), "damping: a voxel lost a genuine line")
    gn = refined.gn_step.cpu().numpy()
    voxels = largest_step_voxels(gn)
    gate = max(gate_errors(
        voxels, sigs, truths,
        lambda i: line_list_to_np(LineList(*(x[i] for x in top))),
        lambda i: refined_to_np(refined._replace(
            z=refined.z[i], d=refined.d[i], mask=refined.mask[i]), DWELL)))
    print(f"north star V={VOXELS}, damping_weight=1.0: fit {t_fit * 1e3:.1f} "
          f"ms, refine {t_refine * 1e3:.1f} ms; peak {peak_gb:.2f} GiB; "
          f"refined lines per voxel min {n_lines.min().item()} max "
          f"{n_lines.max().item()}; oracle gate {gate:.3e} (< 1e-8) on "
          f"voxels {voxels}", flush=True)
    check(gate < 1e-8, f"damping missed the 1e-8 oracle gate: {gate:.3e}")
    return {"launches": launches, "fit_ms": t_fit * 1e3,
            "refine_ms": t_refine * 1e3, "peak_gib": peak_gb, "gate": gate,
            "counts": counts}


def eps_tie_pairs(x: torch.Tensor, ok: torch.Tensor, eps: float) -> int:
    """Pairs of valid 1-D points on which dbscan's neighbour rule (the
    squared difference against float32(eps)^2) and one of dbscan_1d's (x_j
    against the rounded x_i +- eps, or |x_i - x_j| against eps) disagree:
    the distances that round to exactly eps."""
    e = float(torch.tensor(eps, dtype=torch.float32))
    e2 = float(torch.tensor(eps, dtype=torch.float32) ** 2)
    pair = ok[:, None] & ok[None, :]
    dx = x[:, None] - x[None, :]
    rule_2d = dx * dx <= e2
    rule_range = (x[None, :] <= x[:, None] + e) & (x[None, :] >= x[:, None] - e)
    rule_abs = dx.abs() <= e
    return int((((rule_2d != rule_range) | (rule_2d != rule_abs))
                & pair).sum())


def dbscan_phase(pooled, cfg) -> dict:
    """The O(n^2) dbscan against dbscan_1d on the main path's pooled lines
    (damping_weight=0): equal labels on every voxel, or the voxels that
    differ printed with the pairs on which the two neighbour rules disagree
    (exact eps ties after rounding); each timed at V=2048 by the host clock
    around torch.cuda.synchronize() (median of 3 after a warm-up), with its
    peak device memory above what was allocated before it."""
    from llckbdm_tpu_torch.ops import dbscan as db
    from llckbdm_tpu_torch.pipeline.llckbdm import transform_line_lists

    feats = transform_line_lists(pooled, DWELL, 0.0)
    valid = pooled.mask > 0.5
    runs = {"dbscan": lambda: db.dbscan(feats, valid, cfg.eps,
                                        cfg.min_samples),
            "dbscan_1d": lambda: db.dbscan_1d(feats[..., 0], valid, cfg.eps,
                                              cfg.min_samples)}
    out, labels = {}, {}
    for name, fn in runs.items():
        fn()
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            labels[name] = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        out[name] = {"ms": float(np.median(ms)), "runs_ms": ms,
                     "peak_gib": peak}
    diff = (labels["dbscan"].long() != labels["dbscan_1d"]).any(-1)
    bad = diff.nonzero().flatten().tolist()
    ties = {}
    for v in bad:
        ties[v] = eps_tie_pairs(feats[v, :, 0], valid[v], cfg.eps)
        print(f"dbscan: voxel {v} differs from dbscan_1d; {ties[v]} point "
              f"pairs on which the two neighbour rules disagree", flush=True)
        check(ties[v] > 0, f"dbscan and dbscan_1d differ on voxel {v} "
              f"without an eps tie")
    print(f"dbscan vs dbscan_1d on the pooled lines ({tuple(feats.shape)}): "
          f"labels equal on {VOXELS - len(bad)} of {VOXELS} voxels; dbscan "
          f"{out['dbscan']['ms']:.2f} ms (peak +{out['dbscan']['peak_gib']:.2f}"
          f" GiB), dbscan_1d {out['dbscan_1d']['ms']:.2f} ms (peak "
          f"+{out['dbscan_1d']['peak_gib']:.2f} GiB)", flush=True)
    out.update(voxels_differing=bad, tie_pairs=ties)
    return out


def probe_checks() -> dict:
    """The two tool kernels: each tool's path, then each kernel against its
    plain version on the same CUDA inputs."""
    from llckbdm_tpu_torch.ops import cuda_probes
    from llckbdm_tpu_torch.tools import bench_eigh_variants as bev
    from llckbdm_tpu_torch.tools import bounds, kernel_smoke
    from llckbdm_tpu_torch.tools.timing import cuda_ms

    out = {}
    # row_probe: the tool asserts the kernel against its numpy loop (1e-5);
    # here also against the plain version, with and without i == j
    launches, _ = tool_path("row_probe", kernel_smoke.run)
    n, b, steps = 24, 256, 16
    a = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, n, n)).astype(np.float32)).to(DEVICE)
    worst = 0.0
    for make in (kernel_smoke.schedule, kernel_smoke.self_paired_schedule):
        sched = torch.from_numpy(make(n, steps))    # on the host, as always
        err = (cuda_probes.row_probe(sched, a)
               - cuda_probes.row_probe_plain(sched, a)).abs().max().item()
        print(f"row_probe ({b}, {n}, {n}) {make.__name__}: max abs err "
              f"{err:.3e} (< 1e-5)")
        check(err < 1e-5, f"row_probe disagrees ({make.__name__}): {err:.3e}")
        worst = max(worst, err)
    sched = torch.from_numpy(kernel_smoke.schedule(n, steps))
    out["row_probe"] = dict(
        launches=launches, max_abs_err=worst, tol="1e-5 absolute",
        shape=[b, n, n], steps=steps,
        **timed(f"row_probe ({b}, {n}, {n}) steps={steps}",
                lambda: cuda_probes.row_probe(sched, a),
                lambda: cuda_probes.row_probe_plain(sched, a),
                bounds.row_probe(b, n, steps),
                (None, "a probe of dynamic row access: no library call "
                       "computes its schedule of row steps")))
    # the launch floor: an empty kernel through the same ctypes path, timed
    # the same way; the bound lies below it
    floor = cuda_ms(cuda_probes.empty_launch)
    out["row_probe"].update(launch_floor_ms=floor.ms,
                            launch_floor_ms_range=[floor.lo, floor.hi])
    print(f"row_probe: kernel {out['row_probe']['ms']:.4f} ms beside the "
          f"launch floor {floor} and the bound "
          f"{out['row_probe']['bound_ms']:.4f} ms", flush=True)

    # eigh_probe: the tool's seven runs check the invariants and finite w
    # at its size and time each
    launches, runs = tool_path("eigh_probe", bev.run_all)
    # one sweep where the chain is short enough for elementwise parity with
    # the plain version: dense at n=8, and 4 x 4 blocks at n=40 and 64 (a
    # lane's second column); w to 1e-4 max|A|, the norms and the
    # coefficient sum to 1e-5 relative
    worst = 0.0
    for a_s in (bev.make_inputs(8, 512, DEVICE),
                bev.make_block_diagonal(40, 512, DEVICE),
                bev.make_block_diagonal(64, 512, DEVICE)):
        tol = 1e-4 * a_s.abs().max().item()
        for name, switches in cuda_probes.EIGH_VARIANTS.items():
            got = cuda_probes.eigh_probe(a_s, 1, **switches)
            want = cuda_probes.eigh_probe_plain(a_s, 1, **switches)
            err = (got.w - want.w).abs().max().item()
            rel = max(((x - y).abs() / y.abs()).max().item()
                      for x, y in zip(got[1:], want[1:]))
            print(f"eigh_probe {tuple(a_s.shape)} sweeps=1 {name}: max |dw| "
                  f"{err:.3e} (<= {tol:.3e}), norms and coefficient sum rel "
                  f"{rel:.3e} (<= 1e-5)")
            check(err <= tol and rel <= 1e-5,
                  f"eigh_probe n={a_s.shape[-1]} {name} disagrees")
            worst = max(worst, err)
    # the plain version at the tool's size, full variant: its invariants, and
    # its time over one call (a Python loop of 2208 pair steps)
    big = bev.make_inputs(device=DEVICE)
    want = cuda_probes.eigh_probe_plain(big, bev.SWEEPS)
    errs = bev.invariant_errors(big, want, True, True)
    check(max(errs.values()) <= bev.INVARIANT_TOL,
          f"plain eigh_probe invariants {errs}")
    t_p = cuda_ms(lambda: cuda_probes.eigh_probe_plain(big, bev.SWEEPS))
    t_k = runs["full"]
    bnd = bounds.eigh_probe(big.shape[0], big.shape[-1], bev.SWEEPS)
    print(f"eigh_probe {tuple(big.shape)} sweeps={bev.SWEEPS} full: kernel "
          f"{t_k}; plain {t_p}; bound {bnd.ms:.4f} ms ({bnd.by})", flush=True)
    out["eigh_probe"] = dict(
        launches=launches, max_abs_err=worst,
        tol="w: 1e-4 max|A| at n=8 (dense) and n=40, 64 (4 x 4 blocks), one "
            "sweep; at (4480, 24, 24), 8 sweeps: "
            "|V|_F, |S|_F (no column writes) = |A|_F to 1e-5",
        shape=list(big.shape), sweeps=bev.SWEEPS, ms=t_k.ms, plain_ms=t_p.ms,
        ms_range=[t_k.lo, t_k.hi], plain_ms_range=[t_p.lo, t_p.hi],
        variant_ms={name: t.ms for name, t in runs.items()},
        bound_ms=bnd.ms, bound_by=bnd.by, flops=bnd.flops, bytes=bnd.bytes,
        library_call=None, library_ms=None,
        library_null_reason="a cost probe, not an eigensolver: its w is not "
                            "the spectrum of A, so no library call computes "
                            "it")
    return out


def grid_phase(cfg, rcfg) -> dict:
    """GridRunner at config-5 size, then a resume after deleting shards."""
    from llckbdm_tpu_torch.ops import _build
    from llckbdm_tpu_torch.parallel import GridRunner
    from llckbdm_tpu_torch.tools.config5_run import make_grid_signals

    v = GRID_SIDE * GRID_SIDE
    t0 = time.perf_counter()
    sigs, truths = make_grid_signals(v)
    print(f"grid: {v} voxels synthesized in {time.perf_counter() - t0:.2f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as out_dir:
        runner = GridRunner(out_dir, DWELL, cfg, DEVICE, shard_size=GRID_SHARD,
                            refine=rcfg, refine_clusters=REFINE_CLUSTERS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        shards = runner.run(sigs)
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_ON_CUDA)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"grid: GridRunner.run computed {shards} shards of {GRID_SHARD} "
              f"in {wall:.3f} s = {v / wall:.1f} refined fits/s (host copies "
              f"and .npz writes included); peak {peak_gb:.2f} GiB; launches "
              f"{launches}; plain on CUDA {plain}", flush=True)
        check(shards == v // GRID_SHARD, f"computed {shards} shards")
        for name in MAIN_KERNELS:
            check(launches.get(name, 0) > 0,
                  f"{name} was not launched by GridRunner.run")
        check(not any(plain.values()), f"a plain version ran on CUDA: {plain}")

        first = runner.gather(v)
        check(first["refined_z"].shape == (v, REFINE_CLUSTERS)
              and first["refined_z"].dtype == np.complex128,
              "gathered refined_z shape or dtype")
        live = first["refined_mask"] > 0.5
        check(bool(np.isfinite(first["refined_z"][live]).all()
                   and np.isfinite(first["refined_d"][live]).all()),
              "non-finite refined lines in the grid")
        n_lines = live.sum(axis=1)
        check(bool((n_lines >= 5).all()), "a grid voxel lost a genuine line")
        voxels = largest_step_voxels(first["gn_step"])

        errs = gate_errors(
            voxels, sigs, truths, lambda i: _cons_rows(first, i),
            lambda i: rows_of(first["refined_z"][i], first["refined_d"][i],
                              first["refined_mask"][i]))
        gate = max(errs)
        print(f"grid: refined lines per voxel min {n_lines.min()} max "
              f"{n_lines.max()}; vs float64 oracle GN on voxels {voxels}: "
              f"max err {gate:.3e} (< 1e-8)", flush=True)
        check(gate < 1e-8, f"grid missed the 1e-8 oracle gate: {gate:.3e}")

        files = sorted(pathlib.Path(out_dir).glob("shard_*.npz"))
        gone = [files[0], files[len(files) // 2], files[-1]][:GRID_DELETE]
        for f in gone:
            f.unlink()
        t0 = time.perf_counter()
        redone = runner.run(sigs)
        t_redo = time.perf_counter() - t0
        again = runner.gather(v)
        same = all(np.array_equal(first[k], again[k]) for k in first)
        print(f"grid: deleted {[f.name for f in gone]}; the rerun computed "
              f"{redone} shards in {t_redo:.3f} s; gather bitwise equal: "
              f"{same}", flush=True)
        check(redone == GRID_DELETE, f"the rerun computed {redone} shards")
        check(first.keys() == again.keys() and same,
              "the rerun's gather differs from the first")
    return {"voxels": v, "shards": shards, "wall_s": wall,
            "fits_per_s": v / wall, "peak_gib": peak_gb,
            "gate_max_err": gate, "rerun_shards": redone,
            "rerun_s": t_redo, "launches": launches}


def _cons_rows(res: dict, i: int) -> np.ndarray:
    """Voxel i's top REFINE_CLUSTERS consolidated lines from a gathered
    grid, as float64 (A, T2, f, phase) rows sorted by frequency."""
    top = slice(0, REFINE_CLUSTERS)
    arr = np.stack([res[k][i, top] for k in ("amplitude", "t2", "frequency",
                                              "phase")], axis=1)
    arr = arr[res["mask"][i, top] > 0.5].astype(np.float64)
    return arr[np.argsort(arr[:, 2])]


def two_rank_child(rank: int, rdv: str, out_dir: str, sigs: np.ndarray,
                   lines: tuple, cfg, rcfg) -> None:
    """One of two ranks on the one card (gloo): the time-sharded refinement
    of `lines` timed, and the same rank's compute without the all-reduce,
    fit_and_refine_grid (data=1, time=2), then
    fit_grid_sharded (data=2, time=1); saved to out_dir/rank{rank}.npz."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from llckbdm_tpu_torch import LineList, refine_lines
    from llckbdm_tpu_torch.ops import _build
    from llckbdm_tpu_torch.parallel import (distributed_init,
                                            fit_and_refine_grid,
                                            fit_grid_sharded, make_mesh,
                                            refine_grid_timesharded)

    distributed_init(f"file://{rdv}", 2, rank, backend="gloo",
                     device="cuda:0")
    try:
        mesh = make_mesh({"data": 1, "time": 2}, "cuda")
        block = LineList(*(torch.as_tensor(x, device=DEVICE) for x in lines))
        ms = []
        for _ in range(4):                        # the first is a warm-up
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            refined, _ = refine_grid_timesharded(sigs, block, DWELL, mesh, rcfg)
            torch.cuda.synchronize()
            dist.barrier()
            ms.append((time.perf_counter() - t0) * 1e3)
        # the same per-rank compute without the all-reduce (group=None, the
        # rank's own time block): the time-sharded refine apart from its
        # collective
        t_lo = rank * (N // 2)
        c_loc = torch.as_tensor(sigs[:, t_lo:t_lo + N // 2], device=DEVICE)
        local_ms = []
        for _ in range(4):                        # the first is a warm-up
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            refine_lines(c_loc, block, DWELL, rcfg, group=None, t_offset=t_lo)
            torch.cuda.synchronize()
            dist.barrier()
            local_ms.append((time.perf_counter() - t0) * 1e3)
        out = {"ts_z": refined.z.cpu().numpy(), "ts_d": refined.d.cpu().numpy(),
               "ts_ms": np.array(ms[1:]), "local_ms": np.array(local_ms[1:])}
        # every consolidated slot of cfg (2C x 2C GN solves), with this
        # rank's launch counts set to 0 just before and read just after
        _build.reset_counts()
        (chain, counts), _ = fit_and_refine_grid(sigs, DWELL, cfg, mesh, rcfg)
        torch.cuda.synchronize()
        out.update(chain_z=chain.z.cpu().numpy(), chain_d=chain.d.cpu().numpy(),
                   chain_mask=chain.mask.cpu().numpy(),
                   chain_gn_step=chain.gn_step.cpu().numpy(),
                   chain_counts=counts.cpu().numpy(),
                   chain_launches=np.array([_build.LAUNCHES[name]
                                            for name in MAIN_KERNELS]),
                   chain_plain=np.array(sum(_build.PLAIN_ON_CUDA.values())))
        del refined, chain
        mesh = make_mesh({"data": 2, "time": 1}, "cuda")
        (cons, _, counts, _), rows = fit_grid_sharded(sigs, DWELL, cfg, mesh)
        out.update({f"fit_{k}": x.cpu().numpy()
                    for k, x in zip(LineList._fields, cons)},
                   fit_counts=counts.cpu().numpy(), fit_rows=np.array(rows))
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def two_rank_phase(sigs, truths, cons, counts, lines, single,
                   single_all, cfg, rcfg) -> dict:
    """Two ranks on the one card over gloo, held against the single-process
    results of the main path (`cons`, `counts`; `single`: refine_grid of
    `lines`, the top REFINE_CLUSTERS slots; `single_all`: refine_grid of
    all of `cons`'s slots)."""
    from llckbdm_tpu_torch import LineList, line_list_to_np
    from llckbdm_tpu_torch.entry import spawn_ranks

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(two_rank_child, 2,
                    (str(pathlib.Path(tmp) / "rdv"), tmp, sigs,
                     tuple(x.cpu().numpy() for x in lines), cfg, rcfg),
                    timeout=600)
        t_spawn = time.perf_counter() - t0
        outs = [dict(np.load(pathlib.Path(tmp) / f"rank{r}.npz"))
                for r in range(2)]
    errs = {}
    for prefix, ref in (("ts", single), ("chain", single_all)):
        z1, d1 = ref.z.cpu().numpy(), ref.d.cpu().numpy()
        check(np.array_equal(outs[0][f"{prefix}_z"], outs[1][f"{prefix}_z"])
              and np.array_equal(outs[0][f"{prefix}_d"],
                                 outs[1][f"{prefix}_d"]),
              f"{prefix}: the two time ranks disagree")
        errs[prefix] = (float(np.abs(outs[0][f"{prefix}_z"] - z1).max()),
                        float(np.abs(outs[0][f"{prefix}_d"] - d1).max()))
        check(errs[prefix][0] <= 5e-9 and errs[prefix][1] <= 5e-8,
              f"{prefix}: time-sharded vs single-process refine |dz|, |dd| "
              f"{errs[prefix]} (bounds 5e-9, 5e-8)")
    # fit_and_refine_grid: rank 0 fits (every kernel), both ranks take the
    # GN_ITERS 64 x 64 solves and normal equations, and no plain version
    # ran on a CUDA tensor
    chain_launches = [dict(zip(MAIN_KERNELS, o["chain_launches"].tolist()))
                      for o in outs]
    for r, o in enumerate(outs):
        check(int(o["chain_plain"]) == 0,
              f"rank {r}: a plain version ran on CUDA in fit_and_refine_grid")
        check(chain_launches[r]["chol_solve"] >= GN_ITERS,
              f"rank {r}: fit_and_refine_grid launched chol_solve "
              f"{chain_launches[r]['chol_solve']} times")
        check(chain_launches[r]["gn_normal"] == GN_ITERS,
              f"rank {r}: fit_and_refine_grid launched gn_normal "
              f"{chain_launches[r]['gn_normal']} times")
    check(all(chain_launches[0][name] > 0 for name in MAIN_KERNELS),
          f"rank 0's fit_and_refine_grid launches {chain_launches[0]}")
    chain = outs[0]
    check(np.array_equal(chain["chain_counts"], counts.cpu().numpy()),
          "fit_and_refine_grid's cluster counts differ from the main path's")
    check(chain["chain_z"].shape == (VOXELS, cfg.max_clusters),
          f"fit_and_refine_grid refined {chain['chain_z'].shape} slots")
    voxels = largest_step_voxels(chain["chain_gn_step"])
    gate = max(gate_errors(
        voxels, sigs, truths,
        lambda i: line_list_to_np(LineList(*(x[i] for x in cons))),
        lambda i: rows_of(chain["chain_z"][i], chain["chain_d"][i],
                          chain["chain_mask"][i])))
    check(gate < 1e-8, f"fit_and_refine_grid missed the 1e-8 gate: {gate:.3e}")

    fit = {k: np.concatenate([o[f"fit_{k}"] for o in outs])
           for k in ("amplitude", "t2", "frequency", "phase", "mask",
                     "counts")}
    check([list(o["fit_rows"]) for o in outs] == [[0, VOXELS // 2],
                                                  [VOXELS // 2, VOXELS]],
          "fit_grid_sharded's row blocks")
    check(np.array_equal(fit["counts"], counts.cpu().numpy())
          and np.array_equal(fit["mask"], cons.mask.cpu().numpy()),
          "fit_grid_sharded's counts or masks differ from fit_grid's")
    # tests/test_parallel.py's bound: |a - b| <= 1e-4 + 1e-4 |b|
    fit_err = max(float((np.abs(fit[k] - x.cpu().numpy())
                         / (1e-4 + 1e-4 * np.abs(x.cpu().numpy()))).max())
                  for k, x in zip(("amplitude", "t2", "frequency", "phase"),
                                  cons))
    check(fit_err <= 1.0, f"fit_grid_sharded's lines differ by {fit_err:.3e} "
          f"of the bound 1e-4 + 1e-4 |b|")
    ts_ms = float(np.median(outs[0]["ts_ms"]))
    local_ms = float(np.median(outs[0]["local_ms"]))
    print(f"two ranks on one card (gloo): time-sharded refine {ts_ms:.1f} ms "
          f"(runs {outs[0]['ts_ms'].round(1).tolist()}), of which the same "
          f"per-rank compute without its all-reduce {local_ms:.1f} ms (runs "
          f"{outs[0]['local_ms'].round(1).tolist()}); |dz|, |dd| vs single "
          f"{errs['ts']}; fit_and_refine_grid (C={cfg.max_clusters}) |dz|, "
          f"|dd| {errs['chain']}, launches per rank {chain_launches}, "
          f"oracle gate {gate:.3e} on voxels {voxels}; fit_grid_sharded "
          f"counts and masks exact, lines within {fit_err:.3e} of the bound "
          f"1e-4 + 1e-4 |b|; children "
          f"{t_spawn:.1f} s", flush=True)
    return {"ts_refine_ms": ts_ms, "ts_compute_only_ms": local_ms,
            "ts_err": errs["ts"],
            "chain_err": errs["chain"], "chain_gate": gate,
            "chain_launches": chain_launches,
            "sharded_fit_err": fit_err, "children_s": t_spawn}


def entry_phase() -> dict:
    """entry()'s config-1 kbdm_fit step on its default device, the card:
    16 finite line slots, every kernel of a fit launched and no plain
    version on a CUDA tensor."""
    from llckbdm_tpu_torch.entry import entry

    t0 = time.perf_counter()
    fn, args = entry()
    check(args[0].is_cuda and args[0].shape == (512,),
          "entry(): the example signal is not a (512,) tensor on the card")
    launches, out = counted_path("entry()", lambda: fn(*args), FIT_KERNELS)
    check(out.amplitude.shape == (16,) and all(
        bool(torch.isfinite(x).all()) for x in out),
          f"entry(): {tuple(out.amplitude.shape)} line slots, or not finite")
    wall = time.perf_counter() - t0
    print(f"entry: 16 finite line slots, {int(out.mask.sum().item())} valid; "
          f"{wall:.2f} s", flush=True)
    return {"launches": launches, "valid_lines": int(out.mask.sum().item()),
            "wall_s": wall}


def dryrun_phase() -> dict:
    """dryrun_multichip(8) on the one card: eight gloo ranks (NCCL refuses
    two ranks a card), mesh data=4 x time=2, one fit_and_refine_grid step
    on V=8 voxels of N=64.  The refined (8, 4) lines are finite; on every
    rank chol_solve and gn_normal were launched and no plain version ran on
    a CUDA tensor, and every rank that fits (time index 0) launched every
    main-path kernel."""
    from llckbdm_tpu_torch.entry import dryrun_config, dryrun_multichip

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = dryrun_multichip(8)
    wall = time.perf_counter() - t0
    cfg, _ = dryrun_config()
    check(res["mesh"] == {"data": 4, "time": 2} and res["backend"] == "gloo",
          f"dry run: mesh {res['mesh']} over {res['backend']}")
    check(res["z"].shape == (8, cfg.max_clusters),
          f"dry run: refined {res['z'].shape}")
    live = res["mask"] > 0.5
    check(bool(np.isfinite(res["z"][live]).all()
               and np.isfinite(res["d"][live]).all()),
          "dry run: non-finite refined lines")
    for r, (launches, plain) in enumerate(zip(res["launches"], res["plain"])):
        check(not any(plain.values()), f"dry run rank {r}: a plain version "
              f"ran on CUDA: {plain}")
        need = (MAIN_KERNELS if res["time_ranks"][r] == 0
                else ("chol_solve", "gn_normal"))
        check(all(launches.get(k, 0) > 0 for k in need),
              f"dry run rank {r}: launches {launches}")
    print(f"dry run: 8 ranks on one card, wall {wall:.2f} s (spawn "
          f"included); launches per rank {res['launches']}", flush=True)
    return {"mesh": res["mesh"], "backend": res["backend"],
            "refined_shape": list(res["z"].shape),
            "refined_lines": int(live.sum()), "launches": res["launches"],
            "wall_s": wall}


def stages_phase(kcfg) -> dict:
    """tools.ablate_sweep at the north star (V=2048): every _stop prefix of
    the sweep timed by the host clock (median of 3), with its work model
    and bound, driven with the launch counts set to 0 before and read after.
    The whole sweep's cumulative time must lie within 10% of kbdm_sweep
    itself, timed the same way in the same call."""
    from llckbdm_tpu_torch import kbdm_sweep
    from llckbdm_tpu_torch.tools import ablate_sweep, five_peak
    from llckbdm_tpu_torch.tools.timing import host_ms

    t0 = time.perf_counter()
    launches, rows = counted_path(
        "ablate_sweep", lambda: ablate_sweep.run(VOXELS, 3, DEVICE, kcfg),
        FIT_KERNELS)
    sigs, _ = five_peak.signals(VOXELS, amp_jitter=False)
    c = torch.as_tensor(sigs, device=DEVICE).to(torch.complex64)
    whole = host_ms(lambda: kbdm_sweep(c, DWELL, M_VALUES, kcfg), DEVICE)
    last = rows[-1].cum_ms
    print(f"stages: the sweep's last prefix {last:.3f} ms, kbdm_sweep "
          f"{whole}; {time.perf_counter() - t0:.2f} s", flush=True)
    check(abs(last - whole.ms) <= 0.1 * whole.ms,
          f"ablate_sweep's whole sweep {last:.3f} ms is not within 10% of "
          f"kbdm_sweep's {whole.ms:.3f} ms")
    return {"stages": [r._asdict() for r in rows], "sweep_ms": whole.ms,
            "launches": launches, "wall_s": time.perf_counter() - t0}


def fft_hankel_phase() -> dict:
    """The implicit FFT Hankel operator on the card against the dense
    hankel_matrices(c, m, shift) @ x in complex128, with and without shift,
    to 2e-6 of the largest entry (complex64 rounding of two transforms);
    then tools.bench_fft_hankel at its two shapes."""
    from llckbdm_tpu_torch.ops.hankel import (hankel_apply_fft,
                                              hankel_fft_spectrum,
                                              hankel_matrices)
    from llckbdm_tpu_torch.tools import bench_fft_hankel

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    errs = {}
    for n, m, shift, j in ((512, 256, 0, 840), (512, 180, 3, 24),
                           (2048, 512, 1, 32)):
        c, x = crandn(gen, 16, n), crandn(gen, 16, m, j)
        y = hankel_apply_fft(hankel_fft_spectrum(c, m, shift), x, m)
        ref = (hankel_matrices(c.to(torch.complex128), m, shift)
               @ x.to(torch.complex128))
        err = ((y - ref).abs().amax() / ref.abs().amax()).item()
        errs[f"n={n},m={m},shift={shift},J={j}"] = err
        check(err < 2e-6, f"hankel_apply_fft (n={n}, m={m}, shift={shift}) "
              f"disagrees with the dense apply: {err:.3e}")
    print(f"fft hankel: hankel_apply_fft vs dense on the card, max rel err "
          f"{errs} (< 2e-6)", flush=True)
    bench = {}
    for name, shape in bench_fft_hankel.SHAPES.items():
        print(f"## bench_fft_hankel {name}", flush=True)
        bench[name] = bench_fft_hankel.run(shape, DEVICE)
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"fft hankel: {wall:.2f} s", flush=True)
    return {"apply_rel_err": errs, "bench": bench, "wall_s": wall}


def tools_phase() -> dict:
    """The measuring tools on the card at their defaults, each raising
    where it prints FAIL at the production defaults: tune_sweeps (the
    eig_cs counter against eig_sweeps; the two gates at every (eig_sweeps,
    eigh_sweeps) pair, the default (10, 7) first; the smallest pair that
    passes both), noise_gate_sweep (8 voxels, 8 GN iterations, noise 1e-4 ..
    1e-2) and scaling_bench on 1, 2 and 4 gloo ranks of the one card (the
    data-parallel fit must issue no collective, the time-sharded refine one
    all-reduce per GN iteration and its control none; every rank of the fit
    launched every kernel of a fit and no plain version on a CUDA tensor);
    then
    the one-rank NCCL group bound to its card (:func:`nccl_bind_phase`)."""
    from llckbdm_tpu_torch.tools import (noise_gate_sweep, scaling_bench,
                                         tune_sweeps)

    out = {}
    t0 = time.perf_counter()
    launches, tune = counted_path("tune_sweeps", lambda: tune_sweeps.run(
        DEVICE))
    check(tune["ok"], "tune_sweeps: FAIL at the default sweep budgets")
    out["tune_sweeps"] = dict(
        counter=tune["counter"], smallest_passing=tune["smallest_passing"],
        gates={f"{a},{b}": g for (a, b), g in tune["gates"].items()},
        launches=launches, wall_s=time.perf_counter() - t0)
    print(f"tune_sweeps: {out['tune_sweeps']['wall_s']:.2f} s", flush=True)

    t0 = time.perf_counter()
    launches, noise = counted_path("noise_gate_sweep",
                                   lambda: noise_gate_sweep.run(device=DEVICE))
    check(noise["ok"], "noise_gate_sweep: FAIL at the production noise 1e-4")
    out["noise_gate_sweep"] = dict(noise, launches=launches,
                                   wall_s=time.perf_counter() - t0)
    print(f"noise_gate_sweep: {out['noise_gate_sweep']['wall_s']:.2f} s",
          flush=True)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scale = scaling_bench.run((1, 2, 4), DEVICE)
    for row in scale["dp_scaling"]:
        check(row["collectives"] == [0] * row["ranks"],
              f"scaling_bench: the data-parallel fit on {row['ranks']} ranks "
              f"issued collectives {row['collectives']}")
        for r, (launches, plain) in enumerate(zip(row["launches"],
                                                  row["plain"])):
            check(not any(plain.values())
                  and all(launches.get(k, 0) > 0 for k in FIT_KERNELS),
                  f"scaling_bench, {row['ranks']} ranks, rank {r}: launches "
                  f"{launches}, plain on CUDA {plain}")
    probe = scale["overlap_probe"]
    iters = scaling_bench.OVERLAP_RCFG.iters
    check(probe["with_collectives"] == [{"all_reduce": iters}] * 4
          and probe["without_collectives"] == [{}] * 4,
          f"scaling_bench: the time-sharded refine issued "
          f"{probe['with_collectives']}, its control "
          f"{probe['without_collectives']}")
    out["scaling_bench"] = dict(scale, wall_s=time.perf_counter() - t0)
    print(f"scaling_bench: {out['scaling_bench']['wall_s']:.2f} s (spawns "
          f"included)", flush=True)
    out["nccl_bind"] = nccl_bind_phase()
    return out


def nccl_bind_child(rank: int, out_dir: str) -> None:
    """The one rank of a one-rank NCCL group made by distributed_init on
    cuda:0, with its stderr (the file descriptor, so that NCCL's and
    torch's C++ logs land there too) in out_dir/stderr.txt: the group must
    be bound to cuda:0 and an all-reduce of a CUDA tensor must sum it;
    saved to out_dir/rank0.json."""
    import os

    from llckbdm_tpu_torch.parallel import distributed_init

    out = pathlib.Path(out_dir)
    with open(out / "stderr.txt", "w") as err:
        os.dup2(err.fileno(), 2)
    distributed_init(None, backend="nccl", device="cuda:0")
    try:
        bound = dist.distributed_c10d._get_default_group().bound_device_id
        check(bound == torch.device("cuda", 0),
              f"the one-rank NCCL group is bound to {bound}, not cuda:0")
        x = torch.full((1024,), 3.0, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        check(bool((x == 3.0).all()), f"all_reduce gave {x.unique().tolist()}")
    finally:
        dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps({"bound": str(bound)}))


def nccl_bind_phase() -> dict:
    """distributed_init(None, backend="nccl", device="cuda:0") in one
    spawned child (the script's own process joins no group): its group
    bound to cuda:0, one all-reduce, and no "Guessing device ID" in the
    child's stderr, which is echoed here."""
    from llckbdm_tpu_torch.entry import spawn_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            spawn_ranks(nccl_bind_child, 1, (tmp,), timeout=300)
        finally:
            err_path = pathlib.Path(tmp) / "stderr.txt"
            err = err_path.read_text() if err_path.exists() else ""
            sys.stderr.write(err)
        bound = json.loads((pathlib.Path(tmp) / "rank0.json").read_text())[
            "bound"]
    check("Guessing device ID" not in err,
          "the one-rank NCCL group guessed its device")
    wall = time.perf_counter() - t0
    print(f"nccl bind: one-rank NCCL group bound to {bound}; all_reduce "
          f"checked; no 'Guessing device ID' in its stderr; {wall:.2f} s",
          flush=True)
    return {"bound_device_id": bound, "wall_s": wall}


def precision_tools_phase() -> dict:
    """The three tools ported last, on the card: precision_gate at its
    defaults (the four (mxu_precision, subspace_bf16) settings), raising
    only where the default ("highest", bfloat16) prints FAIL;
    config5_run on CONFIG5_VOXELS voxels, twice into one temporary --out
    (the first run computes every shard, the rerun resumes every shard and
    gathers bit for bit); trace_capture of one fit at V=256 (a non-empty
    trace and top table).  Each driven with the launch counts set to 0
    before and read after (every main-path kernel launched, no plain
    version on a CUDA tensor)."""
    from llckbdm_tpu_torch.tools import config5_run, precision_gate, trace_capture

    out = {}
    t0 = time.perf_counter()
    launches, prec = counted_path("precision_gate", lambda: precision_gate.run(
        DEVICE))
    check(prec["ok"], "precision_gate: FAIL at the default (mxu_precision "
          "'highest', bfloat16 power iterations)")
    out["precision_gate"] = dict(
        gates={f"{p},{'bfloat16' if b else 'float32'}": g
               for (p, b), g in prec["gates"].items()},
        launches=launches, wall_s=time.perf_counter() - t0)
    print(f"precision_gate: {out['precision_gate']['wall_s']:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        launches, first = counted_path("config5_run", lambda: config5_run.run(
            CONFIG5_VOXELS, GRID_SHARD, d, DEVICE))
        again = config5_run.run(CONFIG5_VOXELS, GRID_SHARD, d, DEVICE)
    same = first["grid"].keys() == again["grid"].keys() and all(
        np.array_equal(first["grid"][k], again["grid"][k])
        for k in first["grid"])
    print(f"config5_run: {first['total']} shards of {GRID_SHARD}; the rerun "
          f"into the same --out resumed {again['resumed']} and computed "
          f"{again['computed']}; gather bitwise equal: {same}", flush=True)
    check(first["computed"] == first["total"] and again["computed"] == 0
          and again["resumed"] == again["total"] and same,
          "config5_run: the rerun did not resume every shard bit for bit")
    out["config5_run"] = dict(
        {k: first[k] for k in ("total", "computed", "wall_s", "fits_per_s",
                               "gate")},
        rerun_resumed=again["resumed"], rerun_computed=again["computed"],
        launches=launches, wall_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        launches, trace = counted_path("trace_capture", lambda: (
            trace_capture.run(256, 1, d, device=DEVICE, top=12)), FIT_KERNELS)
        size = pathlib.Path(trace["trace"]).stat().st_size
    check(trace["rows"] and size > 0, "trace_capture: an empty trace")
    out["trace_capture"] = dict(total_ms=trace["total_ms"], trace_bytes=size,
                                top=trace["rows"][:12], launches=launches,
                                wall_s=time.perf_counter() - t0)
    print(f"trace_capture: {out['trace_capture']['wall_s']:.2f} s",
          flush=True)
    return out


def captured(fn) -> tuple[object, str, str]:
    """fn's result and what it printed to stdout and to stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn()
    return res, out.getvalue(), err.getvalue()


def clocks_sample() -> str:
    """One ``nvidia-smi`` reading of the card's SM clock, power draw, power
    limit and temperature (CLOCKS_QUERY)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={CLOCKS_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bench_phase(main_fit_ms: float) -> dict:
    """The benchmark and the stage profiler through their entry points,
    each driven with the launch counts set to 0 before and read after:
    ``bench.main(["--json-only"])`` at V=2048 (exit 0, the gate and the
    counter under their limits, every main-path kernel launched by its fit
    and refine and eig_cs by its eigensolve, no plain version on a CUDA
    tensor, its fit within a factor of 1.5 of ``main_fit_ms``),
    ``bench.main(["--saturation"])`` (five rates) and
    ``tools.profile_stages`` at V=512 (every row; its JSON written under the
    checkout's ignored output directory), with the card's clocks, power and
    temperature sampled just before and just after it."""
    from llckbdm_tpu_torch import bench
    from llckbdm_tpu_torch.tools import profile_stages

    out = {}
    t0 = time.perf_counter()
    stages: dict = {}
    launches, (rc, text, _) = counted_path("bench", lambda: captured(
        lambda: bench.main(["--json-only"], stages)))
    lines = text.strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"bench: exit {rc}, output {lines}")
    print(lines[0], flush=True)
    line = json.loads(lines[0])
    counters = line["counters"]
    check(counters["gate_max_rel_err"] < 1e-8
          and counters["jacobi_offdiag_rel_production"] < 1e-2,
          f"bench: counters {counters}")
    fit_refine = set(stages["fit"]["launches"]) | set(
        stages["refine"]["launches"])
    check(fit_refine >= set(MAIN_KERNELS),
          f"bench: its fit and refine launched {fit_refine}")
    check(stages["eigensolve"]["launches"].get("eig_cs", 0) > 0,
          f"bench: its eigensolve launched {stages['eigensolve']}")
    check(not any(s["plain"] for s in stages.values()),
          f"bench: a plain version ran on CUDA: {stages}")
    fit_ms = 1e3 * line["voxels"] / line["fit_fits_per_sec"]
    ratio = fit_ms / main_fit_ms
    print(f"bench: fit {fit_ms:.1f} ms against the main path's "
          f"{main_fit_ms:.1f} ms (x{ratio:.3f}); {line['value']} refined "
          f"fits/s; eigensolve {line['eigensolve_gflops']} GFLOP/s; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(1 / 1.5 <= ratio <= 1.5,
          f"bench: fit {fit_ms:.1f} ms, main path {main_fit_ms:.1f} ms")
    out["bench"] = {"line": line, "stages": stages, "launches": launches,
                    "fit_ms_vs_main_path": ratio,
                    "wall_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    launches, (rc, _, err) = counted_path("bench --saturation", lambda: (
        captured(lambda: bench.main(["--saturation"]))), FIT_KERNELS)
    rates = [x for x in err.splitlines() if x.startswith("# saturation")]
    check(rc == 0 and len(rates) == len(bench.SATURATION_V),
          f"bench --saturation: exit {rc}, {err}")
    print("\n".join(rates), flush=True)
    out["bench_saturation"] = {"rates": rates, "launches": launches,
                               "wall_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    path = ROOT / "chiprun_out" / "profile_stages.json"
    smi = [clocks_sample()]
    launches, rc = counted_path("profile_stages", lambda: profile_stages.main(
        ["--voxels", "512", "--out", str(path)]))
    smi.append(clocks_sample())
    print(f"nvidia-smi ({CLOCKS_QUERY}) before profile_stages: {smi[0]}; "
          f"after: {smi[1]}", flush=True)
    prof = json.loads(path.read_text())
    check(rc == 0 and [r["stage"] for r in prof["rows"]]
          == list(profile_stages.ROWS) and all(
              np.isfinite(r["ms"]) and r["ms"] > 0 for r in prof["rows"])
          and 0 < prof["pipeline_pct_of_light"] < 100,
          f"profile_stages: exit {rc}, {prof}")
    print(f"profile_stages ({prof['branch']}): fit {prof['rows'][0]['ms']:.3f}"
          f" ms, pipeline_pct_of_light {prof['pipeline_pct_of_light']:.3f}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out["profile_stages"] = dict(prof, launches=launches, nvidia_smi=smi,
                                 wall_s=time.perf_counter() - t0)
    return out


def north_star(sigs, truths, c32, c64, cfg, rcfg) -> dict:
    """The main path at the north star: llc_kbdm_fit, then refine_lines on
    the top 16 clusters, once to warm up and once timed with the launch
    counts set to 0 just before and read just after (every main-path
    kernel launched, no plain version on a CUDA tensor).  Checked: shapes,
    finite refined lines, >= 5 a voxel; the Jacobi counter below 1e-2 on 32
    voxels and the 1e-8 oracle gate on the 8 voxels with the largest last
    GN step.  Returns the times, peak, launches, gates, the outputs and
    the path itself (``drive``)."""
    from llckbdm_tpu_torch import (LineList, line_list_to_np, llc_kbdm_fit,
                                   refine_lines, refined_to_np)
    from llckbdm_tpu_torch.ops import _build
    from llckbdm_tpu_torch.solver.kbdm import bf16_power_iterations

    branch = ("bfloat16" if bf16_power_iterations(c32, cfg.kbdm)
              else "float32")

    def top(lines):
        return LineList(*(x[..., :REFINE_CLUSTERS] for x in lines))

    def drive():
        cons, pooled, counts, _ = llc_kbdm_fit(c32, DWELL, cfg)
        torch.cuda.synchronize()
        t_mid = time.perf_counter()
        refined = refine_lines(c64, top(cons), DWELL, rcfg)
        torch.cuda.synchronize()
        return cons, pooled, counts, refined, t_mid

    drive()                                       # warm-up (cuBLAS, allocator)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches, (cons, pooled, counts, refined, t_mid) = counted_path(
        f"main path, {branch} power iterations", drive)
    t_end = time.perf_counter()
    t_fit, t_refine = t_mid - t0, t_end - t_mid
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"main path V={VOXELS}, {branch} power iterations: fit "
          f"{t_fit * 1e3:.1f} ms, refine {t_refine * 1e3:.1f} ms, "
          f"{VOXELS / (t_fit + t_refine):.1f} refined fits/s; peak "
          f"{peak_gb:.2f} GiB", flush=True)
    passes = cfg.kbdm.subspace_iters + cfg.kbdm.final_orth_passes
    check(launches.get("orth_pass") == passes,
          f"{branch}: orth_pass launched {launches.get('orth_pass')} times, "
          f"not {passes}")
    check(cons.amplitude.shape == (VOXELS, cfg.max_clusters),
          f"consolidated shape {tuple(cons.amplitude.shape)}")
    check(refined.z.shape == (VOXELS, REFINE_CLUSTERS)
          and refined.z.dtype == torch.complex128, "refined shape or dtype")
    live = refined.mask > 0.5
    check(bool(torch.isfinite(refined.z[live]).all()
               and torch.isfinite(refined.d[live]).all()),
          f"{branch}: non-finite refined lines")
    n_lines = live.sum(-1)
    check(bool((n_lines >= 5).all()), f"{branch}: a voxel lost a genuine line")
    print(f"refined lines per voxel: min {n_lines.min().item()}, max "
          f"{n_lines.max().item()}; cluster counts of voxel 0 "
          f"{counts[0].tolist()}")

    offdiag = jacobi_counter(c32[:32], DWELL, cfg.m_values, cfg.kbdm)
    print(f"Jacobi off-diagonal on production matrices (32 voxels, {branch}): "
          f"{offdiag:.3e} (< 1e-2)")
    check(offdiag < 1e-2, f"{branch}: Jacobi did not converge: {offdiag:.3e}")
    gn = refined.gn_step.cpu().numpy()
    worst_voxels = largest_step_voxels(gn)
    errs = gate_errors(
        worst_voxels, sigs, truths,
        lambda i: line_list_to_np(LineList(*(x[i] for x in top(cons)))),
        lambda i: refined_to_np(refined._replace(
            z=refined.z[i], d=refined.d[i], mask=refined.mask[i]), DWELL))
    gate = max(errs)
    print(f"{branch}: refined vs float64 oracle GN on voxels {worst_voxels} "
          f"(largest last GN step {gn[worst_voxels[0]].max():.3e}): max err "
          f"{gate:.3e} (< 1e-8); per voxel {errs}", flush=True)
    check(gate < 1e-8, f"{branch}: refined lines missed the 1e-8 oracle "
          f"gate: {gate:.3e}")
    return {"branch": branch, "fit_ms": t_fit * 1e3,
            "refine_ms": t_refine * 1e3, "peak_gib": peak_gb,
            "launches": launches, "jacobi_offdiag_rel": offdiag,
            "gate": gate, "gate_voxels": worst_voxels,
            "refined_lines_min_max": [n_lines.min().item(),
                                      n_lines.max().item()],
            "cons": cons, "pooled": pooled, "counts": counts,
            "refined": refined, "drive": drive}


def f32_shift_record(c32, kcfg) -> dict:
    """The float32 power iterations at the JAX package's float32 shift
    (3e-6, llckbdm_tpu/solver/kbdm.py:345-348) instead of the port's 1e-4:
    the north-star voxels whose last power-iteration block is not finite.
    A record of why the port keeps 1e-4 (solver/kbdm.py), not a gate."""
    from llckbdm_tpu_torch import kbdm_sweep
    from llckbdm_tpu_torch.solver import kbdm

    keep = kbdm.F32_POWITER_SHIFT
    kbdm.F32_POWITER_SHIFT = 3e-6
    try:
        y = kbdm_sweep(c32, DWELL, M_VALUES, kcfg, _stop="powiter")
    finally:
        kbdm.F32_POWITER_SHIFT = keep
    bad = ~torch.isfinite(torch.view_as_real(y)).reshape(y.shape[0], -1).all(-1)
    entries = ~torch.isfinite(torch.view_as_real(y)).flatten(-2).all(-1)
    voxels = torch.nonzero(bad).flatten().tolist()
    per_entry = {v: torch.nonzero(entries[v].any(0)).flatten().tolist()
                 for v in voxels}
    print(f"float32 power iterations at a 3e-6 shift: {len(voxels)} of "
          f"{y.shape[0]} voxels non-finite (the port keeps 1e-4): voxels "
          f"{voxels}; their sweep entries {per_entry}", flush=True)
    return {"shift": 3e-6, "nonfinite_voxels": voxels,
            "nonfinite_entries": per_entry}


def profile_main_path(main_path, wall_ms: float) -> dict:
    """One more run of the main path under torch.profiler (CUDA activity
    only): the device's busy time (the union of the intervals of its
    kernels, copies and fills), the idle share of ``wall_ms`` (the
    unprofiled run's fit + refine wall time), the device time by kind, and
    the 12 largest consumers."""
    from torch.profiler import ProfilerActivity, profile

    from llckbdm_tpu_torch.tools.trace_capture import busy_ms, device_rows

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main_path()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = busy_ms(prof)
    check(busy > 0, "torch.profiler recorded no device time")

    def kind(key: str) -> str:
        low = key.lower()
        if any(f"{name}_kernel" in key
               for name in MAIN_KERNELS + ORTH_KERNELS):
            return "hand-written kernels"
        if "gemm" in low:
            return "gemm"
        if "copy" in low or "memcpy" in low:
            return "copies"
        return "other"

    kinds: dict = {}
    for ms, _, key in rows:
        kinds[kind(key)] = kinds.get(kind(key), 0.0) + ms
    top = [{"name": key[:120], "ms": ms, "calls": n, "share": ms / busy}
           for ms, n, key in rows[:12]]
    idle = 1.0 - busy / wall_ms
    print(f"profile of one fit + refine: device busy {busy:.3f} ms; "
          f"unprofiled wall {wall_ms:.3f} ms (idle share {idle:.4f}); "
          f"profiled window {window_ms:.3f} ms; by kind "
          + ", ".join(f"{k} {v:.3f} ms ({v / busy:.3f})"
                      for k, v in sorted(kinds.items(), key=lambda x: -x[1])),
          flush=True)
    for t in top:
        print(f"  {t['ms']:9.3f} ms {t['share']:.4f} x{t['calls']:<5} "
              f"{t['name']}")
    # each hand-written kernel's own device time: a launch too short for an
    # event window to show it (the GN solve) has its number here
    own = [{"name": key[:120], "calls": n, "ms": ms, "ms_per_call": ms / n}
           for ms, n, key in rows if kind(key) == "hand-written kernels"]
    print("hand-written kernels, device time per launch: " + "; ".join(
        f"{t['name'].split('::')[-1].split('(')[0]} x{t['calls']} "
        f"{t['ms_per_call']:.4f} ms" for t in own), flush=True)
    return {"busy_ms": busy, "wall_ms": wall_ms, "idle_share": idle,
            "profiled_window_ms": window_ms, "by_kind_ms": kinds, "top": top,
            "hand_written": own}


def rank_kernels(results: dict) -> None:
    """Print the main-path kernels in the order a redesign should take them:
    first those slower than their library call, the largest factor first;
    then the rest by launches x (ms - bound_ms) per main-path run.
    chol_solve runs once at the amplitude shape and GN_ITERS times at the
    Gauss-Newton shape; gn_normal GN_ITERS times; orth_pass (timed at the
    power iterations' bfloat16 shape) once a CholeskyQR pass."""
    slower, rest = [], []
    for name in MAIN_KERNELS + ("orth_pass",):
        r = results[name]
        loss = r["launches"] * (r["ms"] - r["bound_ms"])
        if name == "chol_solve":
            check(r["launches"] == 1 + GN_ITERS,
                  f"chol_solve launched {r['launches']} times")
            loss = (r["ms"] - r["bound_ms"]) + GN_ITERS * (r["ms_gn"]
                                                            - r["bound_ms_gn"])
        if name == "gn_normal":
            check(r["launches"] == GN_ITERS,
                  f"gn_normal launched {r['launches']} times")
        lib = r["library_ms"]
        factor = r["ms"] / lib if lib else None
        row = (name, factor, loss)
        (slower if factor and factor > 1.0 else rest).append(row)
    order = (sorted(slower, key=lambda x: -x[1])
             + sorted(rest, key=lambda x: -x[2]))
    print("redesign order: " + "; ".join(
        f"{name} (kernel/library {'n/a' if f is None else f'{f:.3g}'}, "
        f"launches x (ms - bound) {loss:.4f} ms)" for name, f, loss in order),
        flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "llckbdm_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no llckbdm_tpu_torch package beside {__file__}; "
              f"run it from the root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    from llckbdm_tpu_torch import (KbdmConfig, LineList, LlcKbdmConfig,
                                   RefineConfig, kbdm_sweep, line_list_to_np,
                                   llc_kbdm_fit, oracle, refine_lines,
                                   refined_to_np)
    from llckbdm_tpu_torch.ops import _build
    from llckbdm_tpu_torch.tools import five_peak

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # bench.py's signals: the config-1 lines with per-voxel jitter of
    # frequency and amplitude, plus complex noise 1e-4, from seed 0
    sigs, truths = five_peak.signals(VOXELS, 1e-4)
    c64 = torch.as_tensor(sigs, device=DEVICE)
    c32 = c64.to(torch.complex64)
    cfg = LlcKbdmConfig(m_values=M_VALUES, eps=2e-4, min_samples=20,
                        max_clusters=32, kbdm=KbdmConfig(p=16))
    rcfg = RefineConfig(iters=GN_ITERS)

    # --- each kernel against its plain version ----------------------------
    ut = kbdm_sweep(c32, DWELL, cfg.m_values, cfg.kbdm, _stop="reduced")
    ut_odd = kbdm_sweep(c32[:256], DWELL, cfg.m_values,
                        dataclasses.replace(cfg.kbdm, p=cfg.kbdm.p - 1),
                        _stop="reduced")
    results = kernel_checks(ut, ut_odd, cfg.kbdm)
    del ut, ut_odd
    results["orth_pass"] = orth_pass_checks()
    results["cholqr_rinv"]["production_grams"] = production_gram_checks(
        c32, DWELL, cfg.m_values, cfg.kbdm, "the north star")

    # --- the main path ----------------------------------------------------
    # the card's default: KbdmConfig(p=16) on CUDA tensors takes the
    # bfloat16 power iterations (the JAX package's accelerator default)
    main = north_star(sigs, truths, c32, c64, cfg, rcfg)
    cons, pooled, counts, refined = (main.pop(k) for k in (
        "cons", "pooled", "counts", "refined"))
    main_path = main.pop("drive")
    launches = main["launches"]
    t_fit, t_refine = main["fit_ms"] / 1e3, main["refine_ms"] / 1e3
    peak_gb, offdiag, gate = main["peak_gib"], main["jacobi_offdiag_rel"], \
        main["gate"]
    for name in results:
        results[name]["launches"] = launches.get(name, 0)
    rank_kernels(results)

    def top(lines):
        return LineList(*(x[..., :REFINE_CLUSTERS] for x in lines))

    # the same path on the float32 power iterations, under the same gates
    f32_cfg = dataclasses.replace(cfg, kbdm=dataclasses.replace(
        cfg.kbdm, subspace_bf16=False))
    f32 = north_star(sigs, truths, c32, c64, f32_cfg, rcfg)
    for k in ("cons", "pooled", "counts", "refined", "drive"):
        del f32[k]
    results["cholqr_rinv"]["launches_f32_branch"] = f32["launches"][
        "cholqr_rinv"]
    results["cholqr_rinv"]["production_grams_f32_branch"] = \
        production_gram_checks(c32, DWELL, cfg.m_values, f32_cfg.kbdm,
                               "the north star (float32 branch)")
    shift_record = f32_shift_record(c32, f32_cfg.kbdm)
    print(f"{smi}: main path V={VOXELS}, bfloat16 power iterations fit "
          f"{main['fit_ms']:.1f} ms, refine {main['refine_ms']:.1f} ms, peak "
          f"{main['peak_gib']:.2f} GiB; float32 fit {f32['fit_ms']:.1f} ms, "
          f"refine {f32['refine_ms']:.1f} ms, peak {f32['peak_gib']:.2f} GiB",
          flush=True)

    # --- where the main path's device time goes ---------------------------
    prof = profile_main_path(main_path, (t_fit + t_refine) * 1e3)
    # the GN solve's instantiation is the only kernel launched GN_ITERS times
    gn_rows = [t for t in prof["hand_written"]
               if "chol_solve_kernel" in t["name"] and t["calls"] == GN_ITERS]
    check(len(gn_rows) == 1, f"the profile's GN solve rows: {gn_rows}")
    results["chol_solve"]["device_ms_gn"] = gn_rows[0]["ms_per_call"]
    print(f"chol_solve GN ({VOXELS}, {2 * REFINE_CLUSTERS}, "
          f"{2 * REFINE_CLUSTERS}): device time {gn_rows[0]['ms_per_call']:.4f}"
          f" ms a launch in the profiled run (event windows, which include "
          f"the host's launch rate: {results['chol_solve']['ms_gn']:.4f} ms; "
          f"bound {results['chol_solve']['bound_ms_gn']:.4f} ms)", flush=True)

    # --- the benchmark and the stage profiler, through their entry points
    bench_paths = bench_phase(main["fit_ms"])

    # --- the spec-scale gates, damping_weight != 0, the 2-D dbscan --------
    spec = spec_phases(oracle)
    damp = damping_phase(sigs, truths, c32, c64, cfg, rcfg)
    same = (damp.pop("counts") == counts).all(-1).sum().item()
    print(f"damping_weight=1.0: cluster counts equal to the main path's "
          f"(damping_weight=0) on {same} of {VOXELS} voxels", flush=True)
    damp["voxels_with_main_path_counts"] = same
    spec["damping"] = damp
    spec["dbscan"] = dbscan_phase(pooled, cfg)
    del pooled
    spec_widths = spec_kernel_checks(oracle)
    for name in MAIN_KERNELS:
        results[name]["spec_shapes"] = (
            spec_widths[name] if name == "chol_solve" else [spec_widths[name]])

    # --- past one warp: p = 32 and 56, the kernels at k, n <= 64 ----------
    spec["wide"], wide_inputs = wide_phase(sigs, truths, c32, c64,
                                           cfg, rcfg)
    spec["wide"]["default_branch_record"] = wide_default_record(
        sigs, truths, c32, cfg)
    for name, rows in wide_kernel_checks(wide_inputs).items():
        results[name]["wide_shapes"] = rows
    del wide_inputs

    # --- the tool kernels -------------------------------------------------
    results.update(probe_checks())

    # --- the grid layer ---------------------------------------------------
    grid = grid_phase(cfg, rcfg)
    from llckbdm_tpu_torch.parallel import refine_grid
    single_all = refine_grid(c64, cons, DWELL, rcfg)
    single_ms = []
    for _ in range(4):                            # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = refine_grid(c64, top(cons), DWELL, rcfg)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
    two = two_rank_phase(sigs, truths, cons, counts, top(cons),
                         single, single_all, cfg, rcfg)
    two["single_refine_ms"] = float(np.median(single_ms[1:]))
    print(f"single-process refine_grid of the same lines: "
          f"{two['single_refine_ms']:.1f} ms (runs "
          f"{np.round(single_ms[1:], 1).tolist()}); time-sharded over two "
          f"ranks: {two['ts_refine_ms']:.1f} ms", flush=True)
    # rank 1 fits nothing: its launches are the 64 x 64 GN solves alone
    results["chol_solve"]["launches_gn64"] = two["chain_launches"][1][
        "chol_solve"]

    # --- the entry points, the stage profiler, the FFT operator, the tools
    new = {"entry": entry_phase(), "dryrun": dryrun_phase(),
           "stages": stages_phase(cfg.kbdm),
           "stages_f32": stages_phase(dataclasses.replace(
               cfg.kbdm, subspace_bf16=False)),
           "fft_hankel": fft_hankel_phase(),
           **tools_phase(), **precision_tools_phase(), **bench_paths}
    for name in MAIN_KERNELS:
        results[name]["launches_new_paths"] = {
            path: (sum(x.get(name, 0) for x in res["launches"])
                   if isinstance(res["launches"], list)
                   else res["launches"].get(name, 0))
            for path, res in new.items() if "launches" in res}
        results[name]["launches_new_paths"]["scaling_bench"] = sum(
            x.get(name, 0) for row in new["scaling_bench"]["dp_scaling"]
            for x in row["launches"])

    sources = {
        "eig_cs": ("llckbdm_tpu_torch/csrc/eig_cs.cu",
                   "llckbdm_tpu/ops/pallas_jacobi.py:94"),
        "gram_svd": ("llckbdm_tpu_torch/csrc/gram_svd.cu",
                     "llckbdm_tpu/ops/pallas_linalg.py:73"),
        "cholqr_rinv": ("llckbdm_tpu_torch/csrc/chol.cu",
                        "llckbdm_tpu/ops/pallas_linalg.py:244"),
        "chol_solve": ("llckbdm_tpu_torch/csrc/chol.cu",
                       "llckbdm_tpu/ops/pallas_linalg.py:309"),
        "gn_normal": ("llckbdm_tpu_torch/csrc/gn_normal.cu",
                      "none: llckbdm_tpu/solver/refine.py leaves the "
                      "normal equations to XLA"),
        "orth_pass": ("llckbdm_tpu_torch/csrc/orth_pass.cu",
                      "none: llckbdm_tpu/solver/kbdm.py forms the "
                      "CholeskyQR pass's Gram and mix as einsums, left to "
                      "XLA"),
        "row_probe": ("llckbdm_tpu_torch/csrc/row_probe.cu",
                      "tools/pallas_smoke.py:11"),
        "eigh_probe": ("llckbdm_tpu_torch/csrc/eigh_probe.cu",
                       "tools/bench_eigh_variants.py:12"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, **results[name]})
    print(json.dumps({"voxels": VOXELS, "fit_ms": t_fit * 1e3,
                      "refine_ms": t_refine * 1e3, "peak_gib": peak_gb,
                      "jacobi_offdiag_rel": offdiag, "gate_max_err": gate,
                      "branches": {"bfloat16": main, "float32": f32},
                      "f32_powiter_shift_3e-6": shift_record,
                      "profile": prof, "spec": spec, "grid": grid,
                      "two_ranks": two, "new_paths": new}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
