"""North-star benchmark of the port: refined LL-KBDM voxel fits per second
on one card.

Counterpart of the JAX repo's ``bench.py``, on the same pipeline, signals,
configuration and flags:

1. ``value``: the refined pipeline that meets the 1e-8 accuracy gate
   (multi-m KBDM sweep -> pool -> DBSCAN -> consolidation -> complex128
   Gauss-Newton refinement of the top ``--refine-clusters`` slots, 6
   iterations by default), fits per second.  The gate is checked in the
   bench on the first ``--gate-voxels`` voxels against the float64
   oracle's Gauss-Newton polish of the same initial lines.
2. ``fit_fits_per_sec``: ``llc_kbdm_fit`` alone (no refinement).
3. ``eigensolve_gflops``: the batched complex-symmetric Jacobi eigensolve
   (``ops.cuda_jacobi.eig_cs``, the ``csrc/eig_cs.cu`` kernel on a card)
   on random complex-symmetric matrices at the pipeline's shape (S*V, p,
   p), counted by bench.py's flop model (:func:`eig_cs_flops`, unchanged,
   so the number keeps its meaning).
4. ``stage_ms``: sweep (``kbdm_sweep`` alone), cluster + consolidate (fit
   minus sweep) and refine; ``counters``: the Jacobi off-diagonal norm of
   the production reduced matrices on the first min(32, V) voxels (below
   1e-2), the last GN step and the gate.

Signals: ``tools.five_peak.signals(V, 1e-4)`` (bench.py's, bit for bit),
fitted in complex64 and refined in complex128 on the device.
``KbdmConfig(p=16)`` takes the port's default branch: bfloat16 power
iterations on a card, float32 on the CPU (printed).  Each stage is timed
by the host clock: one untimed call (two for the fit and the refine, as
bench.py's compile call and its timeit's first), then the mean of
``--reps`` calls, each ending in ``torch.cuda.synchronize()``
(``tools.timing.host_mean``).
A missed gate or counter raises RuntimeError (not an assert: ``python
-O`` strips asserts, and the line must never claim a gate that was not
checked).

Prints ONE JSON line with bench.py's keys in its order, ``vs_baseline``
null (bench.py's baseline is a TPU slice's target, not a card's), plus
``backend`` ("cuda" or "cpu") and ``device`` (the card's name and power
limit).  ``--saturation`` logs fits/s of ``llc_kbdm_fit`` at V = 128 ..
2048 (tiling the signals where V exceeds ``--voxels``) to stderr and
prints no JSON.

    python -m llckbdm_tpu_torch.bench [--voxels 2048] [--reps 3] [--json-only]
    python -m llckbdm_tpu_torch.bench --saturation
    python -m llckbdm_tpu_torch.bench --cpu --voxels 2 --reps 1 --gate-voxels 1

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys

import numpy as np
import torch

from .ops import _build, cuda_jacobi
from .pipeline.llckbdm import llc_kbdm_fit
from .signals import LineList, line_list_to_np
from .solver.kbdm import bf16_power_iterations, kbdm_sweep
from .solver.refine import RefineConfig, refine_lines, refined_to_np
from .tools import five_peak
from .tools.timing import device_label, host_mean

METRIC = "llckbdm_refined_voxel_fits_per_sec_per_chip"
SATURATION_V = (128, 256, 512, 1024, 2048)
COUNTER_VOXELS = 32
COUNTER_LIMIT = 1e-2
GATE_LIMIT = 1e-8


def log(msg: str, quiet: bool) -> None:
    if not quiet:
        print(msg, file=sys.stderr, flush=True)


def eig_cs_flops(batch: int, p: int, sweeps: int) -> float:
    """bench.py's flop model of the batched complex-symmetric Jacobi
    eigensolve, unchanged: per rotation pair 4 row-output components x p
    entries x 7 flops + ~140 flops of coefficient math and 2x2 fixes;
    sweeps (p-1) p/2 pairs per matrix.  ``tools.bounds.eig_cs`` counts the
    port's kernel differently (28p + 200 a pair, and the counter)."""
    pairs = sweeps * (p - 1) * (p // 2)
    per_pair = 4 * p * 7 + 140
    return float(batch) * pairs * per_pair


def eig_inputs(batch: int, p: int) -> torch.Tensor:
    """bench.py's eigensolve inputs: (batch, p, p) complex-symmetric
    0.5 (u + u^T) of complex Gaussians from default_rng(1), as complex64 on
    the CPU."""
    rng = np.random.default_rng(1)
    ut = rng.standard_normal((batch, p, p)) \
        + 1j * rng.standard_normal((batch, p, p))
    ut = 0.5 * (ut + np.swapaxes(ut, -1, -2))
    return torch.from_numpy(ut.astype(np.complex64))


def saturation_batches(v: int) -> list[tuple[int, int]]:
    """bench.py's saturation schedule for ``v`` signals: per requested V
    the batch's true count and how many times the signals are tiled
    (the first ``count`` signals when V <= v, tiles = 1; else v * (V // v)
    signals, the whole set tiled V // v times)."""
    out = []
    for vv in SATURATION_V:
        tiles = 1 if vv <= v else vv // v
        out.append((vv if vv <= v else v * tiles, tiles))
    return out


def jacobi_counter(c32: torch.Tensor, cfg) -> float:
    """The largest relative off-diagonal norm eig_cs leaves on the
    production reduced matrices of the first min(32, V) voxels."""
    _, diag = kbdm_sweep(c32[:COUNTER_VOXELS], five_peak.DWELL, cfg.m_values,
                         cfg.kbdm, with_diag=True)
    return diag["eig_offdiag_rel"].max().item()


def gate_errors(cons: LineList, refined, sigs: np.ndarray,
                truths: np.ndarray, voxels: int) -> list[float]:
    """Per voxel of the first ``voxels``: the refined lines' largest error
    against the float64 oracle's 20-iteration Gauss-Newton polish of the
    same initial lines, matched through the truth."""
    errs = []
    for i in range(voxels):
        init = line_list_to_np(LineList(*(x[i] for x in cons)))
        est = refined_to_np(refined._replace(z=refined.z[i], d=refined.d[i],
                                             mask=refined.mask[i]),
                            five_peak.DWELL)
        errs.append(five_peak.gate_error(est, init, sigs[i], truths[i]))
    return errs


def check_limits(jacobi_offdiag: float, gate_err: float,
                 errs: list[float]) -> None:
    """Raise RuntimeError where the counter or the gate missed its limit
    (a NaN misses it; a gate on no voxel is NaN and not checked)."""
    if not jacobi_offdiag < COUNTER_LIMIT:
        raise RuntimeError(
            f"Jacobi eigensolve did not converge on production matrices: "
            f"relative off-diagonal {jacobi_offdiag:.3e}")
    if errs and not gate_err < GATE_LIMIT:
        raise RuntimeError(
            f"refined bench outputs missed the 1e-8 oracle gate: max rel "
            f"err {gate_err:.3e} (per-voxel {errs})")


class _StageCounts:
    """Kernel launches and plain versions on CUDA tensors per stage, as
    deltas of ``ops._build``'s counters."""

    def __init__(self, out: dict | None):
        self.out = out
        self.mark()

    def mark(self) -> None:
        self.launches = collections.Counter(_build.LAUNCHES)
        self.plain = collections.Counter(_build.PLAIN_ON_CUDA)

    def stage(self, name: str) -> None:
        if self.out is not None:
            self.out[name] = {
                "launches": dict(collections.Counter(_build.LAUNCHES)
                                 - self.launches),
                "plain": dict(collections.Counter(_build.PLAIN_ON_CUDA)
                              - self.plain)}
        self.mark()


def main(argv: list[str] | None = None, launches: dict | None = None) -> int:
    """The entry point.  ``launches``, where given, receives each timed
    stage's kernel launches and plain versions run on CUDA tensors
    ("fit", "refine", "sweep", "eigensolve"; warm-up calls included)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voxels", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gn-iters", type=int, default=6,
                    help="complex128 Gauss-Newton iterations (bench.py's "
                         "default; the gate is checked in the bench)")
    ap.add_argument("--gn-f32-iters", type=int, default=0,
                    help="plain-f32 GN warm-start iterations before them")
    ap.add_argument("--refine-clusters", type=int, default=16,
                    help="cluster slots refined (consolidated slots are "
                         "sorted by count, so the slice keeps the largest)")
    ap.add_argument("--gate-voxels", type=int, default=3,
                    help="first voxels on which the 1e-8 oracle gate is "
                         "checked (0 disables)")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--saturation", action="store_true",
                    help="fits/s of the fit at V = 128 .. 2048")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench: needs a CUDA device (or --cpu)", file=sys.stderr)
        return 2
    quiet = args.json_only
    device = "cpu" if args.cpu else "cuda"
    label = device_label(device)

    dwell, v = five_peak.DWELL, args.voxels
    cfg = five_peak.north_star_config()
    rcfg = RefineConfig(iters=args.gn_iters, f32_iters=args.gn_f32_iters)
    s_sweep, p = len(cfg.m_values), cfg.kbdm.p

    sigs, truths = five_peak.signals(v, 1e-4)
    c64 = torch.as_tensor(sigs).to(device)
    c32 = c64.to(torch.complex64)
    branch = ("bfloat16" if bf16_power_iterations(c32, cfg.kbdm)
              else "float32")
    log(f"# device: {label}; {branch} power iterations", quiet)

    def fit(x=c32):
        return llc_kbdm_fit(x, dwell, cfg)

    if args.saturation:
        for count, tiles in saturation_batches(v):
            x = c32.repeat(tiles, 1)[:count]
            ms, _, _ = host_mean(lambda: fit(x), device, args.reps)
            log(f"# saturation V={count}: {count / ms * 1e3:.1f} fits/s",
                quiet)
        return 0

    counts = _StageCounts(launches)
    # --- stage 1: the fit (two untimed calls: bench.py's compile call and
    # its timeit's first) --------------------------------------------------
    t_fit, warm, (cons, _, _, _) = host_mean(fit, device, args.reps,
                                             warmups=2)
    counts.stage("fit")
    log(f"# fit first call: {warm / 1e3:.1f} s", quiet)

    # --- stage 2: refinement of the top slots (the gate-meeting pipeline)
    rc = min(args.refine_clusters, cfg.max_clusters)
    cons = LineList(*(x[..., :rc] for x in cons))
    t_refine, warm, refined = host_mean(
        lambda: refine_lines(c64, cons, dwell, rcfg), device, args.reps,
        warmups=2)
    counts.stage("refine")
    log(f"# refine first call: {warm / 1e3:.1f} s", quiet)
    gn_step = refined.gn_step.max().item()

    fits_refined = v / (t_fit + t_refine) * 1e3
    fits_f32 = v / t_fit * 1e3

    # --- stage decomposition ---------------------------------------------
    t_sweep, _, _ = host_mean(
        lambda: kbdm_sweep(c32, dwell, cfg.m_values, cfg.kbdm), device,
        args.reps)
    counts.stage("sweep")
    t_cluster = max(t_fit - t_sweep, 0.0)

    # --- eigensolve GFLOP/s on random complex-symmetric matrices at the
    # pipeline's shape (a fixed sweep count: convergence-independent) -----
    eig_batch, sweeps = s_sweep * v, cfg.kbdm.eig_sweeps
    ut = eig_inputs(eig_batch, p).to(device)
    t_eig, _, _ = host_mean(lambda: cuda_jacobi.eig_cs(ut, sweeps=sweeps),
                            device, args.reps)
    counts.stage("eigensolve")
    del ut
    gflops = eig_cs_flops(eig_batch, p, sweeps) / t_eig / 1e6

    # --- the in-bench checks (untimed) -----------------------------------
    jacobi_offdiag = jacobi_counter(c32, cfg)
    errs = gate_errors(cons, refined, sigs, truths, min(args.gate_voxels, v))
    gate_err = float(np.max(errs)) if errs else float("nan")
    check_limits(jacobi_offdiag, gate_err, errs)
    if errs:
        log(f"# gate: max rel err vs f64 oracle on {len(errs)} voxels = "
            f"{gate_err:.2e} (< 1e-8)", quiet)

    log(f"# fit {t_fit:.1f} ms (sweep {t_sweep:.1f} + cluster "
        f"{t_cluster:.1f}) + refine {t_refine:.1f} ms -> {fits_refined:.1f} "
        f"refined fits/s ({fits_f32:.1f} fit only); eig_cs {t_eig:.2f} ms = "
        f"{gflops:.1f} GFLOP/s", quiet)

    print(json.dumps({
        "metric": METRIC,
        "value": round(fits_refined, 2),
        "unit": f"fits/s/chip on {label} (N=512, m-sweep 120..256:4, p=16, "
                f"{branch} power iterations, "
                f"GN iters={args.gn_f32_iters}f32+{args.gn_iters}c128, "
                f"1e-8 gate asserted)",
        "vs_baseline": None,
        "fit_fits_per_sec": round(fits_f32, 2),
        "eigensolve_gflops": round(gflops, 2),
        "stage_ms": {"sweep": round(t_sweep, 2),
                     "cluster_consolidate": round(t_cluster, 2),
                     "refine": round(t_refine, 2)},
        "counters": {"jacobi_offdiag_rel_production": jacobi_offdiag,
                     "gn_last_step_max": gn_step,
                     "gate_max_rel_err": gate_err},
        "voxels": v,
        "backend": device,
        "device": label,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
