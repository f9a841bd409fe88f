"""Each stage of the north star's pipeline timed alone at the bench's
shapes, beside its work model and the card's peaks, and the whole fit's
speed-of-light budget.

Counterpart of the JAX repo's ``tools/profile_stages.py``, on its signals
(noise free, frequency jitter only: ``five_peak.signals(V, 0.0,
amp_jitter=False)``) and its rows, in its order: ``llc_kbdm_fit``,
``kbdm_sweep``, ``hankel_matrices`` at m=256, one float32 Hankel apply at
the sweep's (V, m, S, k) layout (``solver.kbdm._apply``), the
``cholqr_rinv`` kernel alone on the Gram of that apply's output (at the
power iterations' relative shift; the JAX tool timed it only on a TPU),
``takagi_small`` (the gram_svd kernel), the ``eig_cs`` kernel on random
complex-symmetric (S, V, p, p) matrices, ``_poles_to_lines``,
cluster + consolidate (fit minus sweep) and ``refine_lines`` with 3
iterations on all the fit's slots.  The random inputs are drawn as the JAX
tool draws them (Gaussian parts, the same scales), from torch generators on
the device seeded 0-5 where the JAX tool used PRNGKey 0-5.

Each row is timed by the host clock, two untimed calls (``WARMUPS``, as the
port's ``bench.py`` takes: one left the bench's fit 7.6% slow on the card)
and then the mean of ``--reps`` calls each ending in
``torch.cuda.synchronize()`` (each call's time kept as the row's
``runs_ms``, the dispatch floor not subtracted), less the
dispatch floor: on a card the median of 10 round trips of an empty kernel
(``ops.cuda_probes.empty_launch``) and a synchronise; 0 on the CPU.

Work models, real flops (a complex multiply-add is 8), against the H100
SXM's published peaks (``tools.bounds``: 67 TFLOP/s float32 outside the
tensor cores, 989 bfloat16, 34 float64, 3.35 TB/s):

* the kernels' rows (cholqr_rinv, takagi_small, eig_cs): ``tools.bounds``'
  counts and bounds (the port's convention; the JAX tool counted each
  kernel's TPU implementation, 26 k^3, 72 k a pair and 588 a pair);
* the Hankel gather: its (V, m, m) complex64 output in bytes; the apply
  8 m^2 k S V; ``_poles_to_lines`` and cluster + consolidate: the JAX
  tool's formulas (profile_stages.py:236-238, :259-271; the cluster model
  is the O(n^2) DBSCAN's, which the JAX package runs on a TPU; the port
  runs the sorted ``dbscan_1d``, so that row is a yardstick of the JAX
  algorithm's work, and its % counts the float32 share only, as there);
* refine (:func:`refine_flops`): the port's own arithmetic, a complex128
  state, powers and residual (6 flops a complex multiply) and a float32
  normal matrix and solve, where the JAX tool counted double-float pairs
  (36 flops a complex multiply, 9 x 36 C N for the powers) and an
  8 (2C)^3 / 3 solve.

The ideal budget has the JAX tool's keys (profile_stages.py:300-323) and
takes the branch the sweep takes (``solver.kbdm.bf16_power_iterations``):
on the bfloat16 branch the power iterations' applies at the bfloat16 peak,
their CholeskyQR Grams and mixes (float32 products of the upcast blocks)
at the float32 one; on the float32 branch everything at the float32 peak.
``pipeline_pct_of_light`` = ideal / measured fit.

Prints its JSON (``device``, ``voxels``, ``rows``, ``ideal_ms``,
``pipeline_pct_of_light``, ``branch``) as the last line and writes it to
``--out`` where given, nowhere else.

    python -m llckbdm_tpu_torch.tools.profile_stages [--voxels 512] [--out FILE]
    python -m llckbdm_tpu_torch.tools.profile_stages --cpu --voxels 1 --reps 1

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_jacobi, cuda_linalg, cuda_probes
from ..ops.hankel import hankel_matrices
from ..ops.linalg import matmul_precision, takagi_small
from ..pipeline.llckbdm import LlcKbdmConfig, llc_kbdm_fit
from ..solver.kbdm import (F32_POWITER_SHIFT, _apply, _gram_sk,
                           _poles_to_lines, bf16_power_iterations, kbdm_sweep)
from ..solver.refine import RefineConfig, refine_lines
from . import bounds, five_peak
from .timing import device_label, host_mean

REFINE_ITERS = 3
WARMUPS = 2         # untimed calls before each row's timed ones
ROWS = ("llc_kbdm_fit", "kbdm_sweep", "hankel_matrices m=256",
        "apply (V,m,m)@(V,m,S*k) f32", "cholqr_rinv kernel (V,S,k,k)",
        "takagi_small (V,S,k,k) [gram_svd]", "eig_cs kernel (S,V,p,p)",
        "_poles_to_lines (V,S,p)", "cluster+consolidate (derived)",
        f"refine_lines iters={REFINE_ITERS} (V,C)")


class Work(NamedTuple):
    flops: float
    bytes: float
    light_ms: float     # the least time at the card's peaks
    unit: str           # what it is held to


def _at(flops: float, peak: float, unit: str) -> Work:
    return Work(float(flops), 0.0, 1e3 * flops / peak, unit)


def _kernel(b: bounds.Bound) -> Work:
    return Work(b.flops, b.bytes, b.ms, f"kernel bound ({b.by})")


def refine_flops(v: int, c: int, n: int, iters: int) -> tuple[float, float]:
    """(float64, float32) flops of ``refine_lines``' exact iterations on
    (V, C) slots and N samples.  Per voxel and iteration: the powers
    z^0..z^(N-1) by ceil(log2 N) complex128 multiplies of (C, N) (6 flops
    each), the model sum 8CN, the residual 2N, J^H r over the 2C rows 16CN
    in float64; the Jacobian's second block 8CN, the normal matrix's three
    (C, C) blocks 24 C^2 N and the (2C, 2C) solve (``tools.bounds``'
    chol_solve count) in float32."""
    bits = max(1, math.ceil(math.log2(max(n, 2))))
    f64 = 6 * bits * c * n + 8 * c * n + 2 * n + 16 * c * n
    f32 = 24 * c * c * n + 8 * c * n + bounds.chol_solve(1, 2 * c).flops
    return float(v * iters * f64), float(v * iters * f32)


def cluster_flops(v: int, cfg: LlcKbdmConfig) -> tuple[float, float]:
    """The JAX tool's cluster + consolidate model (profile_stages.py:
    259-271), n = S p pooled lines, C slots: (elementwise 50 n^2, rank
    matmuls 10 n^2 C) per voxel."""
    npool = len(cfg.m_values) * cfg.kbdm.p
    return (float(v) * 50.0 * npool * npool,
            float(v) * 10.0 * npool * npool * cfg.max_clusters)


def _shapes(cfg: LlcKbdmConfig) -> tuple[int, int, int, int]:
    kc = cfg.kbdm
    return len(cfg.m_values), kc.p, kc.p + kc.oversample, max(cfg.m_values)


def lines_flops(v: int, n: int, cfg: LlcKbdmConfig) -> float:
    """The JAX tool's ``_poles_to_lines`` model (profile_stages.py:236-238):
    the chunked right-hand side, the geometric Gram and its solve."""
    kc = cfg.kbdm
    s, p, _, _ = _shapes(cfg)
    nch = (n + kc.rhs_chunk - 1) // kc.rhs_chunk
    return float(s * v) * (nch * kc.rhs_chunk * p * 14 + 60 * p * p
                           + 8 * p ** 3 / 3)


def work_models(v: int, n: int, cfg: LlcKbdmConfig) -> dict:
    """Each row's Work (None for the fit and the sweep, which the JAX tool
    did not model either); the refine row on all cfg.max_clusters slots."""
    kc = cfg.kbdm
    s, p, k, m = _shapes(cfg)
    hank = v * m * m * 2 * 4
    vpu, mxu = cluster_flops(v, cfg)
    f64, f32 = refine_flops(v, cfg.max_clusters, n, REFINE_ITERS)
    return dict(zip(ROWS, (
        None, None,
        Work(0.0, float(hank), 1e3 * hank / bounds.PEAK_BYTES, "HBM"),
        _at(8.0 * m * m * k * s * v, bounds.PEAK_FLOPS, "f32"),
        _kernel(bounds.cholqr_rinv(s * v, k)),
        _kernel(bounds.gram_svd(s * v, k, kc.eigh_sweeps)),
        _kernel(bounds.eig_cs(s * v, p, kc.eig_sweeps)),
        _at(lines_flops(v, n, cfg), bounds.PEAK_FLOPS, "f32"),
        # the % counts the float32 share (the JAX tool's VPU share)
        Work(vpu + mxu, 0.0,
             1e3 * vpu / bounds.PEAK_FLOPS, "f32+bf16"),
        Work(f64 + f32, 0.0,
             1e3 * (f64 / bounds.PEAK_F64 + f32 / bounds.PEAK_FLOPS),
             "f64+f32"),
    )))


def ideal_budget(v: int, n: int, cfg: LlcKbdmConfig, bf16: bool) -> dict:
    """The fit's speed-of-light budget in ms, with the JAX tool's keys
    (profile_stages.py:300-323), for the power iterations' branch."""
    kc = cfg.kbdm
    s, p, k, m = _shapes(cfg)
    it = kc.subspace_iters
    f32 = bounds.PEAK_FLOPS
    apply = 8.0 * m * m * k * s * v
    gram = 8.0 * m * k * k * s * v
    vpu, mxu = cluster_flops(v, cfg)
    sec = {
        "hankel U0 (HBM)": v * m * m * 8 / bounds.PEAK_BYTES,
        f"bf16 applies x{1 + it}":
            (1 + it) * apply / (bounds.PEAK_BF16 if bf16 else f32),
        "bf16 orth grams/mixes": it * 2 * gram / f32,
        "f32 final orth x2 (gram+mix)": 4 * gram / f32,
        f"cholqr kernels x{it + 2}":
            (it + 2) * bounds.cholqr_rinv(s * v, k).ms / 1e3,
        "m_small apply+gram (f32)": (apply + gram) / f32,
        "takagi (gram_svd kernel)":
            bounds.gram_svd(s * v, k, kc.eigh_sweeps).ms / 1e3,
        "u_p mix + U1-shift mix + gram (f32)":
            (2 * 8.0 * m * k * p * s * v + 8.0 * m * p * p * s * v) / f32,
        "eig_cs kernel": bounds.eig_cs(s * v, p, kc.eig_sweeps).ms / 1e3,
        "poles->lines": lines_flops(v, n, cfg) / f32,
        "cluster+consolidate": vpu / f32 + mxu / bounds.PEAK_BF16,
    }
    return {key: t * 1e3 for key, t in sec.items()}


def dispatch_floor(device, reps: int = 10) -> float:
    """ms of one empty kernel launch and synchronise on a card (median of
    ``reps`` after a warm-up); 0 on the CPU."""
    if torch.device(device).type != "cuda":
        return 0.0

    def once() -> float:
        t0 = time.perf_counter()
        cuda_probes.empty_launch()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    once()
    return statistics.median(once() for _ in range(reps))


def _gaussian(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def run(voxels: int = 512, reps: int = 3, device="cuda",
        verbose: bool = True) -> dict:
    """Time every row on ``voxels`` of the JAX tool's signals; returns the
    JSON the entry point prints."""
    cfg = five_peak.north_star_config()
    kc, dwell = cfg.kbdm, five_peak.DWELL
    s, p, k, m = _shapes(cfg)
    sigs, _ = five_peak.signals(voxels, 0.0, amp_jitter=False)
    c128 = torch.as_tensor(sigs).to(device)
    c = c128.to(torch.complex64)
    v, n = c.shape
    bf16 = bf16_power_iterations(c, kc)
    branch = "bfloat16" if bf16 else "float32"
    label = device_label(device)
    floor = dispatch_floor(device)

    def say(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    say(f"# {label}; V={v} S={s} p={p} k={k}; {branch} power iterations; "
        f"host clock, mean of {reps} after {WARMUPS} untimed calls")
    say(f"# dispatch floor: {floor:.4f} ms (subtracted from every row)")

    rows: list[dict] = []
    gens = [torch.Generator(device=device).manual_seed(i) for i in range(6)]

    def row(name: str, ms: float, work, note: str | None = None,
            runs: list | None = None) -> None:
        r = {"stage": name, "ms": ms,
             "gflops": work.flops / 1e9 if work and work.flops else None,
             "gbytes": work.bytes / 1e9 if work and work.bytes else None,
             "unit": work.unit if work else None,
             "pct_peak": 100.0 * work.light_ms / ms if work else None}
        if note:
            r["note"] = note
        if runs is not None:
            r["runs_ms"] = runs
        rows.append(r)
        extra = ""
        if work:
            size = (f"{work.flops / 1e9:9.2f} GF" if work.flops
                    else f"{work.bytes / 1e9:9.3f} GB")
            extra = f"  {size} = {r['pct_peak']:6.2f}% of {work.unit}"
        if runs is not None:
            extra += f"  runs {[round(x, 3) for x in runs]}"
        say(f"{name:44s} {ms:10.3f} ms{extra}")

    models = work_models(v, n, cfg)

    def timed(name: str, fn) -> tuple[float, object]:
        runs: list[float] = []
        ms, _, out = host_mean(fn, device, reps, warmups=WARMUPS, runs=runs)
        ms = max(ms - floor, 1e-3)
        row(name, ms, models[name], runs=runs)
        return ms, out

    t_full, (cons, _, _, _) = timed(ROWS[0],
                                    lambda: llc_kbdm_fit(c, dwell, cfg))
    t_sweep, _ = timed(ROWS[1],
                       lambda: kbdm_sweep(c, dwell, cfg.m_values, kc))
    _, h0 = timed(ROWS[2], lambda: hankel_matrices(c, m))

    # one masked apply at the sweep's layout, on a Gaussian block
    masks = np.zeros((m, s), np.float32)
    for i, mi in enumerate(cfg.m_values):
        masks[:mi, i] = 1.0
    mk = torch.as_tensor(masks, device=device)[:, :, None]
    x0 = torch.complex(_gaussian(gens[0], (v, m, s, k), device),
                       _gaussian(gens[1], (v, m, s, k), device))
    _, y = timed(ROWS[3], lambda: _apply(h0, x0, mk, "highest"))
    del x0, h0
    with matmul_precision():
        g = _gram_sk(y, y)
    del y
    g = 0.5 * (g + g.transpose(-1, -2).conj())
    shift = F32_POWITER_SHIFT * torch.mean(
        torch.abs(torch.diagonal(g, dim1=-2, dim2=-1).real), dim=-1)
    timed(ROWS[4], lambda: cuda_linalg.cholqr_rinv(g, shift))
    # Hermitian rather than complex-symmetric: the kernel's work depends
    # only on the shape and the sweeps (as in the JAX tool)
    timed(ROWS[5], lambda: takagi_small(g, sweeps=kc.eigh_sweeps))
    del g, shift

    ur = _gaussian(gens[2], (s, v, p, p), device)
    ui = _gaussian(gens[3], (s, v, p, p), device)
    ut = torch.complex(0.5 * (ur + ur.transpose(-1, -2)),
                       0.5 * (ui + ui.transpose(-1, -2)))
    timed(ROWS[6], lambda: cuda_jacobi.eig_cs(ut, sweeps=kc.eig_sweeps))
    del ur, ui, ut

    mu = torch.complex(0.9 * _gaussian(gens[4], (v, s, p), device),
                       0.1 * _gaussian(gens[5], (v, s, p), device))
    keep = torch.ones((v, s, p), dtype=torch.bool, device=device)

    def lines():
        with matmul_precision():
            return _poles_to_lines(mu, keep, c[:, None, :], dwell, n, kc)

    timed(ROWS[7], lines)
    row(ROWS[8], max(t_full - t_sweep, 1e-3), models[ROWS[8]],
        note="the JAX package's O(n^2) DBSCAN model (the port runs "
             "dbscan_1d); pct is the float32 share only")
    timed(ROWS[9], lambda: refine_lines(c128, cons, dwell,
                                        RefineConfig(iters=REFINE_ITERS)))

    ideal = ideal_budget(v, n, cfg, bf16)
    total = sum(ideal.values())
    pct = total / t_full * 100.0
    say(f"\n# ideal (speed-of-light) budget, {branch} power iterations:")
    for key, t in ideal.items():
        say(f"  {key:36s} {t:9.4f} ms")
    say(f"# fit: ideal {total:.3f} ms / measured {t_full:.3f} ms -> "
        f"{pct:.2f}% of the card's peaks")
    return {"device": label, "voxels": v, "rows": rows, "ideal_ms": ideal,
            "pipeline_pct_of_light": pct, "branch": branch}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voxels", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("profile_stages: needs a CUDA device (or --cpu)",
              file=sys.stderr)
        return 2
    res = run(args.voxels, args.reps, "cpu" if args.cpu else "cuda")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
        print(f"# wrote {out}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
