"""The implicit FFT Hankel apply against the dense (materialized) apply.

Counterpart of the JAX package's ``tools/bench_fft_hankel.py``.  For each
shape, the per-apply marginal cost of three formulations of
y = H x, H[i, j] = c[i + j], with J columns of x applied at once:

* ``dense_f32``  — ``hankel_matrices`` then a batched complex64 matmul in
  full float32 (no TF32): the sweep's apply;
* ``dense_bf16`` — the same operator as a real (2m, 2m) bfloat16 block
  [[Re, -Im], [Im, Re]] on real pairs (torch has no complex bfloat16): a
  yardstick for lower-precision applies, never on the pipeline;
* ``fft``        — ``hankel_fft_spectrum`` then ``hankel_apply_fft``: no
  (V, m, m) operator in memory.

The marginal is (chain of 3 applies - chain of 1) / 2, each chain timed by
``tools.timing.cuda_ms`` with its set-up (the operator or the spectrum)
inside, so the set-up cancels.  The error of each is its chain of one's
largest deviation from a float64 numpy apply on 4 voxels, relative to the
largest entry.  Beside each: its bound at ``tools.bounds``' peaks (bf16 at
the tensor cores' 989 TFLOP/s), counting x read and y written once and the
operator (or the signal) read once; the FFT's operations as 5 n log2 n a
transform of length n.

Shapes (``--shape``): ``pipeline`` (V=2048, N=512, m=256, J = S k = 840,
the north star's sweep apply) and ``config2`` (V=2048, N=2048, m=512,
J = k = 32, config 2's apply at a batch of 2048).

    python -m llckbdm_tpu_torch.tools.bench_fft_hankel [--shape pipeline]
    python -m llckbdm_tpu_torch.tools.bench_fft_hankel --cpu --voxels 4 --m 32 --n 64 --cols 8

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from ..ops.hankel import fft_length, hankel_apply_fft, hankel_fft_spectrum
from ..ops.hankel import hankel_matrices
from ..ops.linalg import matmul_precision
from . import bounds
from .timing import cuda_ms, device_label, host_ms

SHAPES = {  # name -> (V, N, m, J)
    "pipeline": (2048, 512, 256, 840),
    "config2": (2048, 2048, 512, 32),
}
ERR_VOXELS = 4


def dense_f32(c, x, m, depth):
    h = hankel_matrices(c, m)
    with matmul_precision():
        for _ in range(depth):
            x = h @ x
    return x


def dense_bf16(c, x, m, depth):
    h = hankel_matrices(c, m)
    blk = torch.cat([torch.cat([h.real, -h.imag], dim=-1),
                     torch.cat([h.imag, h.real], dim=-1)], dim=-2)
    blk = blk.to(torch.bfloat16)
    y = torch.cat([x.real, x.imag], dim=-2).to(torch.bfloat16)
    for _ in range(depth):
        y = blk @ y
    y = y.to(torch.float32)
    return torch.complex(y[..., :m, :], y[..., m:, :])


def fft(c, x, m, depth):
    spec = hankel_fft_spectrum(c, m)
    for _ in range(depth):
        x = hankel_apply_fft(spec, x, m)
    return x


METHODS = {"dense_f32": dense_f32, "dense_bf16": dense_bf16, "fft": fft}


def apply_bound(method: str, v: int, n: int, m: int, j: int) -> bounds.Bound:
    """The card's least time for one apply: x read and y written once, the
    operator read once (the signal, for the FFT)."""
    xy = 2 * v * m * j * 8
    if method == "fft":
        nfft = fft_length(m)
        # one forward transform per column and one inverse, the product
        flops = v * j * (2 * 5 * nfft * math.log2(nfft) + 6 * nfft)
        return bounds.bound(flops, xy + v * n * 8)
    flops = 8.0 * m * m * j * v
    if method == "dense_bf16":
        # x and y as bfloat16 real pairs, the (2m, 2m) bfloat16 block
        return bounds.bound(flops, xy / 2 + v * 8 * m * m,
                            bounds.PEAK_BF16)
    return bounds.bound(flops, xy + v * m * m * 8)


def run(shape=(2048, 512, 256, 840), device="cuda", verbose=True) -> dict:
    """Each method's marginal ms per apply, its error and its bound."""
    v, n, m, j = shape
    rng = np.random.default_rng(0)
    sigs = rng.standard_normal((v, n)) + 1j * rng.standard_normal((v, n))
    x_np = (rng.standard_normal((v, m, j)).astype(np.float32)
            + 1j * rng.standard_normal((v, m, j)).astype(np.float32))
    c = torch.as_tensor(sigs).to(device, torch.complex64)
    x = torch.as_tensor(x_np, device=device)
    vs = min(v, ERR_VOXELS)
    idx = np.add.outer(np.arange(m), np.arange(m))
    c32 = sigs[:vs].astype(np.complex64).astype(np.complex128)
    y_ref = np.einsum("vab,vbj->vaj", np.stack([c32[i][idx] for i in range(vs)]),
                      x_np[:vs].astype(np.complex128))
    scale = np.abs(y_ref).max()
    cuda = torch.device(device).type == "cuda"
    if verbose:
        print(f"# {device_label(device)}; V={v} N={n} m={m} J={j} "
              f"nfft={fft_length(m)}", flush=True)
    out = {}
    for name, fn in METHODS.items():
        y = fn(c[:vs], x[:vs], m, 1).cpu().numpy()
        err = float(np.abs(y - y_ref).max() / scale)
        if cuda:
            t1, t3 = (cuda_ms(lambda d=d: fn(c, x, m, d)) for d in (1, 3))
        else:
            t1, t3 = (host_ms(lambda d=d: fn(c, x, m, d), device)
                      for d in (1, 3))
        per = (t3.ms - t1.ms) / 2.0
        bnd = apply_bound(name, v, n, m, j)
        out[name] = dict(ms_per_apply=per, chain1_ms=t1.ms, chain3_ms=t3.ms,
                         rel_err=err, bound_ms=bnd.ms, bound_by=bnd.by,
                         flops=bnd.flops, bytes=bnd.bytes)
        if verbose:
            print(f"{name:10s}: {per:9.4f} ms/apply (chain1 {t1.ms:.4f}, "
                  f"chain3 {t3.ms:.4f}); bound {bnd.ms:.4f} ms ({bnd.by}); "
                  f"max rel err vs float64 {err:.2e}", flush=True)
    if verbose:
        f = out["fft"]["ms_per_apply"]
        print(f"# fft / dense_f32 {f / out['dense_f32']['ms_per_apply']:.3g}; "
              f"fft / dense_bf16 {f / out['dense_bf16']['ms_per_apply']:.3g} "
              f"(< 1: the FFT apply is faster)", flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), nargs="*",
                    default=list(SHAPES))
    ap.add_argument("--voxels", type=int)
    ap.add_argument("--n", type=int)
    ap.add_argument("--m", type=int)
    ap.add_argument("--cols", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a check of the tool, no card's times)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench_fft_hankel: needs a CUDA device (or --cpu)",
              file=sys.stderr)
        return 2
    for name in args.shape:
        shape = [a if a is not None else d for a, d in zip(
            (args.voxels, args.n, args.m, args.cols), SHAPES[name])]
        print(f"## {name}")
        run(tuple(shape), "cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
