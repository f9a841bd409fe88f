"""Time the two Cholesky kernels (``csrc/chol.cu``) alone on one GPU.

    python -m llckbdm_tpu_torch.tools.bench_chol

For ``cholqr_rinv`` and ``chol_solve`` at the main path's shapes (V=2048
voxels, 35 sweep entries: 71,680 matrices of 24 x 24 and 16 x 16; the
Gauss-Newton solves of 16 and 32 clusters, 2048 matrices of 32 x 32 and
64 x 64), at each other compiled size, and at a batch of 2048 at the wide
widths (cholqr_rinv k = 40, 48, 64; the solves of 20 and 24 clusters, 40
and 48): the wrapper's time per call
(``tools.timing.cuda_ms``), the time of the C entry point called directly
(no tensor allocated, no Python around the launch: what a launch too short
for the host to keep up with takes on the device), the card's least time for
the same work (``tools.bounds``), the largest difference from the plain
version relative to its largest entry, and what the instantiation takes of
an SM.  A quick look while working on the kernels; ``chip_smoke.py`` holds
the numbers of record.  Needs a GPU (exits 2 without one).
"""
from __future__ import annotations

import subprocess
import sys

import torch

from ..ops import _build, cuda_linalg
from . import bounds
from .timing import cuda_ms

SHAPES = {  # kernel -> (batch, k)
    "cholqr_rinv": ((71680, 24), (71680, 16), (71680, 32), (71680, 20),
                    (2048, 40), (2048, 48), (2048, 64)),
    "chol_solve": ((71680, 16), (2048, 32), (2048, 64), (71680, 32),
                   (16384, 64), (2048, 40), (2048, 48)),
}


def _crandn(gen, *shape):
    return torch.complex(torch.randn(*shape, generator=gen, device="cuda"),
                         torch.randn(*shape, generator=gen, device="cuda"))


def _resources(name: str, k: int) -> str:
    """What the instantiation takes of an SM.  The file also runs beside an
    older ``csrc/chol.cu`` (copied into that tree, to time two designs on
    one card), whose library does not report it."""
    report = getattr(cuda_linalg, "chol_kernel_resources", None)
    if report is None:
        return ""
    res = report(name, k)
    return (f"; K={res['K']}: {res['registers']} registers, "
            f"{res['local_bytes']} B local, {res['shared_bytes']} B shared a "
            f"block of {res['threads']}, {res['warps_per_sm']} warps an SM")


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_chol: needs a GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(1)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for name, shapes in SHAPES.items():
        for batch, k in shapes:
            y = _crandn(gen, batch, max(64, 2 * k), k)
            g = y.conj().transpose(-1, -2) @ y
            del y
            mean_diag = g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)
            if name == "cholqr_rinv":
                sh = 3e-6 * mean_diag
                out = torch.empty_like(g)
                wrapper = lambda: cuda_linalg.cholqr_rinv(g, sh)
                entry = lambda: lib.llck_cholqr_rinv(
                    g.data_ptr(), sh.data_ptr(), out.data_ptr(), batch, k,
                    stream)
                want = cuda_linalg.cholqr_rinv_plain(g[:2048], sh[:2048])
                bnd = bounds.cholqr_rinv(batch, k)
            else:
                sh = 1e-7 * mean_diag
                rhs = _crandn(gen, batch, k)
                out = torch.empty_like(rhs)
                wrapper = lambda: cuda_linalg.chol_solve(g, rhs, sh)
                entry = lambda: lib.llck_chol_solve(
                    g.data_ptr(), rhs.data_ptr(), sh.data_ptr(),
                    out.data_ptr(), batch, k, stream)
                want = cuda_linalg.chol_solve_plain(g[:2048], rhs[:2048],
                                                    sh[:2048])
                bnd = bounds.chol_solve(batch, k)
            err = ((wrapper()[:2048] - want).abs().max()
                   / want.abs().max()).item()
            t_w, t_e = cuda_ms(wrapper), cuda_ms(entry)
            print(f"{name} ({batch}, {k}, {k}): wrapper {t_w.ms:.4f} ms "
                  f"({t_w.lo:.4f}-{t_w.hi:.4f}), entry point {t_e.ms:.4f} ms "
                  f"({t_e.lo:.4f}-{t_e.hi:.4f}), bound {bnd.ms:.4f} ms "
                  f"({bnd.by}), share {bnd.ms / t_e.ms:.3f}; max rel err "
                  f"{err:.2e}" + _resources(name, k), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
