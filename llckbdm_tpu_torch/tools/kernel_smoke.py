"""Smoke-test the row-access kernel (``csrc/row_probe.cu``) against a numpy
loop: the dynamic row loads and stores, and the element store, that the
Jacobi kernels rely on.  Counterpart of ``tools/pallas_smoke.py``.

    python -m llckbdm_tpu_torch.tools.kernel_smoke          # on a GPU
    python -m llckbdm_tpu_torch.tools.kernel_smoke --cpu    # plain version

Without ``--cpu`` it needs CUDA and exits with 2 when there is none.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..convert import batch_from_lanes, batch_to_lanes
from ..ops.cuda_probes import row_probe


def schedule(n: int, steps: int) -> np.ndarray:
    """The tool's (steps, 2) int32 schedule: (k mod n, (7k + 3) mod n),
    which never pairs a row with itself."""
    k = np.arange(steps)
    return np.stack([k % n, (k * 7 + 3) % n], axis=1).astype(np.int32)


def self_paired_schedule(n: int, steps: int) -> np.ndarray:
    """:func:`schedule` with every third step pairing row k mod n with
    itself, where the write order decides the result."""
    sched = schedule(n, steps)
    sched[::3, 1] = sched[::3, 0]
    return sched


def reference(sched: np.ndarray, a: np.ndarray) -> np.ndarray:
    """The tool's numpy loop, on the lane layout (n, n, B)."""
    ref = a.copy()
    for k in range(sched.shape[0]):
        i, j = sched[k]
        ri, rj = ref[i].copy(), ref[j].copy()
        aij = ref[i, j].copy()
        c = aij * 0.25
        s = 1.0 - c * c
        ref[i] = c * ri - s * rj
        ref[j] = s * ri + c * rj
        ref[i, j] = c
    return ref


def run(n: int = 24, b: int = 256, steps: int = 16, device: str = "cuda") -> float:
    """Run the probe on ``device`` (the kernel on a GPU, the plain version on
    the CPU) and hold it against :func:`reference`; raises above 1e-5.
    Returns the max abs error."""
    sched = schedule(n, steps)
    a = np.random.default_rng(0).standard_normal((n, n, b)).astype(np.float32)
    # the schedule stays on the host, where the kernel takes it from
    out = row_probe(torch.from_numpy(sched), batch_from_lanes(a, device))
    err = float(np.max(np.abs(batch_to_lanes(out) - reference(sched, a))))
    print(f"device={device} ({n}, {n}, {b}) steps={sched.shape[0]} "
          f"max abs err: {err:.2e}")
    if not err < 1e-5:
        raise RuntimeError(f"row_probe disagrees with the numpy loop: {err:.3e}")
    return err


def main(argv: list[str]) -> int:
    cpu = "--cpu" in argv
    if not cpu and not torch.cuda.is_available():
        print("kernel_smoke: needs a CUDA device (or --cpu for the plain "
              "version)", file=sys.stderr)
        return 2
    run(device="cpu" if cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
