"""Checks of the sweep's precision path that the CPU tests
(tests/test_torch_precision.py) and the card's (tests/test_torch_cuda.py)
share.  Not a test module: it imports no JAX.

``logged_products`` logs every matrix product of a kbdm_sweep with the
float32 precision it ran at and where in the sweep it ran.  Products are
caught by a TorchFunctionMode; where they ran comes from
wrappers around the sweep's functions:

* "site": the JAX package's mxu_precision sites, the float32 Hankel apply
  (``_apply``) and the Gram and mix products (``_gram_sk``, ``_mix_sk``);
* "corr": the reduced matrix's correction row (its einsum's equation);
* "takagi", "lines": ``takagi_small`` and ``_poles_to_lines``;
* "bf16 branch": the bfloat16 power iterations, its own Gram and mix
  included;
* "sweep": anything else (the kernels' plain versions among them).
"""
import contextlib

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from llckbdm_tpu_torch import oracle
from llckbdm_tpu_torch.solver import kbdm as K

CORR = "...ms,...msp->...sp"
PRODUCTS = ("matmul", "__matmul__", "__rmatmul__", "einsum", "bmm", "mm")
SPIED = (("_apply", "site"), ("_gram_sk", "site"), ("_mix_sk", "site"),
         ("takagi_small", "takagi"), ("_poles_to_lines", "lines"),
         ("_power_iterations_bf16", "bf16 branch"))


@contextlib.contextmanager
def logged_products(monkeypatch):
    """Yields the log, a list of (where, float32 matmul precision,
    cuBLAS's allow_tf32) for every product inside the block."""
    where, log = ["sweep"], []

    class Log(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in PRODUCTS:
                site = where[-1]
                if func is torch.einsum and args[0] == CORR:
                    site = "corr"
                log.append((site, torch.get_float32_matmul_precision(),
                            torch.backends.cuda.matmul.allow_tf32))
            return func(*args, **(kwargs or {}))

    def spy(name, label):
        fn = getattr(K, name)

        def wrapped(*args, **kwargs):
            # the bfloat16 branch's own Gram and mix stay its own
            where.append(where[-1] if where[-1] == "bf16 branch" else label)
            try:
                return fn(*args, **kwargs)
            finally:
                where.pop()
        monkeypatch.setattr(K, name, wrapped)

    for name, label in SPIED:
        spy(name, label)
    with Log():
        yield log


def high_only_at_the_sites(log) -> list:
    """The entries of a "high" sweep's log that break the rule: "high"
    (TF32 on a card) at the four sites, "highest" everywhere else."""
    return [(site, prec, tf32) for site, prec, tf32 in log
            if (prec == "high") != (site in ("site", "corr"))
            or tf32 != (prec == "high")]


BF16_ULP = 2.0 ** -8        # bfloat16's relative rounding step
# The float32 stage's tolerances for lines of one sweep entry or one
# cluster: two runs of one algorithm in other roundings (the JAX package's
# and the port's, or the card's and the CPU's) agree in the projected
# Hankel's singular values to a few float32 ulps, but a line's pole comes
# out of an eigenproblem whose conditioning turns that into ~1e-3 on A and
# ~0.2 Hz on f on short signals (N=256, m=48) -- as far as each lies from
# the truth (tests/test_torch_solver.py's f32-stage tolerances are 0.5 Hz
# and 10%).
A_RTOL, T2_RTOL, F_ATOL, PHASE_ATOL = 1e-2, 1e-2, 0.5, 5e-2


def largest_angle(a: np.ndarray, b: np.ndarray, r: int = 5) -> float:
    """The largest principal angle (its sine) between the r-dimensional
    dominant left singular subspaces of each (m, k) block of a and b
    (..., m, S, k), over every voxel and sweep entry, in float64."""
    a = np.moveaxis(a, -2, -3).astype(np.complex128)
    b = np.moveaxis(b, -2, -3).astype(np.complex128)
    ua = np.linalg.svd(a, full_matrices=False)[0][..., :r]
    ub = np.linalg.svd(b, full_matrices=False)[0][..., :r]
    cos = np.linalg.svd(np.swapaxes(ua.conj(), -1, -2) @ ub,
                        compute_uv=False)
    return float(np.sqrt(np.clip(1.0 - cos.min() ** 2, 0.0, None)))


def genuine(lines, truth, v, s):
    """Sweep entry (v, s)'s valid lines nearest to each true line of
    ``truth`` (n, 4), as (n, 4) rows (A, T2, f, phase); ``lines`` are the
    five fields of a LineList as numpy arrays."""
    rows = np.stack([x[v, s] for x in lines[:4]], -1)[lines[4][v, s] > 0.5]
    return rows[oracle.match_lines(rows, truth)]


def hold_rows(a, b):
    """Two sets of matched line rows at the float32 stage's tolerances."""
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=A_RTOL)
    np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=T2_RTOL)
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=0, atol=F_ATOL)
    dphi = np.angle(np.exp(1j * (a[:, 3] - b[:, 3])))
    np.testing.assert_allclose(dphi, 0.0, rtol=0, atol=PHASE_ATOL)
