"""Float64 oracle for the port's own checks: numpy and scipy only.

The port's copy of the four functions of ``llckbdm_tpu/oracle/reference.py``
that its checks use (``sample_signal``, ``refine``, ``line_errors``,
``match_lines``), so that nothing of the JAX package is loaded where the port
runs.  The formulas are the reference's, line for line;
``tests/test_torch_oracle.py`` holds the two against each other.

Line-list convention: a line is (A, T2, f, phase), and

    c[n] = sum_k A_k exp(i phase_k) exp((i 2 pi f_k - 1/T2_k) n dwell).
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def sample_signal(params: np.ndarray, n: int, dwell: float) -> np.ndarray:
    """Sample a time-domain signal from a (k, 4) line list of (A, T2, f,
    phase) rows.  Returns a complex128 array of length ``n``."""
    params = np.asarray(params, dtype=np.float64)
    a, t2, f, ph = params[:, 0], params[:, 1], params[:, 2], params[:, 3]
    t = np.arange(n, dtype=np.float64) * dwell
    z = (2j * np.pi * f[:, None] - 1.0 / t2[:, None]) * t[None, :]
    return np.sum(a[:, None] * np.exp(1j * ph[:, None]) * np.exp(z), axis=0)


def refine(lines: np.ndarray, data: np.ndarray, dwell: float,
           iters: int = 10, ridge: float = 1e-12,
           max_step: float = 0.1) -> np.ndarray:
    """Float64 Gauss-Newton polish of a line list against the data.

    Joint GN on (poles z_k, complex amplitudes d_k) of c_n ~= sum_k d_k z_k^n,
    a full normal-equation solve with a relative Tikhonov ridge and a
    per-pole step clip: the least-squares fixed point that the 1e-8 gate
    compares the refined lines with.  lines : (k, 4);  data : (N,) complex.
    Returns the refined (k, 4) list sorted by frequency.
    """
    lines = np.asarray(lines, np.float64)
    n = len(data)
    ns = np.arange(n)
    z = np.exp((2j * np.pi * lines[:, 2] - 1.0 / lines[:, 1]) * dwell)
    d = lines[:, 0] * np.exp(1j * lines[:, 3])
    c = len(z)
    for _ in range(iters):
        p = np.power(z[None, :], ns[:, None])            # (N, k)
        r = data - p @ d
        dj = d[None, :] * ns[:, None] * np.power(
            z[None, :], np.maximum(ns[:, None] - 1, 0))
        j = np.concatenate([p, dj], axis=1)
        g = j.conj().T @ j
        rhs = j.conj().T @ r
        shift = ridge * np.trace(g).real / g.shape[0]
        delta = np.linalg.solve(g + shift * np.eye(g.shape[0]), rhs)
        d = d + delta[:c]
        step = delta[c:]
        sn = np.abs(step)
        z = z + np.where(sn > max_step,
                         max_step * step / np.maximum(sn, 1e-300), step)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(z))
    out = np.stack([np.abs(d), t2,
                    np.angle(z) / (2.0 * np.pi * dwell), np.angle(d)], axis=1)
    return out[np.argsort(out[:, 2])]


def line_errors(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-entry errors of matched line lists: relative on A, T2 and f,
    wrapped absolute on the phase (an angle).  ``.max()`` is what the 1e-8
    gate is asserted on."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    rel = np.abs(est[:, :3] - ref[:, :3]) / np.abs(ref[:, :3])
    dphi = np.abs(est[:, 3] - ref[:, 3]) % (2.0 * np.pi)
    dphi = np.minimum(dphi, 2.0 * np.pi - dphi)
    return np.concatenate([rel, dphi[:, None]], axis=1)


def match_lines(est: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Optimal (Hungarian) frequency matching of estimated lines to truth:
    ``est[sel[k]]`` corresponds to ``truth[k]``.  The cost is |df| with a
    small relative T2 tie-breaker.  Raises ValueError when fewer lines were
    estimated than truth rows (an unmatched -1 would index the last line)."""
    if len(est) < len(truth):
        raise ValueError(
            f"match_lines: {len(est)} estimated lines < {len(truth)} truth "
            f"lines — the estimate is missing lines; cannot match")
    df = np.abs(est[None, :, 2] - truth[:, None, 2])        # (T, E)
    dt2 = np.abs(est[None, :, 1] - truth[:, None, 1]) \
        / np.maximum(np.abs(truth[:, None, 1]), 1e-30)
    cost = df + 1e-3 * np.median(df) * dt2 if len(est) else df
    rows, cols = linear_sum_assignment(cost)
    sel = np.full(len(truth), -1, dtype=int)
    sel[rows] = cols
    return sel
