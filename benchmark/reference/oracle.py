"""The benchmark's plain reference: a frozen copy of the float64 oracle's
functions (numpy and scipy only), so that no later change to the program
moves the yardstick.

Copied from ``llckbdm_tpu_torch/oracle.py`` (itself the line-for-line copy
of the JAX package's ``oracle/reference.py`` with a numpy DBSCAN that gives
scikit-learn's labels); ``benchmark/tests/test_benchmark_frozen.py`` holds
each function equal to its source.  It imports nothing of the program.

Line-list convention: a line is (A, T2, f, phase), and

    c[n] = sum_k A_k exp(i phase_k) exp((i 2 pi f_k - 1/T2_k) n dwell).
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
from scipy.optimize import linear_sum_assignment


def sample_signal(params: np.ndarray, n: int, dwell: float) -> np.ndarray:
    """Sample a time-domain signal from a (k, 4) line list of (A, T2, f,
    phase) rows.  Returns a complex128 array of length ``n``."""
    params = np.asarray(params, dtype=np.float64)
    a, t2, f, ph = params[:, 0], params[:, 1], params[:, 2], params[:, 3]
    t = np.arange(n, dtype=np.float64) * dwell
    z = (2j * np.pi * f[:, None] - 1.0 / t2[:, None]) * t[None, :]
    return np.sum(a[:, None] * np.exp(1j * ph[:, None]) * np.exp(z), axis=0)


def kbdm(data: np.ndarray, dwell: float, m: int | None = None,
         p: int | None = None, *, filter_t2_min: float = 0.0,
         amp_min: float = 0.0, return_all: bool = False):
    """Single KBDM fit: Hankel U0/U1, truncated SVD of U0, the reduced p x p
    eigenproblem, poles, Vandermonde least-squares amplitudes.

    data : complex signal, N >= 2 m;  m : Hankel size (default N // 2);
    p : truncation rank (default m).  Returns (lines, info): (k, 4) rows of
    (A, T2, f, phase) sorted by frequency, kept where T2 > filter_t2_min,
    A >= amp_min and T2 is finite (unless return_all), and a dict of the
    singular values, the poles, m and p.
    """
    c = np.asarray(data, dtype=np.complex128)
    n = c.shape[0]
    if m is None:
        m = n // 2
    if n < 2 * m:
        raise ValueError(f"need len(data) >= 2*m, got N={n}, m={m}")
    if p is None:
        p = m
    p = min(p, m)

    idx = np.arange(m)[:, None] + np.arange(m)[None, :]
    u0 = c[idx]
    u1 = c[idx + 1]

    ll, s, rh = scipy.linalg.svd(u0)
    lp = ll[:, :p]
    sp = s[:p]
    rp = rh[:p, :].conj().T

    # U~ = S^-1/2 L^H U1 R S^-1/2
    s_isqrt = 1.0 / np.sqrt(sp)
    ut = (s_isqrt[:, None] * (lp.conj().T @ u1 @ rp)) * s_isqrt[None, :]
    mu, _ = scipy.linalg.eig(ut)

    freq = np.angle(mu) / (2.0 * np.pi * dwell)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(mu))

    # |mu| <= exp(30/N) keeps |mu^n| <= e^30; clamped poles keep T2 < 0 and
    # the T2 filter drops them
    mu_mag = np.abs(mu)
    mu_max = np.exp(30.0 / n)
    mu_cl = np.where(mu_mag > mu_max, mu * (mu_max / mu_mag), mu)
    v = mu_cl[None, :] ** np.arange(n)[:, None]
    d, *_ = scipy.linalg.lstsq(v, c, lapack_driver="gelsd")
    amp = np.abs(d)
    phase = np.angle(d)

    lines = np.stack([amp, t2, freq, phase], axis=1)
    if not return_all:
        keep = (t2 > filter_t2_min) & (amp >= amp_min) & np.isfinite(t2)
        lines = lines[keep]
    lines = lines[np.argsort(lines[:, 2])]
    info = {"singular_values": s, "poles": mu, "m": m, "p": p}
    return lines, info


def transform_line_lists(lines: np.ndarray, dwell: float, *,
                         damping_weight: float = 0.0) -> np.ndarray:
    """The clustering features of pooled (k, 4) lines: x0 = f dwell and
    x1 = damping_weight dwell / T2."""
    f = lines[:, 2]
    t2 = lines[:, 1]
    x0 = f * dwell
    x1 = damping_weight * dwell / np.maximum(t2, 1e-9)
    return np.stack([x0, x1], axis=1)


def dbscan(feats: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """scikit-learn's ``DBSCAN(eps, min_samples).fit(feats).labels_``, in
    numpy: the same labels, not only the same partition.

    Neighbourhoods are the points at Euclidean distance <= eps, self
    included, compared as the squared distance against eps^2, as sklearn's
    KD tree does; a point with >= min_samples of them is a core point.
    Clusters are numbered in the order of their first core point: each is
    grown from that seed by a stack, expanding core points only, as
    sklearn's ``dbscan_inner`` does, so a border point takes the first
    cluster that reaches it.  Noise is -1.  A dense (n, n) distance matrix: for n up to a
    few thousand.
    """
    x = np.asarray(feats, np.float64)
    n = len(x)
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    neighbours = [np.flatnonzero(row) for row in d2 <= eps * eps]
    core = np.array([len(nb) >= min_samples for nb in neighbours], bool)
    labels = np.full(n, -1, dtype=np.intp)
    label = 0
    for seed in range(n):
        if labels[seed] != -1 or not core[seed]:
            continue
        stack = [seed]
        while stack:
            i = stack.pop()
            if labels[i] != -1:
                continue
            labels[i] = label
            if core[i]:
                stack.extend(v for v in neighbours[i] if labels[v] == -1)
        label += 1
    return labels


def llc_kbdm(data: np.ndarray, dwell: float, m_range, p: int,
             eps: float = 2e-4, min_samples: int = 20, *,
             filter_t2_min: float = 0.0, amp_min: float = 0.0,
             damping_weight: float = 0.0):
    """Line-list KBDM: a kbdm fit at every m of m_range, the lines pooled,
    clustered by :func:`dbscan` on :func:`transform_line_lists`' features,
    and each cluster consolidated by component-wise medians: A, T2 and f
    their medians, phase the angle of median(Re d) + i median(Im d) with
    d = A e^{i phase}.

    Returns (consolidated (n_clusters, 4) sorted by frequency, pooled
    (n_pool, 4), labels (n_pool,), -1 = noise).
    """
    pools = []
    for m in m_range:
        lines, _ = kbdm(data, dwell, m=int(m), p=p,
                        filter_t2_min=filter_t2_min, amp_min=amp_min)
        pools.append(lines)
    pooled = np.concatenate(pools, axis=0) if pools else np.zeros((0, 4))
    if len(pooled) == 0:
        return np.zeros((0, 4)), pooled, np.zeros((0,), dtype=int)

    feats = transform_line_lists(pooled, dwell, damping_weight=damping_weight)
    labels = dbscan(feats, eps, min_samples)

    out = []
    for lab in sorted(set(labels) - {-1}):
        grp = pooled[labels == lab]
        d = grp[:, 0] * np.exp(1j * grp[:, 3])
        out.append([
            np.median(grp[:, 0]),
            np.median(grp[:, 1]),
            np.median(grp[:, 2]),
            np.arctan2(np.median(d.imag), np.median(d.real)),
        ])
    consolidated = np.asarray(out, dtype=np.float64).reshape(-1, 4)
    consolidated = consolidated[np.argsort(consolidated[:, 2])]
    return consolidated, pooled, labels


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
