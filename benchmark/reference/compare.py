"""The comparison that decides ``correct``: the port's answers for sampled
voxels against the frozen float64 oracle's, worked out from the signals
alone.

For one voxel the reference runs the oracle's LL-KBDM (a KBDM fit at every
m of the sweep, the lines pooled, DBSCAN, consolidation by medians), takes
its clusters in the program's order (largest first) up to the refined
slots, and polishes them by the oracle's float64 Gauss-Newton.  Two numbers
are read:

* ``refined_err``, the compared number: the refined lines against the
  configuration's own 1e-8 limit: the largest error (relative on A, T2 and
  f, wrapped absolute on the phase; ``oracle.line_errors``) between the
  port's refined lines and the reference's, matched by
  ``oracle.match_lines``.  A line found on one side only makes the numbers
  of refined lines unequal, which gives infinity: which lines were found
  is compared here too.  The reference's lines nought to round-off, with
  an amplitude under ``ROUNDOFF`` of its largest, are left out (of the
  slot counts too): where a signal has fewer lines than the rank p, the
  float64 reference's spare poles fit the signal's rounding, and now and
  then one of its clusters passes ``min_samples``.  Such lines read 1e-14
  to 1e-13 of the largest line (1e-16 to 1e-15 refined); the weakest line of a
  signal reads 0.08 of the largest, a noise line of a noisy one 2e-5, and
  the float32 program resolves none under 1e-7.
* ``count_gap``, a reading beside it: the slot counts.  The port's
  occupied slots and the reference's clusters are matched by frequency,
  within eps / dwell Hz (the clustering's own radius); the gap is the
  largest difference of member counts over matched pairs, and an
  unmatched line on either side counts its whole count.  It has no
  limit: the control (the precision below the stated one) reads the same
  0 to 5 as sound runs, since a spare pole joins a line's cluster on one
  side and not the other whatever the precision, so no limit lies
  between its readings.  A line found or lost shows in ``refined_err``.

numpy and scipy only.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.optimize import linear_sum_assignment

from . import oracle

NUMBERS = ("count_gap", "refined_err")
LIMITED = ("refined_err",)
# amplitude, relative to the reference's largest line, under which a
# reference line is round-off and not compared
ROUNDOFF = 1e-9


def reference_voxel(sig: np.ndarray, ref: dict) -> dict:
    """The reference's answer for one voxel's (N,) complex128 signal.

    ``ref`` holds dwell, m_values, p, eps, min_samples, damping_weight,
    amp_min, t2_min, slots, iters, ridge and max_step.  Returns the
    consolidated clusters' frequencies and member counts (sorted by
    frequency) and the refined (k, 4) lines sorted by frequency, each
    without the lines nought to round-off."""
    dwell = ref["dwell"]
    cons, pooled, labels = oracle.llc_kbdm(
        sig, dwell, ref["m_values"], ref["p"], ref["eps"],
        ref["min_samples"], filter_t2_min=ref["t2_min"],
        amp_min=ref["amp_min"], damping_weight=ref["damping_weight"])
    groups = [labels == lab for lab in sorted(set(labels.tolist()) - {-1})]
    counts = np.array([g.sum() for g in groups], np.int64)
    freqs = np.array([np.median(pooled[g, 2]) for g in groups])
    order = np.argsort(freqs)                 # the rows of ``cons``
    counts, freqs = counts[order], freqs[order]
    top = np.argsort(-counts, kind="stable")[:ref["slots"]]
    refined = oracle.refine(cons[top], sig, dwell, iters=ref["iters"],
                            ridge=ref["ridge"], max_step=ref["max_step"])
    lines, kept = ~roundoff(cons[:, 0]), ~roundoff(refined[:, 0])
    return {"frequency": freqs[lines], "counts": counts[lines],
            "refined": refined[kept]}


def roundoff(amplitudes: np.ndarray) -> np.ndarray:
    """True for the reference's lines nought to round-off: an amplitude
    under ``ROUNDOFF`` of the largest."""
    amplitudes = np.asarray(amplitudes, np.float64)
    return amplitudes < ROUNDOFF * amplitudes.max(initial=0.0)


def refined_rows(z: np.ndarray, d: np.ndarray, mask: np.ndarray,
                 dwell: float) -> np.ndarray:
    """(A, T2, f, phase) rows of the valid slots of refined complex128 poles
    and amplitudes, sorted by frequency."""
    keep = np.asarray(mask) > 0.5
    z, d = np.asarray(z)[keep], np.asarray(d)[keep]
    freq = np.angle(z) / (2.0 * np.pi * dwell)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(z))
    out = np.stack([np.abs(d), t2, freq, np.angle(d)], axis=1)
    return out[np.argsort(out[:, 2])]


def count_gap(port_f: np.ndarray, port_counts: np.ndarray,
              ref_f: np.ndarray, ref_counts: np.ndarray,
              radius_hz: float) -> float:
    """Largest member-count difference over clusters matched by frequency
    within ``radius_hz``; an unmatched cluster counts its whole count.
    ``port_*`` are the port's slots with a count above 0."""
    gaps = [0.0]
    if len(port_f) and len(ref_f):
        cost = np.abs(port_f[:, None] - ref_f[None, :])
        cost = np.where(np.isfinite(cost), cost, 1e300)
        rows, cols = linear_sum_assignment(cost)
        ok = cost[rows, cols] <= radius_hz
        rows, cols = rows[ok], cols[ok]
    else:
        rows = cols = np.zeros(0, int)
    gaps += [abs(float(port_counts[r]) - float(ref_counts[c]))
             for r, c in zip(rows, cols)]
    gaps += [float(x) for i, x in enumerate(port_counts) if i not in rows]
    gaps += [float(x) for i, x in enumerate(ref_counts) if i not in cols]
    return max(gaps)


def refined_err(port_rows: np.ndarray, ref_rows: np.ndarray) -> float:
    """Largest line error of the port's refined lines against the
    reference's; infinity where the two differ in number or the port's
    are not finite."""
    if len(port_rows) != len(ref_rows) or not np.all(np.isfinite(port_rows)):
        return math.inf
    if not len(ref_rows):
        return 0.0
    sel = oracle.match_lines(port_rows, ref_rows)
    return float(oracle.line_errors(port_rows[sel], ref_rows).max())


def compare_unit(port: dict, ref: dict, dwell: float,
                 radius_hz: float) -> dict:
    """The two numbers for one answer of the port: ``port`` holds the
    slots' ``counts`` and consolidated ``frequency`` (C,) and the refined
    ``z``, ``d`` and ``mask`` (R,)."""
    counts = np.asarray(port["counts"], np.float64)
    occupied = counts > 0
    freq = np.asarray(port["frequency"], np.float64)[occupied]
    rows = refined_rows(port["z"], port["d"], port["mask"], dwell)
    return {"count_gap": count_gap(freq, counts[occupied], ref["frequency"],
                                   ref["counts"], radius_hz),
            "refined_err": refined_err(rows, ref["refined"])}


def worst(numbers: list[dict]) -> dict:
    """Each number's largest value over the compared answers (NaN counts as
    infinity); infinity where nothing was compared."""
    out = {}
    for key in NUMBERS:
        vals = [n[key] for n in numbers]
        vals = [math.inf if math.isnan(v) else v for v in vals]
        out[key] = max(vals) if vals else math.inf
    return out


def decide(numbers: dict, limits: dict) -> bool:
    """True where every limited number is at or below its limit."""
    return all(numbers[k] <= limits[k] for k in LIMITED)
