"""What the metrics' readers (``benchmark/metrics/<name>.py``) share.  A
reader returns None where the record holds nothing for it to read (no
such span, no trace, no launch of the kernel), whatever the cell's traffic
kind; a share of a roofline is never made up as 0."""
from __future__ import annotations

import statistics

from . import bounds, stats


def span_ms(rec, name: str) -> float | None:
    """Median ms of the harness's ``name`` spans."""
    return stats.median_ms(rec.spans.get(name))


def idle_pct(rec) -> float | None:
    """The device's idle share of the traced window: 100 (1 - busy /
    window), busy the union of the device intervals."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def launches_ms(rec, kernel: str) -> list[float]:
    """Device ms of each launch of the kernels whose name holds
    ``kernel``."""
    if rec.trace is None:
        return []
    return [1e3 * (e - s) for name, s, e in rec.trace.device if kernel in name]


def fit_shape(rec) -> dict | None:
    """One fit's kernel shapes from the configuration and the voxels of one
    ``llc_kbdm_fit`` call that the loop reported: matrices per launch
    (voxels x sweep entries), p, k and the sweeps; None without a call."""
    if not rec.fit_voxels:
        return None
    cfg = rec.config
    m = cfg["pipeline"]["m_values"]
    entries = len(range(m["first"], m["last"] + 1, m["step"]))
    kbdm = cfg["kbdm"]
    return {"batch": rec.fit_voxels * entries, "p": kbdm["p"],
            "k": kbdm["p"] + kbdm["oversample"],
            "eig_sweeps": kbdm["eig_sweeps"],
            "eigh_sweeps": kbdm["eigh_sweeps"]}


def roofline_pct(rec, kernel: str, bound) -> float | None:
    """100 x the least time (``bound``, from the frozen counts) over the
    mean device time of one launch."""
    times = launches_ms(rec, kernel)
    if not times:
        return None
    return 100.0 * bound.ms / statistics.fmean(times)

