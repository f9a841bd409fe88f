"""Window arithmetic: rates over all the work and all the time, medians of
spans."""
from __future__ import annotations

import statistics


def rate(units: int, start: float, end: float) -> float:
    """Units completed per second over the whole window: a stall inside it
    lowers the rate."""
    return units / (end - start)


def median_ms(spans) -> float | None:
    """Median duration in ms of (start, end) spans in seconds; None for
    none."""
    if not spans:
        return None
    return 1e3 * statistics.median(e - s for s, e in spans)
