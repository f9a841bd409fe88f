"""Refined fits per second of a batch cell: voxels whose refined lines the
port returned, over the window from the first batch's start to the last
one's sync."""
from benchmark import stats


def read(rec):
    if rec.kind != "batch":
        return None
    return stats.rate(rec.units, *rec.window)
