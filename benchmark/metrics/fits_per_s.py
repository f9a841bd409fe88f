"""Refined fits per second: the units of work the loop completed (voxels
whose refined lines the port returned to its caller) over the loop's
window, from the first unit's start to the last unit's sync, or to its
file on disk (``benchmark/loops/__init__.py``); None where the loop
completed none."""
from benchmark import stats


def read(rec):
    if not rec.units:
        return None
    return stats.rate(rec.units, *rec.window)
