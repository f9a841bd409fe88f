"""Idle share of the device in the traced window of a batch cell."""
from benchmark import readers


def read(rec):
    return readers.idle_pct(rec, "batch")
