"""Idle share of the device in the traced window."""
from benchmark import readers


def read(rec):
    return readers.idle_pct(rec)
