"""Median ms of llc_kbdm_fit plus a sync per call of the pipeline in the
traced window."""
from benchmark import readers


def read(rec):
    return readers.span_ms(rec, "fit")
