"""Median ms of refine_lines plus a sync per call of the pipeline in the
traced window."""
from benchmark import readers


def read(rec):
    return readers.span_ms(rec, "refine")
