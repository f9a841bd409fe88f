"""Idle share of the clustering layer a batch: 100 idle / (busy + idle) of
the llckbdm.cluster span (benchmark/program_spans.py, median over the
replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.idle_pct(rec, "cluster")
