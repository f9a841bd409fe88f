"""Idle share of the sweep layer a batch: 100 idle / (busy + idle), the idle
gaps ended by an op that llckbdm.sweep launched, busy the union of its ops
(benchmark/program_spans.py, median over the replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.idle_pct(rec, "sweep")
