"""Device ms of the power iterations a batch: the llckbdm.sweep.powiter
span (benchmark/program_spans.py, median over the replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.span_ms(rec, "llckbdm.sweep.powiter")
