"""Device ms of the sweep's line stage a batch (Vandermonde amplitudes and
the line filter): the llckbdm.sweep.lines span (benchmark/program_spans.py,
median over the replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.span_ms(rec, "llckbdm.sweep.lines")
