"""Device ms of one Gauss-Newton step: an llckbdm.refine.step span, from its
first device op to its last (benchmark/program_spans.py, median over every
step of the replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.step_ms(rec)
