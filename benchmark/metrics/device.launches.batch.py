"""Device ops (kernels, copies, fills) launched inside llckbdm.fit and
llckbdm.refine in one batch (benchmark/program_spans.py, median over the
replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.launches(rec)
