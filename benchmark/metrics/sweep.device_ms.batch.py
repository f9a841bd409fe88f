"""Device ms of kbdm_sweep a batch: the llckbdm.sweep span with its
children, from its first device op to its last (benchmark/program_spans.py,
median over the replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.device_ms(rec, "sweep")
