"""Device ms of pooling, DBSCAN and consolidation a batch: the
llckbdm.cluster span, from its first device op to its last
(benchmark/program_spans.py, median over the replayed batches)."""
from benchmark import program_spans

after_window = program_spans.after_window


def read(rec):
    return program_spans.device_ms(rec, "cluster")
