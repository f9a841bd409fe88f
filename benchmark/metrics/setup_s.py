"""Set-up: from process start to the first timed call (import, kernel load or
build, signals, warm-up)."""
def read(rec):
    return rec.setup_s
