"""Median ms of kbdm_sweep alone on one call's input of the cell (the loop's
``fit_input``), as bench.py's stage_ms times it: after the window, one
untimed call, then the host clock around each of three calls ended by a
sync."""
import statistics
import time

REPS = 3


def after_window(ctx, rec):
    c32, cfg = ctx.state["fit_input"], ctx.fit_cfg

    def once():
        t = time.perf_counter()
        ctx.port.kbdm_sweep(c32, ctx.dwell, cfg.m_values, cfg.kbdm)
        ctx.sync()
        return 1e3 * (time.perf_counter() - t)

    once()
    rec.extra["sweep_ms"] = statistics.median(once() for _ in range(REPS))


def read(rec):
    return rec.extra.get("sweep_ms")
