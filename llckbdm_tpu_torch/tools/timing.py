"""Milliseconds per call of GPU work: by CUDA events over many launches
(kernels), or by the host clock around a synchronise (whole steps)."""
from __future__ import annotations

import math
import subprocess
import time
from typing import Callable, NamedTuple

import torch

WINDOW_CALLS = 200      # a window is this many calls ...
WINDOW_MS = 100.0       # ... or as many as reach this, if that is fewer
WINDOWS = 5
# A warm-up call longer than this is its own one timing.  First-use costs
# (library and kernel loading) reached 0.21 s on an H100, 2% of this.
ONCE_MS = 10_000.0


class Timing(NamedTuple):
    ms: float           # median over the windows of the mean ms per call
    lo: float           # fastest window
    hi: float           # slowest window
    calls: int          # calls per window
    windows: int

    def __str__(self) -> str:
        if self.windows == 1:
            return f"{self.ms:.4f} ms (one call)"
        return (f"{self.ms:.4f} ms (median of {self.windows} windows of "
                f"{self.calls} calls, {self.lo:.4f}-{self.hi:.4f})")


def cuda_ms(fn: Callable[[], object]) -> Timing:
    """Time ``fn`` on the current CUDA device.

    After one warm-up call, one timed call sets the window: 200 calls, or as
    many as reach 100 ms if that is fewer.  The result is the median of 5
    windows, with the fastest and the slowest.  A call that takes more than
    100 ms is timed once, in one window; a warm-up call over 10 s is that
    one timing.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms: needs a CUDA device")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def window(calls: int) -> float:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    first = window(1)                # the warm-up call
    if first > ONCE_MS:
        return Timing(first, first, first, 1, 1)
    first = window(1)
    if first > WINDOW_MS:
        return Timing(first, first, first, 1, 1)
    calls = min(WINDOW_CALLS, max(1, math.ceil(WINDOW_MS / first)))
    times = sorted(window(calls) for _ in range(WINDOWS))
    return Timing(times[WINDOWS // 2], times[0], times[-1], calls, WINDOWS)


def host_ms(fn: Callable[[], object], device, reps: int = 3) -> Timing:
    """Time ``fn`` by the host clock: one warm-up call, then the median of
    ``reps`` calls, each ending in ``torch.cuda.synchronize()`` on a CUDA
    device (the measure of a step that runs many kernels and host work)."""
    cuda = torch.device(device).type == "cuda"

    def once() -> float:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    once()
    times = sorted(once() for _ in range(reps))
    return Timing(times[reps // 2], times[0], times[-1], 1, reps)


def host_mean(fn: Callable[[], object], device, reps: int = 3,
              warmups: int = 1,
              runs: list | None = None) -> tuple[float, float, object]:
    """Time ``fn`` by the host clock as the JAX package's ``bench.py`` does:
    ``warmups`` untimed calls, then the mean of ``reps`` calls, each ending
    in ``torch.cuda.synchronize()`` on a CUDA device.  Returns (mean ms,
    the first call's ms, the last call's output); ``runs``, where given,
    receives each timed call's ms."""
    cuda = torch.device(device).type == "cuda"

    def once() -> tuple[float, object]:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    first, out = once()
    for _ in range(warmups - 1):
        once()
    total = 0.0
    for _ in range(reps):
        ms, out = once()
        total += ms
        if runs is not None:
            runs.append(ms)
    return total / reps, first, out


def device_label(device) -> str:
    """The device a number was measured on: the card's name and power limit
    as ``nvidia-smi`` gives them, or the CPU's (whose times are no card's)."""
    if torch.device(device).type != "cuda":
        return "cpu (plain versions; no card)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
