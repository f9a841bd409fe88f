"""A device trace of the bench-shaped fit (or refinement) with its top ops.

Counterpart of the JAX package's ``tools/trace_capture.py``: a
``torch.profiler`` trace (CUDA activity) of ``--reps`` steady-state
iterations of the north star's LL-KBDM fit at ``--voxels`` (or, with
``--refine``, of the Gauss-Newton refinement of its top 16 clusters, 6
iterations), after one warm-up call.  The raw trace is kept as
``trace.json`` under ``--out`` (chrome://tracing, Perfetto), and the top
device ops by total time are printed from the profiler's own tables
(``key_averages``), beside the device's busy time: the union of the ops'
intervals, so that time two ops overlap counts once.

    python -m llckbdm_tpu_torch.tools.trace_capture [--voxels 256] [--reps 3] [--out DIR] [--refine]
    python -m llckbdm_tpu_torch.tools.trace_capture --cpu --voxels 1 --reps 1

Without ``--cpu`` it needs CUDA and exits with 2 when there is none; with
it the trace is of the CPU's ops (no card's times).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from ..pipeline.llckbdm import llc_kbdm_fit
from ..signals import LineList
from ..solver.refine import RefineConfig, refine_lines
from . import five_peak
from .timing import device_label


def device_rows(prof, cuda: bool = True) -> list[tuple[float, int, str]]:
    """(ms, calls, name) of every op with device self time in a finished
    ``torch.profiler.profile``, largest first: the CUDA kernels, copies and
    fills, or with ``cuda=False`` the CPU ops."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue        # a span (record_function), not an op
        if cuda:
            if e.device_type != DeviceType.CUDA:   # counted by its kernels
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:                          # older torch
                us = e.self_cuda_time_total
        else:
            us = e.self_cpu_time_total
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(key=lambda r: -r[0])
    return rows


def union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals: overlapping time
    counts once."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def busy_ms(prof, cuda: bool = True) -> float:
    """Busy ms of the device in a finished ``torch.profiler.profile``: the
    union of the intervals of its kernels, copies and fills (or with
    ``cuda=False`` of the CPU ops), so that kernels on two streams, or a
    CPU op and the ops it calls, count once; spans are left out."""
    from torch.autograd import DeviceType

    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    return union_ns((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == kind
                    and not e.is_user_annotation()) / 1e6


def print_top(rows, total: float, top: int = 25) -> None:
    """The ``top`` rows of device_rows with their share of ``total``, the
    busy ms."""
    print(f"# total device-op time {total:.3f} ms (busy: the union of the "
          f"ops' intervals) over {len(rows)} ops")
    print(f"{'op':64s} {'total ms':>10s} {'calls':>6s} {'%':>6s}")
    for ms, calls, name in rows[:top]:
        print(f"{name[:64]:64s} {ms:10.3f} {calls:6d} "
              f"{100.0 * ms / max(total, 1e-12):6.1f}")


def run(voxels: int = 256, reps: int = 3, out: str | None = None,
        refine: bool = False, device="cuda", top: int = 25,
        verbose: bool = True) -> dict:
    """Trace ``reps`` calls after one warm-up; returns the rows of
    device_rows, the trace's path and the busy ms (``busy_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    out = out or os.path.join(tempfile.gettempdir(), "llckbdm_trace")
    cuda = torch.device(device).type == "cuda"
    sigs, _ = five_peak.signals(voxels, 1e-4)
    c64 = torch.as_tensor(sigs, device=device)
    c32 = c64.to(torch.complex64)
    cfg = five_peak.north_star_config()

    def fit():
        return llc_kbdm_fit(c32, five_peak.DWELL, cfg)

    if refine:
        cons = fit()[0]
        lines = LineList(*(x[..., :five_peak.REFINE_CLUSTERS] for x in cons))

        def step():
            return refine_lines(c64, lines, five_peak.DWELL,
                                RefineConfig(iters=6))
    else:
        step = fit
    step()
    if cuda:
        torch.cuda.synchronize()
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        for _ in range(reps):
            step()
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    rows = device_rows(prof, cuda)
    total = busy_ms(prof, cuda)
    if verbose:
        print(f"# {device_label(device)}; traced {reps} iterations "
              f"({'refine' if refine else 'fit'}) at V={voxels} -> {path}",
              flush=True)
        print_top(rows, total, top)
    return {"rows": rows, "trace": path, "total_ms": total}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voxels", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="trace directory (default: llckbdm_trace "
                                  "under the temporary directory)")
    ap.add_argument("--refine", action="store_true",
                    help="trace the GN refinement instead of the fit")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--cpu", action="store_true",
                    help="trace the plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("trace_capture: needs a CUDA device (or --cpu)",
              file=sys.stderr)
        return 2
    run(args.voxels, args.reps, args.out, args.refine,
        "cpu" if args.cpu else "cuda", args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
