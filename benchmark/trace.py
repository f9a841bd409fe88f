"""A device trace of the measured window and what the harness reads from
it: the device intervals, the busy time as their union (overlapping work
counts once), the idle gaps labelled by what the host was doing, and the
``breakdown`` of the result line.

``capture`` runs the window under ``torch.profiler`` (CPU and CUDA
activity) inside a ``bench.window`` annotation, whose host span is the
traced window; the harness's own spans are ``record_function``
annotations inside it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

WINDOW = "bench.window"
TOP = 10            # entries of each breakdown list
LABELLED_GAPS = 500  # the longest idle gaps are named by the host's work
LOOK_BACK = 20000   # host events searched back for the one running in a gap


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list          # (name, start s, end s) from the window's start
    breakdown: dict


def span(name: str):
    """A host annotation in the trace (a no-op outside a profile)."""
    from torch.profiler import record_function
    return record_function(name)


@contextlib.contextmanager
def capture(cuda: bool, out: dict):
    """Profile the block; on exit ``out["trace"]`` holds its Trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with span(WINDOW):
            yield
    out["trace"] = reduce(prof.profiler.kineto_results.events())


def merge(intervals: np.ndarray) -> np.ndarray:
    """The union of (n, 2) intervals as sorted disjoint (m, 2) intervals."""
    if not len(intervals):
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(np.r_[new[1:], True])
    return np.stack([starts, ends[last]], axis=1)


def gaps(busy: np.ndarray, start: float, end: float) -> np.ndarray:
    """(g, 2) idle intervals of [start, end) outside the merged ``busy``."""
    edges = np.concatenate([[start], busy.reshape(-1), [end]]).reshape(-1, 2)
    keep = edges[:, 1] > edges[:, 0]
    return edges[keep]


def _is_annotation(event) -> bool:
    """A ``record_function`` span, on the host or its copy on the device's
    timeline (the harness's are named ``bench.*``)."""
    return event.is_user_annotation() or event.name().startswith("bench.")


def _is_device(event) -> bool:
    from torch.autograd import DeviceType
    return event.device_type() == DeviceType.CUDA and not _is_annotation(event)


def reduce(events) -> Trace:
    """The window's device intervals, busy time and breakdown from the
    profiler's kineto events."""
    window = None
    dev, host = [], []
    for e in events:
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if _is_device(e):
            dev.append((e.name(), start, end))
        elif e.name() == WINDOW:
            if window is None or end - start > window[1] - window[0]:
                window = (start, end)     # the host span, not its device copy
        else:
            host.append((e.name(), start, end))
    if window is None:
        raise RuntimeError("trace: the window's annotation is missing")
    w0, w1 = window
    dev = [(n, max(s, w0) - w0, min(e, w1) - w0) for n, s, e in dev
           if e > w0 and s < w1]
    iv = np.array([(s, e) for _, s, e in dev], np.float64).reshape(-1, 2)
    busy = merge(iv)
    busy_s = float(np.sum(busy[:, 1] - busy[:, 0]))
    idle = gaps(busy, 0.0, w1 - w0)
    return Trace(window_s=w1 - w0, busy_s=busy_s, device=dev,
                 breakdown={"device_ops": top_ops(dev),
                            "idle_gaps": label_gaps(idle, host, w0)})


def top_ops(dev: list) -> list:
    """[[name, seconds], ...] of the device operations that took most
    time, summed by name."""
    total: dict = {}
    for name, s, e in dev:
        total[name] = total.get(name, 0.0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], sec] for name, sec in ranked]


def label_gaps(idle: np.ndarray, host: list, w0: float) -> list:
    """[[host work, idle seconds], ...]: the longest idle gaps, each named
    by the innermost host event running at its start, summed by name; the
    rest under "shorter gaps"."""
    if not len(idle):
        return []
    lengths = idle[:, 1] - idle[:, 0]
    order = np.argsort(-lengths)
    named, rest = order[:LABELLED_GAPS], order[LABELLED_GAPS:]
    host = sorted(host, key=lambda h: h[1])
    starts = np.array([s - w0 for _, s, _ in host], np.float64)
    total: dict = {}
    for g in named:
        t = idle[g, 0]
        label = "no host event"
        # the innermost running event is the latest started one not ended
        last = int(np.searchsorted(starts, t, "right")) - 1
        for i in range(last, max(-1, last - LOOK_BACK), -1):
            if host[i][2] - w0 > t:
                label = host[i][0]
                break
        total[label] = total.get(label, 0.0) + float(lengths[g])
    if len(rest):
        total["shorter gaps"] = float(np.sum(lengths[rest]))
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], sec] for name, sec in ranked]
