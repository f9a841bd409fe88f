"""The program's own spans (``llckbdm.*``, ``llckbdm_tpu_torch/spans.py``)
read on the device's timeline, for the per-layer metrics of a cell whose
loop has a ``replay`` hook (``benchmark/loops/__init__.py``).

After the window (whose profile has closed), ``after_window`` replays
``WARM + READ`` of the loop's units of work through its hook, one call of
the pipeline each (a "batch" below, whatever the traffic kind), under a
profile of its own (CPU and CUDA activity), each inside a ``bench.replay``
range and ended by a sync.  The hook touches neither the window's answers
nor its count of non-finite ones.  The first batch is not read.
``reduce`` then works out each read batch:

* a span's device ops are the kernels, copies and fills whose launching
  runtime call lies inside it: each op is mapped through its
  ``correlation_id`` to its runtime call and goes to the innermost host
  span that holds the call;
* a layer (``LAYER``) is a span with its children folded in: ``sweep``,
  ``cluster``, ``refine``; an op launched outside every ``llckbdm.*`` span
  is the ``harness``'s;
* busy of a layer is the union of its ops' intervals; device ms of a span
  runs from its first op's start to its last op's end;
* an op belongs to the batch whose host range holds its runtime call;
* every idle gap of the device from the batch's first op to its last goes
  to the layer of the op that ends it.

A program without spans, a loop without the hook and a run on the CPU read
nothing: each metric is None.
"""
from __future__ import annotations

import statistics

import numpy as np

from . import trace as trace_mod

WARM, READ = 1, 8
BATCH = "bench.replay"
PREFIX = "llckbdm."
HARNESS = "harness"
LAYER = {"llckbdm.fit": "fit", "llckbdm.sweep": "sweep",
         "llckbdm.sweep.powiter": "sweep", "llckbdm.sweep.lines": "sweep",
         "llckbdm.cluster": "cluster", "llckbdm.refine": "refine",
         "llckbdm.refine.step": "refine"}
RUNTIME = "cu"      # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...


def after_window(ctx, rec) -> None:
    """Replay and reduce once a run on the card of a cell whose loop has
    the ``replay`` hook (a CPU run has no device op to read); the result is
    ``rec.extra["program_spans"]``, one dict per read batch."""
    if (not hasattr(ctx.loop, "replay") or not ctx.cuda
            or "program_spans" in rec.extra):
        return
    rec.extra["program_spans"] = reduce(Events.of(replay(ctx, rec)))[WARM:]


def replay(ctx, rec) -> list:
    """The kineto events of ``WARM + READ`` batches, each the loop's
    ``replay(ctx, i, scratch)`` and a sync inside a ``BATCH`` range, under
    a profile of their own; the spans the harness records go to a record
    of their own."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import harness

    scratch = harness.Record(kind=rec.kind, config=rec.config,
                             traffic=rec.traffic)
    acts = [ProfilerActivity.CPU]
    if ctx.cuda:
        acts.append(ProfilerActivity.CUDA)
    ctx.sync()
    with profile(activities=acts) as prof:
        for i in range(WARM + READ):
            with record_function(BATCH):
                ctx.loop.replay(ctx, i, scratch)
                ctx.sync()
    return prof.profiler.kineto_results.events()


class Events:
    """What ``reduce`` reads of a trace, as plain (name, start s, end s)
    tuples: the device ops with their correlation ids, the host ranges of
    the ``llckbdm.*`` spans and of each replayed batch, and each runtime
    call's start by its correlation id."""

    def __init__(self, ops=(), spans=(), batches=(), launches=None):
        self.ops = list(ops)                  # (start, end, correlation)
        self.spans = list(spans)              # (name, start, end), host
        self.batches = list(batches)          # (start, end), host
        self.launches = dict(launches or {})  # correlation -> start

    @classmethod
    def of(cls, events) -> "Events":
        """From the profiler's kineto events, with times in seconds from
        the trace's first event.  A span's copy on the device's timeline
        (a CUDA-typed user annotation) is neither an op nor a span."""
        from torch.autograd import DeviceType
        rows = [(e.name(), e.start_ns(), e.duration_ns(),
                 e.device_type() == DeviceType.CUDA, e.is_user_annotation(),
                 e.correlation_id()) for e in events]
        out = cls()
        base = min((r[1] for r in rows), default=0)
        for name, start_ns, dur_ns, on_device, note, corr in rows:
            start = (start_ns - base) * 1e-9
            end = (start_ns - base + dur_ns) * 1e-9
            note = note or name.startswith((PREFIX, "bench."))
            if on_device:
                if not note:
                    out.ops.append((start, end, corr))
            elif note and name.startswith(PREFIX):
                out.spans.append((name, start, end))
            elif note and name == BATCH:
                out.batches.append((start, end))
            elif name.startswith(RUNTIME):
                out.launches[corr] = start
        return out


def innermost(times: np.ndarray, ranges: list) -> np.ndarray:
    """Per time, the index of the shortest range (name, start, end) that
    holds it, or -1 (a NaN time is held by none)."""
    best = np.full(len(times), -1)
    width = np.full(len(times), np.inf)
    for i, (_, s, e) in enumerate(ranges):
        held = (times >= s) & (times <= e) & (e - s < width)
        best[held] = i
        width[held] = e - s
    return best


def reduce(ev: Events) -> list[dict]:
    """One dict per replayed batch (see the module's docstring); empty
    where the trace holds no device op."""
    if not ev.ops or not ev.batches:
        return []
    ops = sorted(ev.ops)
    iv = np.array([(s, e) for s, e, _ in ops], np.float64)
    launched = np.array([ev.launches.get(c, np.nan) for _, _, c in ops])
    # each op's innermost ``llckbdm.*`` span around its runtime call's start
    # (an op whose call is missing, NaN, falls to the harness)
    idx = innermost(launched, ev.spans)
    names = np.array([ev.spans[i][0] if i >= 0 else "" for i in idx], object)
    layers = np.array([LAYER.get(n, n) if n else HARNESS for n in names],
                      object)
    # an op belongs to the batch whose range holds its launch, both on the
    # host's clock: the device's timestamps drift from the host's by
    # milliseconds over a replay (up to 2.9 ms on the card)
    when = np.where(np.isnan(launched), iv[:, 0], launched)
    starts = np.array([s for s, _ in sorted(ev.batches)])
    which = np.searchsorted(starts, when, "right") - 1
    return [batch(iv[which == b], names[which == b], layers[which == b],
                  idx[which == b])
            for b in range(len(starts))]


def batch(iv: np.ndarray, names, layers, idx) -> dict:
    """The numbers of one batch from its ops, sorted by start."""
    out = {"ops": int(len(iv))}
    if not len(iv):
        return out
    busy = trace_mod.merge(iv)
    idle = trace_mod.gaps(busy, busy[0, 0], busy[-1, 1])
    out["idle_s"] = float(np.sum(idle[:, 1] - idle[:, 0]))
    # the op that ends each gap is the first op of the next busy block
    ender = np.searchsorted(iv[:, 0], idle[:, 1], "left")
    out["layers"] = {}
    for layer in sorted(set(layers)):
        mine = layers == layer
        lb = trace_mod.merge(iv[mine])
        gap = idle[layers[ender] == layer]
        out["layers"][layer] = {
            "busy_s": float(np.sum(lb[:, 1] - lb[:, 0])),
            "idle_s": float(np.sum(gap[:, 1] - gap[:, 0])),
            "device_ms": extent_ms(iv[mine])}
    for name in ("llckbdm.sweep.powiter", "llckbdm.sweep.lines"):
        if np.any(names == name):
            out[name] = extent_ms(iv[names == name])
    step = names == "llckbdm.refine.step"
    out["llckbdm.refine.step"] = [extent_ms(iv[step & (idx == i)])
                                  for i in sorted(set(idx[step]))]
    launched = int(np.sum(layers != HARNESS))
    if launched:
        out["launches"] = launched
    return out


def extent_ms(iv: np.ndarray) -> float:
    """ms from the first op's start to the last op's end (ops sorted by
    start)."""
    return 1e3 * float(np.max(iv[:, 1]) - iv[0, 0])


def _batches(rec) -> list:
    return rec.extra.get("program_spans") or []


def median(rec, value) -> float | None:
    """Median over the read batches of ``value(batch)``, skipping None;
    None where no batch gives a number."""
    got = [v for v in map(value, _batches(rec)) if v is not None]
    return statistics.median(got) if got else None


def device_ms(rec, layer: str) -> float | None:
    """Median device ms of a layer (a span with its children)."""
    return median(rec, lambda b: b.get("layers", {}).get(layer, {})
                  .get("device_ms"))


def span_ms(rec, name: str) -> float | None:
    """Median device ms of a span that runs once a batch."""
    return median(rec, lambda b: b.get(name))


def idle_pct(rec, layer: str) -> float | None:
    """Median of 100 idle / (busy + idle) of a layer."""
    def share(b):
        part = b.get("layers", {}).get(layer)
        if not part or part["busy_s"] + part["idle_s"] <= 0:
            return None
        return 100.0 * part["idle_s"] / (part["busy_s"] + part["idle_s"])
    return median(rec, share)


def step_ms(rec) -> float | None:
    """Median device ms of one Gauss-Newton step, over every step of every
    read batch."""
    steps = [ms for b in _batches(rec) for ms in b.get(
        "llckbdm.refine.step", [])]
    return statistics.median(steps) if steps else None


def launches(rec) -> float | None:
    """Median device ops launched inside ``llckbdm.fit`` and
    ``llckbdm.refine`` a batch."""
    return median(rec, lambda b: b.get("launches"))
