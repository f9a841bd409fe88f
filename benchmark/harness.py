"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the reference.

``run_cell`` returns the result line's object; ``benchmark/run.py`` checks
for the cards first and prints it.  Tests call ``run_cell`` on the CPU
(``device="cpu"``, the kernels' plain versions) with small traffic.

The order of a run: signals from the seed and every shape warmed up
(set-up, ``setup_s`` up to the first timed call); the window
(``benchmark/loops/<kind>.py``, loaded from ``here``), under
``torch.profiler`` with ``trace=1``; the device's memory peak; with
``trace=1`` each per-layer metric's measurement after the window; the
metrics; the sampled answers fetched and the program's state freed; then
the reference, on the host in a pool of processes, and the comparison
(``reference/compare.py``).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import multiprocessing
import os
import sys
import time

from . import spec as spec_mod
from . import trace as trace_mod
from .reference import compare

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@dataclasses.dataclass
class Record:
    """What a run measured; the metrics' readers read it."""

    kind: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    setup_parts: dict = dataclasses.field(default_factory=dict)
    window: tuple = (0.0, 0.0)       # host clock, seconds
    units: int = 0                   # voxels completed
    attempted: int = 0
    fit_voxels: int = 0              # voxels of one llc_kbdm_fit call
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [(s, e)]
    trace: trace_mod.Trace | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    def span(self, name: str, start: float, end: float) -> None:
        self.spans.setdefault(name, []).append((start, end))


@dataclasses.dataclass
class Ctx:
    """The program under test, configured for one cell."""

    config: dict
    traffic: dict
    seed: int
    device: object
    port: object                     # the llckbdm_tpu_torch module
    fit_cfg: object                  # LlcKbdmConfig
    refine_cfg: object               # RefineConfig
    slots: int                       # consolidated slots refined
    loop: object                     # benchmark/loops/<kind>.py
    state: dict = dataclasses.field(default_factory=dict)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def dwell(self) -> float:
        return float(self.config["signal"]["dwell"])

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()


def m_values(cfg: dict) -> tuple:
    m = cfg["pipeline"]["m_values"]
    return tuple(range(m["first"], m["last"] + 1, m["step"]))


def port_configs(port, cfg: dict, variant: str | None):
    """(LlcKbdmConfig, RefineConfig, slots) from a configuration's file;
    ``variant="control"`` applies its ``control`` overrides."""
    kbdm, refine = dict(cfg["kbdm"]), dict(cfg["refine"])
    if variant == "control":
        kbdm.update(cfg["control"].get("kbdm", {}))
        refine.update(cfg["control"].get("refine", {}))
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    slots = refine.pop("slots")
    pipe = cfg["pipeline"]
    fit = port.LlcKbdmConfig(
        m_values=m_values(cfg), eps=pipe["eps"],
        min_samples=pipe["min_samples"],
        damping_weight=pipe["damping_weight"],
        max_clusters=pipe["max_clusters"], kbdm=port.KbdmConfig(**kbdm))
    return fit, port.RefineConfig(**refine), slots


def reference_params(cfg: dict) -> dict:
    """What the reference needs from a configuration's file."""
    pipe, kbdm, refine = cfg["pipeline"], cfg["kbdm"], cfg["refine"]
    return dict(dwell=float(cfg["signal"]["dwell"]),
                m_values=list(m_values(cfg)), p=kbdm["p"], eps=pipe["eps"],
                min_samples=pipe["min_samples"],
                damping_weight=pipe["damping_weight"],
                amp_min=kbdm["amp_min"], t2_min=kbdm["t2_min"],
                slots=refine["slots"], iters=cfg["reference"]["iters"],
                ridge=refine["ridge"], max_step=refine["max_step"])


def reference_answers(signals: list, ref: dict, workers: int) -> list:
    """The reference for each signal, in a pool of ``workers`` spawned
    processes of one BLAS thread each (the oracle's small SVDs run slower
    on many threads)."""
    if workers <= 1 or len(signals) <= 1:
        return [compare.reference_voxel(s, ref) for s in signals]
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: "1" for k in THREAD_VARS})
    try:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(compare.reference_voxel, signals,
                               [ref] * len(signals)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def default_workers() -> int:
    return max(1, min(len(os.sched_getaffinity(0)), 8) - 1)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, variant: str | None = None, spec: dict | None = None,
             here=spec_mod.HERE, started: float | None = None,
             before_start: float = 0.0, workers: int | None = None) -> dict:
    """Run one cell once; returns the result line's object.

    ``started`` is the host clock at the process's first line and
    ``before_start`` the seconds the process ran before it (set-up counts
    from process start).  ``device`` defaults to cuda:0; the caller
    checks that it exists."""
    started = time.perf_counter() if started is None else started
    spec = spec_mod.load(here.parent) if spec is None else spec
    cell = spec_mod.cell(spec, workload)
    cfg = spec_mod.config(cell["config"], here)
    traffic = spec_mod.traffic(cell["traffic"], here)
    e2e, layer = spec_mod.metrics_of(spec, workload)
    chosen = layer if trace else e2e
    readers = {m["name"]: spec_mod.reader(m["name"], here) for m in chosen}
    loop = spec_mod.loop(traffic["kind"], here)

    import torch
    import llckbdm_tpu_torch as port
    from llckbdm_tpu_torch.ops import _build

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    rec = Record(kind=traffic["kind"], config=cfg, traffic=traffic)
    rec.setup_parts["import"] = time.perf_counter() - started + before_start
    fit_cfg, refine_cfg, slots = port_configs(port, cfg, variant)
    ctx = Ctx(config=cfg, traffic=traffic, seed=seed, device=device,
              port=port, fit_cfg=fit_cfg, refine_cfg=refine_cfg, slots=slots,
              loop=loop)
    t = time.perf_counter()
    if ctx.cuda:
        torch.cuda.set_device(device)
        torch.empty(1, device=device)    # the context, before its counters
        _build.library()                 # built on a checkout's first run
        torch.cuda.reset_peak_memory_stats(device)
    rec.setup_parts["kernels"] = time.perf_counter() - t
    try:
        loop.setup(ctx, rec)
        rec.setup_s = time.perf_counter() - started + before_start
        rec.fit_voxels = int(ctx.state["fit_input"].shape[0])
        if trace:
            out = {}
            with trace_mod.capture(ctx.cuda, out):
                loop.window(ctx, seconds, rec, traced=True)
            rec.trace = out["trace"]
        else:
            loop.window(ctx, seconds, rec, traced=False)
        peak = torch.cuda.max_memory_allocated(device) if ctx.cuda else 0
        for reader in readers.values():
            if trace and hasattr(reader, "after_window"):
                reader.after_window(ctx, rec)
        metrics = {}
        for m in chosen:
            value = readers[m["name"]].read(rec)
            if value is None and not trace:
                raise RuntimeError(f"{m['name']}: nothing to read in "
                                   f"{workload}")
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        failed = loop.failed(ctx, rec)
        answers = [(sig, units) for sig, units in loop.answers(ctx)
                   if units]
    finally:
        loop.close(ctx)
    ctx.state.clear()
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()

    refs = reference_answers([sig for sig, _ in answers],
                             reference_params(cfg),
                             default_workers() if workers is None else workers)
    radius = cfg["pipeline"]["eps"] / ctx.dwell
    numbers = [compare.compare_unit(unit, ref, ctx.dwell, radius)
               for (_, units), ref in zip(answers, refs) for unit in units]
    worst = compare.worst(numbers)
    limits = cfg["limits"]
    device_out = {"platform": "gpu" if ctx.cuda else "cpu",
                  "kind": (torch.cuda.get_device_name(device) if ctx.cuda
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(numbers) and compare.decide(worst, limits),
              "attempted": rec.attempted, "failed": failed,
              "metrics": metrics, "device": device_out}
    if trace:
        device_out["busy_s"] = rec.trace.busy_s
        device_out["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown
    result["setup_parts"] = rec.setup_parts
    result["compared"] = {"signals": len(answers), "answers": len(numbers)}
    result["readings"] = {k: worst[k] for k in compare.NUMBERS
                          if k not in compare.LIMITED}
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]}
                        for k in compare.LIMITED}
    return result


def check_lines(result: dict) -> list[str]:
    """The compared numbers beside their limits, one per line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load:
    JAX and the JAX package (compared whole: the port's name begins with
    the JAX package's)."""
    bad = {"jax", "jaxlib", "flax", "llckbdm_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & bad)
