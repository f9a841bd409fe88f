"""``BENCHMARK.json`` and the files it names, found by name.

* a cell (``workloads`` entry) names a configuration and a traffic mix;
* ``benchmark/configs/<config>.json`` is the configuration as it is run;
* ``benchmark/traffic/<traffic>.json`` is the traffic mix: a ``kind``,
  which names the loop in ``benchmark/loops/<kind>.py``, and its
  parameters;
* ``benchmark/loops/<kind>.py`` is a traffic kind's loop, with the
  functions ``benchmark/loops/__init__.py`` lists;
* ``benchmark/metrics/<metric>.py`` is a metric's reader, with
  ``read(rec)`` and, where the metric measures after the window,
  ``after_window(ctx, rec)``.

A later change adds a configuration, a traffic kind, a cell or a metric by
adding files and entries; nothing here is edited for it.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import types

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str, here: pathlib.Path = HERE) -> dict:
    return json.loads((here / "configs" / f"{name}.json").read_text())


def traffic(name: str, here: pathlib.Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def reports(metric: dict, workload: str, e2e_of_cell: set[str]) -> bool:
    """Whether ``workload`` reports ``metric``: listed in its ``workloads``,
    or, without that key, every cell that reports the metric it moves (a
    per-layer metric) or every cell (an end-to-end metric)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def metrics_of(spec: dict, workload: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) that ``workload`` reports."""
    e2e = [m for m in spec["end_to_end"] if reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if reports(m, workload, names)]
    return e2e, layer


def _load(module: str, path: pathlib.Path) -> types.ModuleType:
    mod_spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: pathlib.Path = HERE) -> types.ModuleType:
    """The module ``benchmark/metrics/<name>.py`` (its name may hold dots,
    so it is loaded from its path)."""
    return _load(f"benchmark_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}",
                 here / "metrics" / f"{name}.py")


def loop(kind: str, here: pathlib.Path = HERE) -> types.ModuleType:
    """The module ``benchmark/loops/<kind>.py``, loaded from its path afresh
    on each call as a module of the package ``benchmark.loops``, so that its
    relative imports (``from . import fit_refine``) resolve there."""
    return _load(f"benchmark.loops.{kind}", here / "loops" / f"{kind}.py")
