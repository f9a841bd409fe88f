"""The harness on the CPU: BENCHMARK.json against the rules for its names and
keys, files found by name, the window arithmetic, the trace's busy time,
the readings of a batch cell pinned, the entry point without a card, and a
cell and a traffic kind added as files."""
import json
import pathlib
import re
import statistics
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import harness, readers, spec, stats, trace
from benchmark.tests.helpers import add_chunked_cell, small_copy

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and LINE.match(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"benchmark/configs/{w['config']}.json"
    assert entry["reduced"] == cfg["reduced"]
    kind = spec.traffic(w["traffic"])["kind"]
    assert (ROOT / "benchmark" / "loops" / f"{kind}.py").exists()
    e2e, layer = spec.metrics_of(BENCH, w["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert hasattr(spec.reader(m["name"]), "read")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_cell_of_a_layer_metric_reports_what_it_moves(m):
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        e2e, _ = spec.metrics_of(BENCH, cell)
        assert m["moves"] in {x["name"] for x in e2e}


def test_rate_is_all_work_over_all_time():
    assert stats.rate(4096, 10.0, 12.0) == 2048.0
    steady = stats.rate(10 * 2048, 0.0, 10 * 0.25)
    stalled = stats.rate(10 * 2048, 0.0, 10 * 0.25 + 0.5)   # one stall
    assert stalled < steady


def test_median_of_spans():
    assert stats.median_ms([(0.0, 0.2), (1.0, 1.3), (2.0, 2.25)]) == \
        pytest.approx(250.0)
    assert stats.median_ms([]) is None


def _record(kind, device=(), window=1.0, busy=None):
    """A record of the north-star cell as its batch loop fills it (one fit
    call of 2048 voxels) with a trace of ``device`` ops."""
    rec = harness.Record(kind=kind, config=spec.config("five_peak_clean"),
                         traffic=spec.traffic("batch2048"), fit_voxels=2048)
    iv = np.array([(s, e) for _, s, e in device]).reshape(-1, 2)
    rec.trace = trace.Trace(window_s=window, device=list(device),
                            busy_s=(float(np.sum(np.diff(trace.merge(iv))))
                                    if busy is None else busy),
                            breakdown={})
    return rec


def test_busy_time_counts_overlap_once():
    dev = [("a", 0.0, 0.4), ("b", 0.2, 0.5), ("c", 0.7, 0.8)]
    rec = _record("batch", dev)
    assert rec.trace.busy_s == pytest.approx(0.6)
    assert readers.idle_pct(rec) == pytest.approx(40.0)
    rec.trace = None                     # an untraced run
    assert readers.idle_pct(rec) is None


def test_roofline_reads_launches_and_is_silent_without_them():
    shape = readers.fit_shape(_record("batch"))
    bound = readers.bounds.eig_cs(shape["batch"], shape["p"],
                                  shape["eig_sweeps"])
    ms = bound.ms / 0.25
    rec = _record("batch", [("void eig_cs_kernel<1>(...)", 0.0, ms / 1e3),
                            ("void eig_cs_kernel<1>(...)", 1.0,
                             1.0 + ms / 1e3)], window=2.0)
    reader = spec.reader("kernel.eig_cs.roofline_pct.batch")
    assert reader.read(rec) == pytest.approx(25.0)
    assert spec.reader("kernel.gram_svd.roofline_pct.batch").read(rec) is None
    assert shape["batch"] == 2048 * 35 and shape["k"] == 24
    rec.fit_voxels = 0                   # a loop that reported no fit call
    assert reader.read(rec) is None


# Three replayed batches as ``program_spans.reduce`` gives them.
BATCHES = [
    {"ops": 12, "idle_s": 2.5, "launches": 11,
     "layers": {"sweep": {"busy_s": 5.5, "idle_s": 0.5, "device_ms": 6000.0},
                "cluster": {"busy_s": 1.5, "idle_s": 1.0,
                            "device_ms": 1500.0},
                "refine": {"busy_s": 1.0, "idle_s": 0.5, "device_ms": 1200.0},
                "harness": {"busy_s": 0.2, "idle_s": 0.5, "device_ms": 200.0}},
     "llckbdm.sweep.powiter": 3000.0, "llckbdm.sweep.lines": 1000.0,
     "llckbdm.refine.step": [400.0, 300.0]},
    {"ops": 14, "idle_s": 1.0, "launches": 13,
     "layers": {"sweep": {"busy_s": 5.0, "idle_s": 0.25, "device_ms": 5500.0},
                "cluster": {"busy_s": 2.0, "idle_s": 0.5,
                            "device_ms": 2600.0},
                "refine": {"busy_s": 1.5, "idle_s": 0.25,
                           "device_ms": 1800.0}},
     "llckbdm.sweep.powiter": 2800.0, "llckbdm.sweep.lines": 900.0,
     "llckbdm.refine.step": [350.0, 380.0]},
    {"ops": 13, "idle_s": 2.0, "launches": 12,
     "layers": {"sweep": {"busy_s": 6.0, "idle_s": 1.0, "device_ms": 7200.0},
                "cluster": {"busy_s": 1.0, "idle_s": 1.0,
                            "device_ms": 2100.0},
                "refine": {"busy_s": 2.0, "idle_s": 0.0,
                           "device_ms": 2000.0}},
     "llckbdm.sweep.powiter": 3100.0, "llckbdm.sweep.lines": 1100.0,
     "llckbdm.refine.step": [500.0, 320.0]},
]
# two eig_cs launches (4 and 6 ms), three gram_svd launches (10, 12 and 14
# ms) and a gemm; their union is busy 20 + 6 + 12 + 14 = 52 ms of 2 s
DEVICE = [("void eig_cs_kernel<16>(...)", 0.010, 0.014),
          ("void eig_cs_kernel<16>(...)", 0.500, 0.506),
          ("void gram_svd_kernel<24>(...)", 0.020, 0.030),
          ("void gram_svd_kernel<24>(...)", 0.600, 0.612),
          ("void gram_svd_kernel<24>(...)", 1.100, 1.114),
          ("ampere_cgemm_64x32", 0.012, 0.025)]
# What each reader returned at the parent of the change that made readers
# kind-free, on the record of ``_pinned_record``, worked out by hand.
PINNED = {
    "fits_per_s": 2048.0,                      # 4096 voxels / 2 s
    "setup_s": 12.5,
    "pipeline.fit_ms.batch": 250.0,            # median of 200, 300, 250
    "sweep.ms.batch": 201.5,
    "refine.ms.batch": 50.0,                   # median of 40, 50, 60
    # 100 x the least time of one launch at 2048 x 35 matrices (eig_cs
    # 0.83273758567 ms, gram_svd 2.64816303761 ms, benchmark/bounds.py) /
    # the mean launch
    "kernel.eig_cs.roofline_pct.batch": 100 * 0.8327375856716418 / 5.0,
    "kernel.gram_svd.roofline_pct.batch": 100 * 2.6481630376119405 / 12.0,
    "device.idle_pct.batch": 97.4,             # 100 (1 - 0.052 / 2)
    "sweep.device_ms.batch": 6000.0,           # median of 6000, 5500, 7200
    "sweep.powiter.device_ms.batch": 3000.0,
    "sweep.lines.device_ms.batch": 1000.0,
    "sweep.idle_pct.batch": 100 * 0.5 / 6.0,   # of 0.5/6, 0.25/5.25, 1/7
    "cluster.device_ms.batch": 2100.0,
    "cluster.idle_pct.batch": 40.0,            # of 1/2.5, 0.5/2.5, 1/2
    "refine.step.device_ms.batch": 365.0,      # (350 + 380) / 2 of 6 steps
    "refine.idle_pct.batch": 100 * 0.25 / 1.75,  # of 0.5/1.5, 0.25/1.75, 0
    "device.launches.batch": 12,               # median of 11, 13, 12
}


def _pinned_record():
    rec = _record("batch", DEVICE, window=2.0)
    rec.units, rec.window, rec.setup_s = 4096, (10.0, 12.0), 12.5
    rec.spans = {"fit": [(0.0, 0.2), (1.0, 1.3), (2.0, 2.25)],
                 "refine": [(0.2, 0.24), (1.3, 1.35), (2.25, 2.31)]}
    rec.extra = {"sweep_ms": 201.5, "program_spans": BATCHES}
    return rec


def test_every_reader_is_pinned():
    assert set(PINNED) == {m["name"] for m in
                           BENCH["end_to_end"] + BENCH["per_layer"]}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_batch_readings_are_pinned(name):
    """Each reader computes from a batch record the number it computed at
    the parent of the change that made the readers kind-free."""
    assert spec.reader(name).read(_pinned_record()) == \
        pytest.approx(PINNED[name], rel=1e-12)


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """The north-star cell run small on the CPU, untraced and traced, each
    with the record the harness filled."""
    here = small_copy(ROOT, tmp_path_factory.mktemp("pinned"))
    out = {}
    for traced in (False, True):
        records = []

        class Kept(harness.Record):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                records.append(self)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(harness, "Record", Kept)
            r = harness.run_cell("five_peak_clean.batch2048", 3000000011,
                                 0.1, traced, device="cpu", spec=BENCH,
                                 here=here, workers=1)
        out[traced] = (r, records[0])
    return out


def test_a_small_batch_run_reads_as_at_the_parent(captured):
    """The numbers of a small CPU run, worked out from its record as the
    parent's readers did: the rate over the window, the medians of the
    spans, the idle share of a trace with no device op.  The device-trace
    readers have nothing to read on the CPU."""
    r, rec = captured[False]
    assert r["correct"], r["checks"]
    assert rec.kind == "batch" and rec.fit_voxels == 2
    assert set(r["metrics"]) == {"fits_per_s", "setup_s"}
    assert r["metrics"]["fits_per_s"]["value"] == \
        rec.units / (rec.window[1] - rec.window[0])
    assert rec.units == r["attempted"] and rec.units % 2 == 0
    assert r["metrics"]["setup_s"]["value"] == rec.setup_s
    r, rec = captured[True]
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"pipeline.fit_ms.batch", "sweep.ms.batch",
                                 "refine.ms.batch", "device.idle_pct.batch"}
    for name, span in (("pipeline.fit_ms.batch", "fit"),
                       ("refine.ms.batch", "refine")):
        assert r["metrics"][name]["value"] == \
            1e3 * statistics.median(e - s for s, e in rec.spans[span])
    assert r["metrics"]["sweep.ms.batch"]["value"] == rec.extra["sweep_ms"]
    assert rec.trace.busy_s == 0.0
    assert r["metrics"]["device.idle_pct.batch"]["value"] == 100.0


class _Event:
    def __init__(self, name, cuda, start, end, note=False):
        self._n, self._c, self._s, self._e, self._a = name, cuda, start, end, note

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)

    def is_user_annotation(self):
        return self._a


def test_trace_reduction_on_synthetic_events():
    events = [_Event(trace.WINDOW, False, 10.0, 12.0, True),
              _Event(trace.WINDOW, True, 10.1, 11.9, True),
              _Event("bench.fit", True, 10.1, 11.0),
              _Event("k1", True, 10.0, 10.5), _Event("k1", True, 10.4, 10.8),
              _Event("k2", True, 11.5, 12.5),
              _Event("cudaStreamSynchronize", False, 10.7, 11.6),
              _Event("aten::item", False, 10.75, 11.55)]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(2.0)
    assert t.busy_s == pytest.approx(0.8 + 0.5)
    assert t.breakdown["device_ops"][0][0] == "k1"
    gaps = dict(t.breakdown["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(0.7)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "llckbdm_tpu_torch_extra",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "llckbdm_tpu.oracle",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["llckbdm_tpu"]


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "five_peak_clean.batch2048", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_run_without_a_card_gives_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_run_with_only_the_benchmark_gives_no_result(tmp_path):
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_a_config_cell_and_metric_added_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files and entries, and edits no file."""
    bench = small_copy(ROOT, tmp_path)
    cfg = json.loads((bench / "configs" / "five_peak_clean.json").read_text())
    cfg["name"] = "five_peak_p12"
    cfg["kbdm"]["p"] = 12
    (bench / "configs" / "five_peak_p12.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "batch1.json").write_text(json.dumps(
        {"kind": "batch", "voxels": 1, "batches": 1, "warmups": 1,
         "check": 1}))
    (bench / "metrics" / "pipeline.fit_count.batch1.py").write_text(
        "def read(rec):\n    return float(len(rec.spans.get('fit', [])))\n")
    spec_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_json["configs"].append(
        {"name": "five_peak_p12", "source": "https://example.org/p12",
         "file": "benchmark/configs/five_peak_p12.json", "reduced": ["p"],
         "why": "a test"})
    spec_json["workloads"].append(
        {"name": "five_peak_p12.batch1", "config": "five_peak_p12",
         "traffic": "batch1", "chips": 1, "why": "a test"})
    spec_json["end_to_end"][0]["workloads"].append("five_peak_p12.batch1")
    spec_json["per_layer"].append(
        {"name": "pipeline.fit_count.batch1", "unit": "calls",
         "better": "lower", "source": "host_clock", "layer": "pipeline",
         "moves": "fits_per_s", "workloads": ["five_peak_p12.batch1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_json))
    r = harness.run_cell("five_peak_p12.batch1", 7, 0.1, True, device="cpu",
                         spec=spec_json, here=bench, workers=1)
    assert r["correct"]
    assert r["metrics"]["pipeline.fit_count.batch1"]["value"] >= 1
    assert "pipeline.fit_ms.batch" not in r["metrics"]
    assert r["device"]["platform"] == "cpu"


def test_a_traffic_kind_added_as_files(tmp_path):
    """A later change adds a traffic kind whose unit of work is not a batch
    (the voxels fed to the pipeline in chunks, as a grid's shards are) by
    adding its loop, a traffic file and a cell, and appending the cell to
    the metrics it reports: fits_per_s and the host-clock spans read what
    the loop reports."""
    bench = small_copy(ROOT, tmp_path)
    host_clock = ["pipeline.fit_ms.batch", "refine.ms.batch", "sweep.ms.batch"]
    spec_json = add_chunked_cell(
        bench, {"voxels": 4, "chunk": 2, "warmups": 1, "check": 2},
        host_clock)
    cell = "five_peak_clean.chunked"
    r = harness.run_cell(cell, 3000000021, 0.1, False, device="cpu",
                         spec=spec_json, here=bench, workers=1)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"fits_per_s", "setup_s"}
    assert r["metrics"]["fits_per_s"]["value"] > 0
    assert r["attempted"] % 2 == 0 and r["compared"]["answers"] >= 1
    r = harness.run_cell(cell, 3000000022, 0.1, True, device="cpu",
                         spec=spec_json, here=bench, workers=1)
    assert r["correct"], r["checks"]
    assert set(host_clock) <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in host_clock)
