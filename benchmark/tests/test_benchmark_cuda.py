"""A short run of the north-star cell through the entry point, and of a
traffic kind added as files, on the card (skips without one; the check is
made inside the test)."""
import json
import pathlib
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.helpers import add_chunked_cell, small_copy

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_of_the_north_star(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "five_peak_clean.batch2048", "--seed", "3000000002", "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert 0 < r["metrics"]["kernel.eig_cs.roofline_pct.batch"]["value"] < 100
        assert r["breakdown"]["device_ops"]
    else:
        assert r["metrics"]["fits_per_s"]["value"] > 0
        assert set(r["metrics"]) == {"fits_per_s", "setup_s"}


DEVICE_TRACE = ["sweep.device_ms.batch", "refine.step.device_ms.batch",
                "device.launches.batch", "kernel.eig_cs.roofline_pct.batch",
                "kernel.gram_svd.roofline_pct.batch"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_traffic_kind_added_as_files_on_the_card(trace, tmp_path):
    """The north star's 2048 voxels fed to the pipeline in chunks of 512,
    a kind added to a copy as files only: untraced it reports fits_per_s,
    traced the metrics read from the device's trace of its calls."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = small_copy(ROOT, tmp_path)
    spec_json = add_chunked_cell(
        bench, {"voxels": 2048, "chunk": 512, "warmups": 1, "check": 8},
        ["pipeline.fit_ms.batch", "refine.ms.batch", "sweep.ms.batch",
         "device.idle_pct.batch", *DEVICE_TRACE])
    r = harness.run_cell("five_peak_clean.chunked", 3000000031 + trace, 2.0,
                         bool(trace), spec=spec_json, here=bench)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] % 512 == 0
    if trace:
        for name in DEVICE_TRACE:
            assert r["metrics"][name]["value"] > 0, name
        for name in DEVICE_TRACE[-2:]:
            assert r["metrics"][name]["value"] < 100, name
    else:
        assert set(r["metrics"]) == {"fits_per_s", "setup_s"}
        assert r["metrics"]["fits_per_s"]["value"] > 0
