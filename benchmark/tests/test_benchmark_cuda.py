"""A short run of the north-star cell through the entry point, on the card
(skips without one; the check is made inside the test)."""
import json
import pathlib
import subprocess
import sys

import pytest

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
