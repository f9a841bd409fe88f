"""The port's benchmark (``llckbdm_tpu_torch.bench``) against the JAX repo's
``bench.py``, on the CPU.

``bench.py`` sits at the repo root and is not a package module, so it is
loaded by file path.  Held equal: its signals, its eigensolve inputs, its
flop model and its saturation schedule; the port's plain eig_cs against the
Pallas kernel in interpret mode on those inputs; the entry point's JSON line
(bench.py's keys plus ``backend`` and ``device``) and its in-bench checks.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from llckbdm_tpu.ops import pallas_jacobi
from llckbdm_tpu.ops.cplx import CArr, to_np
from llckbdm_tpu_torch import bench
from llckbdm_tpu_torch.ops import cuda_jacobi
from llckbdm_tpu_torch.tools import five_peak

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_bench = _load_jax_bench()


def test_signals_are_bench_pys():
    """(a) five_peak.signals(V, 1e-4) is bench.make_signals bit for bit."""
    sigs, truths = five_peak.signals(4, 1e-4)
    want_sigs, want_truths = jax_bench.make_signals(4, 512, 5e-4)
    np.testing.assert_array_equal(sigs, want_sigs)
    np.testing.assert_array_equal(truths, want_truths)


@pytest.mark.parametrize("batch,p,sweeps", [(71680, 16, 10), (8, 24, 7),
                                            (3, 5, 1)])
def test_eig_cs_flops_is_bench_pys(batch, p, sweeps):
    """(b) the flop model is bench.py's, unchanged."""
    assert bench.eig_cs_flops(batch, p, sweeps) == jax_bench.eig_cs_flops(
        batch, p, sweeps)


def _bench_py_eig_inputs(batch, p):
    """bench.py:234-238's draw, as its CArr of float32 planes."""
    rng = np.random.default_rng(1)
    ut = rng.standard_normal((batch, p, p)) \
        + 1j * rng.standard_normal((batch, p, p))
    ut = 0.5 * (ut + np.swapaxes(ut, -1, -2))
    return ut.real.astype(np.float32), ut.imag.astype(np.float32)


def test_eig_inputs_are_bench_pys():
    """(c) the eigensolve inputs equal bench.py's after its cast."""
    re, im = _bench_py_eig_inputs(70, 16)
    ut = bench.eig_inputs(70, 16)
    assert ut.dtype == torch.complex64 and ut.shape == (70, 16, 16)
    np.testing.assert_array_equal(ut.real.numpy(), re)
    np.testing.assert_array_equal(ut.imag.numpy(), im)


def test_eigensolve_matches_pallas_slot_by_slot():
    """(d) on bench.py's inputs at batch 8 the port's plain eig_cs follows
    the Pallas kernel (interpret mode) slot by slot after one sweep (random
    dense complex-symmetric matrices need not converge in ten).

    On these dense 16 x 16 matrices one sweep of complex-orthogonal
    rotations amplifies float32 rounding to ~1e-2: the same algorithm in
    float64 (the plain version's arithmetic on complex128) lies 1.4e-2 from
    the Pallas kernel, so two float32 runs cannot agree to 1e-5 as they do
    at n <= 4 (tests/test_torch_kernels.py).  The bar is that scale: the
    port stays ten times closer to the Pallas kernel, slot by slot, than
    float32 rounding moves the algorithm itself (a wrong pair order or
    orientation moves the slots by O(|A|))."""
    re, im = _bench_py_eig_inputs(8, 16)
    mu_p, res_p = pallas_jacobi.eig_cs_resid(CArr(re, im), sweeps=1,
                                             interpret=True)
    mu_p, res_p = to_np(mu_p), np.asarray(res_p)
    ut = bench.eig_inputs(8, 16)
    mu_t, res_t = cuda_jacobi.eig_cs_resid(ut, 1)
    mu_64, res_64 = cuda_jacobi._eig_cs_flat(ut.to(torch.complex128), 1)
    rounding = np.abs(mu_p - mu_64.numpy()).max()
    assert 1e-3 < rounding < 0.1
    assert np.abs(mu_t.numpy() - mu_p).max() < 0.1 * rounding
    # the off-diagonal norm sums every slot's rounding: no farther from the
    # Pallas kernel's than float32 moves it
    assert (np.abs(res_t.numpy() - res_p).max()
            < np.abs(res_p - res_64.numpy()).max())


@pytest.mark.parametrize("v", [2, 100, 2048])
def test_saturation_batches_are_bench_pys(v):
    """(e) bench.py:185-197's schedule: the first vv signals where vv <= V,
    else the V signals tiled vv // V times (the true count reported)."""
    want = []
    for vv in (128, 256, 512, 1024, 2048):
        if vv <= v:
            want.append((vv, 1))
        else:
            tiles = vv // v
            want.append((v * tiles, tiles))
    assert bench.saturation_batches(v) == want


def test_needs_a_card_without_cpu():
    """(f)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main([]) == 2


def test_cpu_json_line(capsys, monkeypatch):
    """(g) one JSON line with bench.py's keys in its order plus backend and
    device, vs_baseline null, both checks met, and the checks run on the
    line's own values."""
    seen = []
    check = bench.check_limits
    monkeypatch.setattr(bench, "check_limits",
                        lambda *a: (seen.append(a), check(*a)))
    launches = {}
    assert bench.main(["--cpu", "--voxels", "2", "--reps", "1",
                       "--gate-voxels", "1", "--json-only"], launches) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline",
                          "fit_fits_per_sec", "eigensolve_gflops", "stage_ms",
                          "counters", "voxels", "backend", "device"]
    assert line["metric"] == "llckbdm_refined_voxel_fits_per_sec_per_chip"
    assert line["vs_baseline"] is None and line["voxels"] == 2
    assert line["backend"] == "cpu" and line["device"].startswith("cpu")
    assert "float32 power iterations" in line["unit"]
    assert "GN iters=0f32+6c128" in line["unit"]
    assert list(line["stage_ms"]) == ["sweep", "cluster_consolidate",
                                      "refine"]
    counters = line["counters"]
    assert counters["gate_max_rel_err"] < 1e-8
    assert counters["jacobi_offdiag_rel_production"] < 1e-2
    assert seen == [(counters["jacobi_offdiag_rel_production"],
                     counters["gate_max_rel_err"],
                     [counters["gate_max_rel_err"]])]
    # CPU tensors launch no kernel
    assert list(launches) == ["fit", "refine", "sweep", "eigensolve"]
    assert all(not s["launches"] and not s["plain"]
               for s in launches.values())


@pytest.mark.parametrize("offdiag,gate,what", [
    (1e-2, 1e-12, "did not converge"),
    (float("nan"), 1e-12, "did not converge"),
    (1e-7, 1e-8, "missed the 1e-8 oracle gate"),
    (1e-7, float("nan"), "missed the 1e-8 oracle gate"),
])
def test_missed_limit_raises(offdiag, gate, what):
    """(h) a counter or gate at or over its limit raises RuntimeError."""
    with pytest.raises(RuntimeError, match=what):
        bench.check_limits(offdiag, gate, [gate])


def test_limits_met_and_gate_off_pass():
    bench.check_limits(9.9e-3, 9.9e-9, [9.9e-9])
    bench.check_limits(1e-7, float("nan"), [])     # --gate-voxels 0
