"""The port's measuring tools (llckbdm_tpu_torch.tools: ablate_sweep,
bench_fft_hankel, tune_sweeps, noise_gate_sweep, scaling_bench,
precision_gate, config5_run, trace_capture, profile_stages), counterparts
of the JAX package's tools of the same names, run through their ``--cpu``
entry points at tiny sizes on the plain versions.  Their times are the
CPU's and are not checked; what is checked is that each exits 0, refuses to
run without a card unless asked for the CPU, and what each computes that
does not depend on a clock: the stage model, the gates, the collective
counts."""
import json
import pathlib

import numpy as np
import pytest
import torch

from llckbdm_tpu_torch.solver.kbdm import KbdmConfig
from llckbdm_tpu_torch.tools import (ablate_sweep, bench_fft_hankel, bounds,
                                     config5_run, five_peak,
                                     noise_gate_sweep, precision_gate,
                                     profile_stages, scaling_bench,
                                     trace_capture, tune_sweeps)

torch.set_num_threads(1)
TOOLS = (ablate_sweep, bench_fft_hankel, tune_sweeps, noise_gate_sweep,
         scaling_bench, precision_gate, config5_run, trace_capture,
         profile_stages)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__.split(".")[-1])
def test_tool_needs_a_card_without_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tool.main([]) == 2


def test_ablate_sweep_cpu(capsys):
    assert ablate_sweep.main(["--cpu", "--voxels", "1", "--reps", "3"]) == 0
    out = capsys.readouterr().out
    for stage in ablate_sweep.STAGES:
        assert f"\n{stage} " in out


def test_ablate_stage_model_is_the_sweeps_work():
    """The model's operations at the north star's shapes: the Hankel
    operator is only bytes, each power-iteration apply 8 m^2 S k V flops,
    and the kernels' stages are tools.bounds' counts."""
    v, cfg = 2048, KbdmConfig(p=16)
    model = ablate_sweep.stage_model(v, 512, tuple(range(120, 257, 4)), cfg)
    assert list(model) == list(ablate_sweep.STAGES)
    s, m, k = 35, 256, 24
    assert model["hankel"] == (0.0, v * 512 * 8 + v * m * m * 8)
    apply = 8.0 * m * m * s * k * v
    assert model["powiter"][0] > 3 * apply
    assert model["takagi"][0] == bounds.gram_svd(s * v, k, 7).flops
    assert model["eig"][0] == bounds.eig_cs(s * v, 16, 10).flops
    assert all(f >= 0 and b > 0 for f, b in model.values())


def test_ablate_scalarize_reduces_every_output():
    c = torch.tensor([1 + 2j, 3 - 1j], dtype=torch.complex64)
    assert ablate_sweep.scalarize(c).item() == 5.0
    assert ablate_sweep.scalarize((c, torch.ones(3))).item() == 8.0


def test_bench_fft_hankel_cpu():
    res = bench_fft_hankel.run((4, 64, 32, 8), "cpu", verbose=False)
    assert set(res) == {"dense_f32", "dense_bf16", "fft"}
    # float32 applies to complex64 rounding, bf16 to its 8-bit mantissa
    assert res["dense_f32"]["rel_err"] < 1e-6
    assert res["fft"]["rel_err"] < 1e-6
    assert 1e-4 < res["dense_bf16"]["rel_err"] < 2e-2
    assert bench_fft_hankel.main(["--cpu", "--shape", "config2", "--voxels",
                                  "2", "--n", "64", "--m", "32", "--cols",
                                  "4"]) == 0


def test_bench_fft_hankel_bounds_at_the_pipeline_shape():
    """The dense apply at (V=2048, m=256, J=840) is 9.0e11 flops, 13.5 ms
    at 67 TFLOP/s."""
    b = bench_fft_hankel.apply_bound("dense_f32", 2048, 512, 256, 840)
    assert b.flops == 8.0 * 256 ** 2 * 840 * 2048 and b.by == "operations"
    assert abs(b.ms - 13.46) < 0.01


def test_tune_sweeps_cpu():
    res = tune_sweeps.run("cpu", counter_voxels=1, time_voxels=1,
                          sweeps=(10,), pairs=((10, 7),), verbose=False)
    assert res["ok"] and res["smallest_passing"] == (10, 7)
    assert res["counter"][10] < tune_sweeps.COUNTER_GATE
    g = res["gates"][(10, 7)]
    assert g["noiseless_iters3"] < 1e-8 and g["noisy_iters6"] < 1e-8
    # the entry point, on the counter alone (no pairs)
    assert tune_sweeps.main(["--cpu", "--counter-voxels", "1", "--sweeps",
                             "10", "--pairs"]) == 0


def test_noise_gate_sweep_cpu():
    assert noise_gate_sweep.main(["--cpu", "--voxels", "1", "--levels",
                                  "1e-4", "1e-2"]) == 0


def test_scaling_bench_counts_collectives(tmp_path):
    """The data-parallel fit issues no collective on any rank; the
    time-sharded refine issues one all-reduce per Gauss-Newton iteration
    and its control none.  Written to --out, printed otherwise."""
    out = tmp_path / "scaling.json"
    assert scaling_bench.main(["--cpu", "--ranks", "1", "2", "--voxels", "2",
                               "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert [r["ranks"] for r in res["dp_scaling"]] == [1, 2]
    for row in res["dp_scaling"]:
        assert row["collectives"] == [0] * row["ranks"]
        assert row["backend"] == "gloo"
    probe = res["overlap_probe"]
    assert probe["mesh"] == {"data": 1, "time": 2}
    iters = scaling_bench.OVERLAP_RCFG.iters
    assert probe["with_collectives"] == [{"all_reduce": iters}] * 2
    assert probe["without_collectives"] == [{}, {}]
    assert np.isfinite(probe["unhidden_ms"])


def test_ablate_stage_model_bf16_branch():
    """On the bfloat16 branch the power iterations do the same operations;
    their applies stream blocks of 2 bytes a real, and the operator is
    built once from h0 (as many bytes as h0), and each CholeskyQR pass
    reads and writes its block as pairs too.  Bound at a rate between the
    float32 and the bfloat16 peaks."""
    v, m_values, cfg = 2048, tuple(range(120, 257, 4)), KbdmConfig(p=16)
    f32 = ablate_sweep.stage_model(v, 512, m_values, cfg)
    bf16 = ablate_sweep.stage_model(v, 512, m_values, cfg, bf16=True)
    assert bf16["powiter"][0] == f32["powiter"][0]
    blk, hank, it = v * 256 * 35 * 24 * 8, v * 256 * 256 * 8, 2
    applies = (1 + 2 * it) * blk
    passes = it * 3 * blk                  # two reads and a write a pass
    assert bf16["powiter"][1] == (f32["powiter"][1] + 2 * hank - applies / 2
                                  - passes / 2)
    assert {k: x for k, x in bf16.items() if k != "powiter"} == {
        k: x for k, x in f32.items() if k != "powiter"}
    peak = ablate_sweep.powiter_bf16_peak(v, m_values, cfg)
    assert bounds.PEAK_FLOPS < peak < bounds.PEAK_BF16


def test_precision_gate_cpu(capsys):
    """Both precisions and both power-iteration branches at the default
    sweep budgets: on the CPU all four compute in float32 and pass."""
    assert precision_gate.main(["--cpu", "--time-voxels", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 8 and "[FAIL]" not in out
    for prec in ("highest", "high"):
        for branch in ("bf16", "f32 "):
            assert f"{prec:8s} {branch} power iterations" in out


def test_config5_run_resumes_exactly_the_deleted_shard(tmp_path, capsys):
    """A run, a deleted shard, a rerun into the same --out: exactly that
    shard is recomputed, the rest resumed, and the grid gathers bit for
    bit as before."""
    first = config5_run.run(4, 2, str(tmp_path), "cpu", gate_voxels=2,
                            verbose=False)
    assert (first["total"], first["computed"], first["resumed"]) == (2, 2, 0)
    assert first["gate"] < 1e-8
    (tmp_path / "shard_00000002_00000004.npz").unlink()
    assert config5_run.main(["--cpu", "--voxels", "4", "--shard", "2",
                             "--gate-voxels", "0", "--out",
                             str(tmp_path)]) == 0
    assert "1 pending (1 resumed)" in capsys.readouterr().out
    again = config5_run.run(4, 2, str(tmp_path), "cpu", gate_voxels=0,
                            verbose=False)
    assert (again["computed"], again["resumed"]) == (0, 2)
    assert first["grid"].keys() == again["grid"].keys()
    for k in first["grid"]:
        np.testing.assert_array_equal(first["grid"][k], again["grid"][k])


def test_config5_signals_are_the_jax_tools():
    """make_grid_signals draws what the JAX tool's vectorised form draws
    (its config5_run.py:29-52), summed in chunks."""
    v = 6
    sigs, truths = config5_run.make_grid_signals(v, chunk=4)
    base, n, dwell = five_peak.FIVE_PEAK, five_peak.N, five_peak.DWELL
    rng = np.random.default_rng(0)
    amp = base[:, 0] * (1.0 + rng.normal(scale=0.05, size=(v, 5)))
    freq = base[:, 2] + rng.normal(scale=2.0, size=(v, 5))
    t = np.arange(n) * dwell
    z = (2j * np.pi * freq[..., None] - 1.0 / base[:, 1][:, None]) * t
    want = np.sum(amp[..., None] * np.exp(1j * base[:, 3][:, None] + z), 1)
    want += 1e-4 * (rng.standard_normal((v, n))
                    + 1j * rng.standard_normal((v, n)))
    np.testing.assert_allclose(sigs, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(truths[..., 2], freq)


def test_trace_capture_cpu(tmp_path, capsys):
    """The refinement's trace on the CPU: the raw trace kept under --out,
    the top ops printed from the profiler's own table."""
    assert trace_capture.main(["--cpu", "--voxels", "1", "--reps", "1",
                               "--refine", "--top", "5", "--out",
                               str(tmp_path)]) == 0
    assert (tmp_path / "trace.json").stat().st_size > 0
    out = capsys.readouterr().out
    assert "traced 1 iterations (refine) at V=1" in out
    assert "total device-op time" in out


def test_trace_capture_busy_time_counts_overlap_once():
    """Two overlapping intervals count their overlap once (summing the ops'
    own times counted it twice); a disjoint third adds its length."""
    assert trace_capture.union_ns([(0, 10), (5, 20)]) == 20
    assert trace_capture.union_ns([(30, 40), (5, 20), (0, 10)]) == 30
    assert trace_capture.union_ns([(0, 10), (2, 4)]) == 10
    assert trace_capture.union_ns([]) == 0


def test_profile_stages_cpu_writes_only_out(tmp_path, capsys):
    """Every row printed; the JSON printed as the last line and written to
    --out alone: the JAX package's PROFILE.json is left as it was."""
    profile = (ROOT / "PROFILE.json").read_bytes()
    out = tmp_path / "deep" / "profile.json"
    assert profile_stages.main(["--cpu", "--voxels", "1", "--reps", "1",
                                "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    for name in profile_stages.ROWS:
        assert f"\n{name} " in printed
    res = json.loads(printed.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == res
    assert list(tmp_path.rglob("*")) == [out.parent, out]
    assert (ROOT / "PROFILE.json").read_bytes() == profile
    assert list(res) == ["device", "voxels", "rows", "ideal_ms",
                         "pipeline_pct_of_light", "branch"]
    assert res["branch"] == "float32" and res["voxels"] == 1
    assert [r["stage"] for r in res["rows"]] == list(profile_stages.ROWS)
    assert all(r["ms"] > 0 for r in res["rows"])
    assert [len(r.get("runs_ms", ())) for r in res["rows"]] == [
        0 if "derived" in r["stage"] else 1 for r in res["rows"]]
    assert res["pipeline_pct_of_light"] > 0


def test_profile_stages_rows_take_two_untimed_calls(monkeypatch):
    """Every timed row (all but the derived cluster row) goes through
    host_mean with the bench's two untimed calls."""
    seen = []

    def spy(fn, device, reps, warmups=1, runs=None):
        seen.append(warmups)
        return 1.0, 1.0, fn()

    monkeypatch.setattr(profile_stages, "host_mean", spy)
    res = profile_stages.run(1, 1, "cpu", verbose=False)
    assert len(res["rows"]) == len(profile_stages.ROWS)
    assert seen == [2] * (len(profile_stages.ROWS) - 1)


def test_profile_stages_models_are_the_jax_tools():
    """The non-kernel rows' work at V=512 is the JAX tool's formulas,
    restated from tools/profile_stages.py."""
    v, n, cfg = 512, 512, five_peak.north_star_config()
    s, p, k, m, c = 35, 16, 24, 256, 32
    models = profile_stages.work_models(v, n, cfg)
    rows = profile_stages.ROWS
    assert models[rows[0]] is None and models[rows[1]] is None
    # :162-163 hankel_matrices, bytes
    assert models[rows[2]].bytes == v * m * m * 2 * 4
    # :189 the apply
    assert models[rows[3]].flops == 8.0 * m * m * k * s * v
    # :235-238 _poles_to_lines
    nch = (n + 128 - 1) // 128
    assert models[rows[7]].flops == float(s * v) * (
        nch * 128 * p * 14 + 60 * p * p + 8 * p ** 3 / 3)
    # :266-269 cluster + consolidate (the % from its VPU share)
    npool = s * p
    vpu, mxu = float(v) * 50.0 * npool ** 2, float(v) * 10.0 * npool ** 2 * c
    assert models[rows[8]].flops == vpu + mxu
    assert models[rows[8]].light_ms == 1e3 * vpu / bounds.PEAK_FLOPS
    # the port's refine: complex128 powers (9 bits at N=512), model and J^H r
    # in float64; G and the 64 x 64 solve in float32
    f64 = v * 3 * (6 * 9 * c * n + 8 * c * n + 2 * n + 16 * c * n)
    f32 = v * 3 * (24 * c * c * n + 8 * c * n
                   + 4 * 64 ** 3 / 3 + 16 * 64 ** 2)
    assert models[rows[9]].flops == f64 + f32
    assert models[rows[9]].light_ms == 1e3 * (f64 / bounds.PEAK_F64
                                              + f32 / bounds.PEAK_FLOPS)


def test_profile_stages_kernel_rows_are_the_bounds():
    v, cfg = 512, five_peak.north_star_config()
    models = profile_stages.work_models(v, 512, cfg)
    rows = profile_stages.ROWS
    for row, b in ((rows[4], bounds.cholqr_rinv(35 * v, 24)),
                   (rows[5], bounds.gram_svd(35 * v, 24, 7)),
                   (rows[6], bounds.eig_cs(35 * v, 16, 10))):
        assert models[row] == (b.flops, b.bytes, b.ms,
                               f"kernel bound ({b.by})")


@pytest.mark.parametrize("bf16", [True, False])
def test_profile_stages_ideal_budget_has_the_jax_keys(bf16):
    """The keys of tools/profile_stages.py:300-323 (subspace_iters=2); the
    power iterations' applies at the bfloat16 peak on that branch only."""
    cfg = five_peak.north_star_config()
    ideal = profile_stages.ideal_budget(512, 512, cfg, bf16)
    assert list(ideal) == [
        "hankel U0 (HBM)", "bf16 applies x3", "bf16 orth grams/mixes",
        "f32 final orth x2 (gram+mix)", "cholqr kernels x4",
        "m_small apply+gram (f32)", "takagi (gram_svd kernel)",
        "u_p mix + U1-shift mix + gram (f32)", "eig_cs kernel",
        "poles->lines", "cluster+consolidate"]
    applies = 3 * 8.0 * 256 ** 2 * 24 * 35 * 512
    peak = bounds.PEAK_BF16 if bf16 else bounds.PEAK_FLOPS
    assert ideal["bf16 applies x3"] == 1e3 * applies / peak
    gram = 8.0 * 256 * 24 * 24 * 35 * 512
    assert ideal["bf16 orth grams/mixes"] == 1e3 * 4 * gram / bounds.PEAK_FLOPS
    assert ideal["eig_cs kernel"] == bounds.eig_cs(35 * 512, 16, 10).ms
