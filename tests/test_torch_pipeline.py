"""The PyTorch port's refinement and whole refined slice vs JAX and the oracle.

(a) refine_lines from the SAME initial line list as the JAX refine_lines
    (carried across by convert.lines_from_np): both meet the 1e-8 gate
    against the float64 oracle and agree with each other within 2e-8.
(b) The port's whole slice — llc_kbdm_fit then refine_lines — on a small
    configuration: the refined lines meet the 1e-8 gate and the cluster
    counts equal JAX llc_kbdm_fit's, with the JAX sketch as omega.
(c) The same with damping_weight != 0 (the 2-D dbscan) against JAX.
(d) Importing the port never imports JAX, and reaches its parallel layer.
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llckbdm_tpu as lt
import llckbdm_tpu_torch as lp
from llckbdm_tpu.oracle import reference as oracle
from llckbdm_tpu.ops.cplx import from_np
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu.utils import df as D
from llckbdm_tpu_torch import convert

torch.set_num_threads(1)
CFG = lt.KbdmConfig(p=16)
LINE_FIELDS = ("amplitude", "t2", "frequency", "phase")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _noisy_config1(params, seed, noise, dwell=5e-4):
    """The jittered, noisy config-1 signal of tests/test_solver.py."""
    rng = np.random.default_rng(seed)
    params = params.copy()
    params[:, 2] += rng.normal(scale=2.0, size=5)
    sig = oracle.sample_signal(params, 512, dwell)
    sig = sig + noise * (rng.standard_normal(512)
                         + 1j * rng.standard_normal(512))
    return params, sig


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (1, 1e-4), (2, 1e-4)])
def test_refine_from_same_lines_as_jax_hits_gate(five_peak_params, seed,
                                                 noise):
    """tests/test_solver.py::test_refined_hits_1e8_oracle_gate, with the
    port refining the JAX f32 stage's line list."""
    dwell = 5e-4
    params, sig = _noisy_config1(five_peak_params, seed, noise, dwell)
    lines = lt.kbdm_fit(from_np(sig), dwell, 180, CFG)
    if noise == 0.0:
        olines, _ = oracle.kbdm(sig, dwell, m=180, p=16)
        olines = olines[oracle.match_lines(olines, params)]
    else:
        # keep only the 5 genuine lines (top 5 by amplitude) on every side:
        # the 5-line noisy least-squares optimum is unique
        amp = np.where(np.asarray(lines.mask) > 0.5,
                       np.asarray(lines.amplitude), 0.0)
        strong = amp >= np.sort(amp)[-5]
        lines = lines._replace(mask=jnp.asarray(strong, jnp.float32))
        init = lt.line_list_to_np(lines)
        assert len(init) == 5
        olines = oracle.refine(init, sig, dwell, iters=12)
        olines = olines[oracle.match_lines(olines, params)]
    rcfg = lt.RefineConfig(iters=6 if noise else 3)

    port = lp.refine_lines(torch.as_tensor(sig),
                           convert.lines_from_np(np.asarray(x) for x in lines),
                           dwell, convert.refine_config_from_ref(
                               dataclasses.asdict(rcfg)))
    est = lp.refined_to_np(port, dwell)
    est = est[oracle.match_lines(est, params)]
    err = oracle.line_errors(est, olines)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"

    ref = lt.refine_lines(D.dfc_from_np(sig), lines, dwell, rcfg)
    jest = lt.refined_to_np(ref, dwell)
    jest = jest[oracle.match_lines(jest, params)]
    assert oracle.line_errors(est, jest).max() < 2e-8


def test_refine_32_clusters_matches_jax(five_peak_params):
    """At the pipeline's default max_clusters=32 the GN normal equations are
    64 x 64 (chol_solve's widest case): the 5 strong lines of the noisy JAX
    f32 stage, scattered over 32 slots among masked ones, refine on both
    sides to the oracle's fixed point (1e-8) and to each other (2e-8)."""
    dwell, slots = 5e-4, 32
    params, sig = _noisy_config1(five_peak_params, 1, 1e-4, dwell)
    init = lt.line_list_to_np(lt.kbdm_fit(from_np(sig), dwell, 180, CFG))
    init = init[np.argsort(-init[:, 0])[:5]]
    where = np.array([2, 9, 15, 22, 31])
    full = np.zeros((slots, 4))
    full[:, 1] = 1.0                                  # dummy T2 of empty slots
    full[where] = init
    mask = np.zeros(slots)
    mask[where] = 1.0
    fields = [np.asarray(x, np.float32) for x in (*full.T, mask)]
    olines = oracle.refine(init, sig, dwell, iters=12)
    olines = olines[oracle.match_lines(olines, params)]
    rcfg = lt.RefineConfig(iters=6)

    port = lp.refine_lines(torch.as_tensor(sig), convert.lines_from_np(fields),
                           dwell, convert.refine_config_from_ref(
                               dataclasses.asdict(rcfg)))
    assert port.z.shape == (slots,)
    assert torch.equal(port.mask, torch.as_tensor(mask, dtype=torch.float32))
    est = lp.refined_to_np(port, dwell)
    est = est[oracle.match_lines(est, params)]
    err = oracle.line_errors(est, olines)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"

    ref = lt.refine_lines(D.dfc_from_np(sig),
                          lt.LineList(*(jnp.asarray(x) for x in fields)),
                          dwell, rcfg)
    jest = lt.refined_to_np(ref, dwell)
    jest = jest[oracle.match_lines(jest, params)]
    assert oracle.line_errors(est, jest).max() < 2e-8


def test_refine_f32_warmstart_hits_gate(five_peak_params):
    dwell = 5e-4
    params = five_peak_params
    sig = oracle.sample_signal(params, 512, dwell)
    init = params.copy()
    init[:, 2] += 0.05                       # an f32-stage-sized error
    lines = lp.line_list_from_np(init, k=8)
    ref = lp.refine_lines(torch.as_tensor(sig), lines, dwell,
                          lp.RefineConfig(iters=3, f32_iters=3))
    est = lp.refined_to_np(ref, dwell)
    err = oracle.line_errors(est[oracle.match_lines(est, params)], params)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"
    assert ref.gn_step.shape == (8,) and float(ref.gn_step.max()) < 1e-8


def test_refine_is_fixed_point_at_truth(five_peak_signal, five_peak_params):
    sig, dwell = five_peak_signal
    ref = lp.refine_lines(torch.as_tensor(sig),
                          lp.line_list_from_np(five_peak_params, k=16), dwell,
                          lp.RefineConfig(iters=2))
    est = lp.refined_to_np(ref, dwell)
    err = oracle.line_errors(est[oracle.match_lines(est, five_peak_params)],
                             five_peak_params)
    assert err.max() < 1e-10, f"max err {err.max():.3e}\n{err}"


def test_port_slice_hits_gate_and_matches_jax_clusters(five_peak_params):
    """tests/test_solver.py::test_refined_gate_at_1e3_noise_full_pipeline on
    the port: sweep -> DBSCAN consolidation -> refinement, sigma = 1e-3."""
    dwell = 5e-4
    params, sig = _noisy_config1(five_peak_params, 3, 1e-3, dwell)
    cfg = LlcKbdmConfig(m_values=tuple(range(120, 257, 8)), eps=2e-4,
                        min_samples=10, max_clusters=16, kbdm=CFG)
    tcfg = convert.llc_config_from_ref(dataclasses.asdict(cfg))
    m_max, k = max(cfg.m_values), CFG.p + CFG.oversample
    omega = convert.sketch_from_np(np.asarray(jax.random.normal(
        jax.random.PRNGKey(CFG.seed), (m_max, k), dtype=jnp.float32)))

    cons, pooled, counts, stats = lp.llc_kbdm_fit(
        torch.as_tensor(sig[None]).to(torch.complex64), dwell, tcfg,
        omega=omega)
    assert cons.amplitude.shape == (1, 16)
    assert pooled.amplitude.shape == (1, len(cfg.m_values) * CFG.p)
    assert stats.frequency.shape == (1, 16)
    ref = lp.refine_lines(torch.as_tensor(sig[None]), cons, dwell,
                          lp.RefineConfig(iters=8))
    est = lp.refined_to_np(ref._replace(z=ref.z[0], d=ref.d[0],
                                        mask=ref.mask[0]), dwell)
    olines = oracle.refine(np.asarray(params, np.float64), sig, dwell,
                           iters=30)
    err = oracle.line_errors(est[oracle.match_lines(est, params)],
                             olines[oracle.match_lines(olines, params)])
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"

    _, _, jcounts, _ = lt.llc_kbdm_fit(from_np(sig[None]), dwell, cfg)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_llc_kbdm_numpy_entry_point(five_peak_signal, five_peak_params):
    sig, dwell = five_peak_signal
    cons, pooled, counts = lp.llc_kbdm(sig, dwell, range(120, 257, 16), p=16,
                                       min_samples=5, max_clusters=16,
                                       refine_iters=3, device="cpu")
    assert counts.shape == (16,) and len(pooled) >= 5 * 9
    err = oracle.line_errors(cons[oracle.match_lines(cons, five_peak_params)],
                             five_peak_params)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"
    # the 2-D feature space (O(n^2) dbscan) finds the same five lines
    cons, pooled, counts = lp.llc_kbdm(sig, dwell, range(120, 257, 16), p=16,
                                       min_samples=5, max_clusters=16,
                                       damping_weight=1.0, refine_iters=3,
                                       device="cpu")
    assert counts.shape == (16,) and len(pooled) >= 5 * 9
    err = oracle.line_errors(cons[oracle.match_lines(cons, five_peak_params)],
                             five_peak_params)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"


def test_damped_llc_kbdm_fit_matches_jax(five_peak_params):
    """damping_weight=1.0 on tests/test_pipeline.py's SMALL configuration,
    a noiseless and a noisy (sigma 1e-3) voxel, the JAX sketch as omega:
    cluster counts and masks equal JAX llc_kbdm_fit's (which clusters with
    its O(n^2) dbscan too); the consolidated lines agree to the f32 stage's
    tolerances of tests/test_torch_solver.py (other algorithms on the JAX
    CPU path), the phase to 0.05 rad (measured 0.016); and they are the
    lines of damping_weight=0, which clusters by dbscan_1d."""
    dwell = 5e-4
    sigs = np.stack([_noisy_config1(five_peak_params, seed, noise, dwell)[1]
                     for seed, noise in ((0, 0.0), (1, 1e-3))])
    cfg = LlcKbdmConfig(m_values=tuple(range(120, 181, 10)), eps=2e-4,
                        min_samples=5, max_clusters=16, kbdm=CFG,
                        damping_weight=1.0)
    tcfg = convert.llc_config_from_ref(dataclasses.asdict(cfg))
    k = CFG.p + CFG.oversample
    omega = convert.sketch_from_np(np.asarray(jax.random.normal(
        jax.random.PRNGKey(CFG.seed), (max(cfg.m_values), k),
        dtype=jnp.float32)))
    c = torch.as_tensor(sigs).to(torch.complex64)
    cons, _, counts, _ = lp.llc_kbdm_fit(c, dwell, tcfg, omega=omega)
    jcons, _, jcounts, _ = lt.llc_kbdm_fit(from_np(sigs), dwell, cfg)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(cons.mask.numpy(), np.asarray(jcons.mask))
    assert (counts.numpy()[:, :5] == len(cfg.m_values)).all()
    live = cons.mask.numpy() > 0.5
    got = {f: getattr(cons, f).numpy()[live] for f in LINE_FIELDS}
    want = {f: np.asarray(getattr(jcons, f))[live] for f in LINE_FIELDS}
    np.testing.assert_allclose(got["frequency"], want["frequency"], rtol=5e-3,
                               atol=0.5)
    np.testing.assert_allclose(got["amplitude"], want["amplitude"], rtol=0.1)
    np.testing.assert_allclose(got["t2"], want["t2"], rtol=0.05)
    dphi = np.abs(np.angle(np.exp(1j * (got["phase"] - want["phase"]))))
    assert dphi.max() < 0.05, dphi

    undamped = lp.llc_kbdm_fit(
        c, dwell, dataclasses.replace(tcfg, damping_weight=0.0), omega=omega)
    for x, y in zip(cons, undamped[0]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_llc_kbdm_default_device_is_cuda(five_peak_signal):
    """Without a CUDA device the default raises instead of running on the
    CPU; callers that want the CPU say device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sig, dwell = five_peak_signal
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        lp.llc_kbdm(sig, dwell, (120,), p=16)


def test_parallel_is_reachable_after_a_bare_import():
    code = ("import llckbdm_tpu_torch as lp; "
            "assert 'parallel' in lp.__all__; "
            "print(lp.parallel.GridRunner.__name__, "
            "lp.parallel.fit_and_refine_grid.__name__)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["GridRunner", "fit_and_refine_grid"]


def test_import_does_not_load_jax():
    code = ("import sys, llckbdm_tpu_torch, llckbdm_tpu_torch.convert, "
            "llckbdm_tpu_torch.parallel, llckbdm_tpu_torch.oracle, "
            "llckbdm_tpu_torch.tools.bounds; "
            "sys.exit(1 if 'jax' in sys.modules or 'llckbdm_tpu' in "
            "sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
