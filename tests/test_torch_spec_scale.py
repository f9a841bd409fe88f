"""The port at spec scale (BASELINE.json:8-9) on the CPU.

Config 2: the simulated brain signal (16 metabolite lines, N=2048, dwell
2.5e-4), one KBDM fit at m=512 with p=24 (k=32), refined with 10 GN
iterations, within 1e-8 of the port's float64 oracle (oracle.kbdm at m=512,
p=24).  Config 3: the full LL-KBDM sweep m=120..300 step 4 (46 entries,
min_samples=10) on the same signal, all 32 cluster slots refined (64 x 64
normal equations), within 1e-8 of the truth.  These are the gates of
tests/test_spec_scale.py, held by the port's own oracle, as chip_smoke.py
holds them on the card; a few seconds each.  The comparisons with the JAX
pipeline at this scale are marked ``slow``, as tests/test_spec_scale.py is.
"""
import jax
import numpy as np
import pytest
import torch

import llckbdm_tpu as lt
import llckbdm_tpu_torch as lp
from llckbdm_tpu.ops.cplx import from_np
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig as JaxLlcConfig
from llckbdm_tpu.utils import df as D
from llckbdm_tpu_torch import oracle

torch.set_num_threads(1)
DWELL, N = 2.5e-4, 2048
CFG = lp.KbdmConfig(p=24)
LLC = lp.LlcKbdmConfig(m_values=tuple(range(120, 301, 4)), eps=2e-4,
                       min_samples=10, max_clusters=32, kbdm=CFG)


@pytest.fixture(scope="module")
def brain(brain_params):
    return oracle.sample_signal(brain_params, N, DWELL)


@pytest.fixture(scope="module")
def config2(brain):
    lines = lp.kbdm_fit(torch.as_tensor(brain).to(torch.complex64), DWELL,
                        512, CFG)
    return lines, lp.refine_lines(torch.as_tensor(brain), lines, DWELL,
                                  lp.RefineConfig(iters=10))


@pytest.fixture(scope="module")
def config3(brain):
    cons, pooled, counts, _ = lp.llc_kbdm_fit(
        torch.as_tensor(brain[None]).to(torch.complex64), DWELL, LLC)
    ref = lp.refine_lines(torch.as_tensor(brain[None]), cons, DWELL,
                          lp.RefineConfig(iters=10))
    return cons, ref


def _assert_f32_frequencies(est, jest, truth):
    """Port and JAX f32 lines both find every line, each frequency within
    5e-3 of the band of the truth (tests/test_spec_scale.py:63-66)."""
    band = np.abs(truth[:, 2]).max()
    for lines in (est, jest):
        assert len(lines) >= len(truth)
        sel = oracle.match_lines(lines, truth)
        np.testing.assert_allclose(lines[sel, 2], truth[:, 2], rtol=0,
                                   atol=5e-3 * band)


def _voxel(ref, i=0):
    return ref._replace(z=ref.z[i], d=ref.d[i], mask=ref.mask[i])


def test_config2_port_meets_oracle_gate(config2, brain, brain_params):
    lines, ref = config2
    # the f32 stage alone finds every metabolite line
    assert len(lp.line_list_to_np(lines)) >= len(brain_params)
    olines, _ = oracle.kbdm(brain, DWELL, m=512, p=24)
    olines = olines[oracle.match_lines(olines, brain_params)]
    est = lp.refined_to_np(ref, DWELL)
    err = oracle.line_errors(est[oracle.match_lines(est, brain_params)],
                             olines)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"


def test_config3_port_meets_truth_gate(config3, brain_params):
    cons, ref = config3
    assert cons.amplitude.shape == (1, 32)
    est = lp.line_list_to_np(lp.LineList(*(x[0] for x in cons)))
    assert len(est) >= len(brain_params)
    refined = lp.refined_to_np(_voxel(ref), DWELL)
    refined = refined[np.abs(refined[:, 0]) > 0.1]   # drop empty slots
    err = oracle.line_errors(
        refined[oracle.match_lines(refined, brain_params)], brain_params)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"


@pytest.mark.slow
def test_config2_port_matches_jax(config2, brain, brain_params):
    """The f32 frequencies of both within the spec-scale f32 tolerance of
    tests/test_spec_scale.py (5e-3 of the band: the near-degenerate pairs
    at -60/-55 and -20/-15 Hz differ by ~1 Hz between the two f32 paths),
    the refined lines within 2e-8 of the JAX df refinement."""
    lines, ref = config2
    jlines = lt.kbdm_fit(from_np(brain), DWELL, 512, lt.KbdmConfig(p=24))
    _assert_f32_frequencies(lp.line_list_to_np(lines),
                            lt.line_list_to_np(jlines), brain_params)
    jref = lt.refine_lines(D.dfc_from_np(brain), jlines, DWELL,
                           lt.RefineConfig(iters=10))
    got = lp.refined_to_np(ref, DWELL)
    want = lt.refined_to_np(jref, DWELL)
    assert oracle.line_errors(got[oracle.match_lines(got, brain_params)],
                              want[oracle.match_lines(want, brain_params)]
                              ).max() < 2e-8


@pytest.mark.slow
def test_config3_port_matches_jax(config3, brain, brain_params):
    """The consolidated frequencies of both within the spec-scale f32
    tolerance, and the refined lines within 2e-8 of the JAX refinement."""
    cons, ref = config3
    jcfg = JaxLlcConfig(m_values=LLC.m_values, eps=LLC.eps,
                        min_samples=LLC.min_samples,
                        max_clusters=LLC.max_clusters,
                        kbdm=lt.KbdmConfig(p=24))
    jcons, _, _, _ = lt.llc_kbdm_fit(from_np(brain[None]), DWELL, jcfg)
    _assert_f32_frequencies(
        lp.line_list_to_np(lp.LineList(*(x[0] for x in cons))),
        lt.line_list_to_np(lt.LineList(*(x[0] for x in jcons))), brain_params)
    jref = lt.refine_lines(D.dfc_from_np(brain[None]), jcons, DWELL,
                           lt.RefineConfig(iters=10))
    got = lp.refined_to_np(_voxel(ref), DWELL)
    want = lt.refined_to_np(jax.tree.map(lambda x: x[0], jref), DWELL)
    got = got[np.abs(got[:, 0]) > 0.1]
    want = want[np.abs(want[:, 0]) > 0.1]
    assert oracle.line_errors(got[oracle.match_lines(got, brain_params)],
                              want[oracle.match_lines(want, brain_params)]
                              ).max() < 2e-8
