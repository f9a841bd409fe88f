"""Wide sizes, and sizes beyond the CUDA kernels' limits, on CPU tensors.

The kernels take k <= 64 (gram_svd, cholqr_rinv, chol_solve) and n <= 64
(eig_cs), as the JAX package's kernels do; on a CUDA tensor a larger size
raises and names the config field to lower (tests/test_torch_cuda.py).  On
a CPU tensor the plain versions take any size, as the JAX package does:
KbdmConfig(p=32) (k = 40) fits, and refine_lines runs on 40 clusters (80 x
80 normal equations), against the JAX CPU path and the float64 oracle; the
widest configuration the kernels take, KbdmConfig(p=56) (k = 64), meets the
oracle gate on the north star's signals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import llckbdm_tpu as lt
import llckbdm_tpu_torch as lp
from llckbdm_tpu.oracle import reference as oracle
from llckbdm_tpu.ops.cplx import from_np
from llckbdm_tpu.utils import df as D
from llckbdm_tpu_torch import convert
from llckbdm_tpu_torch.ops import cuda_jacobi, cuda_linalg

torch.set_num_threads(1)
DWELL = 5e-4


def test_kernel_limits_bind_only_the_kernels():
    """The plain path runs past every kernel limit, odd sizes included."""
    rng = np.random.default_rng(0)
    k = cuda_linalg.MAX_K + 3
    y = torch.from_numpy((rng.standard_normal((2, 80, k))
                          + 1j * rng.standard_normal((2, 80, k)))
                         .astype(np.complex64))
    g = y.conj().transpose(-1, -2) @ y
    sh = 1e-6 * g.diagonal(dim1=-2, dim2=-1).real.mean(-1)
    x = cuda_linalg.cholqr_rinv(g, sh)
    eye = torch.eye(k, dtype=torch.complex128)
    gs = g.to(torch.complex128) + sh.double()[:, None, None] * eye
    x64 = x.to(torch.complex128)
    assert (x64.conj().transpose(-1, -2) @ gs @ x64 - eye).abs().max() < 1e-3
    s, v = cuda_linalg.gram_svd(y[:, :k, :], 8)
    assert s.shape == (2, k) and v.shape == (2, k, k)
    a = y[:, :k, :] + y[:, :k, :].transpose(-1, -2)
    mu = cuda_jacobi.eig_cs(a, 2)
    assert mu.shape == (2, k) and bool(torch.isfinite(mu).all())
    big = cuda_linalg.MAX_K_SOLVE + 7
    yb = torch.randn(2, 2 * big, big, dtype=torch.complex64,
                     generator=torch.Generator().manual_seed(1))
    gb = yb.conj().transpose(-1, -2) @ yb
    b = torch.randn(2, big, dtype=torch.complex64)
    xb = cuda_linalg.chol_solve(gb, b, 0.0)
    res = (gb.to(torch.complex128) @ xb.to(torch.complex128)[..., None])[..., 0]
    assert ((res - b).abs().max() / b.abs().max()).item() < 1e-4


def test_kbdm_fit_p32_matches_jax_and_meets_gate(five_peak_signal,
                                                 five_peak_params):
    """Config 1 at p=32 (k=40): the five lines at the f32 stage's
    tolerances of tests/test_torch_solver.py against the truth and the JAX
    fit (same sketch), then 3 GN iterations within 1e-8 of the oracle's
    kbdm at p=32."""
    sig, dwell = five_peak_signal
    cfg = lt.KbdmConfig(p=32)
    k = cfg.p + cfg.oversample
    omega = convert.sketch_from_np(np.asarray(jax.random.normal(
        jax.random.PRNGKey(cfg.seed), (180, k), dtype=jnp.float32)))
    lines = lp.kbdm_fit(torch.as_tensor(sig).to(torch.complex64), dwell, 180,
                        convert.kbdm_config_from_ref(dataclasses.asdict(cfg)),
                        omega=omega)
    assert lines.amplitude.shape == (32,)
    est = lp.line_list_to_np(lines)
    jest = lt.line_list_to_np(lt.kbdm_fit(from_np(sig), dwell, 180, cfg))
    assert len(est) == len(jest) == 5
    sel = oracle.match_lines(est, five_peak_params)
    jsel = oracle.match_lines(jest, five_peak_params)
    for ref in (five_peak_params, jest[jsel]):
        np.testing.assert_allclose(est[sel, 2], ref[:, 2], rtol=5e-3, atol=0.5)
        np.testing.assert_allclose(est[sel, 0], ref[:, 0], rtol=0.1)
    np.testing.assert_allclose(est[sel, 1], jest[jsel, 1], rtol=0.05)

    olines, _ = oracle.kbdm(sig, dwell, m=180, p=32)
    olines = olines[oracle.match_lines(olines, five_peak_params)]
    ref = lp.refine_lines(torch.as_tensor(sig), lines, dwell,
                          lp.RefineConfig(iters=3))
    got = lp.refined_to_np(ref, dwell)
    err = oracle.line_errors(got[oracle.match_lines(got, five_peak_params)],
                             olines)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"


def test_refine_40_clusters_matches_jax(five_peak_params):
    """tests/test_torch_pipeline.py's 32-slot case at 40 slots (80 x 80
    normal equations): the five strong lines of a noisy fit, scattered among
    masked slots, refine to the oracle's fixed point (1e-8) and to the JAX
    refinement (2e-8)."""
    rng = np.random.default_rng(1)
    params = five_peak_params.copy()
    params[:, 2] += rng.normal(scale=2.0, size=5)
    sig = oracle.sample_signal(params, 512, DWELL) + 1e-4 * (
        rng.standard_normal(512) + 1j * rng.standard_normal(512))
    init = params.copy()
    init[:, 2] += 0.05
    init[:, 0] *= 1.01
    slots, where = 40, np.array([0, 11, 23, 34, 39])
    full = np.zeros((slots, 4))
    full[:, 1] = 1.0                                  # dummy T2 of empty slots
    full[where] = init
    mask = np.zeros(slots)
    mask[where] = 1.0
    fields = [np.asarray(x, np.float32) for x in (*full.T, mask)]
    rcfg = lt.RefineConfig(iters=6)
    olines = oracle.refine(init, sig, DWELL, iters=12)
    olines = olines[oracle.match_lines(olines, params)]

    port = lp.refine_lines(torch.as_tensor(sig), convert.lines_from_np(fields),
                           DWELL, convert.refine_config_from_ref(
                               dataclasses.asdict(rcfg)))
    assert port.z.shape == (slots,)
    est = lp.refined_to_np(port, DWELL)
    est = est[oracle.match_lines(est, params)]
    err = oracle.line_errors(est, olines)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"

    ref = lt.refine_lines(D.dfc_from_np(sig),
                          lt.LineList(*(jnp.asarray(x) for x in fields)),
                          DWELL, rcfg)
    jest = lt.refined_to_np(ref, DWELL)
    jest = jest[oracle.match_lines(jest, params)]
    assert oracle.line_errors(est, jest).max() < 2e-8


def test_llc_kbdm_p56_meets_the_oracle_gate():
    """The widest configuration the kernels take on a card, KbdmConfig(p=56)
    (k = 64 for gram_svd and cholqr_rinv, n = 56 for eig_cs), on three of
    the north star's noisy voxels (config-1 lines with per-voxel jitter and
    noise 1e-4, m = 120..256 step 4): the consolidated top 16 clusters,
    refined with 3 GN iterations, meet the 1e-8 gate against the float64
    oracle's Gauss-Newton polish from the same lines.  Ten eig_cs sweeps do
    not converge on every reduced matrix at n = 56 (the noise poles'); the
    consolidation and the polish do not need them to."""
    rng = np.random.default_rng(0)
    base = np.array([[1.0, 0.05, -120.0, 0.1], [0.8, 0.08, -40.0, 0.0],
                     [1.2, 0.03, 15.0, -0.2], [0.5, 0.10, 90.0, 0.3],
                     [0.9, 0.06, 200.0, 0.0]])
    truths, sigs = [], []
    for _ in range(3):
        p = base.copy()
        p[:, 2] += rng.normal(scale=2.0, size=5)
        p[:, 0] *= 1.0 + rng.normal(scale=0.05, size=5)
        truths.append(p)
        sigs.append(oracle.sample_signal(p, 512, DWELL) + 1e-4 * (
            rng.standard_normal(512) + 1j * rng.standard_normal(512)))
    c64 = torch.as_tensor(np.stack(sigs))
    cfg = lp.LlcKbdmConfig(m_values=tuple(range(120, 257, 4)), eps=2e-4,
                           min_samples=20, max_clusters=32,
                           kbdm=lp.KbdmConfig(p=56))
    cons, _, _, _ = lp.llc_kbdm_fit(c64.to(torch.complex64), DWELL, cfg)
    top = lp.LineList(*(x[..., :16] for x in cons))
    ref = lp.refine_lines(c64, top, DWELL, lp.RefineConfig(iters=3))
    for i, truth in enumerate(truths):
        init = lp.line_list_to_np(lp.LineList(*(x[i] for x in top)))
        olines = oracle.refine(init, sigs[i], DWELL, iters=20)
        est = lp.refined_to_np(ref._replace(z=ref.z[i], d=ref.d[i],
                                            mask=ref.mask[i]), DWELL)
        assert len(est) >= 5
        err = oracle.line_errors(est[oracle.match_lines(est, truth)],
                                 olines[oracle.match_lines(olines, truth)])
        assert err.max() < 1e-8, f"voxel {i}: max err {err.max():.3e}\n{err}"
