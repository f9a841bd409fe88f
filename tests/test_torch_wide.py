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
import pytest
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


# The two north-star voxels on which KbdmConfig(p=56) takes a sixth line
# with the port's own sketch (chip_smoke.py's wide phase, on the card and on
# the CPU plain path alike), and two clean neighbours.
P56_VOXELS = (2005, 534, 2004, 533)


def _p56_fits(voxels, port_omega):
    """The north star's signals at ``voxels`` (chip_smoke.py's
    make_signals: tools.five_peak.signals(2048, 1e-4)), fitted at
    KbdmConfig(p=56) by the JAX package (its CPU path) and by the port on
    CPU tensors with ``port_omega`` ("jax": the JAX package's sketch; None:
    the port's own draw).  Returns the signals, the truths, the two
    configurations and sketch, and for each package its top-16
    consolidated lines and its pooled sweep lines, as numpy field tuples."""
    from llckbdm_tpu.ops.cplx import CArr
    from llckbdm_tpu_torch.tools import five_peak

    sigs, truths = five_peak.signals(2048, 1e-4)
    sigs, truths = sigs[list(voxels)], truths[list(voxels)]
    jcfg = lt.LlcKbdmConfig(m_values=five_peak.M_VALUES, eps=2e-4,
                            min_samples=20, max_clusters=32,
                            kbdm=lt.KbdmConfig(p=56))
    k = jcfg.kbdm.p + jcfg.kbdm.oversample
    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))
    jcons, jpooled, _, _ = jax.jit(lambda x: lt.llc_kbdm_fit(x, DWELL,
                                                             jcfg))(c)
    omega = None
    if port_omega == "jax":
        omega = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(jcfg.kbdm.seed), (max(jcfg.m_values), k),
            dtype=jnp.float32)))
    pcfg = convert.llc_config_from_ref(dataclasses.asdict(jcfg))
    pcons, ppooled, _, _ = lp.llc_kbdm_fit(
        torch.as_tensor(sigs).to(torch.complex64), DWELL, pcfg, omega=omega)
    top = slice(0, 16)
    return dict(sigs=sigs, truths=truths, jcfg=jcfg, pcfg=pcfg, omega=omega,
                jcons=tuple(np.array(x)[:, top] for x in jcons),
                pcons=tuple(x.numpy()[:, top] for x in pcons),
                jpooled=tuple(np.array(x) for x in jpooled),
                ppooled=tuple(x.numpy() for x in ppooled))


def test_p56_line_counts_match_jax_given_its_sketch():
    """At p=56 the port, given the JAX package's Gaussian sketch, refines
    as many lines as the JAX package on the two north-star voxels where its
    own sketch forms a sixth, noise line (2005 and 534): five each.  The
    sixth line comes from the sketch's draw (jax.random and torch draw
    other numbers from one seed), not from the port's arithmetic; the JAX
    package's CPU path runs other factorizations (Lowdin orthogonalization,
    eigh-based Takagi), so only the count is compared."""
    fit = _p56_fits(P56_VOXELS[:2], "jax")
    jcount = (fit["jcons"][4] > 0.5).sum(-1)
    pcount = (fit["pcons"][4] > 0.5).sum(-1)
    assert jcount.tolist() == [5, 5]
    np.testing.assert_array_equal(pcount, jcount)


def _near(pooled, i, f0) -> int:
    """Pooled sweep lines of voxel i that are valid and within 1 Hz of f0."""
    return int(((np.abs(pooled[2][i] - f0) < 1.0) & (pooled[4][i] > 0.5))
               .sum())


@pytest.mark.slow
def test_p56_against_jax_record(capsys):
    """The record of the p=56 comparison (PERF.md section 7).  For each of
    P56_VOXELS: the refined line count and the 1e-8 gate error (against the
    float64 oracle's 20-iteration polish from the same consolidated lines)
    after 6 and 20 GN iterations, of the JAX package and of the port with
    its own sketch and with the JAX package's.  Then where the two part:
    the Takagi singular values of the projected Hankel (the `takagi` stage)
    relative to the largest, and, for each sixth line of the port, the
    sweep lines (of 35 entries) within 1 Hz of it in each fit.  Printed;
    asserted: the JAX package takes five lines on every voxel, the port
    given its sketch as many, and 20 iterations meet the gate everywhere."""
    from llckbdm_tpu.ops.cplx import CArr
    from llckbdm_tpu_torch.tools import five_peak

    rows, fits = {}, {}
    for name, omega in (("port, own sketch", None),
                        ("port, JAX sketch", "jax")):
        fit = fits[name] = _p56_fits(P56_VOXELS, omega)
        sigs, truths = fit["sigs"], fit["truths"]
        for who, cons in (("jax", fit["jcons"]), (name, fit["pcons"])):
            if who in rows:
                continue
            rows[who] = {}
            for iters in (6, 20):
                if who == "jax":
                    ref = lt.refine_lines(
                        D.dfc_from_np(sigs),
                        lt.LineList(*map(jnp.asarray, cons)), DWELL,
                        lt.RefineConfig(iters=iters))
                    est_of = lambda i, ref=ref: lt.refined_to_np(
                        jax.tree.map(lambda x: x[i], ref), DWELL)
                else:
                    ref = lp.refine_lines(
                        torch.as_tensor(sigs),
                        lp.LineList(*map(torch.as_tensor, cons)), DWELL,
                        lp.RefineConfig(iters=iters))
                    est_of = lambda i, ref=ref: lp.refined_to_np(
                        ref._replace(z=ref.z[i], d=ref.d[i],
                                     mask=ref.mask[i]), DWELL)
                for i, v in enumerate(P56_VOXELS):
                    init = lp.line_list_to_np(lp.LineList(
                        *(torch.as_tensor(x[i]) for x in cons)))
                    est = est_of(i)
                    err = five_peak.gate_error(est, init, sigs[i], truths[i])
                    rows[who].setdefault(v, {})[iters] = (len(est), err)
    with capsys.disabled():
        print("\np=56 | voxel | lines, gate at 6 GN iterations | at 20")
        for who, per in rows.items():
            for v, r in per.items():
                print(f"{who} | {v} | {r[6][0]}, {r[6][1]:.3e} | "
                      f"{r[20][0]}, {r[20][1]:.3e}")

        own, given = fits["port, own sketch"], fits["port, JAX sketch"]
        jcfg, sigs = own["jcfg"], own["sigs"]
        c = CArr(jnp.asarray(sigs.real, jnp.float32),
                 jnp.asarray(sigs.imag, jnp.float32))
        _, jsig = jax.jit(lambda x: lt.kbdm_sweep(
            x, DWELL, jcfg.m_values, jcfg.kbdm, _stop="takagi"))(c)
        jsig = np.asarray(jsig)[..., :jcfg.kbdm.p]
        for name, fit in (("own", own), ("JAX", given)):
            _, psig = lp.kbdm_sweep(
                torch.as_tensor(sigs).to(torch.complex64), DWELL,
                jcfg.m_values, fit["pcfg"].kbdm, _stop="takagi",
                omega=fit["omega"])
            rel = (np.abs(psig.numpy()[..., :jcfg.kbdm.p] - jsig)
                   / jsig[..., :1])
            print(f"takagi: the port's singular values ({name} sketch) "
                  f"against the JAX package's, max |ds| / s_max {rel.max():.3e}"
                  f" (top five {rel[..., :5].max():.3e})")
        for i, v in enumerate(P56_VOXELS):
            f = own["pcons"][2][i][own["pcons"][4][i] > 0.5]
            truth = own["truths"][i][:, 2]
            extra = [x for x in f if np.abs(truth - x).min() > 1.0]
            for f6 in extra:
                print(f"voxel {v}, the port's sixth line at {f6:.2f} Hz: "
                      f"sweep lines within 1 Hz: JAX "
                      f"{_near(own['jpooled'], i, f6)}, port (own sketch) "
                      f"{_near(own['ppooled'], i, f6)}, port (JAX sketch) "
                      f"{_near(given['ppooled'], i, f6)}; min_samples "
                      f"{jcfg.min_samples}")
    for v in P56_VOXELS:
        assert rows["jax"][v][6][0] == 5
        assert rows["port, JAX sketch"][v][6][0] == 5
        for who in rows:
            assert rows[who][v][20][1] < 1e-8, (who, v)


@pytest.mark.slow
def test_p56_against_jax_tpu_path_record(capsys, monkeypatch):
    """The p=56 comparison again, now with the JAX package's TPU path (run
    on the CPU: force_backend("tpu"), its Pallas kernels interpreted), the
    algorithm the port ports (PERF.md sections 6-7, ROADMAP.md section 3).

    1. On voxels 2005 and 534 at p = 24, 32 and 56, stage by stage, the
       port given the JAX package's sketch against the TPU path, on both
       branches: bfloat16 (the port's branch taken on CPU tensors) and
       float32 (the port's power-iteration shift set to the JAX package's
       3e-6, so both run one algorithm).  Printed: the powiter blocks'
       largest principal angle, the Takagi singular values' gap relative
       to the largest, the Jacobi counter, and the sweep entries (of 70)
       that hold a valid line within 1 Hz of each of the five true ones.
       Asserted: the singular values agree to float32 rounding (3e-5 of
       the largest: k eps = 7.6e-6 at k=64 with a margin of 4; the JAX
       package's CPU path was 8.6e-5 away at p=56).
    2. How often the port's own path on the CPU (float32, shift 1e-4)
       refines a sixth line on the two voxels at p=56 over 8 sketches: its
       own draws (seeds 0-7) and the JAX package's (PRNGKey 0-7).
       Printed."""
    import functools

    from llckbdm_tpu.ops import jacobi, pallas_jacobi, pallas_linalg
    from llckbdm_tpu.ops.cplx import CArr
    from llckbdm_tpu_torch.solver import kbdm as K
    from llckbdm_tpu_torch.tools import five_peak
    from torch_precision_checks import largest_angle

    voxels = P56_VOXELS[:2]
    sigs, truths = five_peak.signals(2048, 1e-4)
    sigs, truths = sigs[list(voxels)], truths[list(voxels)]
    m_values = five_peak.M_VALUES
    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))
    ct = torch.as_tensor(sigs).to(torch.complex64)

    def jax_omega(seed, k):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), (max(m_values), k), jnp.float32)))

    def five_lines(f, mask):
        """Sweep entries with a valid line within 1 Hz of each true one."""
        near = ((np.abs(f[..., None, :] - truths[:, None, :, 2, None]) < 1.0)
                & (mask[..., None, :] > 0.5))
        return int(near.any(-1).all(-1).sum())

    rows = []
    with monkeypatch.context() as mp:
        for mod, names in ((pallas_linalg, ("cholqr_rinv", "gram_svd",
                                            "chol_solve")),
                           (pallas_jacobi, ("eig_cs", "eig_cs_resid"))):
            for name in names:
                mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                        interpret=True))
        mp.setattr(K, "bf16_power_iterations",
                   lambda c, cfg: cfg.subspace_bf16)
        mp.setattr(K, "F32_POWITER_SHIFT", 3e-6)
        for p in (24, 32, 56):
            for bf16 in (True, False):
                jcfg = lt.KbdmConfig(p=p, subspace_bf16=bf16)
                pcfg = convert.kbdm_config_from_ref(dataclasses.asdict(jcfg))
                om = jax_omega(jcfg.seed, jcfg.p + jcfg.oversample)
                with jacobi.force_backend("tpu"):
                    def sweep(stop=None, diag=False):
                        return jax.jit(lambda x: lt.kbdm_sweep(
                            x, DWELL, m_values, jcfg, with_diag=diag,
                            _stop=stop))(c)
                    jy = sweep("powiter")
                    _, jsig = sweep("takagi")
                    jlines, jdiag = sweep(diag=True)
                py = lp.kbdm_sweep(ct, DWELL, m_values, pcfg,
                                   _stop="powiter", omega=om)
                _, psig = lp.kbdm_sweep(ct, DWELL, m_values, pcfg,
                                        _stop="takagi", omega=om)
                plines, pdiag = lp.kbdm_sweep(ct, DWELL, m_values, pcfg,
                                              with_diag=True, omega=om)
                angle = largest_angle(py.numpy(), np.asarray(jy.re)
                                      + 1j * np.asarray(jy.im))
                jsig = np.asarray(jsig)[..., :p]
                gap = (np.abs(psig.numpy()[..., :p] - jsig)
                       / jsig[..., :1]).max()
                rows.append((
                    p, bf16, angle, gap,
                    float(np.asarray(jdiag["eig_offdiag_rel"]).max()),
                    pdiag["eig_offdiag_rel"].max().item(),
                    five_lines(np.asarray(jlines.frequency),
                               np.asarray(jlines.mask)),
                    five_lines(plines.frequency.numpy(),
                               plines.mask.numpy())))

    cfg = five_peak.north_star_config(lp.KbdmConfig(p=56))
    sixth = {}
    for who in ("own", "jax"):
        for seed in range(8):
            kcfg = lp.KbdmConfig(p=56, seed=seed)
            om = jax_omega(seed, 64) if who == "jax" else None
            cons, _, _, _ = lp.llc_kbdm_fit(
                ct, DWELL, dataclasses.replace(cfg, kbdm=kcfg), omega=om)
            n = (cons.mask[:, :16] > 0.5).sum(-1)
            sixth[(who, seed)] = [i for i, x in zip(voxels, n.tolist())
                                  if x > 5]
    with capsys.disabled():
        print("\nvoxels 2005 and 534, the port given the JAX package's "
              "sketch against its TPU path (CPU, interpreted):")
        print("p | branch | powiter angle | takagi gap / s_max | counter "
              "JAX, port | entries with the five lines (of 70) JAX, port")
        for p, bf16, angle, gap, jc, pc, jl, pl in rows:
            print(f"{p} | {'bf16' if bf16 else 'f32 (3e-6)'} | {angle:.3e} | "
                  f"{gap:.3e} | {jc:.3e}, {pc:.3e} | {jl}, {pl}")
        for who in ("own", "jax"):
            hits = sum(len(sixth[(who, s)]) for s in range(8))
            print(f"p=56, the port's float32 path (1e-4), {who} sketches, "
                  f"seeds 0-7: a sixth refined line on {hits} of 16 (voxel, "
                  f"seed) pairs: {[sixth[(who, s)] for s in range(8)]}")
    for p, bf16, angle, gap, *_ in rows:
        assert gap < 3e-5, (p, bf16, gap)
