"""The port's precision path against the JAX package's TPU path, on the CPU.

Until the port gained its bfloat16 power iterations it was held only
against the JAX package's CPU algorithms (Lowdin orthogonalization,
eigh-based Takagi and solve), which agree with it only to the float32
stage's tolerance.  Here the JAX package runs its TPU algorithms on the
CPU: ``jacobi.force_backend("tpu")`` takes its TPU branches (CholeskyQR,
the one-sided Jacobi SVD, the Cholesky solve, the bfloat16 power
iterations), and its five Pallas wrappers run with ``interpret=True``, as
its own kernel tests run them.  No file of the JAX package changes.

The port's bfloat16 branch runs on CUDA tensors only
(``solver.kbdm.bf16_power_iterations``); these tests patch that predicate
to take it on CPU tensors.  Both packages get the same signals and the JAX
package's sketch (``omega``).  The inputs are small: N=256, m = 48..80, p=8
(k=16), two voxels (noiseless and noise 1e-4).

(a) the bfloat16 branch's last power-iteration block against the JAX
    package's;
(b) the whole sweep and the LL-KBDM fit on the bfloat16 branch;
(c) the same on the float32 branch (subspace_bf16=False);
(d) mxu_precision="high", and where it reaches;
(e) subspace_bf16=True on a CPU tensor: the float32 branch, bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llckbdm_tpu as lt
import llckbdm_tpu_torch as lp
from llckbdm_tpu.ops import jacobi, pallas_jacobi, pallas_linalg
from llckbdm_tpu.ops.cplx import CArr
from llckbdm_tpu_torch import convert
from llckbdm_tpu_torch.solver import kbdm as K
from llckbdm_tpu_torch.tools import five_peak
from torch_precision_checks import (BF16_ULP, genuine, high_only_at_the_sites,
                                    hold_rows, largest_angle, logged_products)

torch.set_num_threads(1)
N, DWELL = 256, 5e-4
M_VALUES = (48, 56, 64, 72, 80)
JCFG = lt.LlcKbdmConfig(m_values=M_VALUES, eps=2e-4, min_samples=3,
                        max_clusters=8, kbdm=lt.KbdmConfig(p=8))


def _signals():
    """Voxel 0 noiseless, voxel 1 with complex noise 1e-4, both the
    config-1 lines with frequency jitter, at N=256."""
    rng = np.random.default_rng(9)
    truths = np.stack([five_peak.FIVE_PEAK.copy() for _ in range(2)])
    truths[:, :, 2] += rng.normal(scale=2.0, size=(2, 5))
    sigs = np.stack([lp.oracle.sample_signal(t, N, DWELL) for t in truths])
    sigs[1] += 1e-4 * (rng.standard_normal(N) + 1j * rng.standard_normal(N))
    return sigs, truths


SIGS, TRUTHS = _signals()


@pytest.fixture(scope="module")
def tpu_path():
    """The JAX package's TPU branches, its Pallas kernels interpreted."""
    with pytest.MonkeyPatch.context() as mp, jacobi.force_backend("tpu"):
        for mod, names in ((pallas_linalg, ("cholqr_rinv", "gram_svd",
                                            "chol_solve")),
                           (pallas_jacobi, ("eig_cs", "eig_cs_resid"))):
            for name in names:
                mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                        interpret=True))
        yield


@pytest.fixture
def bf16_on_cpu(monkeypatch):
    """The port's predicate, patched to take the bfloat16 branch on CPU
    tensors wherever cfg.subspace_bf16 asks for it."""
    monkeypatch.setattr(K, "bf16_power_iterations",
                        lambda c, cfg: cfg.subspace_bf16)


def _jcfg(**kbdm):
    return dataclasses.replace(JCFG, kbdm=dataclasses.replace(JCFG.kbdm,
                                                              **kbdm))


def _omega(jcfg):
    k = jcfg.kbdm.p + jcfg.kbdm.oversample
    return convert.sketch_from_np(np.asarray(jax.random.normal(
        jax.random.PRNGKey(jcfg.kbdm.seed), (max(M_VALUES), k),
        dtype=jnp.float32)))


def _jax_run(jcfg):
    """The JAX package's TPU path: the sweep's powiter block, its Takagi
    singular values, the sweep's lines and the LL-KBDM fit."""
    c = CArr(jnp.asarray(SIGS.real, jnp.float32),
             jnp.asarray(SIGS.imag, jnp.float32))

    def sweep(stop):
        return jax.jit(lambda x: lt.kbdm_sweep(x, DWELL, M_VALUES, jcfg.kbdm,
                                               _stop=stop))(c)

    y = sweep("powiter")
    _, sig = sweep("takagi")
    lines = sweep(None)
    cons, _, counts, _ = jax.jit(lambda x: lt.llc_kbdm_fit(x, DWELL,
                                                           jcfg))(c)
    return dict(powiter=np.asarray(y.re) + 1j * np.asarray(y.im),
                sig=np.asarray(sig),
                lines=tuple(np.asarray(x) for x in lines),
                cons=tuple(np.asarray(x) for x in cons),
                counts=np.asarray(counts))


def _port_run(jcfg):
    """The same quantities from the port on CPU tensors, given the JAX
    package's sketch."""
    cfg = convert.llc_config_from_ref(dataclasses.asdict(jcfg))
    c = torch.as_tensor(SIGS).to(torch.complex64)
    om = _omega(jcfg)

    def sweep(stop):
        return lp.kbdm_sweep(c, DWELL, M_VALUES, cfg.kbdm, _stop=stop,
                             omega=om)

    _, sig = sweep("takagi")
    cons, _, counts, _ = lp.llc_kbdm_fit(c, DWELL, cfg, omega=om)
    return dict(powiter=sweep("powiter").numpy(), sig=sig.numpy(),
                lines=tuple(x.numpy() for x in sweep(None)),
                cons=tuple(x.numpy() for x in cons), counts=counts.numpy(),
                cons_t=cons)


@pytest.fixture(scope="module")
def jax_bf16(tpu_path):
    return _jax_run(_jcfg(subspace_bf16=True))


@pytest.fixture(scope="module")
def jax_f32(tpu_path):
    return _jax_run(_jcfg(subspace_bf16=False))


def _genuine(lines, v, s):
    return genuine(lines, TRUTHS[v], v, s)


# The Takagi singular values, relative to the largest: float32 rounding of
# the projected Hankel (~k eps = 2e-6 at k=16), with a margin of 10.
SV_TOL = 2e-5


def _hold_sweep(port, ref):
    """The sweep's Takagi singular values (the first p, which the reduced
    stage keeps) within SV_TOL of the reference's relative to the largest;
    each entry's five genuine lines at the float32 stage's tolerances; the
    LL-KBDM fit's line counts (its cluster counts and valid slots) equal
    and its consolidated lines at the same tolerances."""
    p = JCFG.kbdm.p
    ds = np.abs(port["sig"][..., :p] - ref["sig"][..., :p])
    assert (ds / ref["sig"][..., :1]).max() < SV_TOL
    for v in range(2):
        for s in range(len(M_VALUES)):
            hold_rows(_genuine(port["lines"], v, s),
                      _genuine(ref["lines"], v, s))
    np.testing.assert_array_equal(port["counts"], ref["counts"])
    np.testing.assert_array_equal(port["cons"][4], ref["cons"][4])
    for v in range(2):
        live = ref["cons"][4][v] > 0.5
        hold_rows(np.stack([x[v][live] for x in port["cons"][:4]], -1),
                  np.stack([x[v][live] for x in ref["cons"][:4]], -1))


def _refined_gate(port) -> float:
    """The port's refinement of its own consolidated lines (6 GN
    iterations) against the float64 oracle's 20-iteration polish from the
    same lines: the largest error over both voxels."""
    cons = port["cons_t"]
    ref = lp.refine_lines(torch.as_tensor(SIGS), cons, DWELL,
                          lp.RefineConfig(iters=6))
    errs = []
    for v in range(2):
        init = lp.line_list_to_np(lp.LineList(*(x[v] for x in cons)))
        est = lp.refined_to_np(ref._replace(z=ref.z[v], d=ref.d[v],
                                            mask=ref.mask[v]), DWELL)
        errs.append(five_peak.gate_error(est, init, SIGS[v], TRUTHS[v]))
    return max(errs)


def test_bf16_powiter_block_matches_jax(jax_bf16, bf16_on_cpu):
    """(a) The last power-iteration block of the bfloat16 branch (upcast to
    complex64) against the JAX package's: the same bfloat16 roundings of
    the same float32-accumulated products, in another summation order, so
    the dominant five-line subspaces agree to well within one bfloat16
    step and the blocks in norm to a few."""
    port = lp.kbdm_sweep(torch.as_tensor(SIGS).to(torch.complex64), DWELL,
                         M_VALUES, convert.kbdm_config_from_ref(
                             dataclasses.asdict(_jcfg().kbdm)),
                         _stop="powiter", omega=_omega(_jcfg())).numpy()
    ref = jax_bf16["powiter"]
    angle = largest_angle(port, ref)
    print(f"bf16 powiter: largest principal angle {angle:.3e}, "
          f"norm {np.linalg.norm(port - ref) / np.linalg.norm(ref):.3e}")
    assert angle < BF16_ULP
    assert np.linalg.norm(port - ref) < 4 * BF16_ULP * np.linalg.norm(ref)


def test_bf16_sweep_and_fit_match_jax(jax_bf16, bf16_on_cpu):
    """(b) The whole sweep and the LL-KBDM fit on the bfloat16 branch
    against the JAX package's TPU path; the refined lines meet the 1e-8
    gate against the port's oracle."""
    port = _port_run(_jcfg(subspace_bf16=True))
    _hold_sweep(port, jax_bf16)
    assert _refined_gate(port) < 1e-8


def test_f32_sweep_and_fit_match_jax(jax_f32):
    """(c) The float32 branch (subspace_bf16=False; a CPU tensor's branch
    anyway) against the JAX package's float32 TPU branch."""
    port = _port_run(_jcfg(subspace_bf16=False))
    ds = np.abs(port["powiter"] - jax_f32["powiter"]).max()
    print(f"f32 powiter: max |dy| / max |y| "
          f"{ds / np.abs(jax_f32['powiter']).max():.3e}")
    _hold_sweep(port, jax_f32)
    assert _refined_gate(port) < 1e-8


def test_high_matches_jax_high(tpu_path):
    """(d) mxu_precision="high" against the JAX package's "high" on its
    TPU path.  On a CPU both compute in float32 (TF32 is a card's), so the
    port's lines are bit for bit its "highest" ones, and the two packages
    agree as at "highest"."""
    jcfg = _jcfg(subspace_bf16=False, mxu_precision="high")
    c = CArr(jnp.asarray(SIGS.real, jnp.float32),
             jnp.asarray(SIGS.imag, jnp.float32))
    _, sig = jax.jit(lambda x: lt.kbdm_sweep(x, DWELL, M_VALUES, jcfg.kbdm,
                                             _stop="takagi"))(c)
    lines = jax.jit(lambda x: lt.kbdm_sweep(x, DWELL, M_VALUES,
                                            jcfg.kbdm))(c)
    ref = dict(sig=np.asarray(sig), lines=tuple(np.asarray(x) for x in lines))
    cfg = convert.kbdm_config_from_ref(dataclasses.asdict(jcfg.kbdm))
    ct = torch.as_tensor(SIGS).to(torch.complex64)
    _, psig = lp.kbdm_sweep(ct, DWELL, M_VALUES, cfg, _stop="takagi",
                            omega=_omega(jcfg))
    plines = lp.kbdm_sweep(ct, DWELL, M_VALUES, cfg, omega=_omega(jcfg))
    highest = lp.kbdm_sweep(ct, DWELL, M_VALUES, dataclasses.replace(
        cfg, mxu_precision="highest"), omega=_omega(jcfg))
    for x, y in zip(plines, highest):
        assert torch.equal(x, y)
    p = cfg.p
    ds = np.abs(psig.numpy()[..., :p] - ref["sig"][..., :p])
    assert (ds / ref["sig"][..., :1]).max() < SV_TOL
    pl = tuple(x.numpy() for x in plines)
    for v in range(2):
        for s in range(len(M_VALUES)):
            hold_rows(_genuine(pl, v, s), _genuine(ref["lines"], v, s))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_high_reaches_only_the_jax_packages_sites(monkeypatch, bf16):
    """(d) Inside a "high" sweep, every matrix product of the JAX package's
    four mxu_precision sites (the float32 Hankel apply, the Gram and mix
    products, the correction row) runs at "high", and every other one
    (takagi_small, _poles_to_lines, the kernels' plain versions, the
    bfloat16 branch's Gram and mix) at "highest"; the caller's setting is
    restored after it.  tests/torch_precision_log.py logs each product
    with the precision it ran at."""
    monkeypatch.setattr(K, "bf16_power_iterations",
                        lambda c, cfg: cfg.subspace_bf16)
    cfg = lp.KbdmConfig(p=8, subspace_bf16=bf16, mxu_precision="high")
    c = torch.as_tensor(SIGS).to(torch.complex64)
    before = torch.get_float32_matmul_precision()
    with logged_products(monkeypatch) as log:
        lp.kbdm_sweep(c, DWELL, M_VALUES, cfg)
    assert torch.get_float32_matmul_precision() == before
    seen = {site for site, _, _ in log}
    assert {"site", "corr", "takagi", "lines"} <= seen, seen
    assert ("bf16 branch" in seen) == bf16
    assert not high_only_at_the_sites(log)


def test_bf16_setting_on_a_cpu_tensor_is_the_f32_branch():
    """(e) On a CPU tensor subspace_bf16=True (the default) takes the
    float32 branch, as the JAX package does on its CPU: the lines, bit for
    bit, of subspace_bf16=False.  Only a CUDA tensor takes the bfloat16
    branch."""
    c = torch.as_tensor(SIGS).to(torch.complex64)
    on, off = (lp.KbdmConfig(p=8, subspace_bf16=b) for b in (True, False))
    assert not K.bf16_power_iterations(c, on)
    cuda_like = type("CudaTensor", (), {"is_cuda": True})()
    assert K.bf16_power_iterations(cuda_like, on)
    assert not K.bf16_power_iterations(cuda_like, off)
    for x, y in zip(lp.kbdm_sweep(c, DWELL, M_VALUES, on),
                    lp.kbdm_sweep(c, DWELL, M_VALUES, off)):
        assert torch.equal(x, y)


def test_matmul_precision_takes_two_values():
    from llckbdm_tpu_torch.ops.linalg import matmul_precision

    before = torch.get_float32_matmul_precision()
    with matmul_precision("high"):
        assert torch.get_float32_matmul_precision() == "high"
        with matmul_precision():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError):
        with matmul_precision("medium"):
            pass


# The north-star voxels (tools.five_peak.signals(2048, 1e-4)) whose float32
# power iterations went non-finite on an NVIDIA H100 at the JAX package's
# 3e-6 shift (chip_smoke.py's f32_shift_record): why the port keeps 1e-4.
CARD_3E6_VOXELS = (
    5, 16, 82, 90, 97, 98, 124, 130, 177, 214, 308, 322, 344, 373, 400, 401,
    433, 440, 450, 469, 480, 496, 499, 566, 656, 705, 743, 764, 773, 802,
    819, 833, 909, 925, 944, 952, 1000, 1024, 1108, 1137, 1139, 1154, 1162,
    1174, 1193, 1195, 1223, 1257, 1264, 1273, 1324, 1327, 1394, 1402, 1439,
    1494, 1547, 1548, 1550, 1572, 1577, 1594, 1596, 1663, 1700, 1740, 1764,
    1783, 1846, 1850, 1853, 1859, 1922, 1939)


@pytest.mark.slow
def test_f32_shift_3e6_on_the_cpu_record(tpu_path, monkeypatch, capsys):
    """Those voxels on the CPU at the north star's shape: the port's
    float32 power iterations at 3e-6 with its own sketch and with the JAX
    package's, and the JAX package's TPU path (its float32 branch at 3e-6,
    its bfloat16 branch at 1e-4).  Printed: how many voxels go non-finite
    in each.  Asserted: none does (on the CPU neither package breaks down
    there; the card's float32 sums and Cholesky do)."""
    sigs, _ = five_peak.signals(2048, 1e-4)
    sigs = sigs[list(CARD_3E6_VOXELS)]
    m_values = five_peak.M_VALUES

    def bad(y):
        return int((~np.isfinite(y).reshape(y.shape[0], -1).all(-1)).sum())

    monkeypatch.setattr(K, "F32_POWITER_SHIFT", 3e-6)
    cfg = lp.KbdmConfig(p=16, subspace_bf16=False)
    ct = torch.as_tensor(sigs).to(torch.complex64)
    om = convert.sketch_from_np(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (max(m_values), 24), dtype=jnp.float32)))
    counts = {
        "port, own sketch": bad(lp.kbdm_sweep(
            ct, 5e-4, m_values, cfg, _stop="powiter").numpy()),
        "port, JAX sketch": bad(lp.kbdm_sweep(
            ct, 5e-4, m_values, cfg, _stop="powiter", omega=om).numpy())}
    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))
    for bf16 in (False, True):
        jcfg = lt.KbdmConfig(p=16, subspace_bf16=bf16)
        y = jax.jit(lambda x: lt.kbdm_sweep(x, 5e-4, m_values, jcfg,
                                            _stop="powiter"))(c)
        counts[f"JAX TPU path, {'bf16' if bf16 else 'f32 (3e-6)'}"] = bad(
            np.asarray(y.re))
    with capsys.disabled():
        print(f"\n{len(CARD_3E6_VOXELS)} voxels non-finite on the card at "
              f"3e-6; on the CPU: {counts}")
    assert not any(counts.values()), counts
