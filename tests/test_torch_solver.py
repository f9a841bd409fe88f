"""The PyTorch port's KBDM solver at config 1, against JAX and the oracle.

Both packages get the same inputs: the config-1 signal from the oracle and
the JAX solver's Gaussian sketch (``jax.random.normal``, which torch cannot
reproduce), carried across by llckbdm_tpu_torch.convert.  The JAX package's
CPU path runs other algorithms than its TPU path (Lowner orthogonalization,
eigh-based Takagi and solve) while the port runs the TPU algorithms, so the
two agree to the f32 stage's tolerance, not to rounding.
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
from llckbdm_tpu_torch import convert
from llckbdm_tpu_torch.ops.powers import cpow_fixed, cpowers

torch.set_num_threads(1)
CFG = lt.KbdmConfig(p=16)
TCFG = convert.kbdm_config_from_ref(dataclasses.asdict(CFG))
K = CFG.p + CFG.oversample


def _sketch(m_max):
    """The JAX solver's sketch for CFG, as the port's omega."""
    om = jax.random.normal(jax.random.PRNGKey(CFG.seed), (m_max, K),
                           dtype=jnp.float32)
    return convert.sketch_from_np(np.asarray(om))


def _c64(sig):
    return torch.as_tensor(np.asarray(sig)).to(torch.complex64)


@pytest.fixture(scope="module")
def jax_config1(five_peak_signal):
    sig, dwell = five_peak_signal
    return lt.line_list_to_np(lt.kbdm_fit(from_np(sig), dwell, 180, CFG))


def test_kbdm_fit_config1(five_peak_signal, five_peak_params, jax_config1):
    sig, dwell = five_peak_signal
    lines = lp.kbdm_fit(_c64(sig), dwell, 180, TCFG, omega=_sketch(180))
    est = lp.line_list_to_np(lines)
    assert len(est) == 5
    # f32 front end vs truth: the tolerances of tests/test_solver.py
    sel = oracle.match_lines(est, five_peak_params)
    np.testing.assert_allclose(est[sel, 2], five_peak_params[:, 2],
                               rtol=5e-3, atol=0.5)
    np.testing.assert_allclose(est[sel, 0], five_peak_params[:, 0], rtol=0.1)
    # vs JAX kbdm_fit: the same f32-stage tolerances (other algorithms on
    # the JAX CPU path, see the module docstring)
    assert len(jax_config1) == 5
    jsel = oracle.match_lines(jax_config1, five_peak_params)
    np.testing.assert_allclose(est[sel, 2], jax_config1[jsel, 2],
                               rtol=5e-3, atol=0.5)
    np.testing.assert_allclose(est[sel, 0], jax_config1[jsel, 0], rtol=0.1)
    np.testing.assert_allclose(est[sel, 1], jax_config1[jsel, 1], rtol=0.05)


def test_kbdm_fit_batched_matches_single(five_peak_signal):
    sig, dwell = five_peak_signal
    single = lp.kbdm_fit(_c64(sig), dwell, 128, TCFG, omega=_sketch(128))
    batch = lp.kbdm_fit(_c64(np.stack([sig, sig])), dwell, 128, TCFG,
                        omega=_sketch(128))
    for b in range(2):
        np.testing.assert_array_equal(batch.mask[b].numpy(),
                                      single.mask.numpy())
        np.testing.assert_allclose(batch.frequency[b].numpy(),
                                   single.frequency.numpy(), rtol=1e-4,
                                   atol=1e-3)


def test_kbdm_sweep_diag_convergence_counter(five_peak_signal):
    sig, dwell = five_peak_signal
    m_values = (120, 160, 200)
    lines, diag = lp.kbdm_sweep(_c64(sig), dwell, m_values, TCFG,
                                with_diag=True, omega=_sketch(200))
    off = diag["eig_offdiag_rel"].numpy()
    assert off.shape == (3,)
    assert (off < 1e-3).all(), off
    assert lines.amplitude.shape == (3, CFG.p)
    for s in range(3):
        assert int((lines.mask[s] > 0.5).sum()) >= 5
    plain = lp.kbdm_sweep(_c64(sig), dwell, m_values, TCFG, omega=_sketch(200))
    np.testing.assert_allclose(lines.frequency.numpy(),
                               plain.frequency.numpy(), atol=1e-6)


def test_kbdm_sweep_default_sketch_is_seeded(five_peak_signal):
    """Without omega the sketch comes from a generator seeded with
    cfg.seed: the same seed gives the same lines."""
    sig, dwell = five_peak_signal
    a = lp.kbdm_fit(_c64(sig), dwell, 128, TCFG)
    b = lp.kbdm_fit(_c64(sig), dwell, 128, TCFG)
    np.testing.assert_array_equal(a.frequency.numpy(), b.frequency.numpy())
    assert len(lp.line_list_to_np(a)) == 5


def test_kbdm_sweep_default_sketch_is_drawn_on_the_host(five_peak_signal):
    """Without omega the sketch is the draw of a CPU generator seeded with
    cfg.seed, copied to the signal's device: one seed gives one sketch on
    every device (tests/test_torch_cuda.py holds the card to the same)."""
    sig, dwell = five_peak_signal
    om = torch.randn((128, K), dtype=torch.float32,
                     generator=torch.Generator().manual_seed(TCFG.seed))
    a = lp.kbdm_fit(_c64(sig), dwell, 128, TCFG)
    b = lp.kbdm_fit(_c64(sig), dwell, 128, TCFG, omega=om)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kbdm_sweep_rejects_bad_input():
    with pytest.raises(ValueError):
        lp.kbdm_sweep(torch.zeros(100, dtype=torch.complex64), 1e-3, (64,),
                      TCFG)
    with pytest.raises(ValueError):
        lp.kbdm_sweep(torch.zeros(512, dtype=torch.complex64), 1e-3, (64,),
                      dataclasses.replace(TCFG, mxu_precision="medium"))
    with pytest.raises(TypeError):
        lp.kbdm_sweep(torch.zeros(512, dtype=torch.complex128), 1e-3, (64,),
                      TCFG)


def test_config_conversion_round_trips_every_field():
    ref = lt.KbdmConfig(p=12, oversample=6, seed=3, eig_sweeps=9)
    assert dataclasses.asdict(convert.kbdm_config_from_ref(
        dataclasses.asdict(ref))) == dataclasses.asdict(ref)
    with pytest.raises(TypeError):
        convert.kbdm_config_from_ref({"p": 4, "unknown": 1})


def test_power_helpers_match_numpy():
    rng = np.random.default_rng(0)
    z = (rng.uniform(0.9, 1.0, 7) * np.exp(1j * rng.uniform(-3, 3, 7)))
    zt = torch.as_tensor(z)
    for n in (0, 1, 5, 128, 511):
        np.testing.assert_allclose(cpow_fixed(zt, n).numpy(), z ** n,
                                   rtol=1e-12)
    np.testing.assert_allclose(cpowers(zt, 300).numpy(),
                               z[:, None] ** np.arange(300), rtol=1e-12)
    with pytest.raises(ValueError):
        cpow_fixed(zt, -1)
