"""The port's entry points (llckbdm_tpu_torch.entry) against the JAX
package's ``__graft_entry__.py``, on the CPU.

``entry(device="cpu")`` hands out the JAX entry's signal bit for bit and the
config-1 kbdm_fit step; ``dryrun_multichip(4, device="cpu")`` spawns four
gloo ranks (mesh data=2 x time=2, file:// rendezvous) and runs one
fit_and_refine_grid step, held against the single-process fit_grid +
refine_grid of the same input.
"""
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from llckbdm_tpu_torch import entry as tentry
from llckbdm_tpu_torch.parallel import fit_grid, refine_grid
from llckbdm_tpu_torch.solver.kbdm import KbdmConfig, kbdm_fit

torch.set_num_threads(1)


def test_entry_args_are_the_jax_entrys_bit_for_bit():
    fn, (c,) = tentry.entry(device="cpu")
    _, (re, im) = graft.entry()
    assert c.shape == (512,) and c.dtype == torch.complex64
    assert c.device.type == "cpu"
    np.testing.assert_array_equal(c.real.numpy(), np.asarray(re))
    np.testing.assert_array_equal(c.imag.numpy(), np.asarray(im))


def test_entry_fn_is_the_config1_kbdm_fit():
    fn, args = tentry.entry(device="cpu")
    out = fn(*args)
    want = kbdm_fit(args[0], 5e-4, 180, KbdmConfig(p=16))
    assert out.amplitude.shape == (16,)
    for got, ref in zip(out, want):
        assert torch.equal(got, ref)


def test_entry_defaults_to_the_card():
    """The default device is CUDA: without a card it raises and the command
    exits 2; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(2)
    assert tentry.main([]) == 2
    assert tentry.main(["dryrun", "2"]) == 2


@pytest.mark.parametrize("n,axes", [(1, {"data": 1, "time": 1}),
                                    (3, {"data": 3, "time": 1}),
                                    (4, {"data": 2, "time": 2}),
                                    (8, {"data": 4, "time": 2})])
def test_mesh_axes_are_the_jax_entrys(n, axes):
    assert tentry.mesh_axes(n) == axes


def test_dryrun_multichip_four_cpu_ranks():
    """The dry run's grid against fit_grid + refine_grid in one process:
    cluster counts and masks exact; z and d within tests/test_torch_parallel
    .py's bounds (5e-9, 5e-8) plus the float32 rounding of one unconverged
    Gauss-Newton step.  The dry run takes a single step on Gaussian-noise
    signals (the JAX entry's), and that step is solved in float32 from
    normal equations that the time-sharded refine sums in another order (in
    float64 over the two time blocks, rounded once): 1e-4 of the step in z
    (measured 1.7e-5) and 1e-5 of |d| in d (measured 2.5e-6)."""
    res = tentry.dryrun_multichip(4, device="cpu")
    cfg, rcfg = tentry.dryrun_config()
    v = 4
    assert res["mesh"] == {"data": 2, "time": 2} and res["backend"] == "gloo"
    assert res["z"].shape == (v, cfg.max_clusters)
    assert res["z"].dtype == np.complex128
    sigs = tentry.dryrun_signals(v)
    cons, _, counts, _ = fit_grid(torch.as_tensor(sigs).to(torch.complex64),
                                  tentry.DWELL, cfg)
    want = refine_grid(torch.as_tensor(sigs), cons, tentry.DWELL, rcfg)
    np.testing.assert_array_equal(res["counts"], counts.numpy())
    np.testing.assert_array_equal(res["mask"], want.mask.numpy())
    step = want.gn_step.numpy()
    assert (np.abs(res["z"] - want.z.numpy()) <= 5e-9 + 1e-4 * step).all()
    d = want.d.numpy()
    assert (np.abs(res["d"] - d) <= 5e-8 + 1e-5 * np.abs(d)).all()
    assert want.mask.numpy().sum() >= 1          # a line was refined
    # CPU ranks launch no kernel and run no plain version on a CUDA tensor
    assert len(res["launches"]) == 4
    assert not any(sum(p.values()) for p in res["plain"])
