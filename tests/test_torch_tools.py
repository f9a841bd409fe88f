"""The port's two tool kernels: plain versions against the Pallas tool
kernels in interpret mode.

``tools/`` is not a package, so ``tools/pallas_smoke.py`` and
``tools/bench_eigh_variants.py`` are loaded by file path, and their
``pl.pallas_call`` is built here as their ``run`` builds it, with
``interpret=True``.  Inputs are the tools' own, made with numpy from their
seeds in the TPU's lane layout (n, n, B) and handed to the port batch first.
The CUDA kernels are held against the plain versions on a GPU by
tests/test_torch_cuda.py.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from llckbdm_tpu_torch.convert import batch_from_lanes, batch_to_lanes
from llckbdm_tpu_torch.ops import cuda_probes
from llckbdm_tpu_torch.tools import bench_eigh_variants, kernel_smoke

torch.set_num_threads(1)
TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"

def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_smoke = _load_tool("pallas_smoke")
jax_bench = _load_tool("bench_eigh_variants")


def _pallas_row_probe(sched, a):
    """tools/pallas_smoke.py::run's pallas_call, in interpret mode."""
    fn = pl.pallas_call(
        pallas_smoke.kernel,
        out_shape=jax.ShapeDtypeStruct(a.shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(sched), jnp.asarray(a)))


def _lane_inputs(n, b):
    """tools/bench_eigh_variants.py::run's inputs, (n, n, b) real and
    imaginary planes."""
    a = np.random.default_rng(0).standard_normal((n, n, b)).astype(np.float32)
    a = a + np.swapaxes(a, 0, 1)
    ai = np.random.default_rng(1).standard_normal((n, n, b)).astype(np.float32)
    ai = ai - np.swapaxes(ai, 0, 1)
    return a, ai


def _pallas_eigh_probe(a, ai, sweeps, **switches):
    """tools/bench_eigh_variants.py::run's pallas_call (one block of all b
    matrices), in interpret mode; returns w in the lane layout (n, b)."""
    n, b = a.shape[0], a.shape[-1]
    spec = pl.BlockSpec((n, n, b), lambda g: (0, 0, g), memory_space=pltpu.VMEM)
    wspec = pl.BlockSpec((n, b), lambda g: (0, g), memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        jax_bench.make_kernel(n, sweeps, **switches),
        grid=(1,),
        out_shape=jax.ShapeDtypeStruct((n, b), jnp.float32),
        in_specs=[spec, spec],
        out_specs=wspec,
        scratch_shapes=[pltpu.VMEM((n, n, b), jnp.float32)] * 4,
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(a), jnp.asarray(ai)))


@pytest.mark.parametrize("sched_fn", [kernel_smoke.schedule,
                                      kernel_smoke.self_paired_schedule],
                         ids=["tool", "self-paired"])
def test_row_probe_plain_matches_pallas(sched_fn):
    n, b, steps = 24, 256, 16
    sched = sched_fn(n, steps)
    assert (sched[:, 0] == sched[:, 1]).any() == (sched_fn is not kernel_smoke.schedule)
    a = np.random.default_rng(0).standard_normal((n, n, b)).astype(np.float32)
    want = _pallas_row_probe(sched, a)
    got = cuda_probes.row_probe(torch.from_numpy(sched), batch_from_lanes(a))
    assert got.shape == (b, n, n)
    np.testing.assert_allclose(batch_to_lanes(got), want, rtol=0, atol=1e-5)
    # and the tool's numpy loop, which the port's tool asserts against
    np.testing.assert_allclose(want, kernel_smoke.reference(sched, a),
                               rtol=0, atol=1e-5)


def test_row_probe_rejects_bad_schedules():
    a = torch.zeros(2, 5, 5)
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        cuda_probes.row_probe(torch.tensor([[0, 5]], dtype=torch.int32), a)
    with pytest.raises(ValueError, match="int32"):
        cuda_probes.row_probe(torch.tensor([[0, 1]]), a)
    with pytest.raises(ValueError, match="at most"):
        cuda_probes.row_probe(torch.zeros(cuda_probes.MAX_STEPS + 1, 2,
                                          dtype=torch.int32), a)
    # the schedule is read on the host: one on any other device is refused
    # before anything runs (tests/test_torch_cuda.py refuses a CUDA one)
    off_host = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    for fn in (cuda_probes.row_probe, cuda_probes.row_probe_plain):
        with pytest.raises(ValueError, match="read on the host"):
            fn(off_host, a)


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("sched_fn", [kernel_smoke.schedule,
                                      kernel_smoke.self_paired_schedule],
                         ids=["tool", "self-paired"])
def test_row_probe_host_schedule_matches_the_tool_loop(n, sched_fn):
    """The schedule from the host, at the kernel's widths up to its new
    limit: the plain version gives the tool's numpy loop, and the wrapper
    leaves the caller's schedule as it was."""
    b, steps = 8, 33
    sched = sched_fn(n, steps)
    a = np.random.default_rng(n).standard_normal((n, n, b)).astype(np.float32)
    st = torch.from_numpy(sched.copy())
    got = cuda_probes.row_probe(st, batch_from_lanes(a))
    np.testing.assert_allclose(batch_to_lanes(got),
                               kernel_smoke.reference(sched, a), rtol=0,
                               atol=1e-5)
    assert st.device.type == "cpu" and np.array_equal(st.numpy(), sched)


def test_tool_entry_points():
    assert kernel_smoke.main(["--cpu"]) == 0
    if not torch.cuda.is_available():
        assert kernel_smoke.main([]) == 2
        assert bench_eigh_variants.main() == 2
    # the six runs of the TPU tool, then the switch setting they leave out
    assert list(bench_eigh_variants.RUNS) == [
        "coef", "rows", "rows+cols", "full", "full sweeps=1",
        "full per_block=2", "rows+v"]


def test_bench_chol_needs_a_gpu_and_covers_every_compiled_size():
    from llckbdm_tpu_torch.ops import cuda_linalg
    from llckbdm_tpu_torch.tools import bench_chol
    if not torch.cuda.is_available():
        assert bench_chol.main() == 2
    # the main path's shapes and a size that is padded up, within the limits
    sizes = {name: {k for _, k in shapes}
             for name, shapes in bench_chol.SHAPES.items()}
    assert {16, 24, 32, 48, 64, 20, 40} <= sizes["cholqr_rinv"]
    assert max(sizes["cholqr_rinv"]) <= cuda_linalg.MAX_K
    assert {16, 32, 48, 64, 40} <= sizes["chol_solve"]
    assert max(sizes["chol_solve"]) <= cuda_linalg.MAX_K_SOLVE
    for kernel, k in (("gram_svd", 24), ("cholqr_rinv", 65), ("chol_solve", 0)):
        with pytest.raises(ValueError, match="chol_kernel_resources"):
            cuda_linalg.chol_kernel_resources(kernel, k)


@pytest.mark.parametrize("switches", list(cuda_probes.EIGH_VARIANTS.values()),
                         ids=list(cuda_probes.EIGH_VARIANTS))
@pytest.mark.parametrize("n", [4, 8])
def test_eigh_probe_plain_matches_pallas(n, switches):
    b = 128
    a, ai = _lane_inputs(n, b)
    want = _pallas_eigh_probe(a, ai, 1, **switches)
    z = a.astype(np.complex64)
    z.imag = ai
    got = cuda_probes.eigh_probe(batch_from_lanes(z), 1, **switches)
    assert got.w.shape == (b, n) and got.s_norm.shape == (b,)
    # One sweep keeps the chain short enough for elementwise parity; the
    # bound is 1e-4 max|A| (measured 1.6e-5 at max|w| ~ 7 against a numpy
    # f32 replica).
    err = np.abs(batch_to_lanes(got.w) - want).max()
    assert err <= 1e-4 * np.abs(z).max(), err


@pytest.mark.parametrize("switches", list(cuda_probes.EIGH_VARIANTS.values()),
                         ids=list(cuda_probes.EIGH_VARIANTS))
def test_eigh_probe_plain_invariants(switches):
    """At the tool's n and sweeps the chain is chaotic, but every row step is
    unitary: |V|_F = |A|_F, and |S|_F = |A|_F unless the columns are
    written (which does move it)."""
    a = bench_eigh_variants.make_inputs(24, 16)
    out = cuda_probes.eigh_probe(a, 8, **switches)
    assert bool(torch.isfinite(out.w).all())
    errs = bench_eigh_variants.invariant_errors(a, out, switches["do_rows"],
                                                switches["do_cols"])
    assert max(errs.values()) <= 1e-5, errs
    fro = torch.linalg.matrix_norm(a)
    moved = (out.s_norm / fro - 1).abs().max().item()
    if switches["do_rows"] and switches["do_cols"]:
        assert moved > 1e-2, moved
    if not switches["do_rows"]:
        # nothing rotates: w is A's real diagonal
        torch.testing.assert_close(out.w, torch.diagonal(a.real, dim1=-2, dim2=-1),
                                   rtol=0, atol=0)
    assert bool(torch.isfinite(out.coef_sum).all())


def test_eigh_probe_inputs_are_the_tools():
    n, b = 6, 1000
    a, ai = _lane_inputs(n, 1024)    # the tool pads to a multiple of 512
    got = bench_eigh_variants.make_inputs(n, b)
    assert got.dtype == torch.complex64 and got.shape == (b, n, n)
    np.testing.assert_array_equal(batch_to_lanes(got.real), a[..., :b])
    np.testing.assert_array_equal(batch_to_lanes(got.imag), ai[..., :b])


@pytest.mark.parametrize("n", [40, 64])
def test_eigh_probe_block_diagonal_inputs(n):
    """The wide parity inputs: Hermitian, zero exactly off their 4 x 4
    diagonal blocks, and one sweep of the plain probe keeps the invariants
    and a finite w in every variant."""
    a = bench_eigh_variants.make_block_diagonal(n, 3)
    blk = torch.arange(n) // 4
    off = blk[:, None] != blk[None, :]
    assert a.shape == (3, n, n) and a.dtype == torch.complex64
    assert torch.equal(a, a.conj().transpose(-1, -2))
    assert not bool(a[:, off].any()) and bool(a[:, ~off].all())
    for switches in cuda_probes.EIGH_VARIANTS.values():
        out = cuda_probes.eigh_probe_plain(a, 1, **switches)
        assert bool(torch.isfinite(out.w).all())
        errs = bench_eigh_variants.invariant_errors(
            a, out, switches["do_rows"], switches["do_cols"])
        assert max(errs.values()) <= 1e-5, errs


def test_eigh_probe_rejects_odd_n():
    a = bench_eigh_variants.make_inputs(8, 4)[:, :7, :7]
    with pytest.raises(ValueError, match="even n"):
        cuda_probes.eigh_probe(a, 1)
    with pytest.raises(ValueError, match="even n"):
        cuda_probes.eigh_probe_plain(a, 1)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("shape", [(24, 24, 256), (5, 3)])
def test_lane_layout_round_trip(shape, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(dtype)
    t = batch_from_lanes(x)
    assert t.shape == (shape[-1], *shape[:-1]) and t.is_contiguous()
    assert t.dtype == torch.from_numpy(x).dtype
    for b in (0, shape[-1] - 1):
        np.testing.assert_array_equal(t[b].numpy(), x[..., b])
    back = batch_to_lanes(t)
    assert back.flags.c_contiguous
    np.testing.assert_array_equal(back, x)
