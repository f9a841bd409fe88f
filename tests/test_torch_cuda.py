"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports no JAX, so it also runs on a GPU machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py sets JAX up.)  Inputs are made
with numpy from a seed; each kernel runs at the main path's size and at an
odd size, which the wrappers pad or the kernel takes as it is (the eigh
probe, which pairs only even n, raises instead).
"""
import json
import re

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import torch_grid_worker as worker
from llckbdm_tpu_torch import bench
from llckbdm_tpu_torch.ops import (_build, cuda_jacobi, cuda_linalg,
                                   cuda_probes, dbscan)
from llckbdm_tpu_torch.parallel import GridRunner
from llckbdm_tpu_torch.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu_torch.signals import LineList, line_list_from_np, sample_signal
from llckbdm_tpu_torch.solver import kbdm as sweep_mod
from llckbdm_tpu_torch.solver.kbdm import KbdmConfig, kbdm_sweep
from llckbdm_tpu_torch.solver.refine import RefineConfig, refine_lines
from llckbdm_tpu_torch.tools import bench_eigh_variants, five_peak, kernel_smoke
from llckbdm_tpu_torch.tools.normal_checks import normal_errors, normal_inputs
from torch_precision_checks import (BF16_ULP, genuine, high_only_at_the_sites,
                                    hold_rows, largest_angle, logged_products)

CFG = KbdmConfig()
K = CFG.p + CFG.oversample


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_counts()
    return torch.device("cuda")


def _cs_matrices(rng, b, n):
    """Complex-symmetric A = Q D Q^T with well-separated eigenvalues (the
    generator of tests/test_pallas_kernels.py)."""
    grid = (np.arange(n) + rng.uniform(0.1, 0.9, (b, n))) / n * 0.8 - 0.4
    evals = np.exp(2j * np.pi * grid - rng.uniform(0.02, 0.3, (b, n)))
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    a = np.einsum("bij,bj,bkj->bik", q, evals, q)
    return a.astype(np.complex64)


def _reduced(cuda, p, voxels=8, oversample=8):
    """Production reduced matrices of the KBDM sweep at rank p on the card:
    chip_smoke's noisy config-1 signals (N=512), m = 120..256 step 8, on
    the float32 power iterations (subspace_bf16=False).  Past p=16 the
    card's default, the bfloat16 branch, leaves these matrices unconverged
    in ten sweeps, as the JAX package's own accelerator algorithm does
    (ROADMAP.md section 3), and a kernel is compared where both versions
    converge."""
    rng = np.random.default_rng(p)
    base = np.array([[1.0, 0.05, -120.0, 0.1], [0.8, 0.08, -40.0, 0.0],
                     [1.2, 0.03, 15.0, -0.2], [0.5, 0.10, 90.0, 0.3],
                     [0.9, 0.06, 200.0, 0.0]])
    sigs = []
    for _ in range(voxels):
        lines = base + [[0, 0, x, 0] for x in rng.normal(scale=2.0, size=5)]
        sigs.append(sample_signal(line_list_from_np(lines), 512, DWELL).numpy()
                    + 1e-4 * (rng.standard_normal(512)
                              + 1j * rng.standard_normal(512)))
    c = torch.as_tensor(np.stack(sigs), device=cuda).to(torch.complex64)
    ut = kbdm_sweep(c, DWELL, tuple(range(120, 257, 8)),
                    KbdmConfig(p=p, oversample=oversample,
                               subspace_bf16=False), _stop="reduced")
    return ut.reshape(-1, p, p).contiguous()


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _grams(rng, b, k):
    """Well-conditioned y^H y, y (b, max(64, 2k), k)."""
    y = _crandn(rng, b, max(64, 2 * k), k)
    return np.einsum("bij,bik->bjk", y.conj(), y)


def _matched(x, y):
    """Per matrix, the largest distance of the optimal one-to-one matching
    of two unordered eigenvalue sets."""
    out = []
    for xb, yb in zip(x, y):
        cost = np.abs(xb[:, None] - yb[None, :])
        r, c = linear_sum_assignment(cost)
        out.append(cost[r, c].max())
    return np.array(out)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 15, 24, 40, 64])
def test_eig_cs_kernel_matches_plain(cuda, n):
    # n = 24 (config 2's p) and the wide n = 40 and 64 (two columns a lane)
    # on production reduced matrices: ten sweeps leave the synthetic family
    # unconverged in either version from n = 24 on.  n = 64 takes the sweep
    # at k = 64 (oversample 0), the widest the other kernels take.
    if n >= 24:
        a = _reduced(cuda, n, oversample=8 if n + 8 <= 64 else 64 - n)
    else:
        a = torch.from_numpy(_cs_matrices(np.random.default_rng(n), 128,
                                          n)).to(cuda)
    _build.reset_counts()
    mu_k, res_k = cuda_jacobi.eig_cs_resid(a, CFG.eig_sweeps)
    mu_p, res_p = cuda_jacobi.eig_cs_resid_plain(a, CFG.eig_sweeps)
    assert mu_k.shape == (a.shape[0], n) and res_k.shape == (a.shape[0],)
    assert dict(_build.LAUNCHES) == {"eig_cs": 1}
    assert dict(_build.PLAIN_ON_CUDA) == {"eig_cs": 1}
    # The same f32 algorithm, but complex-orthogonal rotations amplify
    # rounding differences (FMA contraction) along the chain.  At n=16 ten
    # sweeps leave a few matrices of this family unconverged (off-diagonal
    # counter ~0.1 |A|_F) in either version, and rounding decides which
    # (measured on an H100: 3 of 128 for each, different ones).  Where both
    # converged (counter < 1e-3 |A|_F, the bound of the solver's counter
    # test), matched eigenvalues agree to 3e-3 |A|_F, the bound the TPU
    # kernel's own tests hold this algorithm to.
    fro = torch.linalg.matrix_norm(a).cpu().numpy()
    rk, rp = res_k.cpu().numpy() / fro, res_p.cpu().numpy() / fro
    both = (rk < 1e-3) & (rp < 1e-3)
    assert both.mean() >= 0.9, (rk, rp)
    err = _matched(mu_k.cpu().numpy(), mu_p.cpu().numpy()) / fro
    assert err[both].max() < 3e-3, err

    # no rotation: the diagonal, and the off-diagonal norm as numpy has it
    mu0, res0 = cuda_jacobi.eig_cs_resid(a, 0)
    a_np = a.cpu().numpy()
    np.testing.assert_array_equal(mu0.cpu().numpy(),
                                  np.diagonal(a_np, axis1=-2, axis2=-1))
    off_diag = ~np.eye(n, dtype=bool)
    off = np.sqrt(np.sum(np.abs(a_np.astype(complex)) ** 2 * off_diag,
                         axis=(-1, -2)))
    np.testing.assert_allclose(res0.cpu().numpy(), off, rtol=1e-5)


# k = 40, 48 and 64: a matrix on two warps; 63 is padded to 64
@pytest.mark.cuda
@pytest.mark.parametrize("k", [K, K - 1, 32, 40, 48, cuda_linalg.MAX_K, 63])
def test_gram_svd_kernel_matches_plain(cuda, k):
    m = torch.from_numpy(_crandn(np.random.default_rng(k), 256, k, k)).to(cuda)
    s_k, v_k = cuda_linalg.gram_svd(m, CFG.eigh_sweeps)
    s_p, _ = cuda_linalg.gram_svd_plain(m, CFG.eigh_sweeps)
    assert dict(_build.LAUNCHES) == {"gram_svd": 1}
    # singular values: the same rotations in another summation order
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-5 * s_p.max().item())
    # V only up to a phase per column: checked through m m^H
    mm = m @ m.conj().transpose(-1, -2)
    rec = (v_k * (s_k * s_k)[:, None, :]) @ v_k.conj().transpose(-1, -2)
    torch.testing.assert_close(rec, mm, rtol=0, atol=1e-4 * mm.abs().max().item())


def _rel_shift(g, rel):
    return rel * g.diagonal(dim1=-2, dim2=-1).real.abs().mean(-1)


def _shifted64(g, sh):
    k = g.shape[-1]
    eye = torch.eye(k, dtype=torch.complex128, device=g.device)
    return g.to(torch.complex128) + sh.double()[:, None, None] * eye


def _contract_error(x, g, sh):
    """max |R^-H (G + shift I) R^-1 - I| in float64."""
    x64 = x.to(torch.complex128)
    eye = torch.eye(g.shape[-1], dtype=torch.complex128, device=g.device)
    return ((x64.conj().transpose(-1, -2) @ _shifted64(g, sh) @ x64)
            - eye).abs().amax().item()


def _rank_deficient(rng, b, k, rank, device):
    y = torch.from_numpy(_crandn(rng, b, rank, k)).to(device)
    return y.conj().transpose(-1, -2) @ y


# k: the four compiled sizes (16, 24, 32, 64), an odd size under three of
# them, and sizes padded up inside the kernel (20 runs in the 24-wide one;
# 40, 48 and 56 in the 64-wide)
@pytest.mark.cuda
@pytest.mark.parametrize("k", [K, K - 1, 16, 32, 31, 20, 40, 48, 47, 56, 64,
                               63])
def test_cholqr_rinv_kernel_matches_plain(cuda, k):
    g = torch.from_numpy(_grams(np.random.default_rng(k), 256, k)).to(cuda)
    sh = _rel_shift(g, 3e-6)
    x_k = cuda_linalg.cholqr_rinv(g, sh)
    x_p = cuda_linalg.cholqr_rinv_plain(g, sh)
    assert dict(_build.LAUNCHES) == {"cholqr_rinv": 1}
    # the same f32 operations in another summation order
    torch.testing.assert_close(x_k, x_p, rtol=0,
                               atol=1e-5 * x_p.abs().max().item())
    assert torch.equal(x_k.tril(-1), torch.zeros_like(x_k))


@pytest.mark.cuda
@pytest.mark.parametrize("shift_rel", [1e-4, 3e-6])
def test_cholqr_rinv_kernel_rank_deficient(cuda, shift_rel):
    """Rank-5 Grams at k = 24 (the power iteration's blocks are such) at the
    solver's two shifts: pivots of the size of the shift, so kernel and plain
    version are not compared entry by entry but both held to the contract
    R^-H (G + shift I) R^-1 = I in float64, to 0.2 k eps / shift_rel (the
    bound of tests/test_torch_kernels.py), with finite outputs."""
    g = _rank_deficient(np.random.default_rng(5), 512, K, 5, cuda)
    sh = _rel_shift(g, shift_rel)
    bound = 0.2 * K * np.finfo(np.float32).eps / shift_rel
    for fn in (cuda_linalg.cholqr_rinv, cuda_linalg.cholqr_rinv_plain):
        x = fn(g, sh)
        assert bool(torch.isfinite(torch.view_as_real(x)).all())
        assert _contract_error(x, g, sh) < bound
    assert dict(_build.LAUNCHES) == {"cholqr_rinv": 1}


# k: the four compiled sizes (16, 32, 48, 64), an odd size under each, and
# sizes padded up inside the kernel (20 in the 32-wide, 40 in the 48-wide,
# 56 in the 64-wide)
@pytest.mark.cuda
@pytest.mark.parametrize("k", [CFG.p, 32, CFG.p - 1, 31, 64, 63, 20, 40, 48,
                               47, 56])
def test_chol_solve_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    g = torch.from_numpy(_grams(rng, 256, k)).to(cuda)
    b = torch.from_numpy(_crandn(rng, 256, k)).to(cuda)
    sh = _rel_shift(g, 1e-7)
    x_k = cuda_linalg.chol_solve(g, b, sh)
    x_p = cuda_linalg.chol_solve_plain(g, b, sh)
    assert dict(_build.LAUNCHES) == {"chol_solve": 1}
    torch.testing.assert_close(x_k, x_p, rtol=0,
                               atol=1e-5 * x_p.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32, 64])
def test_chol_solve_kernel_rank_deficient(cuda, k):
    """Rank-5 Grams with a 1e-4 shift: kernel and plain version both finite,
    both with a float64 residual |(G + shift I) x - b| <= 0.2 k eps /
    shift_rel of |b|_max (the null directions amplify the factor's f32
    rounding by 1 / shift_rel)."""
    rng = np.random.default_rng(k)
    g = _rank_deficient(rng, 512, k, 5, cuda)
    b = torch.from_numpy(_crandn(rng, 512, k)).to(cuda)
    sh = _rel_shift(g, 1e-4)
    bound = 0.2 * k * np.finfo(np.float32).eps / 1e-4
    for fn in (cuda_linalg.chol_solve, cuda_linalg.chol_solve_plain):
        x = fn(g, b, sh)
        assert bool(torch.isfinite(torch.view_as_real(x)).all())
        res = (_shifted64(g, sh) @ x.to(torch.complex128)[..., None])[..., 0] - b
        assert res.abs().amax().item() < bound * b.abs().amax().item()
    assert dict(_build.LAUNCHES) == {"chol_solve": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 257])
def test_chol_kernels_ragged_batches(cuda, batch):
    """Batches that do not fill the last block (a block holds 8, 4 or 1
    matrices), at every compiled size: the same as the plain version, and
    nothing written past the end of the output."""
    rng = np.random.default_rng(batch)
    for k in (16, 24, 32, 48, 64):
        g = torch.from_numpy(_grams(rng, batch, k)).to(cuda)
        sh = _rel_shift(g, 3e-6)
        x_p = cuda_linalg.cholqr_rinv_plain(g, sh)
        torch.testing.assert_close(cuda_linalg.cholqr_rinv(g, sh), x_p, rtol=0,
                                   atol=1e-5 * x_p.abs().max().item())
    for k in (16, 32, 48, 64):
        g = torch.from_numpy(_grams(rng, batch + 1, k)).to(cuda)
        b = torch.from_numpy(_crandn(rng, batch + 1, k)).to(cuda)
        sh = _rel_shift(g, 1e-7)
        x_p = cuda_linalg.chol_solve_plain(g[:batch], b[:batch], sh[:batch])
        # the kernel's output is a view of a larger buffer: the entry after
        # the batch keeps its marker
        buf = torch.full((batch + 1, k), 7.0 + 0j, dtype=torch.complex64,
                         device=cuda)
        lib = _build.library()
        err = lib.llck_chol_solve(g.data_ptr(), b.data_ptr(), sh.data_ptr(),
                                  buf.data_ptr(), batch, k,
                                  torch.cuda.current_stream().cuda_stream)
        _build.check("llck_chol_solve", err)
        torch.testing.assert_close(buf[:batch], x_p, rtol=0,
                                   atol=1e-5 * x_p.abs().max().item())
        assert bool((buf[batch] == 7.0).all())


@pytest.mark.cuda
def test_chol_kernel_resources(cuda):
    """Every instantiation keeps its columns in registers: no local memory
    (spills or a stack frame), and the padded sizes share their K."""
    for kernel, sizes in (("cholqr_rinv", {16: 16, 20: 24, 24: 24, 32: 32,
                                           40: 64, 48: 64, 56: 64, 64: 64}),
                          ("chol_solve", {16: 16, 20: 32, 32: 32, 40: 48,
                                          48: 48, 56: 64, 64: 64})):
        for k, big_k in sizes.items():
            res = cuda_linalg.chol_kernel_resources(kernel, k)
            assert res["K"] == big_k
            assert res["local_bytes"] == 0, res
            assert res["blocks_per_sm"] >= 1, res


# --- sizes past the kernels' limits, and config 2's shapes -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("fn, k, field", [
    ("gram_svd", cuda_linalg.MAX_K + 1, "KbdmConfig.p + oversample"),
    ("cholqr_rinv", cuda_linalg.MAX_K + 8, "KbdmConfig.p + oversample"),
    ("chol_solve", cuda_linalg.MAX_K_SOLVE + 2, "refined clusters"),
    ("eig_cs", cuda_jacobi.MAX_N + 1, "KbdmConfig.p")])
def test_kernel_refuses_size_and_names_the_field(cuda, fn, k, field):
    """A CUDA tensor past a kernel's limit raises, naming the config field
    to lower, and nothing falls back to the plain version."""
    g = torch.from_numpy(_grams(np.random.default_rng(k), 2, k)).to(cuda)
    calls = {"gram_svd": lambda: cuda_linalg.gram_svd(g),
             "cholqr_rinv": lambda: cuda_linalg.cholqr_rinv(g, 1.0),
             "chol_solve": lambda: cuda_linalg.chol_solve(g, g[..., 0], 1.0),
             "eig_cs": lambda: cuda_jacobi.eig_cs(g)}
    with pytest.raises(ValueError, match=re.escape(field)):
        calls[fn]()
    assert not _build.LAUNCHES and not _build.PLAIN_ON_CUDA


def _brain_sweep(cuda, stop):
    """Config 3's sweep (the brain signal, N=2048, m = 120..300 step 4,
    p=24, so k=32) on the card, stopped at ``stop``."""
    import pathlib
    csv = pathlib.Path(__file__).parent.parent / "data" / "params_brain_sim.csv"
    rows = np.loadtxt(csv, delimiter=",", skiprows=1, usecols=(1, 2, 3, 4))
    sig = sample_signal(line_list_from_np(rows), 2048, 2.5e-4)
    return kbdm_sweep(sig[None].to(cuda).to(torch.complex64), 2.5e-4,
                      tuple(range(120, 301, 4)), KbdmConfig(p=24), _stop=stop)


@pytest.mark.cuda
def test_default_sketch_is_the_hosts_draw(cuda):
    """Without omega the sweep on the card takes the sketch a CPU generator
    draws from cfg.seed (a CUDA generator draws other numbers): the same
    reduced matrices, bit for bit, as with that draw passed in."""
    cfg = KbdmConfig(p=8)
    sig = sample_signal(line_list_from_np(np.array(
        [[1.0, 0.05, -60.0, 0.2], [0.7, 0.08, 45.0, -0.4]])), 256, DWELL)
    c = sig[None].to(cuda).to(torch.complex64)
    om = torch.randn((64, cfg.p + cfg.oversample), dtype=torch.float32,
                     generator=torch.Generator().manual_seed(cfg.seed))
    got = kbdm_sweep(c, DWELL, (48, 64), cfg, _stop="reduced")
    want = kbdm_sweep(c, DWELL, (48, 64), cfg, _stop="reduced",
                      omega=om.to(cuda))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sweep_peak_memory_is_bounded(cuda):
    """One kbdm_sweep pass over V=256 voxels at k=40 (the north star's
    m = 120..256 step 4, S=35) holds at most 6 copies of its (V, m_max, S, k)
    complex64 basis plus the (V, m_max, m_max) Hankel operator above its
    input: each block is freed after its last reader (it held ~8 before)."""
    cfg = KbdmConfig(p=32)
    m_values = tuple(range(120, 257, 4))
    v, m_max, k = 256, max(m_values), cfg.p + cfg.oversample
    rng = np.random.default_rng(0)
    c = torch.as_tensor(_crandn(rng, v, 512), device=cuda)
    kbdm_sweep(c[:2], DWELL, m_values, cfg)          # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lines = kbdm_sweep(c, DWELL, m_values, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    basis = v * m_max * len(m_values) * k * 8
    hankel = v * m_max * m_max * 8
    assert lines.mask.shape == (v, len(m_values), cfg.p)
    assert peak <= 6 * basis + hankel, (
        f"peak {peak / basis:.2f} basis copies (Hankel "
        f"{hankel / basis:.2f})")


def _noisy_north_star(v=4):
    """The bench's noisy signals (tools.five_peak.signals(v, 1e-4)) as
    complex64 CPU tensors, and their truths."""
    sigs, truths = five_peak.signals(v, 1e-4)
    return torch.as_tensor(sigs).to(torch.complex64), truths


@pytest.mark.cuda
def test_default_sweep_takes_the_bf16_branch(cuda, monkeypatch):
    """On the card KbdmConfig() runs the bfloat16 power iterations (the
    JAX package's accelerator default) through the cholqr_rinv kernel, one
    launch a power iteration, inside the pass over the pairs as stored
    (orth_pass); a CPU tensor takes the float32 branch."""
    calls = []
    branch = sweep_mod._power_iterations_bf16
    monkeypatch.setattr(sweep_mod, "_power_iterations_bf16",
                        lambda *a: calls.append(1) or branch(*a))
    c, _ = _noisy_north_star()
    cfg = KbdmConfig(p=16)
    assert sweep_mod.bf16_power_iterations(c.to(cuda), cfg)
    assert not sweep_mod.bf16_power_iterations(c, cfg)
    assert not sweep_mod.bf16_power_iterations(c.to(cuda), KbdmConfig(
        p=16, subspace_bf16=False))
    y = kbdm_sweep(c.to(cuda), DWELL, tuple(range(120, 257, 8)), cfg,
                   _stop="powiter")
    assert calls == [1]
    assert y.dtype == torch.complex64 and bool(torch.isfinite(
        torch.view_as_real(y)).all())
    assert dict(_build.LAUNCHES) == {"cholqr_rinv": cfg.subspace_iters,
                                     "orth_pass": cfg.subspace_iters}
    assert not _build.PLAIN_ON_CUDA


@pytest.mark.cuda
def test_bf16_branch_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The bfloat16 branch on the card against the same branch on CPU
    tensors (the predicate patched to take it there), one sketch: cuBLAS
    and the CPU round other bfloat16 products, so the last power-iteration
    blocks agree in their dominant five-line subspaces to within one
    bfloat16 step and in norm to a few; each entry's five lines at the
    float32 stage's tolerances (tests/torch_precision_checks.py)."""
    monkeypatch.setattr(sweep_mod, "bf16_power_iterations",
                        lambda c, cfg: cfg.subspace_bf16)
    c, truths = _noisy_north_star()
    m_values, cfg = tuple(range(120, 257, 8)), KbdmConfig(p=16)
    card, cpu = (kbdm_sweep(x, DWELL, m_values, cfg, _stop="powiter")
                 .cpu().numpy() for x in (c.to(cuda), c))
    assert largest_angle(card, cpu) < BF16_ULP
    assert np.linalg.norm(card - cpu) < 4 * BF16_ULP * np.linalg.norm(cpu)
    card, cpu = (tuple(f.cpu().numpy() for f in kbdm_sweep(
        x, DWELL, m_values, cfg)) for x in (c.to(cuda), c))
    for v in range(len(truths)):
        for s in range(len(m_values)):
            hold_rows(genuine(card, truths[v], v, s),
                      genuine(cpu, truths[v], v, s))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_high_turns_tf32_on_only_inside_the_four_sites(cuda, monkeypatch,
                                                       bf16):
    """mxu_precision="high" on the card: TF32 (torch's "high") inside the
    JAX package's four sites (the float32 Hankel apply, the Gram and mix
    products, the correction row) and nowhere else, and off again after
    the sweep; every product logged by tests/torch_precision_checks.py."""
    c, _ = _noisy_north_star(2)
    cfg = KbdmConfig(p=16, subspace_bf16=bf16, mxu_precision="high")
    with logged_products(monkeypatch) as log:
        kbdm_sweep(c.to(cuda), DWELL, tuple(range(120, 257, 8)), cfg)
    assert not torch.backends.cuda.matmul.allow_tf32
    seen = {site for site, _, _ in log}
    assert {"site", "corr", "takagi", "lines"} <= seen, seen
    assert ("bf16 branch" in seen) == bf16
    assert not high_only_at_the_sites(log)
    assert any(tf32 for _, _, tf32 in log)


@pytest.mark.cuda
def test_kernels_at_config2_widths_match_plain(cuda):
    """k = 32 and n = 24 on the brain sweep's own matrices: eig_cs on its
    reduced matrices (matched eigenvalues, 3e-3 of |A|_F, where both
    converged), gram_svd on its projected Hankel blocks, cholqr_rinv on the
    Grams of its last power iteration at the final passes' 3e-6 shift (both
    versions held to the contract, the blocks being rank-deficient),
    chol_solve at 32 and at the GN solves' 48 and 64."""
    cfg = KbdmConfig(p=24)
    ut = _brain_sweep(cuda, "reduced").reshape(-1, 24, 24).contiguous()
    mu_k, res_k = cuda_jacobi.eig_cs_resid(ut, cfg.eig_sweeps)
    mu_p, res_p = cuda_jacobi.eig_cs_resid_plain(ut, cfg.eig_sweeps)
    fro = torch.linalg.matrix_norm(ut).cpu().numpy()
    rk, rp = res_k.cpu().numpy() / fro, res_p.cpu().numpy() / fro
    both = (rk < 1e-3) & (rp < 1e-3)
    assert both.mean() >= 0.9, (rk, rp)
    err = _matched(mu_k.cpu().numpy(), mu_p.cpu().numpy()) / fro
    assert err[both].max() < 3e-3, err

    m = _brain_sweep(cuda, "m_small").reshape(-1, 32, 32).contiguous()
    s_k, v_k = cuda_linalg.gram_svd(m, cfg.eigh_sweeps)
    s_p, _ = cuda_linalg.gram_svd_plain(m, cfg.eigh_sweeps)
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-5 * s_p.max().item())
    mm = m @ m.conj().transpose(-1, -2)
    rec = (v_k * (s_k * s_k)[:, None, :]) @ v_k.conj().transpose(-1, -2)
    torch.testing.assert_close(rec, mm, rtol=0,
                               atol=1e-4 * mm.abs().max().item())

    y = _brain_sweep(cuda, "powiter")
    g = torch.einsum("vmsk,vmsl->vskl", y.conj(), y).reshape(-1, 32, 32)
    g = 0.5 * (g + g.transpose(-1, -2).conj())
    sh = _rel_shift(g, 3e-6)
    bound = 0.2 * 32 * np.finfo(np.float32).eps / 3e-6
    for fn in (cuda_linalg.cholqr_rinv, cuda_linalg.cholqr_rinv_plain):
        x = fn(g, sh)
        assert bool(torch.isfinite(torch.view_as_real(x)).all())
        assert _contract_error(x, g, sh) < bound

    rng = np.random.default_rng(48)
    for k in (32, 48, 64):
        gk = torch.from_numpy(_grams(rng, 64, k)).to(cuda)
        b = torch.from_numpy(_crandn(rng, 64, k)).to(cuda)
        shk = _rel_shift(gk, 1e-7)
        x_p = cuda_linalg.chol_solve_plain(gk, b, shk)
        torch.testing.assert_close(cuda_linalg.chol_solve(gk, b, shk), x_p,
                                   rtol=0, atol=1e-5 * x_p.abs().max().item())
    # the sweeps: orth_pass and its cholqr_rinv 4 + 4 + 2, gram_svd 1 (the
    # Takagi step)
    assert dict(_build.LAUNCHES) == {"eig_cs": 1, "gram_svd": 2,
                                     "cholqr_rinv": 11, "chol_solve": 3,
                                     "orth_pass": 10}


@pytest.mark.cuda
def test_dbscan_on_cuda_equals_cpu(cuda):
    """The O(n^2) dbscan on the card gives the CPU's labels, in two
    feature dimensions and with a zero second feature (where it also gives
    dbscan_1d's)."""
    rng = np.random.default_rng(11)
    b, n = 16, 560
    x = np.empty((b, n, 2), np.float32)
    for i in range(b):
        centers = rng.uniform(-0.2, 0.2, (5, 2))
        x[i, :n // 2] = (centers[rng.integers(0, 5, n // 2)]
                         + 3e-5 * rng.standard_normal((n // 2, 2)))
        x[i, n // 2:] = rng.uniform(-0.25, 0.25, (n - n // 2, 2))
    valid = rng.uniform(size=(b, n)) > 0.1
    for feats in (x, np.stack([x[..., 0], np.zeros_like(x[..., 0])], -1)):
        cpu = dbscan.dbscan(torch.as_tensor(feats), torch.as_tensor(valid),
                            2e-4, 10)
        got = dbscan.dbscan(torch.as_tensor(feats, device=cuda),
                            torch.as_tensor(valid, device=cuda), 2e-4, 10)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())
    one_d = dbscan.dbscan_1d(torch.as_tensor(x[..., 0], device=cuda),
                             torch.as_tensor(valid, device=cuda), 2e-4, 10)
    np.testing.assert_array_equal(one_d.cpu().numpy(), cpu.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n, sched_fn", [
    (24, kernel_smoke.schedule), (24, kernel_smoke.self_paired_schedule),
    (7, kernel_smoke.self_paired_schedule),
    (64, kernel_smoke.self_paired_schedule)],
    ids=["tool", "self-paired", "n7", "n64"])
def test_row_probe_kernel_matches_plain(cuda, n, sched_fn):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((256, n, n)).astype(np.float32)).to(cuda)
    sched = torch.from_numpy(sched_fn(n, 16))    # the schedule stays on the host
    got = cuda_probes.row_probe(sched, a)
    want = cuda_probes.row_probe_plain(sched, a)
    assert dict(_build.LAUNCHES) == {"row_probe": 1}
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_row_probe_never_syncs_and_refuses_a_schedule_on_the_card(cuda):
    """The wrapper reads the schedule on the host and hands it to the kernel
    as a launch parameter: under sync debug mode "error" a call that waited
    on the device would raise.  A schedule on the card is refused."""
    n, steps = 24, 16
    a = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, n, n)).astype(np.float32)).to(cuda)
    sched = torch.from_numpy(kernel_smoke.self_paired_schedule(n, steps))
    want = cuda_probes.row_probe_plain(sched, a)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [cuda_probes.row_probe(sched, a) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x in got:
        torch.testing.assert_close(x, want, rtol=0, atol=1e-5)
    assert _build.LAUNCHES["row_probe"] == 3
    with pytest.raises(ValueError, match="read on the host"):
        cuda_probes.row_probe(sched.to(cuda), a)
    assert _build.LAUNCHES["row_probe"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("switches", list(cuda_probes.EIGH_VARIANTS.values()),
                         ids=list(cuda_probes.EIGH_VARIANTS))
def test_eigh_probe_kernel_matches_plain(cuda, switches):
    # one sweep at n=8: the chain is short enough for elementwise parity
    a = bench_eigh_variants.make_inputs(8, 512, cuda)
    got = cuda_probes.eigh_probe(a, 1, **switches)
    want = cuda_probes.eigh_probe_plain(a, 1, **switches)
    assert dict(_build.LAUNCHES) == {"eigh_probe": 1}
    torch.testing.assert_close(got.w, want.w, rtol=0,
                               atol=1e-4 * a.abs().max().item())
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=0)

    # the tool's size, where the chain is chaotic: the invariants, finite w,
    # and the same bits at every matrices-per-block value
    big = bench_eigh_variants.make_inputs(device=cuda)
    out = cuda_probes.eigh_probe(big, bench_eigh_variants.SWEEPS, **switches)
    assert bool(torch.isfinite(out.w).all())
    errs = bench_eigh_variants.invariant_errors(big, out, switches["do_rows"],
                                                switches["do_cols"])
    assert max(errs.values()) <= 1e-5, errs
    for per_block in (1, cuda_probes.MAX_PER_BLOCK):
        other = cuda_probes.eigh_probe(big, bench_eigh_variants.SWEEPS,
                                       per_block=per_block, **switches)
        for x, y in zip(other, out):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("switches", list(cuda_probes.EIGH_VARIANTS.values()),
                         ids=list(cuda_probes.EIGH_VARIANTS))
@pytest.mark.parametrize("n", [40, 64])
def test_eigh_probe_wide_kernel_matches_plain(cuda, n, switches):
    """n = 40 and 64, where a lane owns two columns.  One sweep against the
    plain version on 4 x 4 block-diagonal inputs, where the chain is short
    enough for elementwise parity (on dense inputs one sweep at n = 40 is
    already chaotic): w to 1e-4 max|A|, the norms and the coefficient sum to
    1e-5 relative.  Then the tool's 8 sweeps on dense inputs: the
    invariants, finite w and the same bits at every matrices-per-block
    value."""
    a = bench_eigh_variants.make_block_diagonal(n, 512, cuda)
    got = cuda_probes.eigh_probe(a, 1, **switches)
    want = cuda_probes.eigh_probe_plain(a, 1, **switches)
    torch.testing.assert_close(got.w, want.w, rtol=0,
                               atol=1e-4 * a.abs().max().item())
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=0)

    a = bench_eigh_variants.make_inputs(n, 256, cuda)
    got = cuda_probes.eigh_probe(a, bench_eigh_variants.SWEEPS, **switches)
    assert bool(torch.isfinite(got.w).all())
    errs = bench_eigh_variants.invariant_errors(a, got, switches["do_rows"],
                                                switches["do_cols"])
    assert max(errs.values()) <= 1e-5, errs
    for per_block in (1, cuda_probes.MAX_PER_BLOCK):
        other = cuda_probes.eigh_probe(a, bench_eigh_variants.SWEEPS,
                                       per_block=per_block, **switches)
        for x, y in zip(other, got):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_eigh_probe_rejects_odd_n(cuda):
    a = bench_eigh_variants.make_inputs(8, 4, cuda)[:, :7, :7]
    with pytest.raises(ValueError, match="even n"):
        cuda_probes.eigh_probe(a, 1)
    assert not _build.LAUNCHES


# --- the refine's normal equations ---------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("v, nc, n, t0", [
    (1024, 32, 2048, 0),     # the brain cell's refine
    (2048, 16, 512, 0),      # the five-peak cell's
    (1, 32, 2048, 0),        # a single spectrum: one block
    (1, 16, 512, 0),
    (256, 24, 512, 0),       # 24 slots, padded inside the 32-wide kernel
    (2, 17, 300, 5),
    (16, 32, 512, 300),      # a time block at t0 = 300
    (8, 4, 64, 0)])
def test_gn_normal_kernel_matches_plain(cuda, v, nc, n, t0):
    """G on pairs of unmasked slots within 1e-5 of its largest entry, the
    rhs on unmasked rows within 1e-6 of each half's largest: the powers,
    residual and rhs are float64 on both sides, G float32 summed in
    another order."""
    c, z, d, mask = normal_inputs(v, nc, n, t0, seed=nc + t0, device=cuda)
    g, rhs = cuda_linalg.gn_normal(c, z, d, t0)
    g_p, rhs_p = cuda_linalg.gn_normal_plain(c, z, d, t0)
    assert dict(_build.LAUNCHES) == {"gn_normal": 1}
    assert dict(_build.PLAIN_ON_CUDA) == {"gn_normal": 1}
    assert g.dtype == torch.complex64 and rhs.dtype == torch.complex128
    assert bool(torch.isfinite(torch.view_as_real(g)).all())
    eg, er = normal_errors(g, rhs, g_p, rhs_p, mask)
    assert eg <= 1e-5 and er <= 1e-6, (eg, er)


@pytest.mark.cuda
def test_gn_normal_above_32_slots_raises(cuda):
    """C = 33 is past the kernel's limit (the refine's on the card: its
    chol_solve takes 2C <= 64): a CUDA call raises, naming the field to
    lower, and nothing runs."""
    c, z, d, _ = normal_inputs(2, 33, 128, device=cuda)
    with pytest.raises(ValueError, match=r"k <= 32.*refined clusters C"):
        cuda_linalg.gn_normal(c, z, d)
    assert not _build.LAUNCHES and not _build.PLAIN_ON_CUDA


def _brain_refine_inputs(cuda, v=1024, slots=32, seed=17):
    """v brain voxels (N=2048): the 16 lines of data/params_brain_sim.csv,
    one frequency shift a voxel (sd 2 Hz) and amplitudes jittered 5%; the
    initial lines off by f32-stage errors (1e-3 relative on A and T2,
    0.05 Hz, 1e-3 rad), in slots of ``slots`` with the rest masked."""
    import pathlib
    csv = pathlib.Path(__file__).parent.parent / "data" / "params_brain_sim.csv"
    rows = np.loadtxt(csv, delimiter=",", skiprows=1, usecols=(1, 2, 3, 4))
    rng = np.random.default_rng(seed)
    k = len(rows)
    truth = np.repeat(rows[None], v, 0)
    truth[..., 2] += rng.normal(scale=2.0, size=(v, 1))
    truth[..., 0] *= 1 + 0.05 * rng.standard_normal((v, k))
    exact = LineList(*(torch.as_tensor(truth[..., j], device=cuda)
                       for j in range(4)),
                     torch.ones((v, k), dtype=torch.float64, device=cuda))
    c = sample_signal(exact, 2048, 2.5e-4)
    init = truth * [1 + 1e-3, 1 + 1e-3, 1, 1] + [0, 0, 0.05, 1e-3]
    full = np.zeros((v, slots, 4))
    full[..., 1] = 1.0
    full[:, :k] = init
    mask = np.zeros((v, slots))
    mask[:, :k] = 1
    lines = LineList(*(torch.as_tensor(full[..., j], dtype=torch.float32,
                                       device=cuda) for j in range(4)),
                     torch.as_tensor(mask, dtype=torch.float32, device=cuda))
    return c, lines


@pytest.mark.cuda
def test_refine_through_gn_normal_matches_plain(cuda, monkeypatch):
    """refine_lines at the brain cell's shape (1024 voxels, 32 slots, N=2048,
    10 iterations) through the kernel and through the plain version: the
    refined poles and amplitudes agree within 1e-10, and the kernel is
    launched once per exact iteration, never for a float32 one."""
    from llckbdm_tpu_torch.solver import refine as refine_mod

    c, lines = _brain_refine_inputs(cuda)
    rcfg = RefineConfig(iters=10)
    kern = refine_lines(c, lines, 2.5e-4, rcfg)
    assert _build.LAUNCHES["gn_normal"] == rcfg.iters
    assert not _build.PLAIN_ON_CUDA
    with monkeypatch.context() as m:
        m.setattr(refine_mod.cuda_linalg, "gn_normal",
                  cuda_linalg.gn_normal_plain)
        plain = refine_lines(c, lines, 2.5e-4, rcfg)
    assert _build.PLAIN_ON_CUDA["gn_normal"] == rcfg.iters
    assert _build.LAUNCHES["gn_normal"] == rcfg.iters
    assert float((kern.z - plain.z).abs().max()) <= 1e-10
    assert float((kern.d - plain.d).abs().max()
                 / plain.d.abs().max()) <= 1e-10
    assert float(kern.gn_step.max()) < 1e-9

    _build.reset_counts()
    refine_lines(c[:64], LineList(*(x[:64] for x in lines)), 2.5e-4,
                 RefineConfig(iters=0, f32_iters=3))
    assert "gn_normal" not in _build.LAUNCHES
    refine_lines(c[:64], LineList(*(x[:64] for x in lines)), 2.5e-4,
                 RefineConfig(iters=2, f32_iters=3))
    assert _build.LAUNCHES["gn_normal"] == 2


# --- the benchmark's entry point on the card -------------------------------

@pytest.mark.cuda
def test_bench_eigensolve_launches_the_kernel_and_matches_plain(cuda):
    """The bench's eigensolve launches the eig_cs kernel, and on (64, 16,
    16) of its inputs the kernel follows the plain version slot by slot
    after one sweep.  One sweep of complex-orthogonal rotations amplifies
    float32 rounding on these dense matrices to ~1e-2 (the plain version's
    arithmetic in complex128 against float32: 1.6e-2 on an H100), and the
    kernel's FMAs and summation order round otherwise than the plain
    version's, so the two are held to that scale: no farther apart than
    float32 moves the algorithm itself, and within 1e-3 of each matrix's
    norm (a wrong pair order or orientation moves the slots by O(|A|))."""
    ut = bench.eig_inputs(64, 16).to(cuda)
    cuda_jacobi.eig_cs(ut, sweeps=CFG.eig_sweeps)
    assert dict(_build.LAUNCHES) == {"eig_cs": 1}
    mu_k, res_k = cuda_jacobi.eig_cs_resid(ut, 1)
    mu_p, res_p = cuda_jacobi.eig_cs_resid_plain(ut, 1)
    mu_64, res_64 = cuda_jacobi._eig_cs_flat(ut.to(torch.complex128), 1)
    slot = torch.abs(mu_k - mu_p).max(-1).values
    rounding = torch.abs(mu_p.to(torch.complex128) - mu_64).max().item()
    norm = torch.linalg.matrix_norm(ut)
    print(f"kernel - plain: {slot.max().item():.3e}; plain - float64: "
          f"{rounding:.3e}; norms {norm.min().item():.2f}-"
          f"{norm.max().item():.2f}")
    assert slot.max().item() < rounding
    assert bool((slot < 1e-3 * norm).all())
    assert (torch.abs(res_k - res_p).max().item()
            < torch.abs(res_p.double() - res_64).max().item())


@pytest.mark.cuda
def test_bench_entry_point_on_the_card(cuda, capsys):
    """bench.main at V=64 exits 0 on the card: both in-bench checks met,
    the fit and refine launch all six main-path kernels (gn_normal once
    per Gauss-Newton iteration of each refine call, orth_pass once per
    CholeskyQR pass), the eigensolve eig_cs, and no plain version runs on
    a CUDA tensor."""
    launches = {}
    assert bench.main(["--voxels", "64", "--reps", "1", "--json-only"],
                      launches) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["backend"] == "cuda" and line["voxels"] == 64
    assert "bfloat16 power iterations" in line["unit"]
    assert line["counters"]["gate_max_rel_err"] < 1e-8
    assert line["counters"]["jacobi_offdiag_rel_production"] < 1e-2
    fit_refine = {**launches["fit"]["launches"],
                  **launches["refine"]["launches"]}
    assert set(fit_refine) == {"eig_cs", "gram_svd", "cholqr_rinv",
                               "chol_solve", "gn_normal", "orth_pass"}
    assert launches["refine"]["launches"]["gn_normal"] % 6 == 0
    assert launches["eigensolve"]["launches"] == {"eig_cs": 2}
    assert not any(s["plain"] for s in launches.values())


# --- the grid layer on the card (tests/test_parallel.py's small grid) -----

GRID_CFG = LlcKbdmConfig(
    m_values=(16, 24, 32), eps=5e-3, min_samples=2, max_clusters=4,
    kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1, eigh_sweeps=4,
                    eig_sweeps=6))
DWELL = 5e-4


def _small_grid(v=8, n=64):
    """v noiseless 2-line voxels (jittered frequencies) and their truths
    with an f32-stage-sized frequency error, as (v, 4) line arrays."""
    rng = np.random.default_rng(7)
    base = np.array([[1.0, 0.05, -60.0, 0.2], [0.7, 0.08, 45.0, -0.4]])
    truths = np.stack([base + [[0, 0, rng.normal(), 0], [0, 0, rng.normal(), 0]]
                       for _ in range(v)])
    sigs = np.stack([sample_signal(line_list_from_np(t), n, DWELL).numpy()
                     for t in truths])
    init = [line_list_from_np(t + [0, 0, 0.05, 0], k=4) for t in truths]
    lines = tuple(np.stack([x[j].numpy() for x in init]) for j in range(5))
    return sigs, lines


@pytest.mark.cuda
def test_timesharded_refine_two_ranks_one_card(cuda, tmp_path):
    """Two ranks on one card over gloo (time=2): within 5e-9 (z) and 5e-8
    (d) of the single-process refine, and the same bits on both ranks."""
    sigs, lines = _small_grid()
    rcfg = RefineConfig(iters=3)
    ctx = worker.start(worker.grid_ranks, 2, 2, str(tmp_path / "rdv"),
                       str(tmp_path), "cuda:0", {"data": 1, "time": 2}, sigs,
                       lines, DWELL, GRID_CFG, rcfg)
    worker.join(ctx, 600)
    outs = worker.load(tmp_path, 2)
    single = refine_lines(torch.as_tensor(sigs, device=cuda),
                          LineList(*(torch.as_tensor(x, device=cuda)
                                     for x in lines)), DWELL, rcfg)
    np.testing.assert_allclose(outs[0]["ts_z"], single.z.cpu().numpy(),
                               rtol=0, atol=5e-9)
    np.testing.assert_allclose(outs[0]["ts_d"], single.d.cpu().numpy(),
                               rtol=0, atol=5e-8)
    for k in outs[0]:
        assert np.array_equal(outs[0][k], outs[1][k]), k
    # each rank built each step's normal equations in the kernel
    assert int(outs[0]["ts_gn_normal"]) == rcfg.iters
    assert int(outs[0]["ts_gn_normal_plain"]) == 0


@pytest.mark.cuda
def test_gridrunner_deleted_shard_bitwise_on_card(cuda, tmp_path):
    """A deleted shard recomputed on the card gathers bit for bit as before,
    through all six main-path kernels and no plain version."""
    sigs, _ = _small_grid(v=12)
    r = GridRunner(tmp_path, DWELL, GRID_CFG, cuda, shard_size=4,
                   refine=RefineConfig(iters=3), refine_clusters=4)
    assert r.run(sigs) == 3
    assert set(_build.LAUNCHES) == {"cholqr_rinv", "gram_svd", "eig_cs",
                                    "chol_solve", "gn_normal", "orth_pass"}
    assert not _build.PLAIN_ON_CUDA
    first = r.gather(12)
    (tmp_path / "shard_00000004_00000008.npz").unlink()
    assert r.run(sigs) == 1
    again = r.gather(12)
    for k in first:
        assert np.array_equal(first[k], again[k]), k


@pytest.mark.cuda
def test_one_rank_nccl_group_is_bound_to_its_card(cuda):
    """distributed_init binds a one-rank NCCL group to cuda:0 (device_id,
    so NCCL guesses nothing from the rank), and an all-reduce runs on it."""
    import torch.distributed as dist

    from llckbdm_tpu_torch.parallel import distributed_init

    distributed_init(None, backend="nccl", device="cuda:0")
    try:
        group = dist.distributed_c10d._get_default_group()
        assert group.bound_device_id == torch.device("cuda", 0)
        x = torch.full((4,), 3.0, device=cuda)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        assert x.tolist() == [3.0] * 4
    finally:
        dist.destroy_process_group()


# --- the sweep's CholeskyQR pass over a block as stored (csrc/orth_pass.cu) --

def _masked_block(seed, v, m, s, k, cuda):
    """A complex64 Gaussian (v, m, s, k) block drawn on the card, entry i's
    rows from m_i on zero, m_i spread from max(k + 8, m / 2) to m (the
    sweep's masks): every entry keeps more rows than columns."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    y = torch.randn((v, m, s, k), generator=gen, dtype=torch.complex64,
                    device=cuda)
    keep = np.linspace(min(m, max(k + 8, m // 2)), m, s).astype(int)
    rows = torch.arange(m, device=cuda)[:, None]
    mask = rows < torch.as_tensor(keep, device=cuda)[None, :]
    return y * mask[..., None], keep


def _bf16_within_a_step(a, b):
    """As tests/test_torch_orth_pass.py: one bfloat16 step of the larger
    value, beside 64 float32 eps of the block's largest entry (the float32
    rounding by which the two versions' sums may differ)."""
    a, b = a.float(), b.float()
    step = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
    return bool(((a - b).abs() <= step
                 + 64 * np.finfo(np.float32).eps * b.abs().max()).all())


# (V, m, S, k): the five-peak cell (2048, 256, 35, 24), the brain cell
# (1024, 300, 46, 32), the widest k = 64, config 2's single entry at m = 512,
# and a single voxel
ORTH_SHAPES = [(2048, 256, 35, 24), (1024, 300, 46, 32), (128, 256, 35, 64),
               (64, 512, 1, 32), (1, 256, 35, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True], ids=["complex64", "pairs"])
@pytest.mark.parametrize("shape", ORTH_SHAPES,
                         ids=["x".join(map(str, s)) for s in ORTH_SHAPES])
def test_orth_pass_kernel_matches_plain(cuda, shape, pairs):
    """The pass on the card against its plain version on the same block:
    G exactly Hermitian with a real diagonal and within float32 rounding
    of the plain G (m eps of its largest entry), the shift likewise, masked
    rows exactly 0, Q within float32 rounding (complex64: 1e-5 of its
    largest entry, through Cholesky factors of condition ~10 on these
    blocks) or one bfloat16 step of the plain version's rounding; one
    orth_pass launch, with its cholqr_rinv."""
    v, m, s, k = shape
    y, keep = _masked_block(m + k, v, m, s, k, cuda)
    x = cuda_linalg.to_pairs(y) if pairs else y
    g, sh = cuda_linalg.orth_gram(x, 1e-4)
    assert torch.equal(g, g.transpose(-1, -2).conj())
    assert bool((g.diagonal(dim1=-2, dim2=-1).imag == 0).all())
    g_p, sh_p = cuda_linalg._orth_gram_torch(y if not pairs else
                                             cuda_linalg.from_pairs(x), 1e-4)
    assert (g - g_p).abs().max() <= m * 1.2e-7 * g_p.abs().max()
    torch.testing.assert_close(sh, sh_p, rtol=1e-5, atol=0)
    _build.reset_counts()
    q = cuda_linalg.orth_pass(x, 1e-4)
    assert dict(_build.LAUNCHES) == {"orth_pass": 1, "cholqr_rinv": 1}
    q_p = cuda_linalg.orth_pass_plain(x, 1e-4)
    assert q.dtype == x.dtype and q.shape == x.shape
    if pairs:
        assert _bf16_within_a_step(q, q_p)
    else:
        torch.testing.assert_close(q, q_p, rtol=0,
                                   atol=1e-5 * q_p.abs().max().item())
    qc = cuda_linalg.from_pairs(q) if pairs else q
    for i, mm in enumerate(keep):
        assert bool((qc[:, mm:, i, :] == 0).all()), i
    assert bool(torch.isfinite(torch.view_as_real(qc)).all())


def _contract_errors(x, shift_rel):
    """The pass's own G, shift and R^-1 (orth_gram and cholqr_rinv on the
    card) held to cholqr_rinv's contract |R^-H (G + shift I) R^-1 - I| in
    float64, chunked; returns (error, bound 0.2 k eps / shift_rel)."""
    k = x.shape[-1]
    g, sh = cuda_linalg.orth_gram(x, shift_rel)
    g, sh = g.reshape(-1, k, k), sh.reshape(-1)
    rinv = cuda_linalg.cholqr_rinv(g, sh)
    assert bool(torch.isfinite(torch.view_as_real(rinv)).all())
    err = max(_contract_error(rinv[i:i + 8192], g[i:i + 8192], sh[i:i + 8192])
              for i in range(0, g.shape[0], 8192))
    return err, 0.2 * k * np.finfo(np.float32).eps / shift_rel


@pytest.mark.cuda
def test_orth_pass_on_the_north_stars_production_blocks(cuda):
    """On all 2048 noisy north-star voxels (the five-peak cell's shapes) the
    pass stays finite at both shifts (the power iterations' 1e-4 and the
    final 3e-6) on both storages, and its own G and R^-1 meet cholqr_rinv's
    contract (chip_smoke.py's production_gram_checks' bound)."""
    sigs, _ = five_peak.signals(2048, 1e-4)
    c = torch.as_tensor(sigs, device=cuda).to(torch.complex64)
    y = kbdm_sweep(c, DWELL, tuple(range(120, 257, 4)), KbdmConfig(p=16),
                   _stop="powiter")
    for x in (y, cuda_linalg.to_pairs(y)):
        for shift_rel in (1e-4, 3e-6):
            q = cuda_linalg.orth_pass(x, shift_rel)
            qc = cuda_linalg.from_pairs(q) if q.dtype == torch.bfloat16 else q
            assert bool(torch.isfinite(torch.view_as_real(qc)).all())
            del q, qc
            err, bound = _contract_errors(x, shift_rel)
            assert err < bound, (x.dtype, shift_rel, err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("cell, voxels", [("five_peak_clean", 2048),
                                          ("brain_clean", 1024)])
def test_orth_pass_on_the_benchmark_cells_blocks(cuda, cell, voxels):
    """On each benchmark cell's own blocks (its configuration and signals,
    benchmark/configs, benchmark/inputs.py, at its voxels a batch): the
    block the last power iteration's pass reads (pairs on the bfloat16
    branch) at its shift, and the block the final passes read at 3e-6.
    The pass's own G and R^-1 meet cholqr_rinv's contract, and the pass
    stays finite."""
    import dataclasses

    from benchmark import inputs, spec

    conf = spec.config(cell)
    sig, mv = conf["signal"], conf["pipeline"]["m_values"]
    m_values = tuple(range(mv["first"], mv["last"] + 1, mv["step"]))
    kcfg = KbdmConfig(**conf["kbdm"])
    c = inputs.synthesize(sig, voxels, 3021000001, cuda)[2].to(torch.complex64)
    bf16 = sweep_mod.bf16_power_iterations(c, kcfg)
    cases = ((dataclasses.replace(kcfg, subspace_iters=kcfg.subspace_iters - 1),
              sweep_mod.BF16_POWITER_SHIFT if bf16
              else sweep_mod.F32_POWITER_SHIFT, bf16),
             (kcfg, sweep_mod.FINAL_SHIFT, False))
    for case_cfg, shift_rel, pairs in cases:
        y = kbdm_sweep(c, float(sig["dwell"]), m_values, case_cfg,
                       _stop="powiter")
        x = cuda_linalg.to_pairs(y) if pairs else y
        del y
        err, bound = _contract_errors(x, shift_rel)
        assert err < bound, (cell, shift_rel, err, bound)
        q = cuda_linalg.orth_pass(x, shift_rel)
        qc = cuda_linalg.from_pairs(q) if pairs else q
        assert bool(torch.isfinite(torch.view_as_real(qc)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_sweep_runs_each_pass_on_the_kernel_alone(cuda, monkeypatch, bf16):
    """A sweep on the card at "highest" counts subspace_iters +
    final_orth_passes orth_pass launches, and inside a pass no matrix
    product (einsum, matmul) runs and no block is widened or rounded
    (from_pairs, to_pairs)."""
    inside, seen = [False], []

    class Log(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if inside[0] and getattr(func, "__name__", "") in (
                    "einsum", "matmul", "__matmul__", "bmm", "mm"):
                seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    pass_ = sweep_mod._orth_pass

    def spied_pass(*args, **kwargs):
        inside[0] = True
        try:
            return pass_(*args, **kwargs)
        finally:
            inside[0] = False

    def spy(name):
        fn = getattr(cuda_linalg, name)
        monkeypatch.setattr(cuda_linalg, name, lambda *a: (
            seen.append(name) if inside[0] else None) or fn(*a))

    monkeypatch.setattr(sweep_mod, "_orth_pass", spied_pass)
    spy("from_pairs")
    spy("to_pairs")
    c, _ = _noisy_north_star()
    cfg = KbdmConfig(p=16, subspace_bf16=bf16)
    with Log():
        kbdm_sweep(c.to(cuda), DWELL, tuple(range(120, 257, 8)), cfg)
    assert not seen, seen
    assert _build.LAUNCHES["orth_pass"] == (cfg.subspace_iters
                                            + cfg.final_orth_passes)
    assert not _build.PLAIN_ON_CUDA


@pytest.mark.cuda
def test_orth_pass_above_64_columns_raises(cuda):
    """k past 64 on the card raises, naming the config field to lower, and
    nothing falls back to the plain version."""
    y = torch.zeros(1, 40, 2, 65, dtype=torch.complex64, device=cuda)
    for x in (y, cuda_linalg.to_pairs(y)):
        with pytest.raises(ValueError, match=r"KbdmConfig\.p \+ oversample"):
            cuda_linalg.orth_pass(x, 1e-4)
    assert not _build.LAUNCHES and not _build.PLAIN_ON_CUDA
