"""The PyTorch port's kernels: plain versions against the Pallas TPU kernels.

Each plain version in llckbdm_tpu_torch.ops.cuda_* runs its CUDA kernel's
algorithm in PyTorch; here it is held against the Pallas kernel it replaces,
run in interpret mode on the same numpy inputs, and against scipy.  Sweep
counts come from the production KbdmConfig.  The CUDA kernels themselves are
held against the plain versions on a GPU by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import scipy.linalg
import torch
from scipy.optimize import linear_sum_assignment

from llckbdm_tpu.ops import pallas_jacobi, pallas_linalg
from llckbdm_tpu.ops.cplx import from_np, to_np
from llckbdm_tpu.solver.kbdm import KbdmConfig
from llckbdm_tpu_torch.ops import _build, cuda_jacobi, cuda_linalg

torch.set_num_threads(1)
CFG = KbdmConfig()


def _cs_matrices(rng, b, n):
    """Complex-symmetric A = Q D Q^T with known well-separated eigenvalues
    (the generator of tests/test_pallas_kernels.py)."""
    grid = (np.arange(n) + rng.uniform(0.1, 0.9, (b, n))) / n * 0.8 - 0.4
    evals = np.exp(2j * np.pi * grid - rng.uniform(0.02, 0.3, (b, n)))
    a = np.empty((b, n, n), complex)
    for i in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a[i] = q @ np.diag(evals[i]) @ q.T
    return a.astype(np.complex64), evals


def _matched(x, y):
    """Per matrix, the largest distance of the optimal one-to-one matching
    of two unordered eigenvalue sets."""
    out = []
    for xb, yb in zip(np.asarray(x), np.asarray(y)):
        cost = np.abs(xb[:, None] - yb[None, :])
        r, c = linear_sum_assignment(cost)
        out.append(cost[r, c].max())
    return np.array(out)


def _grams(rng, b, k):
    """Well-conditioned y^H y, y (b, max(64, 2k), k)."""
    rows = max(64, 2 * k)
    y = rng.standard_normal((b, rows, k)) + 1j * rng.standard_normal((b, rows, k))
    return np.einsum("bij,bik->bjk", y.conj(), y).astype(np.complex64)


@pytest.mark.parametrize("n", [16, 15])
def test_eig_cs_resid_plain_matches_pallas(n):
    a, evals = _cs_matrices(np.random.default_rng(42 + n), 6, n)
    mu_p, res_p = pallas_jacobi.eig_cs_resid(from_np(a), sweeps=CFG.eig_sweeps,
                                             interpret=True)
    mu_t, res_t = cuda_jacobi.eig_cs_resid(torch.from_numpy(a), CFG.eig_sweeps)
    assert mu_t.shape == (6, n) and res_t.shape == (6,)
    # Same f32 algorithm, but complex-orthogonal rotations are not
    # norm-preserving: rounding differences grow along the rotation chain,
    # and both land within the algorithm's f32 accuracy of the true
    # eigenvalues — 3e-3, the bound tests/test_pallas_kernels.py uses.
    assert _matched(mu_t.numpy(), to_np(mu_p)).max() < 3e-3
    oracle = np.stack([scipy.linalg.eigvals(x.astype(complex)) for x in a])
    assert _matched(mu_t.numpy(), oracle).max() < 3e-3
    assert _matched(mu_t.numpy(), evals).max() < 3e-3
    # the convergence counters agree at the f32 rotation-noise level
    fro = np.linalg.norm(a, axis=(-1, -2))
    np.testing.assert_allclose(res_t.numpy() / fro, np.asarray(res_p) / fro,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_eig_cs_first_sweep_matches_pallas_slot_by_slot(n):
    """Before rounding differences can grow, the plain version follows the
    Pallas kernel rotation by rotation: one sweep, eigenvalue slots equal
    to f32 rounding (same pair order and (i, j) orientation)."""
    a, _ = _cs_matrices(np.random.default_rng(7), 8, n)
    mu_p, res_p = pallas_jacobi.eig_cs_resid(from_np(a), sweeps=1,
                                             interpret=True)
    mu_t, res_t = cuda_jacobi.eig_cs_resid(torch.from_numpy(a), 1)
    np.testing.assert_allclose(mu_t.numpy(), to_np(mu_p), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_p), rtol=0,
                               atol=1e-5)


# k = 34 and 40: past the 32 lanes of one warp (the kernel takes two warps);
# the Pallas kernel in interpret mode takes ~9 s at 34, more at 40
@pytest.mark.parametrize("k", [24, 23, 34, pytest.param(40, marks=pytest.mark.slow)])
def test_gram_svd_plain_matches_pallas(k):
    rng = np.random.default_rng(k)
    m = (rng.standard_normal((6, k, k))
         + 1j * rng.standard_normal((6, k, k))).astype(np.complex64)
    s_p, v_p = pallas_linalg.gram_svd(from_np(m), sweeps=CFG.eigh_sweeps,
                                      interpret=True)
    s_t, v_t = cuda_linalg.gram_svd(torch.from_numpy(m), CFG.eigh_sweeps)
    s_p, v_p, s_t, v_t = np.asarray(s_p), to_np(v_p), s_t.numpy(), v_t.numpy()
    # singular values: the same f32 rotations in another summation order
    np.testing.assert_allclose(s_t, s_p, rtol=0, atol=1e-5 * s_p.max())
    for b in range(6):
        mm = m[b].astype(complex) @ m[b].conj().T
        lam = np.sort(scipy.linalg.eigvalsh(mm))[::-1]
        np.testing.assert_allclose(s_t[b] ** 2, lam, rtol=0, atol=1e-4 * lam[0])
        # V is unique only up to a phase per column (a converged pair's w
        # phase is rounding noise), so it is checked through m m^H
        for v, s in ((v_t[b], s_t[b]), (v_p[b], s_p[b])):
            np.testing.assert_allclose(v @ np.diag(s ** 2) @ v.conj().T, mm,
                                       rtol=0, atol=1e-4 * lam[0])
            np.testing.assert_allclose(v.conj().T @ v, np.eye(k), atol=1e-4)


@pytest.mark.parametrize("k", [CFG.p + CFG.oversample, 16, 23, 32, 40])
def test_cholqr_rinv_plain_matches_pallas(k):
    g = _grams(np.random.default_rng(3), 5, k)
    shift = (3e-6 * np.einsum("bii->b", g.real) / k).astype(np.float32)
    x_p = to_np(pallas_linalg.cholqr_rinv(from_np(g), shift, interpret=True))
    x_t = cuda_linalg.cholqr_rinv(torch.from_numpy(g),
                                  torch.from_numpy(shift)).numpy()
    # the same f32 operations in another summation order
    np.testing.assert_allclose(x_t, x_p, rtol=0, atol=1e-5 * np.abs(x_p).max())
    for b in range(5):
        np.testing.assert_array_equal(np.tril(x_t[b], -1), 0.0)
        gs = g[b].astype(complex) + shift[b] * np.eye(k)
        np.testing.assert_allclose(x_t[b].conj().T @ gs @ x_t[b], np.eye(k),
                                   atol=1e-4)


def _reduced_matrices(p):
    """Production reduced matrices at rank p: the port's plain sweep of one
    noisy config-1 voxel at m = 200 and 248."""
    from llckbdm_tpu_torch.signals import line_list_from_np, sample_signal
    from llckbdm_tpu_torch.solver.kbdm import KbdmConfig as TorchKbdmConfig
    from llckbdm_tpu_torch.solver.kbdm import kbdm_sweep
    lines = np.array([[1.0, 0.05, -120.0, 0.1], [0.8, 0.08, -40.0, 0.0],
                      [1.2, 0.03, 15.0, -0.2], [0.5, 0.10, 90.0, 0.3],
                      [0.9, 0.06, 200.0, 0.0]])
    rng = np.random.default_rng(p)
    sig = (sample_signal(line_list_from_np(lines), 512, 5e-4).numpy()
           + 1e-4 * (rng.standard_normal(512) + 1j * rng.standard_normal(512)))
    ut = kbdm_sweep(torch.as_tensor(sig[None]).to(torch.complex64), 5e-4,
                    (200, 248), TorchKbdmConfig(p=p), _stop="reduced")
    return ut.reshape(-1, p, p).numpy()


# n past one warp's 32 lanes (the kernel gives a lane two columns there), on
# production reduced matrices: the synthetic family above does not converge
# in ten sweeps from n = 24 on, in either version.  The Pallas kernel in
# interpret mode takes ~15 s at 34, more at 40.
@pytest.mark.parametrize("n", [34, pytest.param(40, marks=pytest.mark.slow)])
def test_eig_cs_wide_plain_matches_pallas(n):
    a = _reduced_matrices(n)
    mu_p, res_p = pallas_jacobi.eig_cs_resid(from_np(a), sweeps=CFG.eig_sweeps,
                                             interpret=True)
    mu_t, res_t = cuda_jacobi.eig_cs_resid(torch.from_numpy(a), CFG.eig_sweeps)
    fro = np.linalg.norm(a, axis=(-1, -2))
    # both converge (the solver's counter bound, 1e-3 |A|_F) and agree to
    # the bound of test_eig_cs_resid_plain_matches_pallas
    assert (res_t.numpy() / fro).max() < 1e-3
    assert (np.asarray(res_p) / fro).max() < 1e-3
    assert (_matched(mu_t.numpy(), to_np(mu_p)) / fro).max() < 3e-3
    np.testing.assert_allclose(res_t.numpy() / fro, np.asarray(res_p) / fro,
                               rtol=0, atol=1e-6)


def _contract_error(x, g, shift):
    """max |R^-H (G + shift I) R^-1 - I| in float64, per matrix."""
    k = g.shape[-1]
    x = x.astype(complex)
    gs = g.astype(complex) + shift[:, None, None] * np.eye(k)
    return np.abs(x.conj().transpose(0, 2, 1) @ gs @ x
                  - np.eye(k)).max(axis=(-1, -2))


@pytest.mark.parametrize("shift_rel", [1e-4, 3e-6])
def test_cholqr_rinv_rank_deficient(shift_rel):
    """A rank-5 Gram at k = 24, the shape of the power iteration's blocks (a
    few lines in a k-wide block), at the solver's two shifts: the plain
    version and the Pallas kernel both stay finite and both meet the
    CholeskyQR contract R^-H (G + shift I) R^-1 = I, held in float64.  The
    19 null directions leave pivots of the size of the shift, so the f32
    rounding of the factor (~k eps |G|) shows in the contract in proportion
    to k eps / shift_rel.  Measured: 1.3e-3 at 1e-4 and 4.2e-2 at 3e-6 (both
    versions alike); the bound is 0.2 k eps / shift_rel, 5.7e-3 and 0.19."""
    k, rank = CFG.p + CFG.oversample, 5
    rng = np.random.default_rng(11)
    y = (rng.standard_normal((6, rank, k))
         + 1j * rng.standard_normal((6, rank, k)))
    g = np.einsum("bij,bik->bjk", y.conj(), y).astype(np.complex64)
    shift = (shift_rel * np.einsum("bii->b", g.real) / k).astype(np.float32)
    x_p = to_np(pallas_linalg.cholqr_rinv(from_np(g), shift, interpret=True))
    x_t = cuda_linalg.cholqr_rinv(torch.from_numpy(g),
                                  torch.from_numpy(shift)).numpy()
    bound = 0.2 * k * np.finfo(np.float32).eps / shift_rel
    for x in (x_t, x_p):
        assert np.isfinite(x).all()
        err = _contract_error(x, g, shift)
        assert err.max() < bound, err


@pytest.mark.parametrize("k", [16, 32, 64, 63])
def test_chol_solve_plain_matches_pallas(k):
    rng = np.random.default_rng(k)
    g = _grams(rng, 5, k)
    b = (rng.standard_normal((5, k))
         + 1j * rng.standard_normal((5, k))).astype(np.complex64)
    shift = np.array([0.5, 1.0, 2.0, 4.0, 8.0], np.float32)
    x_p = to_np(pallas_linalg.chol_solve(from_np(g), from_np(b), shift,
                                         interpret=True))
    x_t = cuda_linalg.chol_solve(torch.from_numpy(g), torch.from_numpy(b),
                                 torch.from_numpy(shift)).numpy()
    np.testing.assert_allclose(x_t, x_p, rtol=0, atol=1e-5 * np.abs(x_p).max())
    for i in range(5):
        xe = scipy.linalg.solve(g[i].astype(complex) + shift[i] * np.eye(k), b[i])
        np.testing.assert_allclose(x_t[i], xe, rtol=1e-4, atol=1e-6)


def test_wrappers_reject_bad_inputs(monkeypatch):
    with pytest.raises(TypeError):
        cuda_jacobi.eig_cs(torch.zeros(2, 4, 4, dtype=torch.complex128))
    with pytest.raises(ValueError):
        cuda_jacobi.eig_cs(torch.zeros(2, 4, 3, dtype=torch.complex64))
    with pytest.raises(ValueError):
        cuda_linalg.gram_svd(torch.zeros(1, 34, 33, dtype=torch.complex64))
    with pytest.raises(ValueError):
        cuda_linalg.chol_solve(torch.zeros(2, 4, 4, dtype=torch.complex64),
                               torch.zeros(2, 3, dtype=torch.complex64), 0.0)
    # each kernel has its own size limit, checked only where it would launch
    # (a CUDA tensor; here the launch branch is forced, and the check
    # raises before the library is touched): each takes 64, as the JAX
    # package's kernels do (the solve: the 64 x 64 normal equations of 32
    # clusters); the message names the config field to lower.  A CPU tensor
    # takes the plain version at any size (tests/test_torch_wide.py).
    monkeypatch.setattr(_build, "use_kernel", lambda name, x: True)
    with pytest.raises(ValueError, match=r"k <= 64.*refined clusters"):
        cuda_linalg.chol_solve(torch.zeros(1, 65, 65, dtype=torch.complex64),
                               torch.zeros(1, 65, dtype=torch.complex64), 0.0)
    with pytest.raises(ValueError,
                       match=r"k <= 64.*KbdmConfig\.p \+ oversample"):
        cuda_linalg.cholqr_rinv(torch.zeros(1, 65, 65, dtype=torch.complex64),
                                0.0)
    with pytest.raises(ValueError,
                       match=r"k <= 64.*KbdmConfig\.p \+ oversample"):
        cuda_linalg.gram_svd(torch.zeros(1, 65, 65, dtype=torch.complex64))
    with pytest.raises(ValueError, match=r"n <= 64.*KbdmConfig\.p"):
        cuda_jacobi.eig_cs(torch.zeros(1, 65, 65, dtype=torch.complex64))


def test_cpu_tensors_take_the_plain_versions_uncounted():
    """A CPU tensor goes to the plain version; neither launch counts nor
    plain-on-CUDA counts move."""
    from llckbdm_tpu_torch.ops import _build
    _build.reset_counts()
    g = torch.from_numpy(_grams(np.random.default_rng(0), 2, 4))
    cuda_jacobi.eig_cs(g.transpose(-1, -2) + g, 1)
    cuda_linalg.gram_svd(g, 1)
    cuda_linalg.cholqr_rinv(g, 0.0)
    cuda_linalg.chol_solve(g, g[..., 0], 0.0)
    assert not _build.LAUNCHES and not _build.PLAIN_ON_CUDA
