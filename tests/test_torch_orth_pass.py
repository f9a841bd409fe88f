"""The sweep's CholeskyQR pass over a block as stored
(ops/cuda_linalg.py::orth_pass, csrc/orth_pass.cu) on CPU tensors.

The plain version runs the kernels' algorithm: the pairs widened exactly,
a float32 Gram per row group added by a tree, the upper triangle mirrored
with a real diagonal, the product with R^-1 rounded back to pairs once.
It is held here against the sweep's einsum pass (solver/kbdm.py::
_orth_pass on a CPU tensor, the JAX package's algorithm: on complex64 what
the float32 branch and the final passes run, on pairs what the bfloat16
branch ran inline), on small blocks whose rows past each entry's m are
zero.  The CUDA kernels are held against the plain version in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from llckbdm_tpu_torch.ops import _build, cuda_linalg as cl
from llckbdm_tpu_torch.ops.hankel import hankel_matrices
from llckbdm_tpu_torch.signals import line_list_from_np, sample_signal
from llckbdm_tpu_torch.solver import kbdm as K

EPS32 = float(np.finfo(np.float32).eps)
BF16_STEP = 2.0 ** -7     # bfloat16's spacing relative to a value, at most


def _block(seed, v=2, m=40, s=3, k=24, keep=(40, 30, 26)):
    """A complex64 (v, m, s, k) Gaussian block, rows past keep[i] of entry
    i zero (the sweep's masked rows); every entry keeps more rows than
    columns, so its Gram is well conditioned."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((v, m, s, k))
         + 1j * rng.standard_normal((v, m, s, k))).astype(np.complex64)
    for i, mm in enumerate(keep):
        y[:, mm:, i, :] = 0
    return torch.from_numpy(y)


def _within_a_bf16_step(a, b):
    """bfloat16 values a and b within one bfloat16 step of each other,
    beside the float32 rounding by which the two versions' sums may differ
    (64 eps of the block's largest entry: a value that small has a
    bfloat16 step below that rounding)."""
    a, b = a.float(), b.float()
    step = torch.maximum(a.abs(), b.abs()) * BF16_STEP
    return bool(((a - b).abs() <= step + 64 * EPS32 * b.abs().max()).all())


@pytest.mark.parametrize("shift_rel", [K.F32_POWITER_SHIFT, K.FINAL_SHIFT])
@pytest.mark.parametrize("pairs", [False, True], ids=["complex64", "pairs"])
def test_plain_pass_matches_the_einsum_pass(pairs, shift_rel):
    """Both run the same float32 operations in other summation orders: the
    result within float32 rounding (through a Cholesky of condition below
    ~300 here, 1e-5 of the largest entry), on pairs within one bfloat16
    step; masked rows exactly 0 in both."""
    y = _block(1)
    x = cl.to_pairs(y) if pairs else y
    got = cl.orth_pass_plain(x, shift_rel)
    want = K._orth_pass(x, shift_rel, "highest")
    assert got.dtype == want.dtype == x.dtype and got.shape == x.shape
    if pairs:
        assert _within_a_bf16_step(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    for out in (got, want):
        q = cl.from_pairs(out) if pairs else out
        assert bool((q[:, 30:, 1] == 0).all() and (q[:, 26:, 2] == 0).all())


@pytest.mark.parametrize("pairs", [False, True], ids=["complex64", "pairs"])
def test_the_einsum_pass_is_the_sweeps_former_pass(pairs):
    """On a CPU tensor (and at "high") the sweep's pass is the code it ran
    before the kernel: on complex64 the float32 branch's _orth_pass, on
    pairs the bfloat16 branch's inline pass (widen, Gram, symmetrize,
    shift, cholqr_rinv, mix, round back), bit for bit."""
    y = _block(2)
    x = cl.to_pairs(y) if pairs else y
    yc = cl.from_pairs(x) if pairs else x
    g = K._gram_sk(yc, yc)
    g = 0.5 * (g + g.transpose(-1, -2).conj())
    shift = 1e-4 * torch.mean(
        torch.abs(torch.diagonal(g, dim1=-2, dim2=-1).real), dim=-1)
    q = K._mix_sk(yc, cl.cholqr_rinv(g, shift))
    want = cl.to_pairs(q) if pairs else q
    assert torch.equal(K._orth_pass(x, 1e-4), want)


def _former_bf16_branch(h0, x0, mk, cfg):
    """The bfloat16 power iterations as the sweep ran them before its pass
    took the pairs as stored: each pass widened the pairs, formed Q by the
    einsums and rounded it back, and each apply multiplied its input by
    the mask ([mk, -mk] for a pass's result: masked and conjugated)."""
    m, ns, bf = h0.shape[-1], mk.shape[1], torch.bfloat16
    op = torch.empty((*h0.shape[:-2], 2 * m, 2 * m), dtype=bf)
    op[..., :m, :m].copy_(h0.real)
    op[..., :m, m:].copy_(h0.imag).neg_()
    op[..., m:, :m].copy_(h0.imag)
    op[..., m:, m:].copy_(h0.real)
    mk2, mk2c = torch.cat([mk, mk]).to(bf), torch.cat([mk, -mk]).to(bf)

    def apply(xb, mask):
        xm = xb * mask
        y = op @ xm.reshape(*xm.shape[:-2], ns * xm.shape[-1])
        return y.reshape(*y.shape[:-1], ns, xm.shape[-1]).mul_(mk2)

    yb = apply(torch.cat([x0, torch.zeros_like(x0)]).to(bf), mk2)
    for _ in range(cfg.subspace_iters):
        y = cl.from_pairs(yb)
        g = K._gram_sk(y, y)
        g = 0.5 * (g + g.transpose(-1, -2).conj())
        shift = K.BF16_POWITER_SHIFT * torch.mean(
            torch.abs(torch.diagonal(g, dim1=-2, dim2=-1).real), dim=-1)
        yb = apply(cl.to_pairs(K._mix_sk(y, cl.cholqr_rinv(g, shift))), mk2c)
    return cl.from_pairs(yb)


def test_bf16_branch_on_a_cpu_tensor_is_bit_for_bit_the_former():
    """On a CPU tensor the bfloat16 branch (the pass writing Q's conjugate,
    each apply taking its input as it is) gives the former branch's last
    block bit for bit: the mask products it left out changed no bit (the
    rows past m are zeros, the rest multiplied by 1 or -1)."""
    lines = np.array([[1.0, 0.05, -60.0, 0.2], [0.7, 0.08, 45.0, -0.4],
                      [0.5, 0.04, 120.0, 1.0]])
    c = torch.stack([sample_signal(line_list_from_np(lines * [1, 1, f, 1]),
                                   256, 1e-3) for f in (1.0, 0.9)])
    c = c.to(torch.complex64)
    m_values, cfg = (48, 56, 64), K.KbdmConfig(p=8)
    k = cfg.p + cfg.oversample
    h0 = hankel_matrices(c, 64)
    mk = torch.zeros(64, 3, 1)
    for s, m in enumerate(m_values):
        mk[:m, s] = 1.0
    omega = torch.randn((64, k), generator=torch.Generator().manual_seed(0))
    x0 = omega[:, None, :] * mk
    got = K._power_iterations_bf16(h0, x0, mk, cfg)
    want = _former_bf16_branch(h0, x0, mk, cfg)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    assert bool((got[:, 48:, 0] == 0).all())


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("pairs", [False, True], ids=["complex64", "pairs"])
def test_the_plain_pass_writes_the_conjugate_and_the_einsum_layout(pairs,
                                                                   conj):
    """conj=True gives the conjugate of the result, bit for bit; a
    complex64 result lies as the einsum it replaces lays it out ((V, S, m,
    k) in memory, which the sweep's later products take as it is), pairs
    contiguous."""
    y = _block(5)
    x = cl.to_pairs(y) if pairs else y
    q = cl.orth_pass(x, 1e-4)
    qc = cl.orth_pass(x, 1e-4, conj=conj)
    if pairs:
        assert q.is_contiguous() and qc.is_contiguous()
        want = cl.to_pairs(cl.from_pairs(q).conj()) if conj else q
    else:
        assert q.stride() == (3 * 40 * 24, 24, 40 * 24, 1)
        want = q.conj().resolve_conj() if conj else q
    assert torch.equal(qc, want)


@pytest.mark.parametrize("k", [24, 23, 32, 64])
def test_gram_is_hermitian_and_summed_by_row_groups(k):
    """orth_gram's G is Hermitian bit for bit with a real diagonal, within
    float32 rounding of the float64 Gram (a sum of m terms: m eps of the
    largest entry), and the shift is shift_rel times its mean diagonal;
    the row groups are those of the kernel's 256-thread block."""
    y = _block(k, v=1, m=80, s=2, k=k, keep=(80, 72))
    for x in (y, cl.to_pairs(y)):
        g, shift = cl.orth_gram(x, 1e-4)
        assert g.shape == (1, 2, k, k) and shift.shape == (1, 2)
        assert torch.equal(g, g.transpose(-1, -2).conj())
        d = torch.diagonal(g, dim1=-2, dim2=-1)
        assert bool((d.imag == 0).all())
        torch.testing.assert_close(shift, 1e-4 * d.real.abs().mean(-1),
                                   rtol=4 * EPS32, atol=0)
        y64 = (cl.from_pairs(x) if x.dtype == torch.bfloat16 else x).to(
            torch.complex128)
        g64 = torch.einsum("vmsk,vmsl->vskl", y64.conj(), y64)
        assert (g - g64).abs().max() <= 80 * EPS32 * g64.abs().max()
    assert [cl.orth_gram_groups(k) for k in (8, 16, 24, 32, 40, 48, 56, 64)] \
        == [4, 4, 4, 4, 4, 2, 2, 1]


def test_cpu_tensor_takes_the_plain_pass_uncounted():
    """On a CPU tensor orth_pass is the plain version, bit for bit, and no
    launch or plain-on-CUDA count moves."""
    _build.reset_counts()
    y = _block(3)
    for x in (y, cl.to_pairs(y)):
        assert torch.equal(cl.orth_pass(x, 3e-6), cl.orth_pass_plain(x, 3e-6))
    assert not _build.LAUNCHES and not _build.PLAIN_ON_CUDA


def test_the_sweep_sends_a_cuda_pass_at_highest_to_the_kernel(monkeypatch):
    """K._orth_pass sends a CUDA tensor at "highest" to cuda_linalg.orth_pass
    (here a spy: this machine has no card) and takes the einsums anywhere
    else: a CPU tensor, or "high" (TF32 at the JAX package's sites)."""
    calls = []
    monkeypatch.setattr(cl, "orth_pass", lambda y, shift_rel, conj:
                        calls.append(shift_rel) or "kernel")

    class Einsum(Exception):
        pass

    def refuse(*args):
        raise Einsum

    monkeypatch.setattr(K, "_gram_sk", refuse)
    on_card = type("CudaBlock", (), {"is_cuda": True,
                                     "dtype": torch.complex64})()
    assert K._orth_pass(on_card, 1e-4) == "kernel" and calls == [1e-4]
    with pytest.raises(Einsum):
        K._orth_pass(on_card, 1e-4, "high")
    with pytest.raises(Einsum):
        K._orth_pass(_block(4), 1e-4)
    assert calls == [1e-4]


def test_orth_pass_refuses_what_it_does_not_take(monkeypatch):
    """A storage other than complex64 or bfloat16 pairs, an odd pair row
    count, an R^-1 of the wrong shape; on the card (the launch branch forced
    here; the check raises before the library is touched) k past 64, naming
    the config field to lower."""
    with pytest.raises(TypeError):
        cl.orth_pass(torch.zeros(1, 4, 2, 3, dtype=torch.complex128), 1e-4)
    with pytest.raises(ValueError, match="even"):
        cl.orth_gram(torch.zeros(1, 5, 2, 3, dtype=torch.bfloat16), 1e-4)
    with pytest.raises(ValueError, match="x must be"):
        cl.orth_mix(torch.zeros(1, 4, 2, 3, dtype=torch.complex64),
                    torch.zeros(1, 2, 4, 4, dtype=torch.complex64))
    monkeypatch.setattr(_build, "use_kernel", lambda name, x: True)
    for dtype, rows in ((torch.complex64, 70), (torch.bfloat16, 140)):
        with pytest.raises(ValueError,
                           match=r"k <= 64.*KbdmConfig\.p \+ oversample"):
            cl.orth_pass(torch.zeros(1, rows, 2, 65, dtype=dtype), 1e-4)
