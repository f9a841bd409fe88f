"""llckbdm_tpu_torch.tools.bounds: each kernel's operations, bytes and least
time on an H100 SXM at the main path's shapes.

The expected values are counted by hand from the shapes and sweep counts
(production KbdmConfig: eig_sweeps 10, eigh_sweeps 7; the north star's
p = 16, k = 24, V = 2048 voxels x 35 sweep entries = 71,680 matrices, and
2C = 32 for the Gauss-Newton solve of 16 clusters; the refine's normal
equations at the two benchmark cells' shapes).
"""
import pytest

from llckbdm_tpu_torch.solver.kbdm import KbdmConfig
from llckbdm_tpu_torch.tools import bounds

CFG = KbdmConfig()
B = 2048 * 35


@pytest.mark.parametrize("name, got, flops, nbytes, by, ms", [
    # 1200 rotations x ~650 flop; A in, mu and the counter out
    ("eig_cs", bounds.eig_cs(B, 16, CFG.eig_sweeps), 56e9, 157e6,
     "operations", 0.83),
    # 1932 pair steps x ~1280 flop; m in, s and V out
    ("gram_svd", bounds.gram_svd(B, 24, CFG.eigh_sweeps), 177e9, 667e6,
     "operations", 2.65),
    # 8k^3/3 flop; G and the shift in, R^-1 out
    ("cholqr_rinv", bounds.cholqr_rinv(B, 24), 2.64e9, 661e6, "bytes",
     0.197),
    # 4k^3/3 + 16k^2 flop; G, b and the shift in, x out
    ("chol_solve", bounds.chol_solve(B, 16), 0.685e9, 166e6, "bytes", 0.0494),
    ("chol_solve GN", bounds.chol_solve(2048, 32), 0.123e9, 17.8e6, "bytes",
     0.00532),
    # the refine's normal equations, a step: float32 16 C(C+1)/2 N + 24 C^2
    # (17.74e9 at the brain cell's V=1024, C=32, N=2048) and float64
    # 26 CN + 2N + the anchors' 12 C ceil(N/64) log2 N (1.89e9); c, z, d
    # in, G and the rhs out
    ("gn_normal brain", bounds.gn_normal(1024, 32, 2048), 19.63e9, 69.21e6,
     "operations", 0.2648),
    # the five-peak cell's V=2048, C=16, N=512: 2.294e9 + 0.467e9
    ("gn_normal five-peak", bounds.gn_normal(2048, 16, 512), 2.761e9,
     35.65e6, "operations", 0.03424),
    # the CholeskyQR pass: the Gram's half and the triangular mix, 8 flops a
    # (j <= l, row) each (2 x 8 x 300 x 256 at k = 24, m = 256) and
    # cholqr_rinv's 8k^3/3; the block read once and written once.  The
    # five-peak cell's bfloat16 pairs (4 bytes an entry) and complex64
    # final passes, and the brain cell's complex64 (V=1024 x 46 entries,
    # m = 300, k = 32: 2 x 8 x 528 x 300 + 87,381 flop a block)
    ("orth_pass five-peak bf16", bounds.orth_pass(B, 256, 24, "bf16"),
     90.72e9, 3.523e9, "operations", 1.354),
    ("orth_pass five-peak complex64", bounds.orth_pass(B, 256, 24,
                                                       "complex64"),
     90.72e9, 7.046e9, "bytes", 2.103),
    ("orth_pass brain", bounds.orth_pass(1024 * 46, 300, 32, "complex64"),
     123.5e9, 7.235e9, "bytes", 2.160),
])
def test_main_path_bounds(name, got, flops, nbytes, by, ms):
    assert got.flops == pytest.approx(flops, rel=0.02), name
    assert got.bytes == pytest.approx(nbytes, rel=0.01), name
    assert got.by == by, name
    assert got.ms == pytest.approx(ms, rel=0.02), name


def test_sweep_counts_scale_the_rotation_work():
    one, ten = bounds.eig_cs(B, 16, 1), bounds.eig_cs(B, 16, 10)
    assert ten.bytes == one.bytes
    assert ten.flops - one.flops == pytest.approx(9 * B * 120 * 648)
    assert bounds.gram_svd(B, 24, 0).flops == B * 4 * 24 * 24


def test_bound_takes_the_larger_term():
    ops = bounds.bound(bounds.PEAK_FLOPS * 1e-3, bounds.PEAK_BYTES * 0.5e-3)
    assert ops.by == "operations" and ops.ms == pytest.approx(1.0)
    mem = bounds.bound(bounds.PEAK_FLOPS * 0.5e-3, bounds.PEAK_BYTES * 2e-3)
    assert mem.by == "bytes" and mem.ms == pytest.approx(2.0)


def test_tool_kernel_bounds():
    row = bounds.row_probe(256, 24, 16)
    assert row.flops == 256 * 16 * (6 * 24 + 3)
    assert row.bytes == 2 * 256 * 24 * 24 * 4 + 16 * 2 * 4
    assert row.by == "bytes"
    full = bounds.eigh_probe(4480, 24, 8)
    assert full.flops == 4480 * (8 * 23 * 12 * (25 + 36 * 24) + 8 * 24 * 24)
    assert full.bytes == 4480 * (24 * 24 * 8 + 24 * 4 + 12)
    assert full.by == "operations"
    coef = bounds.eigh_probe(4480, 24, 8, do_rows=False)
    rows = bounds.eigh_probe(4480, 24, 8, do_v=False)
    assert coef.flops < rows.flops < full.flops


def test_orth_pass_counts_the_storage_and_the_triangles():
    """bfloat16 pairs move half the bytes of complex64 for the same
    operations; the operations grow as the triangles k(k+1)/2, and an
    unknown storage raises."""
    c64, bf = (bounds.orth_pass(10, 64, 8, s) for s in ("complex64", "bf16"))
    assert bf.flops == c64.flops == 10 * (16 * 36 * 64 + 8 * 8 ** 3 / 3)
    assert 2 * bf.bytes == c64.bytes == 10 * 2 * 64 * 8 * 8
    with pytest.raises(ValueError, match="storage"):
        bounds.orth_pass(1, 8, 8, "float16")
