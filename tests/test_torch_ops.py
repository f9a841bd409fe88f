"""The PyTorch port's signals, Hankel gather and DBSCAN vs JAX and the oracle.

The same numpy inputs go through the JAX function and its port.  DBSCAN is
held label for label against the JAX ``dbscan_1d`` (the kernel the JAX
pipeline runs on the CPU) and as a partition against sklearn.
"""
import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

import llckbdm_tpu as lt
import llckbdm_tpu_torch as lp
from llckbdm_tpu.ops import dbscan as jdb
from llckbdm_tpu.ops.cplx import from_np, to_np
from llckbdm_tpu.ops import hankel as jhankel
from llckbdm_tpu.ops.hankel import hankel_matrices as jax_hankel
from llckbdm_tpu.oracle import reference as oracle
from llckbdm_tpu_torch.ops import dbscan as tdb
from llckbdm_tpu_torch.ops import hankel as thankel
from llckbdm_tpu_torch.ops.hankel import hankel_matrices
from llckbdm_tpu_torch.pipeline.llckbdm import transform_line_lists

torch.set_num_threads(1)


def test_sample_signal_matches_oracle_and_jax(brain_params):
    dwell = 2.5e-4
    lines = lp.line_list_from_np(brain_params, k=24)
    sig = lp.sample_signal(lines, 2048, dwell)
    assert sig.dtype == torch.complex128 and sig.shape == (2048,)
    # the port synthesizes in float64 from float32 line parameters
    ref = oracle.sample_signal(lp.line_list_to_np(lines), 2048, dwell)
    np.testing.assert_allclose(sig.numpy(), ref, rtol=0, atol=1e-9)
    jsig = to_np(lt.sample_signal(lt.line_list_from_np(brain_params, k=24),
                                  2048, dwell))
    np.testing.assert_allclose(sig.numpy(), jsig, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_line_list_round_trip(five_peak_params):
    lines = lp.line_list_from_np(five_peak_params[::-1], k=8)
    assert lines.shape == (8,) and float(lines.mask.sum()) == 5
    np.testing.assert_allclose(lp.line_list_to_np(lines), five_peak_params,
                               rtol=1e-6)
    np.testing.assert_array_equal(
        lp.line_list_to_np(lines),
        lt.line_list_to_np(lt.line_list_from_np(five_peak_params[::-1], k=8)))


def test_hankel_matches_jax():
    rng = np.random.default_rng(0)
    c = (rng.standard_normal((3, 40))
         + 1j * rng.standard_normal((3, 40))).astype(np.complex64)
    for shift in (0, 1):
        got = hankel_matrices(torch.as_tensor(c), 16, shift).numpy()
        np.testing.assert_array_equal(got, to_np(jax_hankel(from_np(c), 16,
                                                            shift)))
    with pytest.raises(ValueError):
        hankel_matrices(torch.as_tensor(c), 21)


@pytest.mark.parametrize("m", [1, 2, 3, 180, 256, 512])
def test_fft_length_matches_jax(m):
    assert thankel.fft_length(m) == jhankel.fft_length(m)


def _crand(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("m,n,shift,n_fft", [(16, 40, 0, None),
                                             (16, 40, 3, None),
                                             (16, 40, 0, 64),
                                             (180, 512, 1, None)])
def test_hankel_fft_spectrum_matches_jax(m, n, shift, n_fft):
    """The spectrum of the signal window at complex64 tolerance (the two
    FFT libraries round differently), with and without shift and n_fft."""
    c = _crand(np.random.default_rng(m + shift), 3, n)
    got = thankel.hankel_fft_spectrum(torch.as_tensor(c), m, shift,
                                      n_fft).numpy()
    want = np.asarray(jhankel.hankel_fft_spectrum(from_np(c), m, shift,
                                                  n_fft))
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("m,n,shift,j", [(16, 40, 0, 5), (16, 40, 3, 5),
                                         (180, 512, 0, 24),
                                         (180, 512, 1, 7)])
def test_hankel_apply_fft_matches_jax_and_dense(m, n, shift, j):
    """hankel_apply_fft against the JAX function and against the dense
    hankel_matrices(c, m, shift) @ x in float64, at complex64 tolerance
    (2e-6 of the largest entry), with and without shift."""
    rng = np.random.default_rng(m * 7 + shift)
    c, x = _crand(rng, 2, n), _crand(rng, 2, m, j)
    spec = thankel.hankel_fft_spectrum(torch.as_tensor(c), m, shift)
    got = thankel.hankel_apply_fft(spec, torch.as_tensor(x), m).numpy()
    jspec = jhankel.hankel_fft_spectrum(from_np(c), m, shift)
    want = to_np(jhankel.hankel_apply_fft(jspec, from_np(x), m))
    dense = (hankel_matrices(torch.as_tensor(c.astype(np.complex128)), m,
                             shift).numpy() @ x.astype(np.complex128))
    scale = np.abs(dense).max()
    assert got.shape == (2, m, j) and got.dtype == np.complex64
    np.testing.assert_allclose(got, dense, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


def test_hankel_fft_spectrum_raises_where_jax_zero_pads():
    """A signal shorter than the operator's 2m - 1 entries (after shift)
    raises ValueError.  The JAX function zero-pads it silently and applies
    an operator the signal does not define: this departure from the
    reference is deliberate (ADVICE.md).  An n_fft below 2m - 1, which
    would wrap, raises too."""
    c = _crand(np.random.default_rng(0), 2, 40)
    jhankel.hankel_fft_spectrum(from_np(c[:, :30]), 16)     # pads, no error
    with pytest.raises(ValueError, match="need n >= 2m - 1 \\+ shift"):
        thankel.hankel_fft_spectrum(torch.as_tensor(c[:, :30]), 16)
    with pytest.raises(ValueError, match="need n >= 2m - 1"):
        thankel.hankel_fft_spectrum(torch.as_tensor(c), 16, shift=10)
    with pytest.raises(ValueError, match="would wrap"):
        thankel.hankel_fft_spectrum(torch.as_tensor(c), 16, n_fft=16)
    thankel.hankel_fft_spectrum(torch.as_tensor(c[:, :31]), 16)  # 2m - 1


def _pooled_features(rng, b, n):
    """Voxel batches shaped like the pipeline's pooled lines: tight groups
    (genuine lines recurring across the m sweep), scattered junk, and
    invalid slots."""
    x = np.empty((b, n), np.float32)
    valid = np.ones((b, n), bool)
    for i in range(b):
        centers = rng.uniform(-0.2, 0.2, 5)
        k = n // 2
        x[i, :k] = (centers[rng.integers(0, 5, k)]
                    + 3e-5 * rng.standard_normal(k))
        x[i, k:] = rng.uniform(-0.25, 0.25, n - k)
        valid[i, rng.permutation(n)[: n // 8]] = False
    return x, valid


def test_dbscan_1d_matches_jax_label_for_label_and_sklearn():
    rng = np.random.default_rng(5)
    x, valid = _pooled_features(rng, 6, 280)
    eps, min_samples = 2e-4, 10
    got = tdb.dbscan_1d(torch.as_tensor(x), torch.as_tensor(valid), eps,
                        min_samples).numpy()
    ref = np.asarray(jax.vmap(lambda a, v: jdb.dbscan_1d(a, v, eps,
                                                         min_samples))(
        jnp.asarray(x), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, ref)
    for i in range(6):
        sk = np.full(280, -1)
        sk[valid[i]] = DBSCAN(eps=eps, min_samples=min_samples).fit(
            x[i, valid[i], None].astype(np.float64)).labels_
        np.testing.assert_array_equal(got[i] == -1, sk == -1)
        part = lambda lab: frozenset(frozenset(np.flatnonzero(lab == v))
                                     for v in set(lab.tolist()) - {-1})
        assert part(got[i]) == part(sk)
        assert len(part(got[i])) >= 3          # the groups were found


def _dbscan_sets():
    """tests/test_dbscan.py:28-64's four point sets (blobs with scattered
    noise, a blob with masked points, a chain, all noise) as one batch,
    each padded with invalid points to the largest set's size."""
    rng = np.random.default_rng(0)
    centers = np.array([[0.0, 0.0], [1.0, 1.0], [-1.0, 0.5]])
    blobs = np.concatenate(
        [c + 0.02 * rng.standard_normal((40, 2)) for c in centers]
        + [rng.uniform(-2, 2, (30, 2))])
    masked = 0.01 * np.random.default_rng(1).standard_normal((64, 2))
    chain = np.concatenate([np.arange(50)[:, None] * 0.05, np.zeros((50, 1))],
                           axis=1)
    noise = np.random.default_rng(2).uniform(-10, 10, (32, 2))
    sets = [(blobs, len(blobs)), (masked, 40), (chain, 50), (noise, 32)]
    n = len(blobs)
    feats = np.zeros((len(sets), n, 2), np.float32)
    valid = np.zeros((len(sets), n), bool)
    for i, (pts, n_valid) in enumerate(sets):
        feats[i, :len(pts)] = pts
        valid[i, :n_valid] = True
    return feats, valid


def _jax_dbscan(feats, valid, eps, min_samples, max_iters=24):
    return np.asarray(jax.vmap(lambda f, v: jdb.dbscan(
        f, v, eps, min_samples, max_iters=max_iters))(jnp.asarray(feats),
                                                      jnp.asarray(valid)))


# each set's own (eps, min_samples) in tests/test_dbscan.py, run on all four
@pytest.mark.parametrize("eps,min_samples", [(0.1, 8), (0.1, 5), (0.06, 3),
                                             (1e-3, 5)])
def test_dbscan_matches_jax_label_for_label(eps, min_samples):
    feats, valid = _dbscan_sets()
    got = tdb.dbscan(torch.as_tensor(feats), torch.as_tensor(valid), eps,
                     min_samples)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_dbscan(feats, valid, eps, min_samples))
    assert (got.numpy()[~valid] == -1).all()


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_dbscan_max_iters_binds_as_in_jax(max_iters):
    """A chain numbered against its order, so that min labels travel one
    link a round (two with the pointer jump): rounds stop at max_iters
    before the fixed point, and the labels are JAX's at the same bound."""
    n = 64
    feats = np.zeros((2, n, 2), np.float32)
    feats[0, :, 0] = np.arange(n)[::-1] * 0.05
    feats[1, :, 1] = np.arange(n) * 0.05            # converges at once
    valid = np.ones((2, n), bool)
    got = tdb.dbscan(torch.as_tensor(feats), torch.as_tensor(valid), 0.06, 2,
                     max_iters=max_iters).numpy()
    np.testing.assert_array_equal(
        got, _jax_dbscan(feats, valid, 0.06, 2, max_iters))
    assert len(set(got[0].tolist())) > 1            # not yet one cluster
    full = tdb.dbscan(torch.as_tensor(feats), torch.as_tensor(valid), 0.06,
                      2).numpy()
    assert (full[0] == 0).all() and (full[1] == 0).all()


def test_dbscan_with_zero_second_feature_is_dbscan_1d():
    rng = np.random.default_rng(7)
    x, valid = _pooled_features(rng, 6, 280)
    feats = np.stack([x, np.zeros_like(x)], axis=-1)
    for eps, min_samples in ((2e-4, 10), (1e-3, 4)):
        got = tdb.dbscan(torch.as_tensor(feats), torch.as_tensor(valid), eps,
                         min_samples)
        want = tdb.dbscan_1d(torch.as_tensor(x), torch.as_tensor(valid), eps,
                             min_samples)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_dbscan_chunks_give_the_same_labels(monkeypatch):
    """Voxels split over several (chunk, n, n) blocks label as in one."""
    rng = np.random.default_rng(8)
    x, valid = _pooled_features(rng, 5, 120)
    feats = torch.as_tensor(np.stack([x, 0.5 * x ** 2], axis=-1))
    whole = tdb.dbscan(feats, torch.as_tensor(valid), 2e-4, 6)
    monkeypatch.setattr(tdb, "_CHUNK_ELEMS", 2 * 120 * 120)
    np.testing.assert_array_equal(
        tdb.dbscan(feats, torch.as_tensor(valid), 2e-4, 6).numpy(),
        whole.numpy())


def test_compact_labels_and_masked_median_match_jax():
    rng = np.random.default_rng(6)
    x, valid = _pooled_features(rng, 4, 160)
    labels = tdb.dbscan_1d(torch.as_tensor(x), torch.as_tensor(valid), 2e-4, 6)
    member, counts = tdb.compact_labels(labels, 8)
    values = rng.standard_normal((4, 160)).astype(np.float32)
    med = tdb.masked_median(torch.as_tensor(values), member).numpy()
    for i in range(4):
        jm, jc = jdb.compact_labels(jnp.asarray(labels[i].numpy(), jnp.int32), 8)
        np.testing.assert_array_equal(member[i].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(
            med[i], np.asarray(jdb.masked_median(jnp.asarray(values[i]), jm)))
        for c in range(8):
            sel = member[i, :, c].numpy() > 0
            expect = np.median(values[i, sel]) if sel.any() else 0.0
            np.testing.assert_allclose(med[i, c], expect, rtol=1e-6)


def test_transform_matches_oracle(five_peak_params):
    dwell = 5e-4
    lines = lp.line_list_from_np(five_peak_params, dtype=torch.float64)
    got = transform_line_lists(lines, dwell, damping_weight=0.5).numpy()
    ref = oracle.transform_line_lists(five_peak_params, dwell,
                                      damping_weight=0.5)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p.relative_to(ROOT).as_posix() for p in
                    (ROOT / "llckbdm_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
# library kernels where the port's own kernels belong
FORBIDDEN = re.compile(r"torch\.linalg\.(eig|eigh|eigvals|cholesky|solve|svd)\b"
                       r"|torch\.compile\b|scaled_dot_product_attention")


def _without_yardsticks(src: str) -> str:
    """chip_smoke.py without its table of library yardsticks, the one
    module-level ``LIBRARY = {...}`` assignment: the PyTorch calls that
    ``cuda_ms`` times beside the kernels and that nothing else calls."""
    tables = [node for node in ast.parse(src).body
              if isinstance(node, ast.Assign)
              and [getattr(t, "id", None) for t in node.targets] == ["LIBRARY"]]
    assert len(tables) == 1
    lines = src.splitlines(keepends=True)
    del lines[tables[0].lineno - 1:tables[0].end_lineno]
    return "".join(lines)


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax_and_no_library_kernels(path):
    src = (ROOT / path).read_text()
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "llckbdm_tpu"), (path, name)
    if path == "chip_smoke.py":
        src = _without_yardsticks(src)
    assert not FORBIDDEN.search(src), (path, FORBIDDEN.search(src).group(0))
