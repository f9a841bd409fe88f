"""The port's float64 oracle against the JAX package's, and the port's
independence from the JAX package.

``llckbdm_tpu_torch/oracle.py`` is the port's copy of the functions of
``llckbdm_tpu/oracle/reference.py``; on the same numpy inputs the two agree
to 1e-12, and the port's numpy DBSCAN gives scikit-learn's labels.  No
module of the port, and not ``chip_smoke.py``, imports or loads anything of
``llckbdm_tpu``.
"""
import ast
import pathlib

import numpy as np
import pytest
from sklearn.cluster import DBSCAN

from llckbdm_tpu.oracle import reference
from llckbdm_tpu_torch import oracle

ROOT = pathlib.Path(__file__).resolve().parent.parent
DWELL = 5e-4


def _noisy(params, seed, noise=1e-4, n=512):
    rng = np.random.default_rng(seed)
    p = params.copy()
    p[:, 2] += rng.normal(scale=2.0, size=len(p))
    sig = reference.sample_signal(p, n, DWELL)
    return p, sig + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


@pytest.mark.parametrize("n", [512, 37])
def test_sample_signal_matches_reference(five_peak_params, n):
    np.testing.assert_allclose(oracle.sample_signal(five_peak_params, n, DWELL),
                               reference.sample_signal(five_peak_params, n, DWELL),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_matches_reference(five_peak_params, seed):
    truth, sig = _noisy(five_peak_params, seed)
    init = truth.copy()
    init[:, 2] += 0.05
    init[:, 0] *= 1.01
    got = oracle.refine(init, sig, DWELL, iters=12)
    want = reference.refine(init, sig, DWELL, iters=12)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_match_lines_and_line_errors_match_reference(five_peak_params):
    rng = np.random.default_rng(3)
    truth = five_peak_params
    # seven estimated lines in shuffled order, five near the truth
    est = np.concatenate([truth * (1 + 1e-3 * rng.standard_normal(truth.shape)),
                          [[0.1, 0.02, 300.0, 0.0], [0.2, 0.03, -250.0, 1.0]]])
    est = est[rng.permutation(len(est))]
    sel = oracle.match_lines(est, truth)
    np.testing.assert_array_equal(sel, reference.match_lines(est, truth))
    np.testing.assert_allclose(oracle.line_errors(est[sel], truth),
                               reference.line_errors(est[sel], truth),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        oracle.match_lines(est[:3], truth)


@pytest.mark.parametrize("noise,m,p", [(0.0, 180, 16), (1e-4, 180, 16),
                                       (1e-4, 100, 24)])
def test_kbdm_matches_reference(five_peak_params, noise, m, p):
    _, sig = _noisy(five_peak_params, 4, noise)
    for kw in ({}, {"return_all": True}, {"filter_t2_min": 0.04,
                                          "amp_min": 0.6}):
        got, ginfo = oracle.kbdm(sig, DWELL, m=m, p=p, **kw)
        want, winfo = reference.kbdm(sig, DWELL, m=m, p=p, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ginfo["poles"], winfo["poles"], rtol=1e-12)
        assert (ginfo["m"], ginfo["p"]) == (winfo["m"], winfo["p"])
    with pytest.raises(ValueError):
        oracle.kbdm(sig[:300], DWELL, m=180)


def test_transform_line_lists_matches_reference(five_peak_params):
    for weight in (0.0, 1.0, 0.3):
        np.testing.assert_allclose(
            oracle.transform_line_lists(five_peak_params, DWELL,
                                        damping_weight=weight),
            reference.transform_line_lists(five_peak_params, DWELL,
                                           damping_weight=weight),
            rtol=1e-12, atol=0)


@pytest.mark.parametrize("eps,min_samples", [(0.1, 8), (0.25, 4), (0.05, 3)])
def test_dbscan_labels_are_sklearns(eps, min_samples):
    """Blobs, a chain and scattered points: the same labels as sklearn's
    DBSCAN, numbering and border points included."""
    rng = np.random.default_rng(9)
    pts = np.concatenate(
        [c + 0.03 * rng.standard_normal((40, 2)) for c in
         rng.uniform(-1, 1, (3, 2))]
        + [np.stack([np.linspace(-2, -1, 25), np.full(25, 1.5)], axis=1),
           rng.uniform(-2, 2, (60, 2))])
    pts = pts[rng.permutation(len(pts))]
    got = oracle.dbscan(pts, eps, min_samples)
    want = DBSCAN(eps=eps, min_samples=min_samples).fit(pts).labels_
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist()) - {-1}) >= 3


@pytest.mark.parametrize("damping_weight", [0.0, 1.0])
def test_llc_kbdm_matches_reference(five_peak_params, damping_weight):
    """The reference clusters with sklearn: the labels are equal, and the
    consolidated and pooled lines agree to 1e-12."""
    _, sig = _noisy(five_peak_params, 5, 1e-3)
    args = (sig, DWELL, range(120, 181, 10), 16, 2e-4, 5)
    got = oracle.llc_kbdm(*args, damping_weight=damping_weight)
    want = reference.llc_kbdm(*args, damping_weight=damping_weight)
    np.testing.assert_array_equal(got[2], want[2])
    assert len(got[0]) >= 5
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)


# --- the port loads nothing of the JAX package -----------------------------

_LOADERS = {"spec_from_file_location", "import_module", "__import__",
            "run_path", "run_module", "SourceFileLoader", "open", "exec"}


def _names_jax_package(text: str) -> bool:
    return text == "llckbdm_tpu" or text.startswith(("llckbdm_tpu.",
                                                     "llckbdm_tpu/"))


def _loads_of_jax_package(source: str) -> list:
    """Imports of llckbdm_tpu modules, loader calls naming one of its
    files, and "llckbdm_tpu" as a path component, in one module's code."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _names_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _names_jax_package(node.module or ""):
                found.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in _LOADERS:
                found += [c.value for arg in node.args for c in ast.walk(arg)
                          if isinstance(c, ast.Constant) and isinstance(c.value, str)
                          and "llckbdm_tpu" in c.value
                          and "llckbdm_tpu_torch" not in c.value]
        elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)
              and isinstance(node.right, ast.Constant)
              and node.right.value == "llckbdm_tpu"):
            found.append("... / 'llckbdm_tpu'")
    return found


def test_the_check_catches_each_kind_of_load():
    assert _loads_of_jax_package("import llckbdm_tpu.ops.cplx")
    assert _loads_of_jax_package("from llckbdm_tpu.oracle import reference")
    assert _loads_of_jax_package(
        "p = ROOT / 'llckbdm_tpu' / 'oracle' / 'reference.py'")
    assert _loads_of_jax_package(
        "importlib.util.spec_from_file_location('o', 'llckbdm_tpu/oracle/x.py')")
    assert _loads_of_jax_package("importlib.import_module('llckbdm_tpu')")
    assert not _loads_of_jax_package(
        "from llckbdm_tpu_torch import oracle\n"
        "REPLACES = 'llckbdm_tpu/ops/pallas_jacobi.py:94'\n")


def test_port_and_chip_smoke_load_nothing_of_the_jax_package():
    files = sorted((ROOT / "llckbdm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): found for f in files
           if (found := _loads_of_jax_package(f.read_text()))}
    assert not bad, bad
