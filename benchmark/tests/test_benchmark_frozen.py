"""The benchmark's frozen copies against their sources in the program, and
the imports of every module under ``benchmark/``.  CPU only."""
import ast
import inspect
import pathlib

import numpy as np
import pytest

from benchmark import bounds, device, inputs, spec
from benchmark.reference import oracle, signals
from llckbdm_tpu_torch import oracle as port_oracle
from llckbdm_tpu_torch.tools import bounds as port_bounds
from llckbdm_tpu_torch.tools import config5_run, five_peak, timing

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ORACLE_FUNCTIONS = ("sample_signal", "kbdm", "transform_line_lists", "dbscan",
                    "llc_kbdm", "refine", "line_errors", "match_lines")


def _body(fn) -> str:
    """A function's AST without its docstring."""
    node = ast.parse(inspect.getsource(fn)).body[0]
    if ast.get_docstring(node) is not None:
        node.body = node.body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("name", ORACLE_FUNCTIONS)
def test_oracle_copy_equals_source(name):
    assert _body(getattr(oracle, name)) == _body(getattr(port_oracle, name))


def test_device_label_copy_equals_source():
    assert _body(device.device_label) == _body(timing.device_label)
    assert device.device_label("cpu") == timing.device_label("cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_five_peak_signals_copy(seed):
    got = signals.five_peak_signals(6, 1e-4, seed=seed)
    want = five_peak.signals(6, 1e-4, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_make_grid_signals_copy():
    got = signals.make_grid_signals(40, chunk=16, seed=0)
    want = config5_run.make_grid_signals(40, chunk=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    other = signals.make_grid_signals(40, chunk=16, seed=1)
    assert not np.array_equal(other[1], want[1])


@pytest.mark.parametrize("shape", [(71680, 16, 10), (47104, 24, 10),
                                   (71680, 24, 7), (47104, 32, 7)])
def test_bounds_copy(shape):
    assert bounds.eig_cs(*shape) == port_bounds.eig_cs(*shape)
    assert bounds.gram_svd(*shape) == port_bounds.gram_svd(*shape)


def test_config_lines_equal_their_sources():
    five = spec.config("five_peak_clean")["signal"]
    np.testing.assert_array_equal(five["lines"], five_peak.FIVE_PEAK)
    assert (five["n"], five["dwell"]) == (five_peak.N, five_peak.DWELL)
    brain = spec.config("brain_clean")["signal"]
    csv = np.loadtxt(ROOT / "data" / "params_brain_sim.csv", delimiter=",",
                     skiprows=1, usecols=(1, 2, 3, 4))
    np.testing.assert_array_equal(brain["lines"], csv)


def test_generator_draws_make_grid_signals_lines():
    """The harness's generator draws make_grid_signals' lines; its noise and
    line sum run on the device."""
    sig = spec.config("five_peak_clean")["signal"]
    truths = inputs.draw_lines(np.random.default_rng(0), sig, 50)
    np.testing.assert_array_equal(truths,
                                  signals.make_grid_signals(50, seed=0)[1])
    quiet = dict(sig, noise=0.0)
    host, truths, dev = inputs.synthesize(quiet, 5, 11, "cpu")
    for i in range(5):
        np.testing.assert_allclose(
            host[i], oracle.sample_signal(truths[i], sig["n"], sig["dwell"]),
            rtol=0, atol=1e-12)
    np.testing.assert_array_equal(host, dev.numpy())


def test_brain_generator_shares_one_shift_per_voxel():
    sig = spec.config("brain_clean")["signal"]
    truths = inputs.draw_lines(np.random.default_rng(5), sig, 30)
    shift = truths[:, :, 2] - np.asarray(sig["lines"])[:, 2]
    np.testing.assert_allclose(shift, shift[:, :1].repeat(16, 1), atol=1e-9)
    assert 0.5 < shift[:, 0].std() < 4.0


def test_same_seed_same_inputs():
    sig = spec.config("brain_clean")["signal"]
    a = inputs.synthesize(sig, 3, 2 ** 31 + 7, "cpu")[0]
    b = inputs.synthesize(sig, 3, 2 ** 31 + 7, "cpu")[0]
    c = inputs.synthesize(sig, 3, 2 ** 31 + 8, "cpu")[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert inputs.synthesize(sig, 2, -5, "cpu")[0].shape == (2, 2048)


def _top_level_imports(path: pathlib.Path) -> tuple[set, set]:
    """(top-level names imported absolutely, levels of relative imports)."""
    names, levels = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                levels.add(node.level)
            else:
                names.add(node.module.split(".")[0])
    return names, levels


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_and_a_reference_apart_from_the_program(path):
    names, levels = _top_level_imports(path)
    assert not names & {"jax", "jaxlib", "flax", "llckbdm_tpu"}
    if "reference" in path.relative_to(BENCH).parts:
        assert "llckbdm_tpu_torch" not in names
        assert "benchmark" not in names and levels <= {1}


def test_reference_runs_without_the_program():
    """The reference's modules import in a process that has no program:
    numpy and scipy only."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['llckbdm_tpu_torch'] = None; "
            "sys.modules['torch'] = None; "
            "import benchmark.reference.compare, benchmark.reference.signals")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
