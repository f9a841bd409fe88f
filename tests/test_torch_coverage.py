"""The port is complete against the JAX package: every public function of
the JAX package, its tools, ``bench.py`` and ``__graft_entry__.py`` has a
counterpart in ``llckbdm_tpu_torch/``, and every function that reaches a
Pallas kernel has a CUDA source.

Read with ``ast`` alone: nothing of JAX or of either package is imported.

* Each JAX module maps to its port module (the same path under
  ``llckbdm_tpu_torch/`` unless ``MODULES`` names another), which must
  exist.  Every top-level public ``def`` of it must be a top-level ``def``
  of that module, or be listed in ``RENAMED`` (its port's name, whose
  ``def`` must exist) or in ``NOT_PORTED`` (with the reason).  A table
  entry whose JAX ``def`` is gone fails as stale.
* Every function that encloses a ``pallas_call`` maps in ``KERNELS`` to a
  ``llckbdm_tpu_torch/csrc/*.cu`` that exists.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_files(root: pathlib.Path) -> list[str]:
    """The JAX side: the package, its tools and its two entry scripts."""
    files = [*root.glob("llckbdm_tpu/**/*.py"), *root.glob("tools/*.py"),
             root / "bench.py", root / "__graft_entry__.py"]
    return sorted(str(p.relative_to(root)) for p in files if p.is_file())


# JAX module -> port module, where it is not the same path under
# llckbdm_tpu_torch/ (None: no counterpart, every def is NOT_PORTED)
MODULES = {
    "llckbdm_tpu/ops/cplx.py": "llckbdm_tpu_torch/ops/powers.py",
    "llckbdm_tpu/ops/jacobi.py": "llckbdm_tpu_torch/ops/cuda_jacobi.py",
    "llckbdm_tpu/ops/pallas_jacobi.py": "llckbdm_tpu_torch/ops/cuda_jacobi.py",
    "llckbdm_tpu/ops/pallas_linalg.py": "llckbdm_tpu_torch/ops/cuda_linalg.py",
    "llckbdm_tpu/oracle/reference.py": "llckbdm_tpu_torch/oracle.py",
    "llckbdm_tpu/utils/df.py": None,
    "tools/pallas_smoke.py": "llckbdm_tpu_torch/tools/kernel_smoke.py",
    "bench.py": "llckbdm_tpu_torch/bench.py",
    "__graft_entry__.py": "llckbdm_tpu_torch/entry.py",
}

RENAMED = {
    "tools/bench_eigh_variants.py::make_kernel":
        "llckbdm_tpu_torch/ops/cuda_probes.py::eigh_probe",
    "tools/pallas_smoke.py::kernel":
        "llckbdm_tpu_torch/ops/cuda_probes.py::row_probe",
    "tools/bench_fft_hankel.py::timeit":
        "llckbdm_tpu_torch/tools/timing.py::cuda_ms",
    "tools/profile_stages.py::measure_dispatch_floor":
        "llckbdm_tpu_torch/tools/profile_stages.py::dispatch_floor",
    "tools/profile_stages.py::timeit":
        "llckbdm_tpu_torch/tools/timing.py::host_mean",
    "tools/scaling_bench.py::timeit":
        "llckbdm_tpu_torch/tools/scaling_bench.py::_timed",
    "tools/scaling_bench.py::dp_scaling":
        "llckbdm_tpu_torch/tools/scaling_bench.py::run",
    "tools/scaling_bench.py::overlap_probe":
        "llckbdm_tpu_torch/tools/scaling_bench.py::run",
    "tools/trace_capture.py::summarize":
        "llckbdm_tpu_torch/tools/trace_capture.py::device_rows",
    "tools/tune_sweeps.py::make_signals":
        "llckbdm_tpu_torch/tools/five_peak.py::signals",
    "bench.py::timeit": "llckbdm_tpu_torch/tools/timing.py::host_mean",
    "bench.py::make_signals": "llckbdm_tpu_torch/tools/five_peak.py::signals",
}

CPLX = ("the TPU had no complex dtype: the port computes on complex64 and "
        "complex128 tensors")
DF = ("the TPU had no float64: the port's refinement computes in complex128 "
      "on the card's native float64")
NOT_PORTED = {
    **{f"llckbdm_tpu/ops/cplx.py::{name}": CPLX for name in """
        from_np to_np czeros ceye creal cimag cadd csub cneg cmul cscale conj
        cabs2 cabs cangle cdiv crecip cexp clog csqrt cwhere cmatmul
        cmatmul_rc cmatmul_cr ctranspose chermitian cmatmul_hn cdiag
        cdiagonal cscale_cols cscale_rows cpow_int""".split()},
    **{f"llckbdm_tpu/utils/df.py::{name}": DF for name in """
        two_sum quick_two_sum two_prod df_from_f32 df_from_np df_to_np
        dfc_from_np dfc_to_np dfc_from_f32 df_add df_neg df_sub df_mul
        df_scale df_div df_sqrt df_sum df_where dfc_add dfc_sub dfc_neg
        dfc_mul dfc_conj dfc_abs2 dfc_div dfc_scale dfc_sum dfc_where
        dfc_zeros dfc_pow_traced dfc_powers""".split()},
    "llckbdm_tpu/ops/jacobi.py::eigh":
        "the JAX package's CPU-only lax.scan Jacobi; on a card the port runs "
        "the kernels' algorithms, on the CPU their plain versions",
    "llckbdm_tpu/ops/jacobi.py::backend_name":
        "picks between the JAX package's CPU and TPU paths; the port's "
        "device is the tensor's",
    "llckbdm_tpu/ops/linalg.py::lowner_orth":
        "the JAX package's CPU-only orthonormalization; the port runs "
        "CholeskyQR on every device",
}

# function that encloses a pallas_call -> the CUDA source of its port
KERNELS = {
    "llckbdm_tpu/ops/pallas_jacobi.py::eig_cs_resid":
        "llckbdm_tpu_torch/csrc/eig_cs.cu",
    "llckbdm_tpu/ops/pallas_linalg.py::gram_svd":
        "llckbdm_tpu_torch/csrc/gram_svd.cu",
    "llckbdm_tpu/ops/pallas_linalg.py::cholqr_rinv":
        "llckbdm_tpu_torch/csrc/chol.cu",
    "llckbdm_tpu/ops/pallas_linalg.py::chol_solve":
        "llckbdm_tpu_torch/csrc/chol.cu",
    "tools/pallas_smoke.py::run": "llckbdm_tpu_torch/csrc/row_probe.cu",
    "tools/bench_eigh_variants.py::run":
        "llckbdm_tpu_torch/csrc/eigh_probe.cu",
}


def top_defs(path: pathlib.Path) -> set[str]:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def counterpart(rel: str) -> str | None:
    if rel in MODULES:
        return MODULES[rel]
    if rel.startswith("llckbdm_tpu/"):
        return "llckbdm_tpu_torch/" + rel.removeprefix("llckbdm_tpu/")
    return "llckbdm_tpu_torch/" + rel        # tools/*.py


def missing(rel: str, root: pathlib.Path = ROOT, renamed=RENAMED,
            not_ported=NOT_PORTED) -> list[str]:
    """What the port lacks for the JAX module ``rel`` under ``root``, and
    the stale table entries of that module."""
    jax_defs = top_defs(root / rel)
    port = counterpart(rel)
    if port is not None and not (root / port).is_file():
        return [f"{rel}: its counterpart {port} does not exist"]
    port_defs = top_defs(root / port) if port else set()
    out = []
    for name in sorted(n for n in jax_defs if not n.startswith("_")):
        key = f"{rel}::{name}"
        if key in not_ported:
            continue
        if key in renamed:
            path, new = renamed[key].split("::")
            if not ((root / path).is_file() and new in top_defs(root / path)):
                out.append(f"{key}: renamed to {renamed[key]}, which does "
                           f"not exist")
        elif name not in port_defs:
            out.append(f"{key}: no def {name} in {port}")
    for key in (*renamed, *not_ported):
        path, name = key.split("::")
        if path == rel and name not in jax_defs:
            out.append(f"{key}: stale, {rel} has no def {name}")
    return out


def pallas_callers(root: pathlib.Path = ROOT) -> set[str]:
    """``file::function`` of every function of the JAX side that encloses
    a call of ``pallas_call``."""
    found = set()
    for rel in jax_files(root):
        for fn in ast.walk(ast.parse((root / rel).read_text())):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                f = getattr(node, "func", None)
                if isinstance(node, ast.Call) and "pallas_call" in (
                        getattr(f, "attr", None), getattr(f, "id", None)):
                    found.add(f"{rel}::{fn.name}")
    return found


@pytest.mark.parametrize("rel", jax_files(ROOT))
def test_every_function_has_a_counterpart(rel):
    assert missing(rel) == []


def test_tables_name_modules_of_the_jax_side():
    files = set(jax_files(ROOT))
    keys = [k.split("::")[0] for k in (*RENAMED, *NOT_PORTED, *KERNELS)]
    assert set(MODULES) <= files
    assert set(keys) <= files


def test_every_pallas_kernel_has_a_cuda_source():
    assert len(KERNELS) == 6
    assert pallas_callers() == set(KERNELS)
    for src in KERNELS.values():
        assert src.startswith("llckbdm_tpu_torch/csrc/") and src.endswith(".cu")
        assert (ROOT / src).is_file(), src


def test_checker_reports_a_missing_def(tmp_path):
    """On a small tree: a JAX def with no port def is named, as are a stale
    table entry and a missing counterpart module."""
    (tmp_path / "llckbdm_tpu" / "ops").mkdir(parents=True)
    (tmp_path / "llckbdm_tpu_torch" / "ops").mkdir(parents=True)
    (tmp_path / "llckbdm_tpu" / "ops" / "hankel.py").write_text(
        "def hankel_matrices(c, m):\n    pass\n\n\n"
        "def new_operator(c):\n    pass\n\n\n"
        "def _private(c):\n    pass\n")
    (tmp_path / "llckbdm_tpu_torch" / "ops" / "hankel.py").write_text(
        "def hankel_matrices(c, m):\n    pass\n")
    (tmp_path / "llckbdm_tpu" / "signals.py").write_text("def f():\n pass\n")
    rel = "llckbdm_tpu/ops/hankel.py"
    assert missing(rel, tmp_path, renamed={}, not_ported={}) == [
        f"{rel}::new_operator: no def new_operator in "
        f"llckbdm_tpu_torch/ops/hankel.py"]
    assert missing(rel, tmp_path, renamed={},
                   not_ported={f"{rel}::new_operator": "x",
                               f"{rel}::gone": "y"}) == [
        f"{rel}::gone: stale, {rel} has no def gone"]
    assert missing("llckbdm_tpu/signals.py", tmp_path) == [
        "llckbdm_tpu/signals.py: its counterpart "
        "llckbdm_tpu_torch/signals.py does not exist"]
