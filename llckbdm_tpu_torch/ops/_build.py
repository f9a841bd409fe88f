"""Build and load the package's CUDA kernels (``llckbdm_tpu_torch/csrc``).

The sources are compiled by ``nvcc``, one process per source, all started
together, and linked into one shared library with a plain C interface, on
first use, into ``llckbdm_tpu_torch/_build/`` (listed in ``.gitignore``),
keyed on a hash of the sources and flags; ``ctypes`` loads it.  A source that includes PyTorch's headers would take minutes to build;
this takes seconds.  Nothing here runs at import time, and nothing catches a
failed build.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0.

The launch counts live here too: every wrapper adds one to
``LAUNCHES[name]`` where it launches its kernel, and every plain version adds
one to ``PLAIN_ON_CUDA[name]`` when it is handed a CUDA tensor (which only a
comparison with the kernel does).  ``chip_smoke.py`` resets both before the
main path and reads them after.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "llck_eig_cs": (_P, _P, _P, _I, _I, _I, _P),
    "llck_gram_svd": (_P, _P, _P, _I, _I, _I, _P),
    "llck_cholqr_rinv": (_P, _P, _P, _I, _I, _P),
    "llck_chol_solve": (_P, _P, _P, _P, _I, _I, _P),
    "llck_chol_resources": (_I, _I, _P),
    "llck_gn_normal": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "llck_orth_gram": (_P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                       _P, _P, _P),
    "llck_orth_mix": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "llck_row_probe": (_P, _P, _P, _I, _I, _I, _P),
    "llck_eigh_probe": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "llck_empty": (_P,),
}

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_ON_CUDA: collections.Counter = collections.Counter()


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_ON_CUDA.clear()


def use_kernel(name: str, x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def count_plain(name: str, x) -> None:
    """Called by every plain version: counts the calls on a CUDA tensor."""
    if x.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _compile(sources: list[pathlib.Path], obj_dir: pathlib.Path):
    """One nvcc per source, all running at once; raises if any failed."""
    objs = [obj_dir / f"{src.stem}.o" for src in sources]
    procs = []
    try:
        for src, obj in zip(sources, objs):
            procs.append(subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return objs


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libllckbdm_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under temporary names and rename: a concurrent process never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = _compile(sources, pathlib.Path(tmp))
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([_nvcc(), "-shared", "-o", out, *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(out, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
