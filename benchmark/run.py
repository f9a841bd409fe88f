"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix and metrics are found by name under
``benchmark/`` (``benchmark/README.md``).  With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a ``torch.profiler`` trace of the window, with the device's
busy time and a breakdown.

Exits 2 without a result where there is no CUDA device or fewer than the
cell asks for, and 3 where JAX or the JAX package was loaded.  The
compared numbers and their limits are the last lines of standard error
and the last key of the result.
"""
import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age() -> float:
    """Seconds this process ran before ``STARTED`` (from /proc; 0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


BEFORE_START = process_age()


def _finite(x):
    """JSON has no infinity: a non-finite compared number prints as null."""
    if isinstance(x, float) and x != x or x in (float("inf"), float("-inf")):
        return None
    return x


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program's toolchain inside the checkout, at a
    # fixed path (the kernels build into llckbdm_tpu_torch/_build/)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    sys.path.insert(0, ROOT)
    from benchmark import harness, spec
    from benchmark.device import device_label

    bench = spec.load()
    chips = int(spec.cell(bench, args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), spec=bench, started=STARTED,
                              before_start=BEFORE_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    result["card"] = device_label("cuda")
    readings = {k: _finite(v) for k, v in result.pop("readings").items()}
    result["readings"] = readings
    checks = result.pop("checks")
    result["checks"] = {k: {n: _finite(x) for n, x in v.items()}
                        for k, v in checks.items()}
    print(f"# {result['card']}; setup {result['setup_parts']}",
          file=sys.stderr)
    print(f"# readings beside the check (no limit): {readings}",
          file=sys.stderr)
    for line in harness.check_lines({"checks": checks}):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
