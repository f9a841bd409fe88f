"""Small traffic for CPU runs of the harness: the cell's configuration at
its published sizes, a few voxels, a short window."""
import json
import shutil

SMALL = {"batch": {"voxels": 2, "batches": 2, "warmups": 1, "check": 2}}


def small_copy(src, dst):
    """A copy of ``benchmark/`` and ``BENCHMARK.json`` under ``dst`` whose
    traffic files are cut to a few voxels; returns the copy's benchmark
    directory."""
    bench = dst / "benchmark"
    shutil.copytree(src / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src / "BENCHMARK.json", dst / "BENCHMARK.json")
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(SMALL[t["kind"]])
        path.write_text(json.dumps(t))
    return bench
