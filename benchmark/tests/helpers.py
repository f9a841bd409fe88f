"""Small traffic for CPU runs of the harness: the cell's configuration at
its published sizes, a few voxels, a short window; and a second traffic
kind, added to a copy as files, as a later change adds one."""
import json
import shutil

SMALL = {"batch": {"voxels": 2, "batches": 2, "warmups": 1, "check": 2}}

# a traffic kind whose unit of work is not a batch: the traffic's voxels,
# resident on the device, fed to fit_refine in chunks of ``chunk`` voxels
# in turn, as a grid's shards are, each chunk's answers copied to the host
CHUNKED_LOOP = '''"""The voxels fed to fit_refine in chunks, as a grid's
shards are."""
import torch

from ..inputs import sample, synthesize
from . import fit_refine, nonfinite, now, unit


def setup(ctx, rec):
    v, c = int(ctx.traffic["voxels"]), int(ctx.traffic["chunk"])
    host, _, dev = synthesize(ctx.config["signal"], v, ctx.seed, ctx.device)
    ctx.state.update(host=host, c64=list(dev.split(c)),
                     c32=[x.to(torch.complex64) for x in dev.split(c)],
                     picks=sample(ctx.seed, v, int(ctx.traffic["check"])),
                     outs=[], bad=0)
    ctx.state["fit_input"] = ctx.state["c32"][0]
    for i in range(int(ctx.traffic["warmups"])):
        k = i % len(ctx.state["c32"])
        fit_refine(ctx, ctx.state["c32"][k], ctx.state["c64"][k], rec,
                   traced=False)
    ctx.sync()


def window(ctx, seconds, rec, traced):
    c32, c64, outs = ctx.state["c32"], ctx.state["c64"], ctx.state["outs"]
    t0 = t = now()
    while t - t0 < seconds:
        k = len(outs) % len(c32)
        out = fit_refine(ctx, c32[k], c64[k], rec, traced)
        ctx.state["bad"] += int(nonfinite(*out[2:]).sum())
        outs.append((k, [x.cpu() for x in out]))
        t = now()
    rec.window = (t0, t)
    rec.units = rec.attempted = sum(len(c32[k]) for k, _ in outs)


def replay(ctx, i, rec):
    k = i % len(ctx.state["c32"])
    fit_refine(ctx, ctx.state["c32"][k], ctx.state["c64"][k], rec,
               traced=True)


def failed(ctx, rec):
    return ctx.state["bad"]


def answers(ctx):
    c = int(ctx.traffic["chunk"])
    return [(ctx.state["host"][i],
             [unit(*(x[i % c] for x in out))
              for k, out in ctx.state["outs"] if k == i // c])
            for i in ctx.state["picks"]]


def close(ctx):
    pass
'''


def small_copy(src, dst):
    """A copy of ``benchmark/`` and ``BENCHMARK.json`` under ``dst`` whose
    traffic files of the kinds in ``SMALL`` are cut to a few voxels; returns
    the copy's benchmark directory."""
    bench = dst / "benchmark"
    shutil.copytree(src / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src / "BENCHMARK.json", dst / "BENCHMARK.json")
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(SMALL.get(t["kind"], {}))
        path.write_text(json.dumps(t))
    return bench


def add_chunked_cell(bench, traffic: dict, metrics: list[str]) -> dict:
    """Add the ``chunked`` kind to the copy ``bench`` as files and entries
    only: its loop, a traffic file with ``traffic``'s parameters and the
    cell ``five_peak_clean.chunked``, appended to the ``workloads`` of
    ``fits_per_s`` and of each of ``metrics``.  Returns the copy's
    ``BENCHMARK.json``."""
    (bench / "loops" / "chunked.py").write_text(CHUNKED_LOOP)
    (bench / "traffic" / "chunked.json").write_text(
        json.dumps(dict(traffic, kind="chunked")))
    path = bench.parent / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    cell = "five_peak_clean.chunked"
    spec["workloads"].append(
        {"name": cell, "config": "five_peak_clean", "traffic": "chunked",
         "chips": 1, "why": "a second traffic kind, added as files"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ["fits_per_s", *metrics]:
            m["workloads"].append(cell)
    path.write_text(json.dumps(spec))
    return spec
