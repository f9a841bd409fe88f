"""A closed loop of back-to-back batches resident on the device.

Traffic parameters: ``voxels`` per batch, ``batches`` distinct batches
drawn from the seed (the loop cycles through them), ``warmups`` untimed
batches, ``check`` signals compared with the reference.  Each batch is one
``llc_kbdm_fit`` and one ``refine_lines`` of its top slots, ended by a
sync; the window holds whole batches.  The sample compared with the
reference is drawn in set-up, and each batch keeps only its sampled rows
(and a count of non-finite answers on the device), so the window holds no
growing store of answers.
"""
from __future__ import annotations

import torch

from ..inputs import sample, synthesize
from . import fit_refine, nonfinite, now, unit


def setup(ctx, rec) -> None:
    v, b = int(ctx.traffic["voxels"]), int(ctx.traffic["batches"])
    t = now()
    host, _, dev = synthesize(ctx.config["signal"], v * b, ctx.seed,
                              ctx.device)
    ctx.sync()
    rec.setup_parts["signals"] = now() - t
    picks = sample(ctx.seed, v * b, int(ctx.traffic["check"]))
    rows = [torch.tensor([i % v for i in picks if i // v == k],
                         dtype=torch.long, device=ctx.device)
            for k in range(b)]
    ctx.state.update(host=host, c64=list(dev.split(v)), outs=[], picks=picks,
                     rows=rows, c32=[x.to(torch.complex64) for x in dev.split(v)],
                     bad=torch.zeros((), dtype=torch.long, device=ctx.device))
    ctx.state["fit_input"] = ctx.state["c32"][0]
    t = now()
    for i in range(int(ctx.traffic["warmups"])):
        fit_refine(ctx, ctx.state["c32"][i % b], ctx.state["c64"][i % b],
                   rec, traced=False)
        ctx.sync()
    rec.setup_parts["warm_up"] = now() - t


def window(ctx, seconds: float, rec, traced: bool) -> None:
    c32, c64, outs = ctx.state["c32"], ctx.state["c64"], ctx.state["outs"]
    rows, bad = ctx.state["rows"], ctx.state["bad"]
    v = int(ctx.traffic["voxels"])
    t0 = t = now()
    while t - t0 < seconds:
        b = len(outs) % len(c32)
        s = now()
        out = fit_refine(ctx, c32[b], c64[b], rec, traced)
        bad += nonfinite(*out[2:]).sum()
        outs.append((b, [x.index_select(0, rows[b]) for x in out]))
        ctx.sync()
        t = now()
        if traced:
            rec.span("batch", s, t)
    rec.window = (t0, t)
    rec.units = rec.attempted = len(outs) * v


def replay(ctx, i: int, rec) -> None:
    """The ``i``-th replayed batch: the resident batches in turn."""
    b = i % len(ctx.state["c32"])
    fit_refine(ctx, ctx.state["c32"][b], ctx.state["c64"][b], rec,
               traced=True)


def failed(ctx, rec) -> int:
    return int(ctx.state["bad"].item())


def answers(ctx) -> list:
    v = int(ctx.traffic["voxels"])
    host, picks = ctx.state["host"], ctx.state["picks"]
    found = {i: [] for i in picks}
    for b, out in ctx.state["outs"]:
        cpu = [x.cpu() for x in out]
        for j, i in enumerate(i for i in picks if i // v == b):
            found[i].append(unit(*(x[j] for x in cpu)))
    return [(host[i], found[i]) for i in picks]


def close(ctx) -> None:
    pass
