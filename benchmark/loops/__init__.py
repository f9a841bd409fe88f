"""The traffic kinds: ``benchmark/loops/<kind>.py`` runs the window of every
traffic mix whose file names that ``kind``.  A loop module has

* ``setup(ctx, rec)``: the inputs from the seed, resident where the mix
  keeps them, and every shape the window uses warmed up; it sets
  ``ctx.state["fit_input"]``, one call's complex64 input on the device,
  for measurements after the window;
* ``window(ctx, seconds, rec, traced)``: the closed loop, until
  ``seconds`` have passed at the end of a unit of work; fills
  ``rec.window``, ``rec.units``, ``rec.attempted`` and, with ``traced``,
  the spans of each layer (each ended by a sync);
* ``failed(ctx, rec)``: the answers of the window with a non-finite
  refined line;
* ``answers(ctx)``: the traffic's ``check`` signals drawn from the seed
  (``inputs.sample``), each with every answer the window gave for it
  (dicts of numpy arrays: ``counts``, ``frequency``, ``z``, ``d``,
  ``mask``);
* ``close(ctx)``: frees what it holds outside the process (files).
"""
from __future__ import annotations

import contextlib
import time

from .. import trace as trace_mod

now = time.perf_counter


def fit_refine(ctx, c32, c64, rec, traced: bool) -> tuple:
    """``llc_kbdm_fit`` then ``refine_lines`` on the top slots: the
    window's unit of work.  Returns (counts, consolidated frequency,
    refined z, d, mask) on the device.  With ``traced``, each layer is a
    span ended by a sync (``fit``, ``refine``)."""
    port, cfg = ctx.port, ctx.fit_cfg
    t0 = now()
    with trace_mod.span("bench.fit") if traced else contextlib.nullcontext():
        cons, _, counts, _ = port.llc_kbdm_fit(c32, ctx.dwell, cfg)
        if traced:
            ctx.sync()
    t1 = now()
    top = port.LineList(*(x[..., :ctx.slots] for x in cons))
    with trace_mod.span("bench.refine") if traced else \
            contextlib.nullcontext():
        ref = port.refine_lines(c64, top, ctx.dwell, ctx.refine_cfg)
        if traced:
            ctx.sync()
    if traced:
        rec.span("fit", t0, t1)
        rec.span("refine", t1, now())
    return counts, cons.frequency, ref.z, ref.d, ref.mask


def nonfinite(z, d, mask):
    """Per answer (leading dims): True where a valid refined slot holds a
    non-finite pole or amplitude."""
    import torch
    bad = ~(torch.isfinite(z) & torch.isfinite(d))
    return torch.any(bad & (mask > 0.5), dim=-1)


def unit(counts, freq, z, d, mask) -> dict:
    """One answer as numpy arrays (host tensors in)."""
    return {"counts": counts.numpy(), "frequency": freq.numpy(),
            "z": z.numpy(), "d": d.numpy(), "mask": mask.numpy()}
