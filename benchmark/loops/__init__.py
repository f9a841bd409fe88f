"""The traffic kinds: ``benchmark/loops/<kind>.py`` runs the window of every
traffic mix whose file names that ``kind``.  The harness loads it from its
path as a module of this package (``spec.loop``), so a new kind is a new
file.  A loop module has

* ``setup(ctx, rec)``: the inputs from the seed, resident where the mix
  keeps them, and every shape the window uses warmed up; it sets
  ``ctx.state["fit_input"]``, one ``llc_kbdm_fit`` call's complex64 input
  on the device, for measurements after the window (``sweep.ms.batch``
  times the sweep on it; its leading size is the voxels of one call, which
  the kernel rooflines count);
* ``window(ctx, seconds, rec, traced)``: the loop, until ``seconds`` have
  passed at the end of a unit of work; fills ``rec.window``, ``rec.units``,
  ``rec.attempted`` and, with ``traced``, the spans of each layer (each
  ended by a sync; ``fit_refine`` records ``fit`` and ``refine``).
  ``fits_per_s`` is ``rec.units`` over ``rec.window``, so ``units`` counts
  the voxels whose refined lines the program returned to its caller, and
  the window runs from the first unit's start to the last unit's sync (or,
  where the program writes its answers to files, to the last one on disk);
* ``failed(ctx, rec)``: the answers of the window with a non-finite
  refined line;
* ``answers(ctx)``: the traffic's ``check`` signals drawn from the seed
  (``inputs.sample``), each with every answer the window gave for it
  (dicts of numpy arrays: ``counts``, ``frequency``, ``z``, ``d``,
  ``mask``);
* ``close(ctx)``: frees what it holds outside the process (files);

and, for the per-layer metrics read from the program's spans
(``benchmark/program_spans.py``), ``replay(ctx, i, rec)``: the ``i``-th
of a few units of work replayed after the window, each one call of the
pipeline through ``fit_refine(..., rec, traced=True)``, touching none of
the window's answers.  A loop without it reports none of those metrics.

``.batch`` at the end of a per-layer metric's name means one call of the
pipeline, whatever the traffic kind.
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
