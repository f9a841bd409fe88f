"""Named spans inside the pipeline, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
``torch.profiler`` profile is active, and a shared no-op context
otherwise: the profiler being on is the only switch.  A span adds no
tensor operation and no sync, so the arithmetic is the same with the
profiler on or off.  Its host range and, on a CUDA device, its copy on the
device's timeline sit in the same kineto trace as the device operations it
launches.

The spans (each read by a per-layer metric of the benchmark):

* ``llckbdm.fit``: ``llc_kbdm_fit``, parent of the next four;
* ``llckbdm.sweep``: ``kbdm_sweep``, with
  ``llckbdm.sweep.powiter`` (the power iterations) and
  ``llckbdm.sweep.lines`` (the Vandermonde amplitudes and the line filter);
* ``llckbdm.cluster``: pool, DBSCAN, labels and consolidation;
* ``llckbdm.refine``: ``refine_lines``, with one ``llckbdm.refine.step``
  per Gauss-Newton iteration.
"""
from __future__ import annotations

import contextlib
import functools

import torch

FIT = "llckbdm.fit"
SWEEP = "llckbdm.sweep"
POWITER = "llckbdm.sweep.powiter"
LINES = "llckbdm.sweep.lines"
CLUSTER = "llckbdm.cluster"
REFINE = "llckbdm.refine"
STEP = "llckbdm.refine.step"
NAMES = (FIT, SWEEP, POWITER, LINES, CLUSTER, REFINE, STEP)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profile is active; else a
    no-op context (``record_function`` is then never entered)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``,
    which is looked up at the call, so the profiler switches it."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap
