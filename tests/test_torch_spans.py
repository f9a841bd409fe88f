"""The port's spans (``llckbdm_tpu_torch/spans.py``) on the CPU at a tiny
shape: under a ``torch.profiler`` profile ``llc_kbdm_fit`` and
``refine_lines`` emit the seven names, nested as the pipeline nests them,
with one step per Gauss-Newton iteration; the answers are bit for bit
those of a run without the profiler; with no profile active no
``record_function`` is entered; and no name can be taken for a kernel
that the benchmark's roofline readers match, or for the benchmark's own
spans."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import llckbdm_tpu_torch as lp
from llckbdm_tpu_torch import spans
from llckbdm_tpu_torch.oracle import sample_signal

DWELL = 5e-4
FIT = lp.LlcKbdmConfig(m_values=(120, 140, 160), min_samples=2,
                       max_clusters=8, kbdm=lp.KbdmConfig(p=8))
REFINE = lp.RefineConfig(iters=2, f32_iters=1)
# the span that holds each span
PARENT = {spans.SWEEP: spans.FIT, spans.CLUSTER: spans.FIT,
          spans.POWITER: spans.SWEEP, spans.LINES: spans.SWEEP,
          spans.STEP: spans.REFINE}


@pytest.fixture(scope="module")
def signals(five_peak_params):
    sig = np.stack([sample_signal(five_peak_params, 512, DWELL)] * 2)
    sig[1] *= 0.5
    return torch.as_tensor(sig)


def fit_and_refine(c64):
    cons, pooled, counts, _ = lp.llc_kbdm_fit(c64.to(torch.complex64), DWELL,
                                              FIT)
    ref = lp.refine_lines(c64, cons, DWELL, REFINE)
    return [*cons, *pooled, counts, ref.z, ref.d, ref.mask]


@pytest.fixture(scope="module")
def traced(signals):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fit_and_refine(signals)
    ranges = sorted((e.start_ns(), -e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("llckbdm."))
    return out, [(n, s, s - d) for s, d, n in ranges]


def test_the_seven_names_and_no_more(traced):
    _, ranges = traced
    assert {n for n, _, _ in ranges} == set(spans.NAMES)
    assert len(spans.NAMES) == 7


def test_spans_nest_as_the_pipeline_does(traced):
    _, ranges = traced
    for name, s, e in ranges:
        holders = [(n, a, b) for n, a, b in ranges
                   if a <= s and e <= b and (n, a, b) != (name, s, e)]
        inner = min(holders, key=lambda h: h[2] - h[1], default=(None,))
        assert inner[0] == PARENT.get(name), name
    fit = [r for r in ranges if r[0] == spans.FIT]
    refine = [r for r in ranges if r[0] == spans.REFINE]
    assert len(fit) == len(refine) == 1 and fit[0][2] <= refine[0][1]
    sweep = next(r for r in ranges if r[0] == spans.SWEEP)
    cluster = next(r for r in ranges if r[0] == spans.CLUSTER)
    assert sweep[2] <= cluster[1]


def test_one_step_per_gauss_newton_iteration(traced):
    _, ranges = traced
    steps = [r for r in ranges if r[0] == spans.STEP]
    assert len(steps) == REFINE.f32_iters + REFINE.iters
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))


def test_answers_are_the_same_with_the_profiler_on_and_off(signals, traced):
    on, _ = traced
    off = fit_and_refine(signals)
    assert float(on[-1].sum()) > 0       # refined lines came out
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_no_record_function_without_a_profile(signals, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span(spans.FIT) is spans.span(spans.STEP)
    fit_and_refine(signals)


def test_names_stay_clear_of_the_benchmarks_readers():
    for name in spans.NAMES:
        assert name.startswith("llckbdm.")
        assert not name.startswith("bench.")
        assert "eig_cs_kernel" not in name and "gram_svd_kernel" not in name


def test_spanned_functions_keep_their_names_and_signatures():
    import inspect
    assert lp.refine_lines.__name__ == "refine_lines"
    assert list(inspect.signature(lp.refine_lines).parameters) == [
        "c", "lines", "dwell", "cfg", "group", "t_offset"]
    assert list(inspect.signature(lp.kbdm_sweep).parameters)[:4] == [
        "c", "dwell", "m_values", "cfg"]
    assert lp.llc_kbdm_fit.__doc__.startswith("Full LL-KBDM fit")
