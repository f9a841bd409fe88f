"""The comparison that decides ``correct``, on the CPU at a size a test run
holds (the configurations' published sizes, a few voxels): sound runs of
each loop come out correct, and the control and each fault a cell can have
come out not correct.

The faults are planted under the timed path, where the program produces
its answer: a refined line altered, a consolidated line dropped, half of
the batch left out.  A cell on one chip has no exchange between chips,
and no cell trains, so no step returns its state unchanged."""
import json
import pathlib

import pytest

import llckbdm_tpu_torch as port
from benchmark import harness, spec
from benchmark.tests.helpers import small_copy

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("small")
    here = small_copy(ROOT, tmp)
    return here, spec.load(ROOT)


def _run(bench, cell, **kw):
    here, spec_json = bench
    return harness.run_cell(cell, 3000000001, 0.1, False, device="cpu",
                            spec=spec_json, here=here, workers=2, **kw)


CELLS = ["five_peak_clean.batch2048", "brain_clean.mrsi1024"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(bench, cell):
    r = _run(bench, cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["refined_err"]["value"] < 1e-10
    assert r["readings"]["count_gap"] < 20      # reported; no limit
    assert r["failed"] == 0 and r["compared"]["answers"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    r = _run(bench, cell, variant="control")
    assert not r["correct"]
    assert r["checks"]["refined_err"]["value"] > 1e-7


def _altered(refine):
    """refine_lines with its first refined pole moved by 1e-6 relative (a
    relative 1e-4 or so in T2)."""
    def bad(*args, **kw):
        out = refine(*args, **kw)
        z = out.z.clone()
        z[..., 0] *= 1.0 + 1e-6
        return out._replace(z=z)
    return bad


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_produced(bench, cell, monkeypatch):
    monkeypatch.setattr(port, "refine_lines", _altered(port.refine_lines))
    r = _run(bench, cell)
    assert not r["correct"]
    assert r["checks"]["refined_err"]["value"] > 1e-8


def test_a_line_dropped_by_the_fit(bench, monkeypatch):
    fit = port.llc_kbdm_fit

    def bad(*args, **kw):
        cons, pooled, counts, stats = fit(*args, **kw)
        mask = cons.mask.clone()
        mask[..., 0] = 0.0
        return cons._replace(mask=mask), pooled, counts * (mask > 0), stats
    monkeypatch.setattr(port, "llc_kbdm_fit", bad)
    r = _run(bench, "five_peak_clean.batch2048")
    assert not r["correct"]
    assert r["checks"]["refined_err"]["value"] == float("inf")
    assert r["readings"]["count_gap"] >= 20


def test_half_of_the_batch_left_out(bench, monkeypatch):
    refine = port.refine_lines

    def bad(c, lines, *args, **kw):
        out = refine(c, lines, *args, **kw)
        mask = out.mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
        return out._replace(mask=mask)
    monkeypatch.setattr(port, "refine_lines", bad)
    here, spec_json = bench
    traffic = here / "traffic" / "batch2048.json"
    t = json.loads(traffic.read_text())
    monkeypatch.setattr(spec, "traffic", lambda name, here=here: dict(
        t, check=t["voxels"] * t["batches"]))
    r = _run(bench, "five_peak_clean.batch2048")
    assert not r["correct"]
    assert r["compared"]["signals"] >= t["voxels"]   # a whole batch


def test_no_result_where_nothing_is_compared(bench, monkeypatch):
    load = spec.loop

    def no_answers(kind, here):
        loop = load(kind, here)         # a fresh module each run
        loop.answers = lambda ctx: []
        return loop
    monkeypatch.setattr(spec, "loop", no_answers)
    assert not _run(bench, "five_peak_clean.batch2048")["correct"]


def test_only_round_off_lines_are_left_out():
    from benchmark.reference import compare
    amps = [1.0, 0.08, 2e-5, 1e-7, 1e-13, 0.0]
    assert compare.roundoff(amps).tolist() == [False] * 4 + [True] * 2
    assert compare.roundoff([]).tolist() == []


def test_the_reference_keeps_a_noise_line():
    """A noise line of the noisy north star (noise 1e-4, amplitude ~3e-5)
    stays in the reference's answer: the round-off rule leaves out only
    what float64 cannot resolve."""
    from benchmark.inputs import synthesize
    from benchmark.reference import compare
    cfg = spec.config("five_peak_clean")
    noisy = dict(cfg["signal"], noise=1e-4)
    host = synthesize(noisy, 6, 3000000777, "cpu")[0]
    ref = compare.reference_voxel(host[1], harness.reference_params(cfg))
    assert len(ref["refined"]) == 6
    assert 1e-5 < ref["refined"][:, 0].min() < 1e-4
