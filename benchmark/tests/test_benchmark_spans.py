"""The reduction of the program's spans (``benchmark/program_spans.py``) on
synthetic intervals, and its readers on a CPU run, where there is nothing
for them to read."""
import pathlib
import types

import numpy as np
import pytest

from benchmark import harness, program_spans, spec
from benchmark.tests.helpers import small_copy

ROOT = pathlib.Path(__file__).resolve().parents[2]
NEW = ["sweep.device_ms.batch", "sweep.powiter.device_ms.batch",
       "sweep.lines.device_ms.batch", "sweep.idle_pct.batch",
       "cluster.device_ms.batch", "cluster.idle_pct.batch",
       "refine.step.device_ms.batch", "refine.idle_pct.batch",
       "device.launches.batch"]


def events(batches, launches, spans):
    """Events from host spans (name, start, end), per-batch host ranges and
    launches (launch time, device start, device end), one correlation id
    each."""
    ops = [(s, e, corr) for corr, (_, s, e) in enumerate(launches)]
    when = {corr: t for corr, (t, _, _) in enumerate(launches)}
    return program_spans.Events(ops=ops, spans=spans, batches=batches,
                                launches=when)


# one batch: fit [0, 9.2) holds the sweep [0, 6) (powiter [1, 3), lines
# [4, 5)) and the cluster [6, 9); the refine [10, 14) holds two steps; the
# harness launches one op at 9.5 between the fit and the refine.  Each op
# runs on the device after its launch, on the same clock.
SPANS = [("llckbdm.fit", 0.0, 9.2), ("llckbdm.sweep", 0.0, 6.0),
         ("llckbdm.sweep.powiter", 1.0, 3.0),
         ("llckbdm.sweep.lines", 4.0, 5.0), ("llckbdm.cluster", 6.0, 9.0),
         ("llckbdm.refine", 10.0, 14.0), ("llckbdm.refine.step", 11.0, 12.0),
         ("llckbdm.refine.step", 12.0, 12.3)]
LAUNCHES = [
    (0.5, 2.0, 3.0),        # sweep, direct
    (1.5, 3.0, 5.0),        # powiter
    (2.5, 5.0, 6.0),        # powiter
    (3.5, 6.5, 7.0),        # sweep: 0.5 idle before it
    (4.5, 7.0, 8.0),        # lines
    (6.5, 9.0, 10.0),       # cluster: 1.0 idle before it
    (7.5, 10.0, 10.5),      # cluster
    (9.5, 11.0, 11.2),      # harness: 0.5 idle before it
    (10.5, 11.5, 11.6),     # refine, direct: 0.3 idle before it
    (11.5, 11.6, 12.0),     # step 1
    (12.1, 12.2, 12.5),     # step 2: 0.2 idle before it
    (12.4, 12.5, 12.7),     # refine, direct
]


def shifted(spans, launches, dt, dd):
    return ([(n, a + dt, b + dt) for n, a, b in spans],
            [(t + dt, s + dd, e + dd) for t, s, e in launches])


def two_batches(drift=0.0):
    """Two batches; ``drift`` moves the second one's device times against
    the host's clock."""
    s2, l2 = shifted(SPANS, LAUNCHES, 20.0, 20.0 + drift)
    return events([(-0.5, 19.0), (19.5, 40.0)], LAUNCHES + l2, SPANS + s2)


@pytest.fixture
def reduced():
    return program_spans.reduce(two_batches())


def test_nested_spans_fold_into_their_layer(reduced):
    b = reduced[0]
    assert b["layers"]["sweep"]["device_ms"] == pytest.approx(6e3)
    assert b["llckbdm.sweep.powiter"] == pytest.approx(3e3)
    assert b["llckbdm.sweep.lines"] == pytest.approx(1e3)
    assert b["layers"]["sweep"]["busy_s"] == pytest.approx(5.5)
    assert b["layers"]["cluster"]["device_ms"] == pytest.approx(1.5e3)
    assert b["layers"]["refine"]["device_ms"] == pytest.approx(1.2e3)
    assert b["llckbdm.refine.step"] == pytest.approx([0.4e3, 0.3e3])
    assert set(b["layers"]) == {"sweep", "cluster", "refine", "harness"}


def test_a_gap_goes_to_the_layer_of_the_op_that_ends_it(reduced):
    idle = {k: v["idle_s"] for k, v in reduced[0]["layers"].items()}
    assert idle["sweep"] == pytest.approx(0.5)
    assert idle["cluster"] == pytest.approx(1.0)     # before its first op
    assert idle["harness"] == pytest.approx(0.5)     # ended by a harness op
    assert idle["refine"] == pytest.approx(0.3 + 0.2)


def test_idle_put_down_adds_up_to_the_batch(reduced):
    for b in reduced:
        parts = sum(v["idle_s"] for v in b["layers"].values())
        assert parts == pytest.approx(b["idle_s"], abs=1e-9)
        assert b["idle_s"] == pytest.approx(2.5)


def test_launches_are_counted_per_batch(reduced):
    assert len(reduced) == 2
    assert [b["launches"] for b in reduced] == [11, 11]   # not the harness's
    assert [b["ops"] for b in reduced] == [12, 12]


def test_batches_go_by_the_host_clock():
    """The second batch's device times drift 3 s early, its first op before
    the host's start of the batch: each op still goes to the batch that
    launched it."""
    out = program_spans.reduce(two_batches(drift=-3.0))
    assert [b["ops"] for b in out] == [12, 12]
    assert [b["launches"] for b in out] == [11, 11]
    assert [b["layers"]["sweep"]["device_ms"] for b in out] == \
        pytest.approx([6e3, 6e3])


def test_a_spans_own_device_ops_come_out():
    """An op goes to the span that launched it, wherever it runs on the
    device: one launched inside the power iterations and run after the
    sweep's host range has closed is still theirs."""
    spans = [("llckbdm.sweep", 0.0, 4.0), ("llckbdm.sweep.powiter", 1.0, 2.0)]
    launches = [(0.5, 1.0, 2.0),        # sweep, direct
                (1.5, 5.0, 6.5),        # powiter, run late
                (3.0, 7.0, 7.5)]        # sweep, direct
    b, = program_spans.reduce(events([(0.0, 10.0)], launches, spans))
    assert b["llckbdm.sweep.powiter"] == pytest.approx(1.5e3)
    assert b["layers"]["sweep"]["device_ms"] == pytest.approx(6.5e3)
    assert b["layers"]["sweep"]["busy_s"] == pytest.approx(3.0)
    assert set(b["layers"]) == {"sweep"} and b["launches"] == 3


def test_an_op_without_its_runtime_call_goes_to_the_harness():
    """An op whose runtime call the trace lacks goes to the harness, and to
    the batch that holds its device start."""
    ev = two_batches()
    del ev.launches[0]                  # the first batch's first sweep op
    b = program_spans.reduce(ev)[0]
    assert b["ops"] == 12 and b["launches"] == 10
    assert b["layers"]["harness"]["busy_s"] == pytest.approx(1.2)
    assert b["layers"]["sweep"]["device_ms"] == pytest.approx(5e3)


def test_innermost_takes_the_shortest_range_that_holds_the_time():
    ranges = [("a", 0.0, 10.0), ("b", 2.0, 4.0), ("c", 3.0, 3.5)]
    times = np.array([1.0, 2.5, 3.2, 4.0, 11.0, np.nan])
    assert program_spans.innermost(times, ranges).tolist() == \
        [0, 1, 2, 1, -1, -1]


class Kineto:
    """A stand-in for a ``_KinetoEvent``."""

    def __init__(self, name, start_ns, dur_ns, cuda, note, corr):
        from torch.autograd import DeviceType
        self._row = (name, start_ns, dur_ns,
                     DeviceType.CUDA if cuda else DeviceType.CPU, note, corr)

    def name(self):
        return self._row[0]

    def start_ns(self):
        return self._row[1]

    def duration_ns(self):
        return self._row[2]

    def device_type(self):
        return self._row[3]

    def is_user_annotation(self):
        return self._row[4]

    def correlation_id(self):
        return self._row[5]


def test_events_of_sorts_the_kineto_events():
    """Device ops, program spans, replayed batches and runtime calls are
    told apart; a span's copy on the device's timeline, the harness's own
    spans and other host ops are left out.  Times are seconds from the
    first event."""
    t0 = 1_792_296_467_885_704_747
    ev = program_spans.Events.of([
        Kineto("bench.replay", t0, 9_000, False, True, 0),
        Kineto("llckbdm.sweep", t0 + 1_000, 4_000, False, True, 0),
        Kineto("bench.fit", t0 + 1_000, 5_000, False, False, 0),
        Kineto("cudaLaunchKernel", t0 + 2_000, 100, False, False, 7),
        Kineto("aten::mm", t0 + 1_900, 300, False, False, 0),
        Kineto("gemm_kernel", t0 + 3_000, 500, True, False, 7),
        Kineto("llckbdm.sweep", t0 + 3_000, 500, True, True, 7)])
    assert ev.batches == [pytest.approx((0.0, 9e-6))]
    assert [n for n, _, _ in ev.spans] == ["llckbdm.sweep"]
    assert ev.spans[0][1:] == pytest.approx((1e-6, 5e-6))
    assert ev.launches == {7: pytest.approx(2e-6)}
    assert ev.ops == [pytest.approx((3e-6, 3.5e-6, 7))]


def test_a_span_that_launched_nothing_reads_none():
    """Without any op launched in ``lines`` its reader gives None; the
    sweep's other readers still read."""
    ev = two_batches()
    for corr in (4, 16):                # the lines op of each batch
        del ev.launches[corr]
    rec = harness.Record(kind="batch", config={}, traffic={})
    rec.extra["program_spans"] = program_spans.reduce(ev)
    assert spec.reader("sweep.lines.device_ms.batch").read(rec) is None
    assert spec.reader("sweep.powiter.device_ms.batch").read(rec) == \
        pytest.approx(3e3)


@pytest.mark.parametrize("kind, cuda", [("batch", False), ("grid", True)])
def test_after_window_replays_only_a_batch_cell_on_the_card(kind, cuda):
    """A run on the CPU, or of a loop without the ``replay`` hook, replays
    nothing and leaves the record without program spans; the kind's name
    is not looked at."""
    from benchmark.loops import batch

    class Ctx:
        state = {}
    ctx = Ctx()
    ctx.cuda = cuda
    ctx.loop = batch if kind == "batch" else types.ModuleType(kind)
    rec = harness.Record(kind=kind, config={}, traffic={})
    program_spans.after_window(ctx, rec)
    assert "program_spans" not in rec.extra


def test_readers_take_medians_and_shares():
    rec = harness.Record(kind="batch", config={}, traffic={})
    rec.extra["program_spans"] = program_spans.reduce(two_batches())
    read = {n: spec.reader(n).read(rec) for n in NEW}
    assert read["sweep.device_ms.batch"] == pytest.approx(6e3)
    assert read["sweep.idle_pct.batch"] == pytest.approx(100 * 0.5 / 6.0)
    assert read["cluster.idle_pct.batch"] == pytest.approx(100 * 1.0 / 2.5)
    assert read["refine.idle_pct.batch"] == pytest.approx(100 * 0.5 / 1.5)
    assert read["refine.step.device_ms.batch"] == pytest.approx(0.35e3)
    assert read["device.launches.batch"] == 11


def test_a_program_without_spans_reads_nothing():
    ev = two_batches()
    ev.spans = []
    rec = harness.Record(kind="batch", config={}, traffic={})
    rec.extra["program_spans"] = program_spans.reduce(ev)
    assert all(set(b["layers"]) == {"harness"} for b in
               rec.extra["program_spans"])
    assert all(spec.reader(n).read(rec) is None for n in NEW)


def test_every_new_metric_is_declared_for_both_cells():
    """Both cells report each; a later cell may be appended."""
    bench = spec.load(ROOT)
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] == "device_trace" and m["moves"] == "fits_per_s"
        assert m["workloads"][:2] == ["five_peak_clean.batch2048",
                                      "brain_clean.mrsi1024"]


def test_a_cpu_run_reads_none(tmp_path):
    """On the CPU there is no device op: the nine readers return None and
    raise nothing."""
    here = small_copy(ROOT, tmp_path)
    r = harness.run_cell("five_peak_clean.batch2048", 3000000001, 0.1, True,
                         device="cpu", spec=spec.load(ROOT), here=here,
                         workers=1)
    assert r["correct"], r["checks"]
    assert not set(NEW) & set(r["metrics"])
    assert "pipeline.fit_ms.batch" in r["metrics"]


def test_the_replay_sees_the_spans_and_leaves_the_window_alone(
        monkeypatch):
    """The replay, on the CPU's plain versions at two voxels: every span
    of the program is in its trace, one range a batch, and the window's
    answers and its count of non-finite ones are as they were."""
    import llckbdm_tpu_torch as port
    from benchmark.loops import batch

    monkeypatch.setattr(program_spans, "READ", 1)
    cfg = spec.config("five_peak_clean")
    traffic = dict(spec.traffic("batch2048"), voxels=2, batches=2, warmups=1,
                   check=2)
    fit, refine, slots = harness.port_configs(port, cfg, None)
    ctx = harness.Ctx(config=cfg, traffic=traffic, seed=3000000001,
                      device=__import__("torch").device("cpu"), port=port,
                      fit_cfg=fit, refine_cfg=refine, slots=slots, loop=batch)
    rec = harness.Record(kind="batch", config=cfg, traffic=traffic)
    batch.setup(ctx, rec)
    batch.window(ctx, 1e-9, rec, traced=False)         # one batch
    outs, bad = list(ctx.state["outs"]), int(ctx.state["bad"])
    assert len(outs) == 1
    ev = program_spans.Events.of(program_spans.replay(ctx, rec))
    assert ctx.state["outs"] == outs and int(ctx.state["bad"]) == bad
    assert rec.spans == {} and not rec.extra
    assert len(ev.batches) == program_spans.WARM + 1
    names = sorted({n for n, _, _ in ev.spans})
    assert names == sorted(program_spans.LAYER)
    steps = refine.f32_iters + refine.iters
    assert sum(n == "llckbdm.refine.step" for n, _, _ in ev.spans) == \
        steps * len(ev.batches)
    assert program_spans.reduce(ev) == []       # no device op on the CPU
