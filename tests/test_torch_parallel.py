"""The port's voxel-grid layer (llckbdm_tpu_torch.parallel) against the JAX
package's parallel layer, on the CPU over gloo.

Inputs are tests/test_parallel.py's CFG and 8 noiseless 2-line voxels
(N=64), carried across by convert.  One module-scoped spawn of 4 ranks (mesh
data=2 x time=2; torch only, tests/torch_grid_worker.py, file:// rendezvous
in a temporary directory) runs the error cases, the time-sharded refinement,
fit_grid_sharded and fit_and_refine_grid; the parent computes the JAX side
while the ranks run, and several tests read the ranks' outputs.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import llckbdm_tpu as lt
import llckbdm_tpu_torch as lp
import torch_grid_worker as worker
from llckbdm_tpu.ops.cplx import CArr
from llckbdm_tpu.oracle import reference as oracle
from llckbdm_tpu.parallel import checkpoint as jcheckpoint
from llckbdm_tpu.parallel import grid as jgrid
from llckbdm_tpu.parallel.mesh import make_mesh as jmake_mesh
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu.solver.kbdm import KbdmConfig
from llckbdm_tpu.utils import df as D
from llckbdm_tpu_torch import convert
from llckbdm_tpu_torch.parallel import (fit_grid, refine_grid,
                                        shard_manifest)

torch.set_num_threads(1)
DWELL = 5e-4
CFG = LlcKbdmConfig(
    m_values=(16, 24, 32), eps=5e-3, min_samples=2, max_clusters=4,
    kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1,
                    eigh_sweeps=4, eig_sweeps=6))
RCFG = lt.RefineConfig(iters=3)
PCFG = convert.llc_config_from_ref(dataclasses.asdict(CFG))
PRCFG = convert.refine_config_from_ref(dataclasses.asdict(RCFG))


@pytest.fixture(scope="module")
def grid_truth():
    """tests/test_parallel.py's per-voxel truths: 2 lines, jittered."""
    rng = np.random.default_rng(7)
    base = np.array([[1.0, 0.05, -60.0, 0.2], [0.7, 0.08, 45.0, -0.4]])
    truths = []
    for _ in range(8):
        p = base.copy()
        p[:, 2] += rng.normal(scale=1.0, size=2)
        truths.append(p)
    return np.stack(truths)


@pytest.fixture(scope="module")
def grid_signals(grid_truth):
    return np.stack([oracle.sample_signal(t, 64, DWELL) for t in grid_truth])


@pytest.fixture(scope="module")
def init_lines(grid_truth):
    """JAX LineList (8, 4) of the truths with an f32-stage-sized error."""
    init = grid_truth.copy()
    init[:, :, 2] += 0.05
    one = [lt.line_list_from_np(p, k=CFG.max_clusters) for p in init]
    return lt.LineList(*(np.stack([np.asarray(x[j]) for x in one])
                         for j in range(5)))


@pytest.fixture(scope="module")
def ranks(grid_signals, init_lines, tmp_path_factory):
    """Each rank's saved outputs, and JAX refine_grid_timesharded of
    init_lines on the {'data': 4, 'time': 2} CPU mesh."""
    d = tmp_path_factory.mktemp("ranks")
    ctx = worker.start(worker.grid_ranks, 4, 4, str(d / "rdv"), str(d),
                       "cpu", {"data": 2, "time": 2}, grid_signals,
                       tuple(init_lines), DWELL, PCFG, PRCFG)
    mesh = jmake_mesh({"data": 4, "time": 2})
    jts = jgrid.refine_grid_timesharded(
        D.dfc_from_np(grid_signals),
        lt.LineList(*map(jax.numpy.asarray, init_lines)), DWELL, mesh, RCFG)
    jts = {"z": D.dfc_to_np(jts.z), "d": D.dfc_to_np(jts.d)}
    worker.join(ctx, 300)
    return worker.load(d, 4), jts


def _grid(outs, key):
    """A key's rows of the whole grid from the time-0 ranks (data 0, 1)."""
    return np.concatenate([outs[0][key], outs[2][key]])


def _rows(z, d, mask):
    keep = mask > 0.5
    z, d = z[keep], d[keep]
    est = np.stack([np.abs(d), -DWELL / np.log(np.abs(z)),
                    np.angle(z) / (2.0 * np.pi * DWELL), np.angle(d)], axis=1)
    return est[np.argsort(est[:, 2])]


@pytest.mark.parametrize("n,size,procs", [(10, 3, 1), (10, 3, 2), (7, 8, 2),
                                          (65536, 2048, 3)])
def test_shard_manifest_matches_jax(n, size, procs):
    for i in range(procs):
        assert (shard_manifest(n, size, i, procs)
                == jcheckpoint.shard_manifest(n, size, i, procs))


def test_refine_grid_from_jax_fit_lines(grid_signals, grid_truth):
    """The port's refine_grid from JAX fit_grid's lines meets the truth to
    1e-8 and JAX refine_grid to 2e-8."""
    sig32 = CArr(jax.numpy.asarray(grid_signals.real, jax.numpy.float32),
                 jax.numpy.asarray(grid_signals.imag, jax.numpy.float32))
    cons, _, _, _ = jgrid.fit_grid(sig32, DWELL, CFG)
    port = refine_grid(torch.as_tensor(grid_signals),
                       convert.lines_from_np(np.asarray(x) for x in cons),
                       DWELL, PRCFG)
    jref = jgrid.refine_grid(D.dfc_from_np(grid_signals), cons, DWELL, RCFG)
    jz, jd = D.dfc_to_np(jref.z), D.dfc_to_np(jref.d)
    for v in range(8):
        est = _rows(port.z[v].numpy(), port.d[v].numpy(),
                    port.mask[v].numpy())
        err = oracle.line_errors(est[oracle.match_lines(est, grid_truth[v])],
                                 grid_truth[v])
        assert err.max() < 1e-8, f"voxel {v}: {err.max():.3e}"
        jest = _rows(jz[v], jd[v], np.asarray(jref.mask[v]))
        jest = jest[oracle.match_lines(jest, grid_truth[v])]
        assert oracle.line_errors(
            est[oracle.match_lines(est, grid_truth[v])], jest).max() < 2e-8


@pytest.mark.parametrize("against", ["port_single", "jax_timesharded"])
def test_timesharded_refine_matches(ranks, grid_signals, init_lines, against):
    """Time split over 2 ranks: within 5e-9 (z) and 5e-8 (d) of the port's
    single-process refine and of JAX's time-sharded refine, the bounds of
    tests/test_parallel.py."""
    outs, jts = ranks
    if against == "port_single":
        single = lp.refine_lines(torch.as_tensor(grid_signals),
                                 convert.lines_from_np(init_lines), DWELL,
                                 PRCFG)
        want_z, want_d = single.z.numpy(), single.d.numpy()
    else:
        want_z, want_d = jts["z"], jts["d"]
    np.testing.assert_allclose(_grid(outs, "ts_z"), want_z, rtol=0,
                               atol=5e-9)
    np.testing.assert_allclose(_grid(outs, "ts_d"), want_d, rtol=0,
                               atol=5e-8)


def test_fit_grid_sharded_matches_fit_grid(ranks, grid_signals):
    """Two data blocks concatenated == the local fit of all 8 voxels:
    counts and masks exact, lines to 1e-4 (tests/test_parallel.py)."""
    outs, _ = ranks
    cons, _, counts, _ = fit_grid(
        torch.as_tensor(grid_signals).to(torch.complex64), DWELL, PCFG)
    np.testing.assert_array_equal(_grid(outs, "fit_counts"), counts.numpy())
    np.testing.assert_array_equal(_grid(outs, "fit_mask"), cons.mask.numpy())
    for name, x in zip(lp.LineList._fields, cons):
        np.testing.assert_allclose(_grid(outs, f"fit_{name}"), x.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_fit_and_refine_grid_recovers_truth(ranks, grid_truth):
    """The full step on 4 ranks: every voxel recovers its 2 lines to 1e-8."""
    outs, _ = ranks
    z, d = _grid(outs, "chain_z"), _grid(outs, "chain_d")
    mask = _grid(outs, "chain_mask")
    assert z.shape == (8, CFG.max_clusters) and z.dtype == np.complex128
    assert _grid(outs, "chain_counts").shape == (8, CFG.max_clusters)
    for v in range(8):
        est = _rows(z[v], d[v], mask[v])
        assert len(est) >= 2
        err = oracle.line_errors(est[oracle.match_lines(est, grid_truth[v])],
                                 grid_truth[v])
        assert err.max() < 1e-8, f"voxel {v}: {err.max():.3e}"


@pytest.mark.parametrize("prefix", ["ts_", "chain_"])
def test_time_group_ranks_bitwise_equal(ranks, prefix):
    """The ranks of a 'time' group end with the same bits: the broadcast
    lines and the all-reduced normal equations leave nothing rank-local."""
    outs, _ = ranks
    keys = [k for k in outs[0] if k.startswith(prefix)]
    assert len(keys) >= 4
    for a, b in ((0, 1), (2, 3)):
        for k in keys:
            assert np.array_equal(outs[a][k], outs[b][k]), (a, b, k)
    assert list(outs[0]["rows"]) == [0, 4] and list(outs[3]["rows"]) == [4, 8]


@pytest.mark.parametrize("key,message", [
    ("err_mesh_too_big", r"mesh \{'data': 8\} needs 8 devices, have 4"),
    ("err_auto_mesh", "4 devices not divisible by time=5"),
    ("err_fit_v", "voxel count 7 not divisible by data=2"),
    ("err_refine_n", "signal length 63 not divisible by time=2"),
    ("err_chain_n", "signal length 63 not divisible by time=2"),
])
def test_not_divisible_raises(ranks, key, message):
    """A mesh larger than the world, or V / N not divisible by the mesh,
    raises ValueError on every rank, with the JAX package's messages."""
    outs, _ = ranks
    for out in outs:
        assert re.fullmatch(message, str(out[key])), str(out[key])


def test_single_process_mesh(grid_signals):
    """One process needs no rendezvous: distributed_init(None) and a 1 x 1
    mesh run fit_and_refine_grid as the local fit and refine do."""
    import torch.distributed as dist

    from llckbdm_tpu_torch.parallel import (auto_mesh, distributed_init,
                                            fit_and_refine_grid)

    distributed_init(None, backend="gloo", device="cpu")
    try:
        mesh = auto_mesh(device_type="cpu")
        (refined, counts), rows = fit_and_refine_grid(grid_signals, DWELL,
                                                      PCFG, mesh, PRCFG)
    finally:
        dist.destroy_process_group()
    assert rows == (0, 8)
    cons, _, want_counts, _ = fit_grid(
        torch.as_tensor(grid_signals).to(torch.complex64), DWELL, PCFG)
    want = refine_grid(torch.as_tensor(grid_signals), cons, DWELL, PRCFG)
    assert torch.equal(counts, want_counts)
    assert torch.equal(refined.z, want.z) and torch.equal(refined.d, want.d)


@pytest.mark.parametrize("backend,device,coordinator,world,want", [
    ("nccl", "cuda:1", None, 1, ("cuda:1", "store")),
    ("nccl", "cuda:1", "host:1234", 2, ("cuda:1", "tcp://host:1234")),
    ("nccl", "cuda", None, 1, ("cuda:3", "store")),
    ("nccl", "cuda", "host:1234", 2, ValueError),
    ("gloo", "cuda:0", "host:1234", 2, (None, "tcp://host:1234")),
    ("gloo", "cpu", None, 1, (None, "store")),
], ids=["nccl-cuda1-one", "nccl-cuda1-tcp", "nccl-cuda-one",
        "nccl-cuda-two-raises", "gloo-cuda0", "gloo-cpu"])
def test_distributed_init_binds_the_card(monkeypatch, backend, device,
                                         coordinator, world, want):
    """What distributed_init hands torch: NCCL gets the rank's indexed card
    as device_id (an index-less 'cuda' is the current device in one
    process and raises across processes); gloo never gets a device_id.
    torch itself is patched: this build has no card to bind."""
    import torch.distributed as dist

    from llckbdm_tpu_torch.parallel import distributed_init

    calls, current = [], []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    if want is ValueError:
        with pytest.raises(ValueError, match=r"pass 'cuda:<local index>'"):
            distributed_init(coordinator, world, 0, backend=backend,
                             device=device)
        assert calls == [] and current == []
        return
    distributed_init(coordinator, world, world - 1, backend=backend,
                     device=device)
    device_id, rendezvous = want
    [(got_backend, kw)] = calls
    assert got_backend == backend
    assert kw.get("device_id") == (device_id and torch.device(device_id))
    assert ("device_id" in kw) == (backend == "nccl")
    if rendezvous == "store":
        assert isinstance(kw["store"], dist.HashStore)
        assert (kw["rank"], kw["world_size"]) == (0, 1)
    else:
        assert (kw["init_method"], kw["rank"], kw["world_size"]) == (
            rendezvous, world - 1, world)
    cuda = torch.device(device).type == "cuda"
    assert current == ([torch.device(device_id or device)] if cuda else [])
