"""The port's GridRunner (llckbdm_tpu_torch.parallel.checkpoint) on the CPU.

tests/test_parallel.py's GridRunner tests with the same assertions, and:
a grid that is not a multiple of shard_size, shard files with the JAX
runner's keys, dtypes and shapes, a JAX runner's out_dir refused, a deleted
shard recomputed bit for bit, and two processes sharing one out_dir (the
O_EXCL manifest race; torch-only children, tests/torch_grid_worker.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import llckbdm_tpu as lt
import torch_grid_worker as worker
from llckbdm_tpu.oracle import reference as oracle
from llckbdm_tpu.parallel.checkpoint import GridRunner as JaxGridRunner
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu.solver.kbdm import KbdmConfig
from llckbdm_tpu_torch import convert
from llckbdm_tpu_torch.parallel import (GridRunner, fit_grid, refine_grid,
                                        shard_manifest)
from llckbdm_tpu_torch.signals import LineList

torch.set_num_threads(1)
DWELL = 5e-4
JCFG = LlcKbdmConfig(
    m_values=(16, 24, 32), eps=5e-3, min_samples=2, max_clusters=4,
    kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1,
                    eigh_sweeps=4, eig_sweeps=6))
CFG = convert.llc_config_from_ref(dataclasses.asdict(JCFG))
RCFG = convert.refine_config_from_ref(
    dataclasses.asdict(lt.RefineConfig(iters=3)))


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


def _fit(sigs):
    cons, _, counts, _ = fit_grid(torch.as_tensor(sigs).to(torch.complex64),
                                  DWELL, CFG)
    return cons, counts


def test_gridrunner_resume_skips_completed(grid_signals, tmp_path):
    r1 = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4)
    assert r1.run(grid_signals) == 2          # 8 voxels / 4 per shard
    r2 = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4)
    assert r2.run(grid_signals) == 0
    out = r2.gather(8)
    assert out["amplitude"].shape == (8, CFG.max_clusters)
    # results match a direct fit: bit for bit shard by shard; against one
    # fit of all 8 voxels to float32 rounding (CPU matmuls round by batch
    # size), with the cluster structure exact
    for s, e in shard_manifest(8, 4):
        cons, _ = _fit(grid_signals[s:e])
        np.testing.assert_array_equal(out["amplitude"][s:e],
                                      cons.amplitude.numpy())
    cons, counts = _fit(grid_signals)
    np.testing.assert_allclose(out["amplitude"], cons.amplitude.numpy(),
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(out["counts"], counts.numpy())


def test_gridrunner_refined_stores_gate_meeting_lines(grid_signals,
                                                      grid_truth, tmp_path):
    """Noiseless 2-line voxels: the stored refined lines match the truth to
    1e-8; a refined runner's fingerprint differs from the f32-only one."""
    r = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4, refine=RCFG,
                   refine_clusters=4)
    assert r.run(grid_signals) == 2
    out = r.gather(8)
    assert out["refined_z"].shape == (8, 4)
    assert out["refined_z"].dtype == np.complex128
    for v in range(8):
        keep = out["refined_mask"][v] > 0.5
        z, d = out["refined_z"][v][keep], out["refined_d"][v][keep]
        est = np.stack([np.abs(d), -DWELL / np.log(np.abs(z)),
                        np.angle(z) / (2.0 * np.pi * DWELL), np.angle(d)],
                       axis=1)
        est = est[np.argsort(est[:, 2])]
        err = oracle.line_errors(est[oracle.match_lines(est, grid_truth[v])],
                                 grid_truth[v])
        assert err.max() < 1e-8, f"voxel {v}: {err.max():.3e}"
    with pytest.raises(ValueError, match="config mismatch"):
        GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4)


@pytest.mark.parametrize("change", ["eps", "nested kbdm"])
def test_gridrunner_rejects_config_mismatch(tmp_path, change):
    GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4)
    if change == "eps":
        other = dataclasses.replace(CFG, eps=1e-2)
    else:                      # the full fingerprint reaches nested knobs
        other = dataclasses.replace(
            CFG, kbdm=dataclasses.replace(CFG.kbdm, eig_sweeps=99))
    with pytest.raises(ValueError, match="config mismatch"):
        GridRunner(tmp_path, DWELL, other, "cpu", shard_size=4)


def test_gridrunner_rejects_different_data(grid_signals, tmp_path):
    GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4).run(grid_signals)
    r2 = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4)
    with pytest.raises(ValueError, match="data mismatch"):
        r2.run(grid_signals + 1e-3)


def test_gridrunner_gather_incomplete_raises(grid_signals, tmp_path):
    r = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4,
                   process_index=0, num_processes=2)
    assert r.run(grid_signals) == 1            # only process 0's shard
    with pytest.raises(FileNotFoundError, match=r"missing shards \[4,8\)"):
        r.gather(8)
    with pytest.raises(ValueError, match="does not match the grid"):
        r.gather(16)


def test_gridrunner_tail_shard(grid_signals, tmp_path):
    """8 voxels in shards of 3: the 2-voxel tail shard is fitted as it is,
    and each shard's rows equal a direct fit and refinement of its rows."""
    r = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=3, refine=RCFG,
                   refine_clusters=2)
    assert r.pending(8) == [(0, 3), (3, 6), (6, 8)]
    assert r.run(grid_signals, queue_depth=2) == 3
    out = r.gather(8)
    assert out["refined_z"].shape == (8, 2) and out["counts"].shape == (8, 4)
    for s, e in shard_manifest(8, 3):
        cons, counts = _fit(grid_signals[s:e])
        ref = refine_grid(torch.as_tensor(grid_signals[s:e]),
                          LineList(*(x[:, :2] for x in cons)), DWELL, RCFG)
        np.testing.assert_array_equal(out["frequency"][s:e],
                                      cons.frequency.numpy())
        np.testing.assert_array_equal(out["counts"][s:e], counts.numpy())
        np.testing.assert_array_equal(out["refined_z"][s:e], ref.z.numpy())
        np.testing.assert_array_equal(out["gn_step"][s:e],
                                      ref.gn_step.numpy())


@pytest.fixture(scope="module")
def jax_runner_dir(grid_signals, tmp_path_factory):
    """A refined JAX GridRunner's out_dir over the same grid."""
    d = tmp_path_factory.mktemp("jax_grid")
    r = JaxGridRunner(d, DWELL, JCFG, shard_size=4,
                      refine=lt.RefineConfig(iters=3), refine_clusters=4)
    assert r.run(grid_signals) == 2
    return d


def test_shard_files_match_jax_runner(grid_signals, jax_runner_dir,
                                      tmp_path):
    """Same files, keys, dtypes and shapes as the JAX runner's, so that
    gather() output is interchangeable."""
    r = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4, refine=RCFG,
                   refine_clusters=4)
    r.run(grid_signals)
    names = sorted(p.name for p in tmp_path.glob("shard_*.npz"))
    assert names == sorted(p.name for p in jax_runner_dir.glob("shard_*.npz"))
    for name in names:
        with np.load(tmp_path / name) as got, \
                np.load(jax_runner_dir / name) as want:
            assert got.files == want.files
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].shape == want[k].shape, k
    jout = JaxGridRunner(jax_runner_dir, DWELL, JCFG, shard_size=4,
                         refine=lt.RefineConfig(iters=3),
                         refine_clusters=4).gather(8)
    np.testing.assert_array_equal(r.gather(8)["counts"], jout["counts"])


def test_jax_out_dir_refused(jax_runner_dir):
    """The port draws its sketch from torch.Generator: resuming a JAX
    runner's out_dir would mix shards of two sketches."""
    with pytest.raises(ValueError, match="config mismatch"):
        GridRunner(jax_runner_dir, DWELL, CFG, "cpu", shard_size=4,
                   refine=RCFG, refine_clusters=4)


def test_deleted_shard_recomputed_bitwise(grid_signals, tmp_path):
    r = GridRunner(tmp_path, DWELL, CFG, "cpu", shard_size=4, refine=RCFG,
                   refine_clusters=4)
    assert r.run(grid_signals) == 2
    first = r.gather(8)
    (tmp_path / "shard_00000004_00000008.npz").unlink()
    assert r.pending(8) == [(4, 8)]
    assert r.run(grid_signals) == 1
    again = r.gather(8)
    assert first.keys() == again.keys()
    for k in first:
        assert np.array_equal(first[k], again[k]), k


def test_two_processes_share_out_dir(grid_truth, tmp_path):
    """Two processes (process_index 0 and 1) start on one empty out_dir at
    once: each computes its round-robin half, and the gather equals a
    single-process fit (tests/test_distributed.py's assertions)."""
    rng = np.random.default_rng(0)
    sigs = np.stack([oracle.sample_signal(grid_truth[v % 8] + [0, 0, dv, 0],
                                          64, DWELL)
                     for v, dv in enumerate(rng.normal(scale=2.0, size=16))])
    grid_dir, res_dir = tmp_path / "grid", tmp_path / "res"
    res_dir.mkdir()
    ctx = worker.start(worker.runner_ranks, 2, 2, str(grid_dir), str(res_dir),
                       "cpu", sigs, DWELL, CFG, 4, None)
    worker.join(ctx, 300)
    assert sorted(int(o["done"]) for o in worker.load(res_dir, 2)) == [2, 2]
    full = GridRunner(grid_dir, DWELL, CFG, "cpu", shard_size=4).gather(16)
    cons, counts = _fit(sigs)
    np.testing.assert_allclose(full["frequency"], cons.frequency.numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(full["counts"], counts.numpy())
    assert not list(grid_dir.glob("*.tmp*"))
