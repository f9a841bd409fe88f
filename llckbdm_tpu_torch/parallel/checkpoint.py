"""Resumable grid sweeps: voxel-range manifests + shard results.

Counterpart of llckbdm_tpu/parallel/checkpoint.py, with the same files: a
grid fit is decomposed into deterministic voxel-range *shards*; each
completed shard's results are written atomically (tmp + rename) as an .npz
with the JAX runner's keys, dtypes and shapes, and a re-run skips shards
whose result file already exists — resume-by-manifest, no coordinator state.

The manifest's fingerprint also names the package: the port draws its
Gaussian sketch from ``torch.Generator``, not ``jax.random``, so resuming a
JAX runner's out_dir here raises ``config mismatch`` instead of mixing
shards of the two.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib

import numpy as np
import torch

from ..pipeline.llckbdm import LlcKbdmConfig
from ..signals import LineList
from ..solver.refine import RefineConfig
from .grid import fit_grid, refine_grid

_LINE_KEYS = ("amplitude", "t2", "frequency", "phase", "mask")


def shard_manifest(n_voxels: int, shard_size: int,
                   process_index: int = 0,
                   num_processes: int = 1) -> list[tuple[int, int]]:
    """Deterministic [start, stop) voxel ranges owned by this process.

    Shards are dealt round-robin so every process touches the whole grid's
    address space (even load when signal difficulty correlates with voxel
    position).
    """
    if shard_size <= 0:
        raise ValueError("shard_size must be positive")
    starts = range(0, n_voxels, shard_size)
    return [(s, min(s + shard_size, n_voxels))
            for i, s in enumerate(starts)
            if i % num_processes == process_index]


def _shard_path(out_dir: pathlib.Path, start: int, stop: int) -> pathlib.Path:
    return out_dir / f"shard_{start:08d}_{stop:08d}.npz"


def _publish(path: pathlib.Path, record: dict, tag: str) -> dict:
    """Create ``path`` holding ``record`` unless it exists; return what the
    file holds.  A private tmp is published by hard link: link() fails with
    FileExistsError if another process won, and readers never see a
    partially written file."""
    tmp = path.with_suffix(f".tmp.{os.getpid()}.{tag}")
    tmp.write_text(json.dumps(record, indent=1))
    try:
        os.link(tmp, path)
    except FileExistsError:
        pass
    finally:
        tmp.unlink()
    return json.loads(path.read_text())


def _to_device_async(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """x on device; to a GPU through pinned memory, without waiting."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _to_host_async(x: torch.Tensor):
    """Start copying x to host memory; returns (host tensor, event to wait
    on, or None when x already is on the host)."""
    if not x.is_cuda:
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


@dataclasses.dataclass
class GridRunner:
    """Checkpointed LL-KBDM sweep over a flat voxel batch.

    out_dir   : shard results + manifest.json live here
    dwell     : sample dwell time (s)
    cfg       : pipeline config (must be identical across resume runs; a
                fingerprint is stored in manifest.json and checked)
    device    : where the shards are computed (``"cuda"``, ``"cpu"``)
    shard_size: voxels per shard (one launch of the pipeline each)
    refine    : when set, each shard additionally runs the Gauss-Newton
                polish (the stage that meets the 1e-8 oracle gate,
                solver.refine) on its top ``refine_clusters`` consolidated
                clusters, and stores the refined poles / amplitudes as
                complex128 (``refined_z``, ``refined_d``, + ``refined_mask``,
                ``gn_step``).  None (default) = f32-only pipeline.
    """

    out_dir: str | os.PathLike
    dwell: float
    cfg: LlcKbdmConfig
    device: str | torch.device
    shard_size: int = 256
    process_index: int = 0
    num_processes: int = 1
    refine: RefineConfig | None = None
    refine_clusters: int = 16

    def __post_init__(self):
        self.out_dir = pathlib.Path(self.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.device = torch.device(self.device)
        self._check_manifest()

    def _fingerprint(self) -> dict:
        # The FULL config (recursing into cfg.kbdm via dataclasses.asdict):
        # resuming after changing ANY solver knob would silently mix shards
        # computed under different configs.
        cfg = dataclasses.asdict(self.cfg)
        cfg["m_values"] = list(map(int, cfg["m_values"]))
        fp = {
            "package": "llckbdm_tpu_torch",
            "dwell": float(self.dwell),
            "cfg": cfg,
            "shard_size": int(self.shard_size),
        }
        if self.refine is not None:
            fp["refine"] = dataclasses.asdict(self.refine)
            fp["refine_clusters"] = int(self.refine_clusters)
        return fp

    def _check_manifest(self) -> None:
        """Create-or-validate manifest.json, atomically and from EVERY
        process: exactly one exclusive create wins, the rest compare."""
        path = self.out_dir / "manifest.json"
        fp = self._fingerprint()
        old = _publish(path, fp, str(self.process_index))
        if old != fp:
            raise ValueError(
                f"resume config mismatch in {path}:\n old={old}\n new={fp}")

    @staticmethod
    def _data_fingerprint(signals: np.ndarray) -> dict:
        """Cheap content digest tying shard files to the input grid.

        Full blake2b for small grids; for pod-scale inputs (config 5 can be
        GBs) a deterministic sample: head + tail + strided slice.
        """
        b = np.ascontiguousarray(signals)
        view = b.view(np.uint8).reshape(-1)
        h = hashlib.blake2b(digest_size=16)
        h.update(str((b.shape, b.dtype.str)).encode())
        if view.nbytes <= (1 << 26):
            h.update(view.tobytes())
        else:
            h.update(view[: 1 << 20].tobytes())
            h.update(view[-(1 << 20):].tobytes())
            h.update(np.ascontiguousarray(
                view[:: max(1, view.nbytes // (1 << 20))]).tobytes())
        return {"n_voxels": int(signals.shape[0]), "digest": h.hexdigest()}

    def _check_data(self, signals: np.ndarray) -> None:
        """Create-or-validate data.json (same atomic protocol as the manifest)."""
        path = self.out_dir / "data.json"
        fp = self._data_fingerprint(signals)
        old = _publish(path, fp, str(self.process_index))
        if old != fp:
            raise ValueError(
                f"input data mismatch in {path} (resuming in this out_dir "
                f"with different signals):\n old={old}\n new={fp}")

    def pending(self, n_voxels: int) -> list[tuple[int, int]]:
        """Manifest shards owned by this process that have no result yet."""
        return [(s, e)
                for s, e in shard_manifest(n_voxels, self.shard_size,
                                           self.process_index,
                                           self.num_processes)
                if not _shard_path(self.out_dir, s, e).exists()]

    def _layout(self) -> list[tuple[str, int, type]]:
        """(key, float64 columns per voxel, stored dtype) of a shard's
        packed result, in packing order."""
        c = self.cfg.max_clusters
        layout = [(k, c, np.float32) for k in _LINE_KEYS]
        layout.append(("counts", c, np.int32))
        if self.refine is not None:
            rc = min(self.refine_clusters, c)
            layout += [("refined_z", 2 * rc, np.complex128),
                       ("refined_d", 2 * rc, np.complex128),
                       ("refined_mask", rc, np.float32),
                       ("gn_step", rc, np.float32)]
        return layout

    def run(self, signals: np.ndarray, queue_depth: int = 16) -> int:
        """Fit every pending shard of `signals` ((V, N) complex); return the
        number of shards computed this call (0 = everything was resumed).

        Up to `queue_depth` shards are launched before the oldest is
        fetched.  On a GPU a launch waits for nothing: its signals go up
        from pinned memory, and it ends by packing the shard's whole result
        into one float64 buffer (lossless for every stored dtype) and
        starting its copy to pinned host memory, so the fetches and .npz
        writes overlap the next shards' compute.  Each shard's result file
        is written atomically (tmp + rename), so a kill mid-run loses at
        most the in-flight shards.
        """
        signals = np.asarray(signals)
        self._check_data(signals)
        layout = self._layout()

        def launch(s, e):
            c64 = _to_device_async(np.asarray(signals[s:e], np.complex128),
                                   self.device)
            cons, _pooled, counts, _stats = fit_grid(
                c64.to(torch.complex64), self.dwell, self.cfg)
            parts = [*cons, counts]
            if self.refine is not None:
                # gate-meeting stage: consolidated slots are count-sorted,
                # so the top refine_clusters slice keeps every genuine line
                rc = min(self.refine_clusters, self.cfg.max_clusters)
                refined = refine_grid(
                    c64, LineList(*(x[..., :rc] for x in cons)), self.dwell,
                    self.refine)
                parts += [torch.view_as_real(refined.z),
                          torch.view_as_real(refined.d),
                          refined.mask, refined.gn_step]
            packed = torch.cat([x.reshape(e - s, -1).to(torch.float64)
                                for x in parts], dim=1)
            return _to_host_async(packed)

        def drain(item):
            (s, e), (host, done) = item
            if done is not None:
                done.synchronize()
            packed = host.numpy()
            out, col = {}, 0
            for key, width, dtype in layout:
                block = packed[:, col:col + width]
                col += width
                if dtype is np.complex128:
                    out[key] = np.ascontiguousarray(block).view(np.complex128)
                else:
                    out[key] = block.astype(dtype)
            path = _shard_path(self.out_dir, s, e)
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, **out)
            tmp.replace(path)

        done = 0
        inflight: list = []
        for s, e in self.pending(signals.shape[0]):
            inflight.append(((s, e), launch(s, e)))
            if len(inflight) >= queue_depth:
                drain(inflight.pop(0))
                done += 1
        while inflight:
            drain(inflight.pop(0))
            done += 1
        return done

    def gather(self, n_voxels: int) -> dict[str, np.ndarray]:
        """Assemble the full-grid result from ALL processes' shard files.

        Raises FileNotFoundError listing missing shards if incomplete.
        """
        data_path = self.out_dir / "data.json"
        if data_path.exists():
            rec = json.loads(data_path.read_text())
            if rec["n_voxels"] != n_voxels:
                raise ValueError(
                    f"gather(n_voxels={n_voxels}) does not match the grid "
                    f"these shards were computed from (n_voxels="
                    f"{rec['n_voxels']}, {data_path})")
        shards = shard_manifest(n_voxels, self.shard_size, 0, 1)
        missing = [f"[{s},{e})" for s, e in shards
                   if not _shard_path(self.out_dir, s, e).exists()]
        if missing:
            raise FileNotFoundError(
                f"grid incomplete: missing shards {', '.join(missing)}")
        # keys come from the first shard file: refined runners carry the
        # extra refined_z/refined_d/refined_mask/gn_step arrays
        with np.load(_shard_path(self.out_dir, *shards[0])) as z0:
            keys = tuple(z0.files)
        parts = {k: [] for k in keys}
        for s, e in shards:
            with np.load(_shard_path(self.out_dir, s, e)) as z:
                for k in keys:
                    parts[k].append(z[k])
        return {k: np.concatenate(v, axis=0) for k, v in parts.items()}
