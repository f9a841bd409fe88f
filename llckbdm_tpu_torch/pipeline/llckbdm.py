"""LL-KBDM pipeline: m-sweep -> pool -> cluster -> consolidate (-> refine).

Counterpart of llckbdm_tpu/pipeline/llckbdm.py (oracle counterpart:
oracle.reference.llc_kbdm).  Fixed shapes, batched over voxels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..ops.dbscan import compact_labels, dbscan, dbscan_1d, masked_median
from ..ops.linalg import matmul_precision
from ..signals import LineList, line_list_to_np
from ..solver.kbdm import KbdmConfig, kbdm_sweep
from ..spans import CLUSTER, FIT, span, spanned


class ClusterStats(NamedTuple):
    """Per-cluster dispersion of the pooled lines.  Shapes (..., C); 0 for
    empty slots."""

    amplitude: torch.Tensor   # std of A over cluster members
    t2: torch.Tensor          # std of T2
    frequency: torch.Tensor   # std of f
    phase: torch.Tensor       # CIRCULAR std of phase: sqrt(-2 ln R)


@dataclass(frozen=True)
class LlcKbdmConfig:
    """LL-KBDM configuration (oracle.reference.llc_kbdm: m_range via
    `m_values`, eps, min_samples)."""

    m_values: tuple = tuple(range(120, 257, 4))
    eps: float = 2e-4
    min_samples: int = 20
    damping_weight: float = 0.0   # weight of the dwell/T2 clustering feature
    max_clusters: int = 32        # consolidated line capacity C
    kbdm: KbdmConfig = field(default_factory=KbdmConfig)


def transform_line_lists(lines: LineList, dwell: float,
                         damping_weight: float = 0.0) -> torch.Tensor:
    """Clustering feature space — must match oracle transform_line_lists:
    x0 = f * dwell, x1 = damping_weight * dwell / T2."""
    dt = float(np.float32(dwell))
    x0 = lines.frequency * dt
    x1 = float(np.float32(damping_weight)) * dt / torch.clamp(lines.t2, min=1e-9)
    return torch.stack([x0, x1], dim=-1)


def _masked_std(values: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Population std of values[b, i] over member[b, :, c] > 0, per cluster."""
    cnt = torch.sum(member, dim=-2)
    safe = torch.clamp(cnt, min=1.0)
    mean = torch.einsum("bnc,bn->bc", member, values) / safe
    var = torch.einsum("bnc,bn->bc", member, values * values) / safe - mean ** 2
    return torch.where(cnt > 0, torch.sqrt(torch.clamp(var, min=0.0)), 0.0)


def _consolidate_one(pool: LineList, member: torch.Tensor):
    """Median consolidation of a batch of voxels' pooled lines.

    pool   : LineList with (B, n) fields
    member : (B, n, C) one-hot cluster membership
    Component-wise medians; phase from the medians of Re(d), Im(d) with
    d = A e^{i phase} (oracle.reference.llc_kbdm).  Also returns the
    per-cluster dispersion (ClusterStats).
    """
    amp = masked_median(pool.amplitude, member)
    t2 = masked_median(pool.t2, member)
    freq = masked_median(pool.frequency, member)
    med_re = masked_median(pool.amplitude * torch.cos(pool.phase), member)
    med_im = masked_median(pool.amplitude * torch.sin(pool.phase), member)
    phase = torch.atan2(med_im, med_re)
    counts = torch.sum(member, dim=-2)
    mask = (counts > 0).to(pool.amplitude.dtype)

    safe = torch.clamp(counts, min=1.0)
    cbar = torch.einsum("bnc,bn->bc", member, torch.cos(pool.phase)) / safe
    sbar = torch.einsum("bnc,bn->bc", member, torch.sin(pool.phase)) / safe
    r = torch.clamp(torch.hypot(cbar, sbar), max=1.0)
    circ_std = torch.sqrt(torch.clamp(-2.0 * torch.log(torch.clamp(r, min=1e-9)),
                                      min=0.0))
    stats = ClusterStats(amplitude=_masked_std(pool.amplitude, member),
                         t2=_masked_std(pool.t2, member),
                         frequency=_masked_std(pool.frequency, member),
                         phase=torch.where(counts > 0, circ_std, 0.0))
    lines = LineList(amplitude=amp * mask, t2=torch.where(mask > 0, t2, 1.0),
                     frequency=freq * mask, phase=phase * mask, mask=mask)
    return lines, stats


@matmul_precision()
@spanned(FIT)
def llc_kbdm_fit(c: torch.Tensor, dwell: float, cfg: LlcKbdmConfig,
                 omega: torch.Tensor | None = None):
    """Full LL-KBDM fit: c (..., N) complex64 -> (consolidated, pooled,
    counts, stats).

    consolidated : LineList (..., C) sorted deterministically by cluster size
    pooled       : LineList (..., S*p) all sweep lines (mask = validity)
    counts       : (..., C) cluster member counts
    stats        : ClusterStats (..., C) per-cluster std of (A, T2, f) and
                   circular std of phase
    omega        : optional sketch, passed to kbdm_sweep
    """
    sweep = kbdm_sweep(c, dwell, cfg.m_values, cfg.kbdm, omega=omega)
    with span(CLUSTER):
        flat = LineList(*(x.reshape(*x.shape[:-2], -1) for x in sweep))
        batch_shape, n = flat.amplitude.shape[:-1], flat.amplitude.shape[-1]

        feats = transform_line_lists(flat, dwell, cfg.damping_weight)
        feats = feats.reshape(-1, n, 2)
        pool = LineList(*(x.reshape(-1, n) for x in flat))
        valid = pool.mask > 0.5
        # The 1-D feature space (damping_weight == 0) takes the sorted
        # dbscan_1d on every device; the JAX package takes the O(n^2)
        # dbscan on a TPU even then, where sorts are slow.  The two
        # agree except where a distance rounds to exactly eps.
        if cfg.damping_weight == 0.0:
            labels = dbscan_1d(feats[..., 0], valid, cfg.eps,
                               cfg.min_samples)
        else:
            labels = dbscan(feats, valid, cfg.eps, cfg.min_samples)
        member, counts = compact_labels(labels, cfg.max_clusters)
        cons, stats = _consolidate_one(pool, member)

    def unflat(x):
        return x.reshape(*batch_shape, x.shape[-1])
    return (LineList(*map(unflat, cons)), flat, unflat(counts),
            ClusterStats(*map(unflat, stats)))


def llc_kbdm(data: np.ndarray, dwell: float, m_range, p: int = 24,
             eps: float = 2e-4, min_samples: int = 20, *,
             damping_weight: float = 0.0, max_clusters: int = 32,
             refine_iters: int = 0, device="cuda"):
    """NumPy-in / NumPy-out entry point with the reference's signature
    ``llc_kbdm(data, dwell, m_range, p, eps, min_samples)``.

    data : (N,) or (V, N) complex time-domain signal(s).
    refine_iters > 0 additionally runs the Gauss-Newton polish (the stage
    that meets the 1e-8 oracle gate).  device: where to run; the default
    "cuda" raises where there is no CUDA device (pass device="cpu" to run
    the kernels' plain versions on the CPU).  On a CUDA device the kernels
    take p + 8 <= 64 (KbdmConfig's oversample is 8), so p <= 56, and at
    most 32 clusters.  The solver's power iterations run in bfloat16 on a
    CUDA device (``KbdmConfig.subspace_bf16``, True by default, as the JAX
    package runs them on its accelerator; past p=16 on noisy signals that
    algorithm loses lines, so pass p <= 16 or a KbdmConfig with
    subspace_bf16=False through llc_kbdm_fit) and in float32 on the CPU;
    ``RefineConfig.eigh_sweeps`` is read by nothing, kept for parity with
    the JAX configurations.  The solver and the refinement switch torch's
    process-wide float32 matmul precision to "highest" while they run
    (``ops.linalg.matmul_precision``): another thread's matmuls see it
    meanwhile.

    Returns (consolidated, pooled, counts):
      consolidated : (k, 4) [or list of per-voxel (k_v, 4)] float64 rows of
                     (A, T2, f, phase), valid clusters only, sorted by f;
      pooled       : same layout for ALL pooled sweep lines;
      counts       : (C,) [or (V, C)] member counts per cluster slot.
    """
    data = np.asarray(data, np.complex128)
    single = data.ndim == 1
    batch = data[None] if single else data
    cfg = LlcKbdmConfig(m_values=tuple(int(m) for m in m_range), eps=eps,
                        min_samples=min_samples, max_clusters=max_clusters,
                        damping_weight=damping_weight,
                        kbdm=KbdmConfig(p=p))
    c = torch.as_tensor(batch, device=device)
    cons, pooled, counts, _stats = llc_kbdm_fit(c.to(torch.complex64), dwell,
                                                cfg)

    def voxel(lines, i):
        return LineList(*(x[i] for x in lines))

    if refine_iters > 0:
        from ..solver.refine import RefineConfig, refine_lines, refined_to_np
        ref = refine_lines(c, cons, dwell, RefineConfig(iters=refine_iters))
        cons_np = [refined_to_np(ref._replace(z=ref.z[i], d=ref.d[i],
                                              mask=ref.mask[i]), dwell)
                   for i in range(batch.shape[0])]
    else:
        cons_np = [line_list_to_np(voxel(cons, i))
                   for i in range(batch.shape[0])]
    pooled_np = [line_list_to_np(voxel(pooled, i))
                 for i in range(batch.shape[0])]
    counts_np = counts.cpu().numpy()
    if single:
        return cons_np[0], pooled_np[0], counts_np[0]
    return cons_np, pooled_np, counts_np
