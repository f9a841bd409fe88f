"""Fixed-shape, exact-semantics DBSCAN, batched over voxels.

Counterpart of ``dbscan``, ``dbscan_1d``, ``compact_labels`` and
``masked_median`` in llckbdm_tpu/ops/dbscan.py, written for a leading batch
axis instead of vmap.  Semantics (sklearn's DBSCAN with a deterministic
border rule):

* neighbor count = #valid points within eps (self included);
* core           = valid & count >= min_samples;
* clusters       = connected components of the core-core eps graph;
* border         = non-core valid point within eps of >= 1 core; adopts the
                   minimum root label among its core neighbors;
* labels         = root point index (the cluster's minimum original core
                   index), -1 for noise.  Invalid points are always -1.

:func:`dbscan` takes any feature dimension (the pipeline's 2-D space when
damping_weight != 0) at O(n^2) per voxel; :func:`dbscan_1d` takes the 1-D
space (damping_weight == 0) by sort and range counting.  The two agree label
for label except where a pair's distance rounds to exactly eps
(llckbdm_tpu/ops/dbscan.py:94-101).  Plain PyTorch: the JAX package has no
Pallas kernel here.
"""
from __future__ import annotations

import torch

_BIG = 2 ** 30
# dbscan's (chunk, n, n) temporaries hold at most this many elements each
# (512 MiB in float32); its only whole-batch (B, n, n) tensor is boolean.
_CHUNK_ELEMS = 2 ** 27


def _neighbour_min(adj: torch.Tensor, lab: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """min over j of lab[b, j] where adj[b, i, j], else _BIG: (B, n)."""
    out = torch.empty_like(lab)
    for s in range(0, lab.shape[0], chunk):
        a, l = adj[s:s + chunk], lab[s:s + chunk]
        out[s:s + chunk] = torch.where(a, l[:, None, :], _BIG).amin(dim=-1)
    return out


def dbscan(feats: torch.Tensor, valid: torch.Tensor, eps: float,
           min_samples: int, max_iters: int = 24) -> torch.Tensor:
    """Exact DBSCAN by pairwise distances and min-label propagation.

    feats : (B, n, d) float32;  valid : (B, n) bool.  Returns (B, n) int32
    labels.  The arithmetic is the JAX function's, so the labels are its
    labels: squared distances summed over the features (not the |a|^2 +
    |b|^2 - 2ab expansion, which rounds otherwise at eps ties) against
    float32(eps)^2; then rounds of "min over core neighbours, then follow
    the label once more" (pointer jumping) until a round changes nothing or
    ``max_iters`` rounds have run.  A round after the fixed point changes
    nothing, so stopping when no voxel of the batch changed gives each
    voxel its own JAX labels; one host sync a round.

    Memory: the (B, n, n) adjacency in bool, and (chunk, n, n) temporaries
    of at most ``_CHUNK_ELEMS`` elements (at n = 560, 428 voxels a chunk).
    """
    b, n = valid.shape
    chunk = max(1, _CHUNK_ELEMS // max(1, n * n))
    thr = float(torch.tensor(eps, dtype=torch.float32) ** 2)
    adj = torch.empty((b, n, n), dtype=torch.bool, device=feats.device)
    count = torch.empty((b, n), dtype=torch.int32, device=feats.device)
    for s in range(0, b, chunk):
        f, v = feats[s:s + chunk], valid[s:s + chunk]
        d2 = torch.zeros((f.shape[0], n, n), dtype=feats.dtype,
                         device=feats.device)
        for j in range(f.shape[-1]):
            x = f[..., j]
            d2 += (x[:, :, None] - x[:, None, :]).square_()
        a = (d2 <= thr) & v[:, :, None] & v[:, None, :]
        del d2
        adj[s:s + chunk] = a
        # a whole-batch sum of the boolean adjacency would widen it to int64
        count[s:s + chunk] = a.sum(dim=-1, dtype=torch.int32)
    core = valid & (count >= min_samples)

    idx = torch.arange(n, dtype=torch.int32, device=feats.device)
    lab = torch.where(core, idx, _BIG)
    # a non-core point's label is _BIG, so "min over adjacent cores" is the
    # min over all neighbours
    for _ in range(max_iters):
        lab1 = torch.minimum(lab, _neighbour_min(adj, lab, chunk))
        jump = torch.gather(lab1, -1, lab1.clamp(0, n - 1).long())
        lab2 = torch.where(core, torch.minimum(lab1, jump), _BIG)
        changed = bool((lab2 != lab).any())
        lab = lab2
        if not changed:
            break

    border = _neighbour_min(adj, lab, chunk)
    is_border = valid & ~core & (border < _BIG)
    return torch.where(core, lab, torch.where(is_border, border, -1))


def dbscan_1d(x: torch.Tensor, valid: torch.Tensor, eps: float,
              min_samples: int) -> torch.Tensor:
    """Exact DBSCAN over 1-D features via sort + range counting.

    x : (B, n) float32;  valid : (B, n) bool.  Returns (B, n) int64 labels.
    """
    n = x.shape[-1]
    big = 3.0e38
    key = torch.where(valid, x, big)                  # invalid sort to the end
    xs, order = torch.sort(key, dim=-1, stable=True)
    valid_s = torch.gather(valid, -1, order)

    # neighbor counts within eps (self included): two binary searches
    e = float(torch.tensor(eps, dtype=x.dtype))
    ub = torch.searchsorted(xs, xs + e, right=True)
    lb = torch.searchsorted(xs, xs - e, right=False)
    core_s = valid_s & ((ub - lb) >= min_samples)

    # a new segment starts at each core whose gap to the previous core
    # exceeds eps (previous core x = running max of core xs)
    core_x = torch.where(core_s, xs, -big)
    run_max = torch.cummax(core_x, dim=-1).values
    prev_core_x = torch.cat(
        [torch.full_like(run_max[..., :1], -big), run_max[..., :-1]], dim=-1)
    start = core_s & (xs - prev_core_x > e)

    # root label = min ORIGINAL index among the segment's cores: a
    # segment-min by scatter (points before the first segment, seg = -1,
    # are never cores and carry _BIG)
    seg = torch.clamp(torch.cumsum(start.to(torch.int64), dim=-1) - 1, min=0)
    core_orig = torch.where(core_s, order, _BIG)
    seg_min = torch.full_like(order, _BIG).scatter_reduce(
        -1, seg, core_orig, reduce="amin")
    lab_core = torch.where(core_s, torch.gather(seg_min, -1, seg), _BIG)

    # border points: nearest core on each side within eps; adopt the min
    # root among those (<= 2) clusters
    pos = torch.arange(n, device=x.device).expand_as(order)
    left_pos = torch.cummax(torch.where(core_s, pos, -1), dim=-1).values
    right_rev = torch.cummax(torch.where(core_s.flip(-1), pos, -1),
                             dim=-1).values.flip(-1)
    right_pos = torch.where(right_rev >= 0, (n - 1) - right_rev, -1)

    def side_root(p):
        pc = torch.clamp(p, 0, n - 1)
        near = (p >= 0) & (torch.abs(xs - torch.gather(xs, -1, pc)) <= e)
        return torch.where(near, torch.gather(lab_core, -1, pc), _BIG)

    cand = torch.minimum(side_root(left_pos), side_root(right_pos))
    is_border = valid_s & ~core_s & (cand < _BIG)
    lab_s = torch.where(core_s, lab_core, torch.where(is_border, cand, -1))
    return torch.empty_like(lab_s).scatter_(-1, order, lab_s)


def compact_labels(labels: torch.Tensor, max_clusters: int):
    """Map root-index labels to compact ids [0, C) by descending cluster size.

    labels : (B, n) int from :func:`dbscan` or :func:`dbscan_1d` (-1 =
    noise).  Returns (membership (B, n, C) float32 one-hot, counts (B, C)
    int64).  Clusters are ordered by (descending size, ascending root index).
    """
    labels = labels.to(torch.int64)
    n = labels.shape[-1]
    clustered = labels >= 0
    root_counts = torch.zeros_like(labels).scatter_add_(
        -1, torch.clamp(labels, 0, n - 1), clustered.to(labels.dtype))
    # size desc, index asc: the key values are unique
    order_key = root_counts * n - torch.arange(n, device=labels.device)
    top_roots = torch.topk(order_key, max_clusters, dim=-1).indices
    top_counts = torch.gather(root_counts, -1, top_roots)
    top_roots = torch.where(top_counts > 0, top_roots, -2)  # never matches
    membership = (labels[..., :, None] == top_roots[..., None, :]).to(torch.float32)
    return membership, top_counts


def masked_median(values: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Median of values[i] over member[:, c] > 0, per cluster c.

    values : (B, n);  member : (B, n, C) 0/1.  Returns (B, C) with numpy
    median semantics (mean of the two middle order statistics for even
    counts), 0 for empty clusters.  The within-cluster rank is the stable
    ascending rank (index tie-break), as in the JAX rank-selection.
    """
    vs, order = torch.sort(values, dim=-1, stable=True)
    mem = torch.gather(member, -2, order[..., None].expand_as(member))
    rank = torch.cumsum(mem, dim=-2) - 1.0                   # for members
    cnt = torch.sum(member, dim=-2)                          # (B, C)
    lo = torch.floor(0.5 * (cnt - 1.0))
    hi = torch.floor(0.5 * cnt)
    sel_lo = mem * (rank == lo[..., None, :])
    sel_hi = mem * (rank == hi[..., None, :])
    # one-hot selections summed elementwise: exact whatever the matmul mode
    med = 0.5 * (torch.sum(vs[..., None] * sel_lo, dim=-2)
                 + torch.sum(vs[..., None] * sel_hi, dim=-2))
    return torch.where(cnt > 0, med, 0.0)
