"""Inputs and error measures for the refine's normal equations
(``ops.cuda_linalg.gn_normal`` against ``gn_normal_plain``), shared by the
CPU tests, the card's tests and ``chip_smoke.py``.  Imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

DWELL = 2.5e-4


def normal_inputs(v, nc, n, t0=0, seed=0, masked=2, device="cpu"):
    """One exact Gauss-Newton step's inputs, as refine_lines forms them:
    c (v, n) complex128, a sum of nc damped lines whose poles and amplitudes
    sit 1e-4 and 1e-2 away from z and d (v, nc) complex128, sampled at
    global times t0 .. t0 + n - 1; ``masked`` slots of each voxel are 0 in z
    and d.  Returns (c, z, d, mask) with mask (v, nc) a numpy bool array."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(-400.0, 400.0, (v, nc))
    t2 = rng.uniform(0.03, 0.15, (v, nc))
    z = np.exp((2j * np.pi * f - 1.0 / t2) * DWELL)
    d = rng.uniform(0.5, 3.0, (v, nc)) * np.exp(
        1j * rng.uniform(-np.pi, np.pi, (v, nc)))
    zt = z * (1 + 1e-4 * (rng.standard_normal((v, nc))
                          + 1j * rng.standard_normal((v, nc))))
    dt = d * (1 + 1e-2 * rng.standard_normal((v, nc)))
    c = np.einsum("vk,vkn->vn", dt, zt[..., None] ** (t0 + np.arange(n)))
    mask = np.ones((v, nc), bool)
    for i in range(v):
        mask[i, rng.choice(nc, size=min(masked, nc - 1), replace=False)] = False
    z, d = np.where(mask, z, 0), np.where(mask, d, 0)
    return (*(torch.as_tensor(x).to(device) for x in (c, z, d)), mask)


def normal_errors(g, rhs, g_ref, rhs_ref, mask):
    """(G, rhs) errors against a reference, per voxel, on unmasked slots
    only (the masked ones are overwritten by identity rows): the largest
    |dG| over pairs of unmasked slots over the largest |G_ref| there, and
    the largest |d rhs| over the unmasked rows of each half (the P and the
    D block) over the largest |rhs_ref| of that half.  Returns the largest
    of each over the voxels."""
    g, rhs, g_ref, rhs_ref = (np.asarray(x.cpu()) if torch.is_tensor(x)
                              else np.asarray(x)
                              for x in (g, rhs, g_ref, rhs_ref))
    nc = mask.shape[-1]
    eg = er = 0.0
    for i in range(mask.shape[0]):
        m2 = np.concatenate([mask[i], mask[i]])
        pair = m2[:, None] & m2[None, :]
        eg = max(eg, np.abs(g[i][pair] - g_ref[i][pair]).max()
                 / np.abs(g_ref[i][pair]).max())
        for half in (slice(0, nc), slice(nc, 2 * nc)):
            live = m2[half]
            ref = rhs_ref[i][half][live]
            er = max(er, np.abs(rhs[i][half][live] - ref).max()
                     / np.abs(ref).max())
    return float(eg), float(er)
