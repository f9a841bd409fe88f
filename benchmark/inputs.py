"""Signals for a cell, made from ``--seed``: the line parameters on the host
in ``make_grid_signals``' order of draws (``reference/signals.py``), the
noise and the sum of the lines on the device in float64, in a few large
calls.

A configuration's ``signal`` block gives the lines (A, T2, f, phase), N,
the dwell, the amplitude jitter (relative sd, one draw per line and voxel),
the frequency jitter in Hz (one draw per line and voxel, or with
``shared_shift`` one per voxel for all lines: a B0 shift) and the sd of
the complex noise per part.  One seed gives the same inputs on one kind of
device (a CUDA generator draws other noise than the CPU's).
"""
from __future__ import annotations

import numpy as np
import torch

# elements of complex128 (voxels x lines x N) per chunk of the line sum
CHUNK_ELEMENTS = 1 << 25
# the streams of one seed: the signals, and the sample compared with the
# reference
SIGNALS, SAMPLE = 0, 1


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for each use of one seed; any whole
    number is a seed (negative ones wrap to 64 bits)."""
    return np.random.default_rng(
        np.random.SeedSequence(seed % (1 << 64), spawn_key=(stream,)))


def sample(seed: int, population: int, count: int) -> list[int]:
    """``count`` distinct indices below ``population`` drawn from the seed's
    SAMPLE stream, sorted."""
    rng = rng_for(seed, SAMPLE)
    return sorted(rng.choice(population, size=min(count, population),
                             replace=False).tolist())


def draw_lines(rng: np.random.Generator, sig: dict, v: int) -> np.ndarray:
    """(v, L, 4) per-voxel lines: amplitudes then frequencies, drawn as
    ``make_grid_signals`` draws them."""
    base = np.asarray(sig["lines"], np.float64)
    lines = base.shape[0]
    amp = base[:, 0] * (1.0 + rng.normal(scale=sig["amp_jitter"],
                                         size=(v, lines)))
    shift = rng.normal(scale=sig["freq_jitter_hz"],
                       size=(v, 1) if sig["shared_shift"] else (v, lines))
    freq = base[:, 2] + shift
    t2 = np.broadcast_to(base[:, 1], (v, lines))
    ph = np.broadcast_to(base[:, 3], (v, lines))
    return np.stack([amp, t2, freq, ph], axis=-1)


def synthesize(sig: dict, v: int, seed: int,
               device) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """(host signals (v, N) complex128, truths (v, L, 4), the same signals
    on ``device``)."""
    rng = rng_for(seed, SIGNALS)
    truths = draw_lines(rng, sig, v)
    n, dwell = int(sig["n"]), float(sig["dwell"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 63)))
    noise = torch.randn((v, n, 2), dtype=torch.float64, generator=gen,
                        device=device)
    out = torch.view_as_complex(noise).mul_(float(sig["noise"]))
    par = torch.as_tensor(truths, device=device)
    t = torch.arange(n, dtype=torch.float64, device=device) * dwell
    chunk = max(1, CHUNK_ELEMENTS // (truths.shape[1] * n))
    for s in range(0, v, chunk):
        a, t2, f, ph = par[s:s + chunk].unbind(-1)
        rate = torch.complex(-1.0 / t2, 2.0 * np.pi * f)          # (c, L)
        terms = torch.exp(rate[..., None] * t + (1j * ph)[..., None])
        out[s:s + chunk] += torch.sum(a[..., None] * terms, dim=1)
    return out.cpu().numpy(), truths, out
