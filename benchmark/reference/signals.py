"""Frozen copies of the program's two sound signal generators, each with a
``seed`` argument: ``five_peak_signals`` (``llckbdm_tpu_torch/tools/
five_peak.py::signals``) and ``make_grid_signals`` (``llckbdm_tpu_torch/
tools/config5_run.py::make_grid_signals``, hard-wired there to seed 0).

They define the signal family that ``benchmark/inputs.py`` draws on the
device: ``benchmark/tests/test_benchmark_frozen.py`` holds each copy equal
to its source and the harness's generator to ``make_grid_signals``' draws.
numpy only.
"""
from __future__ import annotations

import numpy as np

from .oracle import sample_signal

FIVE_PEAK = np.array([
    [1.0, 0.05, -120.0, 0.1],
    [0.8, 0.08, -40.0, 0.0],
    [1.2, 0.03, 15.0, -0.2],
    [0.5, 0.10, 90.0, 0.3],
    [0.9, 0.06, 200.0, 0.0],
])
N, DWELL = 512, 5e-4


def five_peak_signals(v: int, noise: float = 0.0, seed: int = 0,
                      amp_jitter: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """(v, N) complex128 signals and their (v, 5, 4) truths: per voxel the
    five lines with frequency jitter (sd 2 Hz) and, with ``amp_jitter``,
    amplitude jitter (sd 5%), drawn voxel by voxel from default_rng(seed);
    then complex noise of sd ``noise`` per part, drawn for the whole batch."""
    rng = np.random.default_rng(seed)
    sigs = np.empty((v, N), np.complex128)
    truths = np.empty((v, 5, 4))
    for i in range(v):
        p = FIVE_PEAK.copy()
        p[:, 2] += rng.normal(scale=2.0, size=5)
        if amp_jitter:
            p[:, 0] *= 1.0 + rng.normal(scale=0.05, size=5)
        sigs[i] = sample_signal(p, N, DWELL)
        truths[i] = p
    if noise:
        sigs += noise * (rng.standard_normal((v, N))
                         + 1j * rng.standard_normal((v, N)))
    return sigs, truths


def make_grid_signals(v: int, chunk: int = 4096, seed: int = 0):
    """Config 5's signals: the config-1 lines with per-voxel jitter of
    amplitude (5%) and frequency (2 Hz), plus complex noise 1e-4, from
    default_rng(seed).  Returns (signals (v, N) complex128, truths (v, 5,
    4)).  The lines are summed ``chunk`` voxels at a time."""
    base, n, dwell = FIVE_PEAK, N, DWELL
    rng = np.random.default_rng(seed)
    amp = base[:, 0] * (1.0 + rng.normal(scale=0.05, size=(v, 5)))
    t2 = np.broadcast_to(base[:, 1], (v, 5))
    freq = base[:, 2] + rng.normal(scale=2.0, size=(v, 5))
    ph = np.broadcast_to(base[:, 3], (v, 5))
    noise = 1e-4 * (rng.standard_normal((v, n))
                    + 1j * rng.standard_normal((v, n)))
    t = np.arange(n) * dwell
    sigs = np.empty((v, n), np.complex128)
    for s in range(0, v, chunk):
        z = (2j * np.pi * freq[s:s + chunk, :, None]
             - 1.0 / t2[s:s + chunk, :, None]) * t
        sigs[s:s + chunk] = np.sum(amp[s:s + chunk, :, None]
                                   * np.exp(1j * ph[s:s + chunk, :, None] + z),
                                   axis=1)
    sigs += noise
    return sigs, np.stack([amp, t2, freq, ph], axis=-1)
