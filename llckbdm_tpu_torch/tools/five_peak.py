"""The config-1 signal family the measuring tools share (BASELINE.json:7):
five lines, N=512, dwell 0.5 ms, as the JAX package's tools draw it, and
the north star's LL-KBDM configuration (bench.py:172-177)."""
from __future__ import annotations

import numpy as np

from .. import oracle
from ..pipeline.llckbdm import LlcKbdmConfig
from ..solver.kbdm import KbdmConfig

FIVE_PEAK = np.array([
    [1.0, 0.05, -120.0, 0.1],
    [0.8, 0.08, -40.0, 0.0],
    [1.2, 0.03, 15.0, -0.2],
    [0.5, 0.10, 90.0, 0.3],
    [0.9, 0.06, 200.0, 0.0],
])
N, DWELL = 512, 5e-4
M_VALUES = tuple(range(120, 257, 4))
REFINE_CLUSTERS = 16


def north_star_config(kbdm: KbdmConfig = KbdmConfig(p=16)) -> LlcKbdmConfig:
    """The bench's sweep m = 120..256 step 4, eps 2e-4, min_samples 20, 32
    cluster slots (the top REFINE_CLUSTERS of them refined)."""
    return LlcKbdmConfig(m_values=M_VALUES, eps=2e-4, min_samples=20,
                         max_clusters=32, kbdm=kbdm)


def signals(v: int, noise: float = 0.0, seed: int = 0,
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
        sigs[i] = oracle.sample_signal(p, N, DWELL)
        truths[i] = p
    if noise:
        sigs += noise * (rng.standard_normal((v, N))
                         + 1j * rng.standard_normal((v, N)))
    return sigs, truths


def gate_error(refined_rows: np.ndarray, init_rows: np.ndarray,
               sig: np.ndarray, truth: np.ndarray, iters: int = 20) -> float:
    """The largest error of one voxel's refined lines (refined_to_np rows)
    against the float64 oracle's Gauss-Newton polish of the same signal
    from ``init_rows``, matched through the truth.  A voxel without a line
    for each true one raises ValueError (oracle.match_lines)."""
    olines = oracle.refine(init_rows, sig, DWELL, iters=iters)
    sel_o = oracle.match_lines(olines, truth)
    sel_e = oracle.match_lines(refined_rows, truth)
    return float(oracle.line_errors(refined_rows[sel_e], olines[sel_o]).max())
