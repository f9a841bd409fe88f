"""Hankel operators (counterpart of llckbdm_tpu/ops/hankel.py).

U0[i, j] = c[i + j], U1[i, j] = c[i + j + 1] (oracle: reference.kbdm).  Two
forms:

* :func:`hankel_matrices` materializes the m x m operator.  For the m-sweep
  the largest m is materialized once; every smaller m is its leading
  submatrix, selected by the row/col masks of solver.kbdm.kbdm_sweep.
* :func:`hankel_fft_spectrum` + :func:`hankel_apply_fft` apply the same
  operator implicitly, as an FFT correlation with the raw signal: no
  (..., m, m) operator in memory, O(nfft log nfft) per column.  The sweep
  uses neither package's implicit form; whether it should is measured by
  ``tools/bench_fft_hankel.py``.

Both raise ValueError when the signal is too short for the operator, where
the JAX package's spectrum zero-pads it silently.
"""
from __future__ import annotations

import torch


def _check_length(fn: str, n: int, m: int, shift: int) -> None:
    if n < 2 * m - 1 + shift:
        raise ValueError(f"{fn}: need n >= 2m - 1 + shift, got n={n}, m={m}, "
                         f"shift={shift}")


def hankel_matrices(c: torch.Tensor, m: int, shift: int = 0) -> torch.Tensor:
    """H[..., i, j] = c[..., i + j + shift] as one gather: (..., n) -> (..., m, m).

    Raises ValueError when the signal is too short for the operator.
    """
    _check_length("hankel_matrices", c.shape[-1], m, shift)
    ar = torch.arange(m, device=c.device)
    return c[..., ar[:, None] + ar[None, :] + shift]


def fft_length(m: int) -> int:
    """Smallest power of two >= 2m: indices i + j <= 2m - 2 never wrap."""
    nfft = 1
    while nfft < 2 * m:
        nfft *= 2
    return nfft


def hankel_fft_spectrum(c: torch.Tensor, m: int, shift: int = 0,
                        n_fft: int | None = None) -> torch.Tensor:
    """FFT of the signal window that defines the implicit m x m Hankel
    H[i, j] = c[i + j + shift]: (..., n) -> (..., nfft), computed once per
    signal; each :func:`hankel_apply_fft` is then two batched FFTs.

    The window is c[shift : shift + nfft], zero-padded to nfft where the
    signal ends first; only its first 2m - 1 entries enter the operator, so
    a signal shorter than that raises ValueError (the JAX function pads it
    with zeros instead), as does an ``n_fft`` below 2m - 1, which would wrap.
    """
    nfft = n_fft or fft_length(m)
    n = c.shape[-1]
    _check_length("hankel_fft_spectrum", n, m, shift)
    if nfft < 2 * m - 1:
        raise ValueError(f"hankel_fft_spectrum: n_fft={nfft} < 2m - 1 = "
                         f"{2 * m - 1} would wrap")
    take = min(nfft, n - shift)
    return torch.fft.fft(c[..., shift:shift + take], n=nfft, dim=-1)


def hankel_apply_fft(spec: torch.Tensor, x: torch.Tensor, m: int) -> torch.Tensor:
    """Implicit Hankel apply  y_i = sum_{j<m} c[i + j + shift] x_j,  i < m.

    spec : (..., nfft) from :func:`hankel_fft_spectrum`
    x    : (..., m, J) — J columns applied at once
    Returns (..., m, J).

    With ct the signal window and x~ the index-reversed zero-padded x, whose
    DFT is nfft * ifft(x), the circular convolution (ct (*) x~)[i] equals
    sum_j ct[i + j] x_j wherever i + j < nfft, which nfft >= 2m - 1
    guarantees.  The unnormalized inverse transform (``norm="forward"``)
    gives nfft * ifft without a pass over the array to scale it.
    """
    nfft = spec.shape[-1]
    xf = torch.fft.ifft(x.transpose(-1, -2), n=nfft, dim=-1, norm="forward")
    y = torch.fft.ifft(spec[..., None, :] * xf, dim=-1)
    return y[..., :m].transpose(-1, -2)
