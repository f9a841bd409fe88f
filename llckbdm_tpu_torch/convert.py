"""Carry the JAX reference's configurations and state across to the port.

Everything arrives as plain dicts and numpy arrays, so this module needs no
JAX: a config as ``dataclasses.asdict`` of the JAX dataclass, a line list as
the numpy arrays of its fields, a batch of matrices in the TPU kernels' lane
layout as one numpy array.  With these, a test feeds both packages identical
inputs.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .pipeline.llckbdm import LlcKbdmConfig
from .signals import LineList
from .solver.kbdm import KbdmConfig
from .solver.refine import RefineConfig


def kbdm_config_from_ref(fields: dict) -> KbdmConfig:
    """KbdmConfig from ``dataclasses.asdict`` of the JAX KbdmConfig (an
    unknown field raises TypeError)."""
    return KbdmConfig(**fields)


def llc_config_from_ref(fields: dict) -> LlcKbdmConfig:
    """LlcKbdmConfig from ``dataclasses.asdict`` of the JAX LlcKbdmConfig
    (whose ``kbdm`` entry is itself a dict there)."""
    fields = dict(fields)
    fields["m_values"] = tuple(int(m) for m in fields["m_values"])
    fields["kbdm"] = kbdm_config_from_ref(fields["kbdm"])
    return LlcKbdmConfig(**fields)


def refine_config_from_ref(fields: dict) -> RefineConfig:
    """RefineConfig from ``dataclasses.asdict`` of the JAX RefineConfig."""
    return RefineConfig(**fields)


def sketch_from_np(omega: np.ndarray, device=None) -> torch.Tensor:
    """The (m_max, k) float32 Gaussian sketch the JAX solver draws as
    ``jax.random.normal(PRNGKey(seed), (m_max, k), float32)``, which torch's
    generators cannot reproduce; pass it to kbdm_sweep as ``omega``."""
    omega = np.asarray(omega)
    if omega.ndim != 2:
        raise ValueError(f"sketch: need (m_max, k), got {omega.shape}")
    return torch.tensor(omega, dtype=torch.float32, device=device)


def lines_from_np(fields: Sequence[np.ndarray], device=None) -> LineList:
    """LineList from the five numpy arrays of a JAX LineList (amplitude,
    t2, frequency, phase, mask), as float32 tensors."""
    fields = list(fields)
    if len(fields) != len(LineList._fields):
        raise ValueError(f"need {len(LineList._fields)} arrays "
                         f"{LineList._fields}, got {len(fields)}")
    return LineList(*(torch.tensor(np.asarray(x), dtype=torch.float32,
                                   device=device) for x in fields))


def batch_from_lanes(x: np.ndarray, device=None) -> torch.Tensor:
    """A batch in the TPU kernels' lane layout, (..., B) with the batch last
    (such as (n, n, B) matrices), as the port's batch-first (B, ...) tensor
    of the same dtype."""
    x = np.asarray(x)
    if x.ndim < 1:
        raise ValueError("lane layout: need at least one axis (the batch)")
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0))).to(device)


def batch_to_lanes(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`batch_from_lanes`: (B, ...) -> numpy (..., B)."""
    if t.ndim < 1:
        raise ValueError("lane layout: need at least one axis (the batch)")
    return np.ascontiguousarray(np.moveaxis(t.detach().cpu().numpy(), 0, -1))
