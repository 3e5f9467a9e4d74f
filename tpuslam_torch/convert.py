"""Carry configs and state across from the JAX package.

The system has no weights: what a run carries is its config and its
:class:`~tpuslam_torch.filters.EkfState`.  These helpers read any object
with the right fields (the JAX package's ``EkfConfig`` and ``EkfState``
are such objects) without importing that package, and exchange state as
numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.filters.ekf import EkfConfig, EkfState


def ekf_config_from(obj) -> EkfConfig:
    """The port's :class:`EkfConfig` with the field values of ``obj``."""
    values = {}
    for field in dataclasses.fields(EkfConfig):
        value = getattr(obj, field.name)
        values[field.name] = (tuple(value) if isinstance(value, (list, tuple))
                              else value)
    return EkfConfig(**values)


def ekf_state_from_numpy(state, *,
                         device: torch.device | str = "cpu") -> EkfState:
    """An :class:`EkfState` of tensors on ``device``, in the arrays' own
    dtype, from any object with array-like ``x_true``, ``x_dr``, ``x_hat``
    and ``cov`` fields."""
    return EkfState(*(torch.tensor(np.asarray(getattr(state, name)),
                                   device=device)
                      for name in EkfState._fields))


def ekf_state_to_numpy(state: EkfState) -> EkfState:
    """The same :class:`EkfState` with each field a numpy array."""
    return EkfState(*(t.detach().cpu().numpy() for t in state))
