"""Carry configs and state across from the JAX package.

The system has no weights: what a run carries is its config and its
state (:class:`~tpuslam_torch.filters.EkfState`,
:class:`~tpuslam_torch.filters.PfState`).  These helpers read any object
with the right fields (the JAX package's configs and states are such
objects) without importing that package, and exchange state as numpy
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.filters.ekf import EkfConfig, EkfState
from tpuslam_torch.filters.pf import PfConfig, PfState


def _config_from(cls, obj):
    values = {}
    for field in dataclasses.fields(cls):
        value = getattr(obj, field.name)
        values[field.name] = (tuple(value) if isinstance(value, (list, tuple))
                              else value)
    return cls(**values)


def ekf_config_from(obj) -> EkfConfig:
    """The port's :class:`EkfConfig` with the field values of ``obj``."""
    return _config_from(EkfConfig, obj)


def pf_config_from(obj) -> PfConfig:
    """The port's :class:`PfConfig` with the field values of ``obj``."""
    return _config_from(PfConfig, obj)


def _state_from_numpy(cls, state, device):
    return cls(*(torch.tensor(np.asarray(getattr(state, name)),
                              device=device)
                 for name in cls._fields))


def ekf_state_from_numpy(state, *, device: torch.device | str) -> EkfState:
    """An :class:`EkfState` of tensors on ``device``, in the arrays' own
    dtype, from any object with array-like ``x_true``, ``x_dr``, ``x_hat``
    and ``cov`` fields."""
    return _state_from_numpy(EkfState, state, device)


def ekf_state_to_numpy(state: EkfState) -> EkfState:
    """The same :class:`EkfState` with each field a numpy array."""
    return EkfState(*(t.detach().cpu().numpy() for t in state))


def pf_state_from_numpy(state, *, device: torch.device | str) -> PfState:
    """A :class:`PfState` of tensors on ``device``, in the arrays' own
    dtype, from any object with array-like ``x_true``, ``particles`` and
    ``weights`` fields."""
    return _state_from_numpy(PfState, state, device)


def pf_state_to_numpy(state: PfState) -> PfState:
    """The same :class:`PfState` with each field a numpy array."""
    return PfState(*(t.detach().cpu().numpy() for t in state))
