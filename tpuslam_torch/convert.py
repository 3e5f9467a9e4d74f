"""Carry configs and state across from the JAX package.

The system has no weights: what a run carries is its config and its
state (:class:`~tpuslam_torch.filters.EkfState`,
:class:`~tpuslam_torch.filters.PfState`, the batched filters'
:class:`~tpuslam_torch.ops.pf_batch_cuda.PfBatchState` and
:class:`~tpuslam_torch.ops.pf_batch_cuda.PfBatchWideState`, and graph
SLAM's :class:`~tpuslam_torch.slam.GraphObservations` and
:class:`~tpuslam_torch.slam.SlamTrajectory`).  These
helpers read any object with the right fields (the JAX package's configs
and states are such objects) without importing that package, and
exchange state as numpy arrays.

The batched states differ in layout between the packages.  The JAX
package pads each filter's particle axis (to 128 lanes, or to whole
resample tiles on the wide path) and may pack it into R sublane planes:
particles ``(3R, B*P/R)``, log weights ``(R, B*P/R)``
(``pf_batch_pallas.py::pack_batch_rows``; R = 8 is both rollouts'
default).  The port keeps ``(3, B, n)`` and ``(B, n)`` with no padding.
"""


from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.filters.ekf import EkfConfig, EkfState
from tpuslam_torch.filters.pf import PfConfig, PfState
from tpuslam_torch.models.motion import MotionConfig
from tpuslam_torch.models.scan_sensor import ScanConfig
from tpuslam_torch.ops.pf_batch_cuda import PfBatchState, PfBatchWideState
from tpuslam_torch.slam.frontend import SlamSceneConfig, SlamTrajectory
from tpuslam_torch.slam.graph import GraphConfig, GraphObservations


def _config_from(cls, obj, **nested):
    """``cls`` with the field values of ``obj``; ``nested`` maps a field
    holding a config to the function that carries that config across."""
    values = {}
    for field in dataclasses.fields(cls):
        value = getattr(obj, field.name)
        if field.name in nested:
            value = nested[field.name](value)
        elif isinstance(value, (list, tuple)):
            value = tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                          for v in value)
        values[field.name] = value
    return cls(**values)


def ekf_config_from(obj) -> EkfConfig:
    """The port's :class:`EkfConfig` with the field values of ``obj``."""
    return _config_from(EkfConfig, obj)


def pf_config_from(obj) -> PfConfig:
    """The port's :class:`PfConfig` with the field values of ``obj``."""
    return _config_from(PfConfig, obj)


def motion_config_from(obj) -> MotionConfig:
    """The port's :class:`MotionConfig` with the field values of ``obj``."""
    return _config_from(MotionConfig, obj)


def scan_config_from(obj) -> ScanConfig:
    """The port's :class:`ScanConfig` with the field values of ``obj``."""
    return _config_from(ScanConfig, obj)


def graph_config_from(obj) -> GraphConfig:
    """The port's :class:`GraphConfig` with the field values of ``obj``,
    its ``scan`` carried across too."""
    return _config_from(GraphConfig, obj, scan=scan_config_from)


def slam_scene_config_from(obj) -> SlamSceneConfig:
    """The port's :class:`SlamSceneConfig` with the field values of
    ``obj``, its ``motion`` carried across too."""
    return _config_from(SlamSceneConfig, obj, motion=motion_config_from)


def graph_observations_from_numpy(obs, *, device: torch.device | str
                                  ) -> GraphObservations:
    """:class:`GraphObservations` on ``device`` from any object with
    array-like ``dist``, ``bearing``, ``orient`` and ``valid`` fields, in
    the arrays' own dtype (``valid`` as bool)."""
    def t(name, dtype=None):
        a = np.asarray(getattr(obs, name))
        return torch.tensor(a if dtype is None else a.astype(dtype),
                            device=device)

    return GraphObservations(t("dist"), t("bearing"), t("orient"),
                             t("valid", bool))


def slam_trajectory_from_numpy(traj, *, device: torch.device | str
                               ) -> SlamTrajectory:
    """A :class:`SlamTrajectory` on ``device`` from any object with the
    fields of one (the JAX package's ``simulate`` output)."""
    return SlamTrajectory(
        poses_actu=torch.tensor(np.asarray(traj.poses_actu), device=device),
        poses_odom=torch.tensor(np.asarray(traj.poses_odom), device=device),
        obs=graph_observations_from_numpy(traj.obs, device=device),
        obs_true=graph_observations_from_numpy(traj.obs_true, device=device))


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


def _flat_batch_rows(rows: np.ndarray, batch: int, r: int) -> np.ndarray:
    """Packed ``(k*R, B*P/R)`` rows to the flat ``(k, B*P)`` order: the
    JAX package's ``pf_batch_pallas.py::flat_batch_rows`` on numpy (filter
    f's particle i sits at row ``v*R + i // (P/R)``, column
    ``f*(P/R) + i % (P/R)`` of variable v's plane)."""
    kr, bp8 = rows.shape
    k, p8 = kr // r, bp8 // batch
    return (rows.reshape(k, r, batch, p8).transpose(0, 2, 1, 3)
            .reshape(k, batch * r * p8))


def _batch_rows_from_numpy(state, n: int, device):
    """``(particles (3, B, n), log_w (B, n))`` tensors from a JAX batched
    state, flat or packed; the padding lanes are dropped."""
    lw = np.asarray(state.log_w)
    b, r = np.asarray(state.lse).shape[0], lw.shape[0]
    p = _flat_batch_rows(np.asarray(state.particles), b, r)
    lw = _flat_batch_rows(lw, b, r)
    return (torch.tensor(p.reshape(3, b, -1)[:, :, :n].copy(), device=device),
            torch.tensor(lw.reshape(b, -1)[:, :n].copy(), device=device))


def _batch_rows_to_numpy(particles: torch.Tensor, log_w: torch.Tensor,
                         n_pad: int):
    """The flat, padded JAX rows ``(3, B*P)`` and ``(1, B*P)``: padding
    particles 0, padding log weights -inf."""
    b, n = log_w.shape
    p = np.zeros((3, b, n_pad), np.float32)
    p[:, :, :n] = particles.detach().cpu().numpy()
    lw = np.full((b, n_pad), -np.inf, np.float32)
    lw[:, :n] = log_w.detach().cpu().numpy()
    return p.reshape(3, b * n_pad), lw.reshape(1, b * n_pad)


def _vec(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def pf_batch_state_from_numpy(state, n: int, *,
                              device: torch.device | str) -> PfBatchState:
    """A :class:`PfBatchState` on ``device`` from the JAX package's
    ``PfBatchState`` (flat, or packed with any ``sub_rows``) of filters of
    ``n`` particles."""
    p, lw = _batch_rows_from_numpy(state, n, device)
    return PfBatchState(
        x_true=torch.tensor(np.asarray(state.x_true), device=device),
        particles=p, log_w=lw,
        lse=torch.tensor(np.asarray(state.lse), device=device),
        lse2=torch.tensor(np.asarray(state.lse2), device=device))


def pf_batch_state_to_numpy(state: PfBatchState) -> PfBatchState:
    """The state as numpy arrays in the JAX package's flat layout
    (``sub_rows=1``, each filter padded to a multiple of 128 lanes), so it
    can be fed to its ``pf_batch_step``."""
    n = state.log_w.shape[1]
    p, lw = _batch_rows_to_numpy(state.particles, state.log_w,
                                 -(-n // 128) * 128)
    return PfBatchState(x_true=_vec(state.x_true), particles=p, log_w=lw,
                        lse=_vec(state.lse), lse2=_vec(state.lse2))


def pf_batch_wide_state_from_numpy(state, n: int, *,
                                   device: torch.device | str
                                   ) -> PfBatchWideState:
    """A :class:`PfBatchWideState` on ``device`` from the JAX package's
    ``PfBatchWideState`` (flat or packed) of filters of ``n``
    particles."""
    base = pf_batch_state_from_numpy(state, n, device=device)
    return PfBatchWideState(
        *base, x_est=torch.tensor(np.asarray(state.x_est), device=device))


def pf_batch_wide_state_to_numpy(state: PfBatchWideState,
                                 tile_n: int = 1024) -> PfBatchWideState:
    """The state as numpy arrays in the JAX package's flat wide layout,
    each filter padded to whole ``tile_n`` resample tiles."""
    n = state.log_w.shape[1]
    p, lw = _batch_rows_to_numpy(state.particles, state.log_w,
                                 -(-n // tile_n) * tile_n)
    return PfBatchWideState(x_true=_vec(state.x_true), particles=p,
                            log_w=lw, lse=_vec(state.lse),
                            lse2=_vec(state.lse2), x_est=_vec(state.x_est))
