"""The one bridge from the JAX package's data to the port's.

Plain functions over numpy arrays, or objects whose fields convert with
np.asarray (a JAX ChainModel, GaussianState, ReacherState, PegParams,
PegState, ReinforceState, VFParams, LGPolicyParams, SwimmerParams,
CheetahParams, SwimmerState, CheetahState, PenParams, PenState,
PendulumParams or PendulumState does;
models with ball and free joints keep the JAX layout: qpos [nq] with
quaternions in wxyz order, per-DOF arrays [nv], limits [nq]). This module
never imports jax; tests use it so that both packages compute on the same
model and state.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine.chain import ChainModel
from .envs.half_cheetah import CheetahParams, CheetahState
from .envs.pen import PenParams, PenState
from .envs.pendulum import PendulumParams, PendulumState
from .envs.reacher_7dof import ReacherState
from .envs.sawyer_tasks import PegParams, PegState
from .envs.swimmer import _VEL_LIMIT, SwimmerParams, SwimmerState
from .ops.pendulum import PARAM_FIELDS as _PENDULUM_FIELDS
from .policies.linear_gaussian import LGPolicyParams
from .solvers.base import GaussianState
from .solvers.reinforce import ReinforceState
from .value_functions import VFParams

_MODEL_TENSORS = ("joint_axis", "body_pos", "mass", "com", "inertia",
                  "armature", "damping", "frictionloss", "stiffness", "gear",
                  "qpos_low", "qpos_high", "gravity", "site_pos")


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def chain_model_from_reference(model, device="cuda") -> ChainModel:
    """A reference ChainModel (array leaves plus static topology) as the
    port's ChainModel on `device`."""
    tensors = {k: _t(getattr(model, k), device) for k in _MODEL_TENSORS}
    return ChainModel(
        **tensors, parent=tuple(int(p) for p in model.parent),
        joint_types=tuple(str(t) for t in model.joint_types),
        dt=float(model.dt), site_body=int(model.site_body))


def gaussian_state_from_reference(state, seed: int = 0,
                                  device="cuda") -> GaussianState:
    """A reference GaussianState (mean, cov, step, key) as the port's.
    The reference PRNG key has no torch counterpart: the port's streams
    start from `seed`."""
    return GaussianState(mean=_t(state.mean, device), cov=_t(state.cov, device),
                         step=int(np.asarray(state.step)), seed=int(seed))


def reacher_state_from_reference(state, seed: int = 0,
                                 device="cuda") -> ReacherState:
    """A reference ReacherState (qpos, qvel, target, timestep, key) as the
    port's; continual target events draw from `seed`."""
    return ReacherState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                        target=_t(state.target, device),
                        timestep=int(np.asarray(state.timestep)), seed=int(seed))


def peg_params_from_reference(params, device="cuda") -> PegParams:
    """A reference PegParams (model, hole entry, axis, depth, sensor bias)
    as the port's."""
    return PegParams(model=chain_model_from_reference(params.model, device),
                     hole_entry=_t(params.hole_entry, device),
                     hole_axis=_t(params.hole_axis, device),
                     hole_depth=_t(params.hole_depth, device),
                     sensor_bias=_t(params.sensor_bias, device))


def peg_state_from_reference(state, device="cuda") -> PegState:
    """A reference PegState (qpos, qvel, timestep) as the port's."""
    return PegState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                    timestep=int(np.asarray(state.timestep)))


def reinforce_state_from_reference(state, seed: int = 0, device="cuda") -> ReinforceState:
    """A reference ReinforceState as the port's; the port's streams start
    from `seed` (the reference PRNG key has no torch counterpart)."""
    return ReinforceState(mean_weights=_t(state.mean_weights, device),
                          cov_diag=_t(state.cov_diag, device),
                          vf_weights=_t(state.vf_weights, device),
                          vf_bias=_t(state.vf_bias, device),
                          fit_error=_t(state.fit_error, device),
                          step=int(np.asarray(state.step)), seed=int(seed))


def vf_params_from_reference(params, device="cuda") -> VFParams:
    return VFParams(weights=_t(params.weights, device), bias=_t(params.bias, device))


def lg_policy_params_from_reference(params, device="cuda") -> LGPolicyParams:
    return LGPolicyParams(weight=_t(params.weight, device), bias=_t(params.bias, device),
                          log_std=_t(params.log_std, device))


def swimmer_params_from_reference(params, device="cuda") -> SwimmerParams:
    """A reference SwimmerParams (model, drag_perp, drag_par) as the
    port's; the velocity limit is the env's constant."""
    return SwimmerParams(model=chain_model_from_reference(params.model, device),
                         drag_perp=_t(params.drag_perp, device),
                         drag_par=_t(params.drag_par, device),
                         vel_limit=_t(_VEL_LIMIT, device))


def cheetah_params_from_reference(params, device="cuda") -> CheetahParams:
    """A reference CheetahParams (model, kp, kd, mu) as the port's."""
    return CheetahParams(model=chain_model_from_reference(params.model, device),
                         kp=_t(params.kp, device), kd=_t(params.kd, device),
                         mu=_t(params.mu, device))


def loco_state_from_reference(state, device="cuda"):
    """A reference SwimmerState or CheetahState (qpos, qvel) as the port's
    state of the same env (told apart by the number of dofs: 7 or 9)."""
    qpos, qvel = _t(state.qpos, device), _t(state.qvel, device)
    cls = SwimmerState if qpos.shape[-1] == 7 else CheetahState
    return cls(qpos=qpos, qvel=qvel)


def pen_params_from_reference(params, device="cuda") -> PenParams:
    """A reference PenParams (the hand and free-pen model, kp, kd, mu, pen
    radius) as the port's."""
    return PenParams(model=chain_model_from_reference(params.model, device),
                     kp=_t(params.kp, device), kd=_t(params.kd, device),
                     mu=_t(params.mu, device), pen_r=_t(params.pen_r, device))


def pen_state_from_reference(state, device="cuda") -> PenState:
    """A reference PenState (qpos [31] with the pen's quaternion in wxyz
    order, qvel [30], desired [3], timestep) as the port's."""
    return PenState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                    desired=_t(state.desired, device),
                    timestep=int(np.asarray(state.timestep)))


def pendulum_params_from_reference(params, device="cuda") -> PendulumParams:
    """A reference PendulumParams (g, m, l, dt, max_speed, max_torque) as
    the port's, 0-d float32 tensors."""
    return PendulumParams(**{f: _t(getattr(params, f), device)
                             for f in _PENDULUM_FIELDS})


def pendulum_state_from_reference(state, device="cuda") -> PendulumState:
    """A reference PendulumState (th, thdot; any leading batch shape) as the
    port's."""
    return PendulumState(th=_t(state.th, device), thdot=_t(state.thdot, device))
