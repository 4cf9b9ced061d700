"""The one bridge from the JAX package's data to the port's.

Plain functions over numpy arrays, or objects whose fields convert with
np.asarray (a JAX ChainModel, GaussianState or ReacherState does). This
module never imports jax; tests use it so that both packages compute on
the same model and state.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine.chain import ChainModel
from .envs.reacher_7dof import ReacherState
from .solvers.base import GaussianState

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
