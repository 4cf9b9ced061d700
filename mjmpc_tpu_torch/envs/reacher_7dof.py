"""7-DOF arm reacher: the flagship benchmark task.

Counterpart of mjmpc_tpu/envs/reacher_7dof.py: the sawyer arm (7 hinge
joints, zero gravity, armature 0.004, joint damping, torque motors with
gear [20, 10 x 6], Euler dt = 0.01 with frame_skip = 2) on the port's
chain engine.

- reward = -l1 - 5 * l2 between the 'finger' site and the target;
- obs = [qpos(7), qvel(7), hand_xyz(3), hand - target(3)];
- target drawn uniformly in the box [-.3, .3] x [-.2, .2] x [-.25, .25];
- success: l2 < 0.025;
- the continual variant redraws the target every 50 steps: Philox4x32-10
  (ops/noise.py) under the state's `seed` with the timestep as a counter
  word, a device-side draw chosen by torch.where, so a step reads nothing
  back to the host and can be captured in a CUDA graph (the maze keys its
  goal the same way).

State = (qpos, qvel, target, timestep, seed); timestep is an int64 tensor
on the device ([] or the batch's leading dims), as in the JAX package;
seed is a host integer fixed at init, the key of the target redraws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from ..engine import chain as rb
from ..ops.noise import _key_words, _uniform01, philox4x32_10
from ..ops.chain_rollout import (build_chain_cl_rollout, build_chain_obs_rollout,
                                 build_chain_rollout)
from .base import Env

_FRAME_SKIP = 2
_DT = 0.01

# Kinematic/inertial data of the sawyer arm (bodies without joints fused
# into their jointed parent); the same table as the JAX package's.
_BODIES = [
    dict(  # r_shoulder_pan_link
        pos=(0.0, -0.6, 0.0), axis=(0.0, 0.0, 1.0), damping=2.0,
        armature=0.004, gear=20.0, range=(-2.2854, 1.714602),
        geoms=[rb.sphere_geom(0.05, (-0.06, 0.05, 0.2)),
               rb.sphere_geom(0.05, (0.06, 0.05, 0.2)),
               rb.sphere_geom(0.03, (-0.06, 0.09, 0.2)),
               rb.sphere_geom(0.03, (0.06, 0.09, 0.2)),
               rb.capsule_geom(0.1, (0, 0, -0.4, 0, 0, 0.2))]),
    dict(  # r_shoulder_lift_link
        pos=(0.1, 0.0, 0.0), axis=(0.0, 1.0, 0.0), damping=2.0,
        armature=0.004, gear=10.0, range=(-0.5236, 1.3963),
        geoms=[rb.capsule_geom(0.1, (0, -0.1, 0, 0, 0.1, 0))]),
    dict(  # r_upper_arm_roll_link + fused r_upper_arm_link
        pos=(0.0, 0.0, 0.0), axis=(1.0, 0.0, 0.0), damping=0.8,
        armature=0.004, gear=10.0, range=(-1.5, 1.7),
        geoms=[rb.capsule_geom(0.02, (-0.1, 0, 0, 0.1, 0, 0)),
               rb.capsule_geom(0.06, (0, 0, 0, 0.4, 0, 0))]),
    dict(  # r_elbow_flex_link
        pos=(0.4, 0.0, 0.0), axis=(0.0, 1.0, 0.0), damping=0.8,
        armature=0.004, gear=10.0, range=(-2.3213, 0.0),
        geoms=[rb.capsule_geom(0.06, (0, -0.02, 0, 0, 0.02, 0))]),
    dict(  # r_forearm_roll_link + fused r_forearm_link
        pos=(0.0, 0.0, 0.0), axis=(1.0, 0.0, 0.0), damping=0.8,
        armature=0.004, gear=10.0, range=(-1.5, 1.5),
        geoms=[rb.capsule_geom(0.02, (-0.1, 0, 0, 0.1, 0, 0)),
               rb.capsule_geom(0.05, (0, 0, 0, 0.291, 0, 0))]),
    dict(  # r_wrist_flex_link
        pos=(0.321, 0.0, 0.0), axis=(0.0, 1.0, 0.0), damping=0.8,
        armature=0.004, gear=10.0, range=(-1.094, 0.0),
        geoms=[rb.capsule_geom(0.01, (0, -0.02, 0, 0, 0.02, 0))]),
    dict(  # r_wrist_roll_link ('finger' site at frame origin)
        pos=(0.0, 0.0, 0.0), axis=(1.0, 0.0, 0.0), damping=0.8,
        armature=0.004, gear=10.0, range=(-1.5, 1.5),
        geoms=[rb.sphere_geom(0.08, (0.03, 0.0, 0.0))]),
]

N_JOINTS = 7
D_OBS = 20
GOAL_RADIUS = 0.025
_TARGET_LOW = np.array([-0.3, -0.2, -0.25], np.float32)
_TARGET_HIGH = np.array([0.3, 0.2, 0.25], np.float32)
_MASK32 = 0xFFFFFFFF
_TARGET_WORD = 0x74617267   # the redraws' third counter word, apart from other streams'


@dataclasses.dataclass(frozen=True)
class ReacherParams:
    model: rb.ChainModel
    continual_period: int         # 0 = plain (non-continual) task
    target_low: torch.Tensor      # [3]
    target_high: torch.Tensor     # [3]


@dataclasses.dataclass(frozen=True)
class ReacherState:
    qpos: torch.Tensor     # [..., 7]
    qvel: torch.Tensor     # [..., 7]
    target: torch.Tensor   # [..., 3]
    timestep: torch.Tensor   # int64, [] or the batch's leading dims
    seed: int              # seeds the continual target events


def build_model(device="cuda") -> rb.ChainModel:
    return rb.build_chain(_BODIES, dt=_DT, site_body=6,
                          site_pos=(0.0, 0.0, 0.0), device=device)


def _sample_target(params: ReacherParams, seed: int) -> torch.Tensor:
    lo, hi = params.target_low, params.target_high
    u = torch.rand(3, generator=rng.generator(seed, lo.device), device=lo.device)
    return lo + (hi - lo) * u


def _init(params: ReacherParams, seed: int) -> ReacherState:
    device = params.target_low.device
    return ReacherState(
        qpos=torch.zeros(N_JOINTS, device=device),
        qvel=torch.zeros(N_JOINTS, device=device),
        target=_sample_target(params, rng.derive_seed(seed, 0)),
        timestep=rng.step_tensor(0, device), seed=rng.derive_seed(seed, 1))


def redrawn_target(params: ReacherParams, key: int, t: torch.Tensor) -> torch.Tensor:
    """The continual variant's target [..., 3] drawn at timestep t (an
    int64 tensor) under `key`: Philox counter (0, t, word, 0), three of its
    four uniforms, scaled into the target box."""
    zeros = torch.zeros_like(t)
    words = philox4x32_10((zeros, t & _MASK32, torch.full_like(t, _TARGET_WORD), zeros),
                          _key_words(key))
    u = _uniform01(torch.stack(words[:3], -1))
    lo, hi = params.target_low, params.target_high
    return lo + (hi - lo) * u


def _hand_pos(params: ReacherParams, qpos: torch.Tensor) -> torch.Tensor:
    return rb.site_position(params.model, qpos)


def _observe(params: ReacherParams, state: ReacherState) -> torch.Tensor:
    hand = _hand_pos(params, state.qpos)
    return torch.cat([state.qpos, state.qvel, hand, hand - state.target], -1)


def _step(params: ReacherParams, state: ReacherState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl,
                         n_substeps=_FRAME_SKIP)
    t = state.timestep + 1
    target = state.target
    period = params.continual_period
    if period > 0:   # continual variant: a new target every `period` steps
        fire = (t % period == 0)[..., None]
        target = torch.where(fire, redrawn_target(params, state.seed, t), target)
    hand = _hand_pos(params, qpos)
    diff = hand - target
    reward = (-torch.sum(torch.abs(diff), -1)
              - 5.0 * torch.linalg.vector_norm(diff, dim=-1))
    obs = torch.cat([qpos, qvel, hand, diff], -1)
    new_state = ReacherState(qpos=qpos, qvel=qvel, target=target,
                             timestep=t, seed=state.seed)
    return new_state, obs, reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: ReacherParams, state: ReacherState) -> torch.Tensor:
    dist = torch.linalg.vector_norm(_hand_pos(params, state.qpos) - state.target,
                                    dim=-1)
    return dist < GOAL_RADIUS


def _build_fused(params: ReacherParams) -> dict:
    """The fused rollout kernels (#1, #3, #4) built from params.model, plain
    reacher only: the continual variant's target can move within a
    planning rollout, which the kernels do not model. The obs and
    closed-loop kernels' observation is exactly _observe's [qpos, qvel,
    hand, hand - target]."""
    if params.continual_period:
        return {}
    roll = build_chain_rollout(params.model, n_substeps=_FRAME_SKIP)
    roll_obs = build_chain_obs_rollout(params.model, n_substeps=_FRAME_SKIP)
    roll_cl = build_chain_cl_rollout(params.model, n_substeps=_FRAME_SKIP)

    def fused(p, state, mean, noise):
        return roll(state.qpos, state.qvel, state.target, mean, noise)

    def fused_obs(p, state, mean, noise):
        return roll_obs(state.qpos, state.qvel, state.target, mean, noise)

    def fused_cl(p, state, weights, noise):
        return roll_cl(state.qpos, state.qvel, state.target, weights, noise)

    def fused_batch(p, states, means, noises):
        """B states (each field with a leading [B]), means [B, H, 7] and
        noise [B, N, H, 7] -> costs [B, N, H] in one launch of #1."""
        return roll.batch(states.qpos, states.qvel, states.target, means, noises)

    # the wrappers, for checks against their plain versions
    fused.kernel, fused_obs.kernel, fused_cl.kernel = roll, roll_obs, roll_cl
    fused.batched = fused_batch
    return dict(fused_rollout=fused, fused_obs_rollout=fused_obs, fused_cl_rollout=fused_cl)


def _make(continual_period: int, name: str, device) -> Env:
    device = torch.device(device)
    params = ReacherParams(
        model=build_model(device), continual_period=int(continual_period),
        target_low=torch.as_tensor(_TARGET_LOW, device=device),
        target_high=torch.as_tensor(_TARGET_HIGH, device=device))
    return Env(
        name=name, d_obs=D_OBS, d_action=N_JOINTS,
        action_lows=torch.full((N_JOINTS,), -1.0, device=device),
        action_highs=torch.full((N_JOINTS,), 1.0, device=device),
        params=params, init=_init, step=_step, observe=_observe,
        device=device, success=_success, max_episode_steps=75,
        build_fused=_build_fused, **_build_fused(params))


def make(device="cuda") -> Env:
    """reacher_7dof-v0 (max 75 steps)."""
    return _make(0, "reacher_7dof-v0", device)


def make_continual(device="cuda") -> Env:
    """continual_reacher-v0: the target moves every 50 steps."""
    return _make(50, "continual_reacher-v0", device)


# Dynamics-randomization name tables (the reference's sawyer body and joint
# names, JAX reacher_7dof.py BODY_NAMES / JOINT_NAMES).
BODY_NAMES = [
    "r_shoulder_pan_link", "r_shoulder_lift_link", "r_upper_arm_roll_link",
    "r_elbow_flex_link", "r_forearm_roll_link", "r_wrist_flex_link",
    "r_wrist_roll_link",
]
JOINT_NAMES = [
    "r_shoulder_pan_joint", "r_shoulder_lift_joint", "r_upper_arm_roll_joint",
    "r_elbow_flex_joint", "r_forearm_roll_joint", "r_wrist_flex_joint",
    "r_wrist_roll_joint",
]

from .randomize import register_names as _register_names  # noqa: E402

for _env_name in ("reacher_7dof-v0", "continual_reacher-v0"):
    _register_names(_env_name, BODY_NAMES, JOINT_NAMES)
