"""Sawyer-arm tasks: the peg-insertion family.

Counterpart of the peg part of mjmpc_tpu/envs/sawyer_tasks.py: the reacher
arm with the site moved to the tip of a wrist-mounted peg
(site_pos = (0.12, 0, 0) on the last body), guided into a hole.

- obs = [qpos(7), qvel(7), tip - entry(3), depth, lateral], where depth
  (along the hole axis, > 0 once inside) and lateral (off-axis distance)
  are taken from the sensed entry, entry + sensor_bias;
- reward = -|tip - bottom| - 5 * lateral * inserted + inserted, with
  inserted = clip(depth, 0, hole_depth) / hole_depth (a depth-progress
  term that keeps a gradient once the tip sits at the mouth);
- success: depth > 0.8 hole_depth and lateral < 0.025;
- v1 is the sensed-target variant: the real hole sits at a fixed sensor
  offset from the nominal entry that v0's model does not know.

Fused rollouts: the closed-loop-linear kernel (Reinforce) and the
open-loop kernel with observations, both with the peg task
(ops/chain_rollout.py); the costs-only open-loop slot is the forest kernel
(ops/forest_rollout.py, kernel #6) with the peg task: the arm alone, no
contact, the same peg cost. The pusher and door tasks need contact and
wait for further tasks of the forest kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from ..engine import chain as rb
from ..ops.chain_rollout import build_chain_cl_rollout, build_chain_obs_rollout
from ..ops.forest_rollout import ForestRollout, build_forest_rollout, peg_task
from .base import Env
from .reacher_7dof import _BODIES as _ARM_BODIES
from .reacher_7dof import _DT, _FRAME_SKIP

_N_ARM = 7
D_OBS = 2 * _N_ARM + 5
_HOLE_ENTRY = (0.2, -0.25, -0.1)
_HOLE_AXIS = (0.0, 0.0, -1.0)
_HOLE_DEPTH = 0.08
V1_SENSOR_BIAS = (0.01, -0.012, 0.008)


@dataclasses.dataclass(frozen=True)
class PegParams:
    model: rb.ChainModel
    hole_entry: torch.Tensor    # [3] nominal (sensed) hole position
    hole_axis: torch.Tensor     # [3] unit, pointing into the hole
    hole_depth: torch.Tensor    # []
    sensor_bias: torch.Tensor   # [3] true-hole offset from the sensed one


@dataclasses.dataclass(frozen=True)
class PegState:
    qpos: torch.Tensor   # [..., 7]
    qvel: torch.Tensor   # [..., 7]
    timestep: int


def _peg_model(device="cuda") -> rb.ChainModel:
    return rb.build_chain(list(_ARM_BODIES), dt=_DT, site_body=6,
                          site_pos=(0.12, 0.0, 0.0), device=device)


def _peg_init(params: PegParams, seed: int) -> PegState:
    device = params.hole_entry.device
    return PegState(qpos=torch.zeros(_N_ARM, device=device),
                    qvel=torch.zeros(_N_ARM, device=device), timestep=0)


def _peg_metrics(params: PegParams, q: torch.Tensor):
    tip = rb.site_position(params.model, q)
    rel = tip - (params.hole_entry + params.sensor_bias)
    depth = rel @ params.hole_axis                  # > 0 once inside
    lateral = torch.linalg.vector_norm(rel - depth[..., None] * params.hole_axis, dim=-1)
    return tip, depth, lateral


def _observe(params: PegParams, state: PegState) -> torch.Tensor:
    tip, depth, lateral = _peg_metrics(params, state.qpos)
    return torch.cat([state.qpos, state.qvel, tip - params.hole_entry,
                      depth[..., None], lateral[..., None]], -1)


def _step(params: PegParams, state: PegState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl,
                         n_substeps=_FRAME_SKIP)
    new = PegState(qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    tip, depth, lateral = _peg_metrics(params, qpos)
    bottom = params.hole_entry + params.hole_depth * params.hole_axis
    inserted = (torch.minimum(torch.clamp(depth, min=0.0), params.hole_depth)
                / torch.clamp(params.hole_depth, min=1e-6))
    reward = (-torch.linalg.vector_norm(tip - bottom, dim=-1)
              - 5.0 * lateral * inserted + 1.0 * inserted)
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: PegParams, state: PegState) -> torch.Tensor:
    _, depth, lateral = _peg_metrics(params, state.qpos)
    return (depth > 0.8 * params.hole_depth) & (lateral < 0.025)


def peg_extras(params: PegParams) -> torch.Tensor:
    """The kernels' extras [entry 3, axis 3, hole depth, sensor bias 3]."""
    return torch.cat([params.hole_entry, params.hole_axis, params.hole_depth[None],
                      params.sensor_bias])


def build_rollout(model: rb.ChainModel) -> ForestRollout:
    """Kernel #6 with the peg task: the 7-joint arm, actions on every
    joint, 2 substeps per control step, the peg cost of the site."""
    return build_forest_rollout(model, _FRAME_SKIP, list(range(_N_ARM)), peg_task())


def make_peg_insertion(device="cuda") -> Env:
    """sawyer_peg_insertion-v0 (max 100 steps)."""
    device = torch.device(device)
    model = _peg_model(device)
    t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    params = PegParams(model=model, hole_entry=t(_HOLE_ENTRY), hole_axis=t(_HOLE_AXIS),
                       hole_depth=t(_HOLE_DEPTH), sensor_bias=torch.zeros(3, device=device))
    roll_cl = build_chain_cl_rollout(model, n_substeps=_FRAME_SKIP, task="peg")
    roll_obs = build_chain_obs_rollout(model, n_substeps=_FRAME_SKIP, task="peg")
    roll = build_rollout(model)

    def fused(p: PegParams, state: PegState, mean, noise):
        return roll(state.qpos, state.qvel, peg_extras(p), mean, noise)

    def fused_cl(p: PegParams, state: PegState, weights, noise):
        return roll_cl(state.qpos, state.qvel, peg_extras(p), weights, noise)

    def fused_obs(p: PegParams, state: PegState, mean, noise):
        return roll_obs(state.qpos, state.qvel, peg_extras(p), mean, noise)

    return Env(
        name="sawyer_peg_insertion-v0", d_obs=D_OBS, d_action=_N_ARM,
        action_lows=torch.full((_N_ARM,), -1.0, device=device),
        action_highs=torch.full((_N_ARM,), 1.0, device=device),
        params=params, init=_peg_init, step=_step, observe=_observe,
        device=device, success=_success, max_episode_steps=100,
        fused_rollout=fused,
        fused_cl_rollout=fused_cl, fused_obs_rollout=fused_obs)


def make_peg_insertion_v1(device="cuda", sensor_bias=V1_SENSOR_BIAS) -> Env:
    """sawyer_peg_insertion-v1: v0 with the real hole at a fixed sensor
    offset; the same state type and kernels (the bias rides the extras)."""
    env = make_peg_insertion(device)
    bias = torch.as_tensor(sensor_bias, dtype=torch.float32, device=env.device)
    return dataclasses.replace(env, name="sawyer_peg_insertion-v1",
                               params=dataclasses.replace(env.params, sensor_bias=bias))
