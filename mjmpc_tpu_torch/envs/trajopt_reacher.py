"""trajopt_reacher-v0: planar 2-link reacher on the chain engine.

Counterpart of mjmpc_tpu/envs/trajopt_reacher.py: two hinges about z
(links 0.1 long, capsules of radius 0.01; the elbow limited to [-3, 3]),
zero gravity, damping 0.01, armature 0.002, gear 0.1, Euler dt = 0.01 with
frame skip 2. The target is drawn in the reachable annulus (radius U(0.05,
0.19), angle U(-pi, pi)). reward = -|tip - target| - 0.001 |a|^2 (a
clipped to [-1, 1]), the tip at the post-step state; obs = [cos q, sin q,
qvel, tip, tip - target]; success: |tip - target| < 0.025.

State = (qpos [..., 2], qvel [..., 2], target [..., 2], timestep); the
timestep is an int64 tensor on the device, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import rng
from ..engine import chain as rb
from .base import Env

_DT = 0.01
_FRAME_SKIP = 2
_L = 0.1
GOAL_RADIUS = 0.025


@dataclasses.dataclass(frozen=True)
class TrajoptReacherParams:
    model: rb.ChainModel


@dataclasses.dataclass(frozen=True)
class TrajoptReacherState:
    qpos: torch.Tensor
    qvel: torch.Tensor
    target: torch.Tensor   # [..., 2] planar target
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


def build_model(device="cuda") -> rb.ChainModel:
    unlim = (-1e6, 1e6)
    link = [rb.capsule_geom(0.01, (0, 0, 0, _L, 0, 0))]
    bodies = [
        dict(pos=(0, 0, 0), axis=(0, 0, 1), range=unlim, damping=0.01, armature=0.002,
             gear=0.1, geoms=link),
        dict(pos=(_L, 0, 0), axis=(0, 0, 1), range=(-3.0, 3.0), damping=0.01,
             armature=0.002, gear=0.1, geoms=link),
    ]
    return rb.build_chain(bodies, dt=_DT, site_body=1, site_pos=(_L, 0.0, 0.0),
                          device=device)


def fingertip(params: TrajoptReacherParams, qpos: torch.Tensor) -> torch.Tensor:
    return rb.site_position(params.model, qpos)[..., :2]


def _init(params: TrajoptReacherParams, seed: int) -> TrajoptReacherState:
    device = params.model.device
    u = torch.rand(4, generator=rng.generator(rng.derive_seed(seed, 0), device), device=device)
    ang = (2.0 * u[2] - 1.0) * math.pi
    rad = 0.05 + 0.14 * u[3]
    return TrajoptReacherState(qpos=0.2 * u[:2] - 0.1, qvel=torch.zeros(2, device=device),
                               target=rad * torch.stack([torch.cos(ang), torch.sin(ang)]),
                               timestep=rng.step_tensor(0, device))


def _observe(params: TrajoptReacherParams, state: TrajoptReacherState) -> torch.Tensor:
    tip = fingertip(params, state.qpos)
    return torch.cat([torch.cos(state.qpos), torch.sin(state.qpos), state.qvel, tip,
                      tip - state.target], -1)


def _step(params: TrajoptReacherParams, state: TrajoptReacherState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP)
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    dist = torch.linalg.vector_norm(fingertip(params, qpos) - state.target, dim=-1)
    reward = -dist - 0.001 * torch.sum(ctrl * ctrl, -1)
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: TrajoptReacherParams, state: TrajoptReacherState) -> torch.Tensor:
    return torch.linalg.vector_norm(fingertip(params, state.qpos) - state.target,
                                    dim=-1) < GOAL_RADIUS


def make(device="cuda") -> Env:
    device = torch.device(device)
    return Env(name="trajopt_reacher-v0", d_obs=10, d_action=2,
               action_lows=torch.full((2,), -1.0, device=device),
               action_highs=torch.full((2,), 1.0, device=device),
               params=TrajoptReacherParams(model=build_model(device)), init=_init, step=_step,
               observe=_observe, device=device, success=_success, max_episode_steps=200)
