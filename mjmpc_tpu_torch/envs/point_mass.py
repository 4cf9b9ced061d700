"""point_mass-v0 (alias mjrl_point_mass-v0): a 2-D point mass driven to a
goal.

Counterpart of mjmpc_tpu/envs/point_mass.py: a double integrator with the
action clipped to [-1, 1], vel += u / mass * dt, pos += vel * dt;
reward = -|pos - goal| - 0.01 |vel|^2 at the post-step state; obs = [pos,
vel, pos - goal]; success: |pos - goal| < 0.025.

State = PointMassState(pos [..., 2], vel [..., 2]).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng
from .base import Env


@dataclasses.dataclass(frozen=True)
class PointMassParams:
    dt: torch.Tensor     # []
    mass: torch.Tensor   # []
    goal: torch.Tensor   # [2]


@dataclasses.dataclass(frozen=True)
class PointMassState:
    pos: torch.Tensor    # [..., 2]
    vel: torch.Tensor    # [..., 2]


def default_params(device="cuda") -> PointMassParams:
    device = torch.device(device)
    return PointMassParams(dt=torch.tensor(0.02, device=device),
                           mass=torch.tensor(1.0, device=device),
                           goal=torch.zeros(2, device=device))


def init(params: PointMassParams, seed: int) -> PointMassState:
    """pos ~ U(-1, 1), vel = 0."""
    device = params.goal.device
    u = torch.rand(2, generator=rng.generator(rng.derive_seed(seed, 0), device), device=device)
    return PointMassState(pos=2.0 * u - 1.0, vel=torch.zeros(2, device=device))


def observe(params: PointMassParams, state: PointMassState) -> torch.Tensor:
    return torch.cat([state.pos, state.vel, state.pos - params.goal], -1)


def step(params: PointMassParams, state: PointMassState, action: torch.Tensor):
    u = torch.clamp(action, -1.0, 1.0)
    vel = state.vel + (u / params.mass) * params.dt
    pos = state.pos + vel * params.dt
    new = PointMassState(pos=pos, vel=vel)
    reward = (-torch.linalg.vector_norm(pos - params.goal, dim=-1)
              - 0.01 * torch.sum(vel * vel, -1))
    return new, observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def success(params: PointMassParams, state: PointMassState) -> torch.Tensor:
    return torch.linalg.vector_norm(state.pos - params.goal, dim=-1) < 0.025


def make(max_episode_steps: int = 100, device="cuda") -> Env:
    device = torch.device(device)
    return Env(name="point_mass-v0", d_obs=6, d_action=2,
               action_lows=torch.full((2,), -1.0, device=device),
               action_highs=torch.full((2,), 1.0, device=device),
               params=default_params(device), init=init, step=step, observe=observe,
               device=device, success=success, max_episode_steps=max_episode_steps)
