"""SimplePendulum-v0: analytic pendulum swing-up.

Counterpart of mjmpc_tpu/envs/pendulum.py: a torque-limited pendulum,
reward = -(angle^2 + 0.1 thdot^2 + 0.001 u^2) at the pre-step state, obs =
[cos th, sin th, thdot], semi-implicit Euler at dt = 0.05 (th advances with
the new, unclamped thdot; thdot is clamped after).

State = PendulumState(th, thdot), tensors with leading batch dimensions.
The fused rollout is kernel #7 (ops/pendulum.py), which reads all six
params at call time.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import rng
from ..ops.pendulum import angle_normalize, pendulum_rollout, step_cost  # noqa: F401
from .base import Env


@dataclasses.dataclass(frozen=True)
class PendulumParams:
    g: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor
    dt: torch.Tensor
    max_speed: torch.Tensor
    max_torque: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PendulumState:
    th: torch.Tensor
    thdot: torch.Tensor


def default_params(device="cuda") -> PendulumParams:
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=torch.device(device))
    return PendulumParams(g=t(10.0), m=t(1.0), l=t(1.0), dt=t(0.05), max_speed=t(8.0),
                          max_torque=t(2.0))


def init(params: PendulumParams, seed: int) -> PendulumState:
    """th ~ U(-pi, pi), thdot ~ U(-1, 1) from a stream keyed by seed."""
    device = params.g.device
    u = torch.rand(2, generator=rng.generator(rng.derive_seed(seed, 0), device), device=device)
    s = (2.0 * u - 1.0) * torch.tensor([math.pi, 1.0], device=device)
    return PendulumState(th=s[0], thdot=s[1])


def observe(params: PendulumParams, state: PendulumState) -> torch.Tensor:
    return torch.stack([torch.cos(state.th), torch.sin(state.th), state.thdot], -1)


def step(params: PendulumParams, state: PendulumState, action: torch.Tensor):
    cost, th, thdot = step_cost(params, state.th, state.thdot, action[..., 0])
    new = PendulumState(th=th, thdot=thdot)
    return new, observe(params, new), -cost, torch.zeros_like(cost, dtype=torch.bool)


def make(device="cuda", max_episode_steps: int = 200) -> Env:
    device = torch.device(device)
    return Env(name="SimplePendulum-v0", d_obs=3, d_action=1,
               action_lows=torch.full((1,), -2.0, device=device),
               action_highs=torch.full((1,), 2.0, device=device),
               params=default_params(device), init=init, step=step, observe=observe,
               device=device, max_episode_steps=max_episode_steps,
               fused_rollout=pendulum_rollout)
