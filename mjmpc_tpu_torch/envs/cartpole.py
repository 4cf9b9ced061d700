"""cartpole-v0: continuous-force cart-pole swing-up.

Counterpart of mjmpc_tpu/envs/cartpole.py: the Barto-Sutton cart-pole
equations with force = clip(a, -1, 1) * force_mag, semi-implicit Euler at
dt = 0.02 (each position advances with its new velocity), theta = 0
upright. The cost, at the post-step state, is

    ang^2 + 0.01 x^2 + 0.01 thdot^2 + 0.001 xdot^2 + 0.001 (force / force_mag)^2
    + 100 [|x| > x_limit],

with ang = angle_normalize(theta) (the pendulum's wrap, ops/pendulum.py);
leaving the track is penalised and flags `done` instead of ending the
episode (static shapes). obs = [x, xdot, theta, thdot]; success:
|angle_normalize(theta)| < 0.2.

State = CartpoleState(x, x_dot, theta, theta_dot), tensors with the same
leading batch dimensions.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..ops.pendulum import angle_normalize
from .base import Env


@dataclasses.dataclass(frozen=True)
class CartpoleParams:
    gravity: torch.Tensor
    masscart: torch.Tensor
    masspole: torch.Tensor
    length: torch.Tensor      # half the pole's length
    force_mag: torch.Tensor
    dt: torch.Tensor
    x_limit: torch.Tensor


PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(CartpoleParams))


@dataclasses.dataclass(frozen=True)
class CartpoleState:
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor       # 0 = upright
    theta_dot: torch.Tensor


def default_params(device="cuda") -> CartpoleParams:
    values = dict(gravity=9.8, masscart=1.0, masspole=0.1, length=0.5, force_mag=10.0,
                  dt=0.02, x_limit=2.4)
    return CartpoleParams(**{k: torch.tensor(v, device=torch.device(device))
                             for k, v in values.items()})


def init(params: CartpoleParams, seed: int) -> CartpoleState:
    """Every coordinate ~ U(-0.05, 0.05)."""
    device = params.dt.device
    u = torch.rand(4, generator=rng.generator(rng.derive_seed(seed, 0), device), device=device)
    s = 0.1 * u - 0.05
    return CartpoleState(x=s[0], x_dot=s[1], theta=s[2], theta_dot=s[3])


def observe(params: CartpoleParams, state: CartpoleState) -> torch.Tensor:
    return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], -1)


def step(params: CartpoleParams, state: CartpoleState, action: torch.Tensor):
    p = params
    force = torch.clamp(action[..., 0], -1.0, 1.0) * p.force_mag
    total_mass = p.masscart + p.masspole
    polemass_length = p.masspole * p.length

    costh, sinth = torch.cos(state.theta), torch.sin(state.theta)
    temp = (force + polemass_length * state.theta_dot ** 2 * sinth) / total_mass
    theta_acc = (p.gravity * sinth - costh * temp) / (
        p.length * (4.0 / 3.0 - p.masspole * costh ** 2 / total_mass))
    x_acc = temp - polemass_length * theta_acc * costh / total_mass

    x_dot = state.x_dot + p.dt * x_acc
    x = state.x + p.dt * x_dot
    theta_dot = state.theta_dot + p.dt * theta_acc
    theta = state.theta + p.dt * theta_dot
    new = CartpoleState(x=x, x_dot=x_dot, theta=theta, theta_dot=theta_dot)

    ang = angle_normalize(theta)
    off_track = torch.abs(x) > p.x_limit
    cost = (ang ** 2 + 0.01 * x ** 2 + 0.01 * theta_dot ** 2 + 0.001 * x_dot ** 2
            + 0.001 * (force / p.force_mag) ** 2 + 100.0 * off_track)
    return new, observe(params, new), -cost, off_track


def success(params: CartpoleParams, state: CartpoleState) -> torch.Tensor:
    return torch.abs(angle_normalize(state.theta)) < 0.2


def make(max_episode_steps: int = 200, device="cuda") -> Env:
    device = torch.device(device)
    return Env(name="cartpole-v0", d_obs=4, d_action=1,
               action_lows=torch.full((1,), -1.0, device=device),
               action_highs=torch.full((1,), 1.0, device=device),
               params=default_params(device), init=init, step=step, observe=observe,
               device=device, success=success, max_episode_steps=max_episode_steps)


from .randomize import register_param_paths as _register_param_paths  # noqa: E402

# the reference's cartpole spec: the mass axes map onto the analytic params;
# its zeroed axes (inertia, damping) keep their defaults through the
# randomizer's [0, 0] rule
_register_param_paths("cartpole-v0", {"body_mass": {"cart": "masscart", "pole": "masspole"}})
