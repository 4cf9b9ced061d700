"""acrobot-v0: torque-limited two-link swing-up on the chain engine.

Counterpart of mjmpc_tpu/envs/acrobot.py: two capsule links (length 1,
radius 0.018) on hinges about y hanging under gravity along -z; the
shoulder is unactuated (gear 0), the elbow motor has gear 8; damping
0.02; Euler dt = 0.01 with frame skip 5. reward = tip height - 0.01 |a|^2
(a clipped to [-1, 1]), at the post-step state; obs = [cos q, sin q,
qvel]; success: tip height > 1.5. Swing-up drives the tip from -2
(hanging) toward +2 (inverted).

State = AcrobotState(qpos [..., 2], qvel [..., 2]).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..engine import chain as rb
from .base import Env

_DT = 0.01
_FRAME_SKIP = 5
_L = 1.0
_R = 0.018


@dataclasses.dataclass(frozen=True)
class AcrobotParams:
    model: rb.ChainModel


@dataclasses.dataclass(frozen=True)
class AcrobotState:
    qpos: torch.Tensor
    qvel: torch.Tensor


def build_model(device="cuda") -> rb.ChainModel:
    unlim = (-1e6, 1e6)
    bodies = [
        dict(pos=(0, 0, 0), axis=(0, 1, 0), range=unlim, damping=0.02, gear=0.0,
             geoms=[rb.capsule_geom(_R, (0, 0, 0, 0, 0, -_L))]),
        dict(pos=(0, 0, -_L), axis=(0, 1, 0), range=unlim, damping=0.02, gear=8.0,
             geoms=[rb.capsule_geom(_R, (0, 0, 0, 0, 0, -_L))]),
    ]
    return rb.build_chain(bodies, dt=_DT, site_body=1, site_pos=(0.0, 0.0, -_L),
                          gravity=(0.0, 0.0, -9.81), device=device)


def _init(params: AcrobotParams, seed: int) -> AcrobotState:
    """qpos, qvel ~ U(-0.1, 0.1)."""
    device = params.model.device
    u = torch.rand(4, generator=rng.generator(rng.derive_seed(seed, 0), device), device=device)
    s = 0.2 * u - 0.1
    return AcrobotState(qpos=s[:2], qvel=s[2:])


def tip_height(params: AcrobotParams, state: AcrobotState) -> torch.Tensor:
    return rb.site_position(params.model, state.qpos)[..., 2]


def _observe(params: AcrobotParams, state: AcrobotState) -> torch.Tensor:
    q = state.qpos
    return torch.cat([torch.cos(q), torch.sin(q), state.qvel], -1)


def _step(params: AcrobotParams, state: AcrobotState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    full_ctrl = torch.cat([torch.zeros_like(ctrl[..., :1]), ctrl], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, full_ctrl,
                         n_substeps=_FRAME_SKIP)
    new = AcrobotState(qpos=qpos, qvel=qvel)
    reward = tip_height(params, new) - 0.01 * torch.sum(ctrl * ctrl, -1)
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: AcrobotParams, state: AcrobotState) -> torch.Tensor:
    return tip_height(params, state) > 1.5


def make(device="cuda") -> Env:
    device = torch.device(device)
    return Env(name="acrobot-v0", d_obs=6, d_action=1,
               action_lows=torch.full((1,), -1.0, device=device),
               action_highs=torch.full((1,), 1.0, device=device),
               params=AcrobotParams(model=build_model(device)), init=_init, step=_step,
               observe=_observe, device=device, success=_success, max_episode_steps=200)
