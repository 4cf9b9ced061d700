"""Swimmer-v0: 5-link planar swimmer in viscous fluid.

Counterpart of mjmpc_tpu/envs/swimmer.py: a free planar base (slide x,
slide y, hinge z) plus 4 actuated hinge joints (gear 20, range +-1.5),
capsule links 0.3 long, dt 0.005 x frame_skip 4, water-density fluid.

- reward = (x_after - x_before) / (dt * frame_skip) - 1e-4 * sum a^2;
- obs = [qpos[2:], qvel] (12-dim);
- reset: qpos and qvel drawn from U(-0.1, 0.1).

Fluid model: each link gets slender-body anisotropic quadratic drag,
F = -c_perp/2 min(|v_n|, 4) v_n - c_par/2 min(|v_t|, 4) v_t, at two
sample points per link, mapped to generalized forces through the engine's
AD point Jacobians (engine/chain.py point_state and
point_force_to_generalized); after each control step |qvel| is clamped
to _VEL_LIMIT. The fused rollout (kernel #5, ops/chain_rollout.py
ChainExtRollout) computes the same forces through analytic point
Jacobians.

State = (qpos, qvel), with leading batch dimensions.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import rng
from ..engine import chain as rb
from ..ops.chain_rollout import (CapsuleDrag, ChainExtRollout, ExtTask,
                                 build_chain_ext_rollout)
from .base import Env

_DT = 0.005
_FRAME_SKIP = 4
_DENSITY = 1000.0
_N_LINKS = 5
_LINK_LEN = 0.3
_LINK_R = [0.07, 0.065, 0.06, 0.055, 0.05]
N_Q = 3 + 4           # slide x, slide y, base yaw + 4 joints
D_OBS = (N_Q - 2) + N_Q   # qpos[2:] + qvel
_LINK_BODIES = tuple(range(2, 2 + _N_LINKS))
_SAMPLES = (0.25 * _LINK_LEN, 0.75 * _LINK_LEN)
# Velocity ceiling: quadratic drag is stiff at speed; beyond this the
# explicit substeps can overshoot.
_VEL_LIMIT = np.array([8.0, 8.0, 25.0, 25.0, 25.0, 25.0, 25.0], np.float32)


def _bodies():
    unlim = (-1e6, 1e6)
    bodies = [
        dict(pos=(0, 0, 0), axis=(1, 0, 0), type="slide", range=unlim, geoms=[]),
        dict(pos=(0, 0, 0), axis=(0, 1, 0), type="slide", range=unlim, geoms=[]),
        # torso link carries the first capsule
        dict(pos=(0, 0, 0), axis=(0, 0, 1), range=unlim,
             geoms=[rb.capsule_geom(_LINK_R[0], (0, 0, 0, _LINK_LEN, 0, 0))]),
    ]
    for i in range(1, _N_LINKS):
        bodies.append(dict(
            pos=(_LINK_LEN, 0, 0), axis=(0, 0, 1), range=(-1.5, 1.5), gear=20.0,
            geoms=[rb.capsule_geom(_LINK_R[i], (0, 0, 0, _LINK_LEN, 0, 0))]))
    return bodies


def build_model(device="cuda") -> rb.ChainModel:
    return rb.build_chain(_bodies(), dt=_DT, site_body=2, site_pos=(0.0, 0.0, 0.0),
                          device=device)


@dataclasses.dataclass(frozen=True)
class SwimmerParams:
    model: rb.ChainModel
    drag_perp: torch.Tensor   # [5] per-link perpendicular drag coefficient
    drag_par: torch.Tensor    # [5] per-link parallel drag coefficient
    vel_limit: torch.Tensor   # [7] per-dof |qvel| ceiling
    bodies: torch.Tensor      # [10] int64, the drag points' links (_POINT_BODIES): made
                              # with the params, a step indexes them without a host copy


@dataclasses.dataclass(frozen=True)
class SwimmerState:
    qpos: torch.Tensor   # [..., 7]
    qvel: torch.Tensor   # [..., 7]


def _drag_coeffs():
    """Quadratic slender-body drag, 0.5 * rho * Cd * frontal area, per link
    (perpendicular, parallel), as f32 numpy."""
    per = [0.5 * _DENSITY * 1.0 * (_LINK_LEN * 2 * r) for r in _LINK_R]
    par = [0.5 * _DENSITY * 0.1 * (np.pi * r * r) for r in _LINK_R]
    return np.asarray(per, np.float32), np.asarray(par, np.float32)


_POINT_BODIES = [b for b in _LINK_BODIES for _ in _SAMPLES]


@functools.lru_cache(maxsize=None)
def _sample_points(device: torch.device) -> torch.Tensor:
    """The drag sample points [10, 3] in their links' frames, link-major."""
    return torch.tensor([[s, 0.0, 0.0] for _ in _LINK_BODIES for s in _SAMPLES],
                        device=device)


def _ext_forces(params: SwimmerParams):
    """Generalized fluid-drag forces: two sample points per capsule, all ten
    through one jvp and one vjp of the points' world positions."""
    bodies = params.bodies
    pts = _sample_points(params.drag_perp.device)
    c_perp = params.drag_perp.repeat_interleave(len(_SAMPLES))
    c_par = params.drag_par.repeat_interleave(len(_SAMPLES))

    def fn(model, q, qd):
        rots, _ = rb.forward_kinematics(model, q)
        axis = rots[..., bodies, :, 0]                      # R e_x [..., K, 3]
        _, v = rb.point_state(model, q, qd, bodies, pts)
        v_par = torch.sum(v * axis, dim=-1, keepdim=True) * axis
        v_perp = v - v_par
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        # saturated quadratic drag: the |v| factor is capped so that the
        # stiff high-speed regime cannot overshoot the explicit substep
        f = (-c_perp[:, None] * 0.5 * torch.clamp(norm(v_perp), max=4.0) * v_perp
             - c_par[:, None] * 0.5 * torch.clamp(norm(v_par), max=4.0) * v_par)
        return rb.point_force_to_generalized(model, q, bodies, pts, f)

    return fn


def _init(params: SwimmerParams, seed: int) -> SwimmerState:
    device = params.drag_perp.device
    draw = lambda k: (0.2 * torch.rand(N_Q, generator=rng.generator(rng.derive_seed(seed, k),
                                                                    device), device=device)
                      - 0.1)
    return SwimmerState(qpos=draw(0), qvel=draw(1))


def _observe(params: SwimmerParams, state: SwimmerState) -> torch.Tensor:
    return torch.cat([state.qpos[..., 2:], state.qvel], -1)


def _step(params: SwimmerParams, state: SwimmerState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    x_before = state.qpos[..., 0]
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, pad_base(ctrl),
                         n_substeps=_FRAME_SKIP, ext_force_fn=_ext_forces(params))
    qvel = torch.minimum(torch.maximum(qvel, -params.vel_limit), params.vel_limit)
    new = SwimmerState(qpos=qpos, qvel=qvel)
    reward = ((qpos[..., 0] - x_before) / (_DT * _FRAME_SKIP)
              - 1e-4 * torch.sum(ctrl ** 2, -1))
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def build_rollout(params: SwimmerParams) -> ChainExtRollout:
    """Kernel #5 for these params (ops/chain_rollout.py ChainExtRollout):
    capsule drag on the five links, the velocity limit and the step cost
    1e-4 sum u^2 - forward progress / control dt. The drag coefficients are
    baked into the kernel, so planning against other fluid params must
    bypass it (build_solve_fn's `fused`)."""
    host = lambda x: tuple(float(c) for c in x.detach().cpu().numpy())
    task = ExtTask("swimmer", CapsuleDrag(
        link_bodies=_LINK_BODIES, sample_offsets=_SAMPLES, drag_perp=host(params.drag_perp),
        drag_par=host(params.drag_par)), ctrl_weight=1e-4, inv_dt=1.0 / (_DT * _FRAME_SKIP))
    return build_chain_ext_rollout(params.model, _FRAME_SKIP, task,
                                   vel_limit=params.vel_limit.detach().cpu().numpy())


def pad_base(x: torch.Tensor) -> torch.Tensor:
    """Zero actions of the three unactuated base dofs before the actuated
    ones ([..., dA] -> [..., dA + 3]), the env's control layout."""
    return torch.cat([x.new_zeros(x.shape[:-1] + (3,)), x], -1)


def _build_fused(params: SwimmerParams) -> dict:
    """Kernel #5 built from params: the model and the drag (Env.build_fused)."""
    roll = build_rollout(params)

    def fused(p, state, mean, noise):
        return roll(state.qpos, state.qvel, pad_base(mean), pad_base(noise))

    def fused_batch(p, states, means, noises):
        """B states (each field with a leading [B]), means [B, H, 4] and
        noise [B, N, H, 4] -> costs [B, N, H] in one launch of #5."""
        return roll.batch(states.qpos, states.qvel, pad_base(means), pad_base(noises))

    fused.kernel = roll   # the wrapper, for checks against its plain version
    fused.batched = fused_batch
    return dict(fused_rollout=fused)


def make(device="cuda") -> Env:
    device = torch.device(device)
    per, par = _drag_coeffs()
    params = SwimmerParams(model=build_model(device),
                           drag_perp=torch.as_tensor(per, device=device),
                           drag_par=torch.as_tensor(par, device=device),
                           vel_limit=torch.as_tensor(_VEL_LIMIT, device=device),
                           bodies=rb.constant(_POINT_BODIES, device))
    return Env(
        name="Swimmer-v0", d_obs=D_OBS, d_action=4,
        action_lows=torch.full((4,), -1.0, device=device),
        action_highs=torch.full((4,), 1.0, device=device),
        params=params, init=_init, step=_step, observe=_observe, device=device,
        max_episode_steps=500, build_fused=_build_fused, **_build_fused(params))
