"""HalfCheetah-v0: planar running quadruped half-model.

Counterpart of mjmpc_tpu/envs/half_cheetah.py: a 9-DOF planar tree
(rootx/rootz slides and rooty pitch on the torso, branching into back and
front legs of thigh/shin/foot), joint springs, dampers and armature per
the reference XML, total mass rescaled to 14 (settotalmass), gears
[120, 90, 60, 120, 60, 30], gravity -9.81, dt 0.002 x frame_skip 25.

- reward = (x_after - x_before) / (dt * frame_skip) - 0.1 * sum a^2;
- obs = [qpos[1:], qvel] (17-dim);
- reset: qpos from U(-0.1, 0.1), qvel 0.1 * N(0, 1).

Ground contact is a smooth penalty model (spring-damper normal force and
tanh-saturated Coulomb friction at the feet's and shins' endpoints and
the head), mapped to generalized forces through the engine's AD point
Jacobians; the fused rollout (kernel #5, ops/chain_rollout.py
ChainExtRollout) computes the same forces through analytic ones. The JAX
package's hook that maps geom_friction randomization onto `mu`
(register_param_paths) waits for the port of envs/randomize.py.

State = (qpos, qvel), with leading batch dimensions.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import rng
from ..engine import chain as rb
from ..ops.chain_rollout import (ChainExtRollout, ExtTask, GroundContact,
                                 build_chain_ext_rollout)
from .base import Env
from .swimmer import pad_base

_DT = 0.002
_FRAME_SKIP = 25        # control dt = 0.05, gym's 0.01 x 5
_TOTAL_MASS = 14.0
N_Q = 9
D_OBS = (N_Q - 1) + N_Q
_G = (0.0, 0.0, -9.81)


def _cap(r, pos, angle, hl):
    """Capsule geom from the XML's (pos, axisangle-about-y, half-length)."""
    d = np.array([np.sin(angle), 0.0, np.cos(angle)])
    p = np.asarray(pos)
    return rb.capsule_geom(r, tuple(p - hl * d) + tuple(p + hl * d))


_UNLIM = (-1e6, 1e6)

_BODIES = [
    dict(pos=(0, 0, 0.7), axis=(1, 0, 0), type="slide", range=_UNLIM,
         parent=-1, geoms=[]),                                   # rootx
    dict(pos=(0, 0, 0), axis=(0, 0, 1), type="slide", range=_UNLIM,
         parent=0, geoms=[]),                                    # rootz
    dict(pos=(0, 0, 0), axis=(0, 1, 0), range=_UNLIM, parent=1,  # rooty
         geoms=[rb.capsule_geom(0.046, (-0.5, 0, 0, 0.5, 0, 0)),
                _cap(0.046, (0.6, 0, 0.1), 0.87, 0.15)]),        # torso+head
    dict(pos=(-0.5, 0, 0), axis=(0, 1, 0), range=(-0.52, 1.05), parent=2,
         damping=6.0, stiffness=240.0, armature=0.1, gear=120.0,
         geoms=[_cap(0.046, (0.1, 0, -0.13), -3.8, 0.145)]),     # bthigh
    dict(pos=(0.16, 0, -0.25), axis=(0, 1, 0), range=(-0.785, 0.785),
         parent=3, damping=4.5, stiffness=180.0, armature=0.1, gear=90.0,
         geoms=[_cap(0.046, (-0.14, 0, -0.07), -2.03, 0.15)]),   # bshin
    dict(pos=(-0.28, 0, -0.14), axis=(0, 1, 0), range=(-0.4, 0.785),
         parent=4, damping=3.0, stiffness=120.0, armature=0.1, gear=60.0,
         geoms=[_cap(0.046, (0.03, 0, -0.097), -0.27, 0.094)]),  # bfoot
    dict(pos=(0.5, 0, 0), axis=(0, 1, 0), range=(-1.0, 0.7), parent=2,
         damping=4.5, stiffness=180.0, armature=0.1, gear=120.0,
         geoms=[_cap(0.046, (-0.07, 0, -0.12), 0.52, 0.133)]),   # fthigh
    dict(pos=(-0.14, 0, -0.24), axis=(0, 1, 0), range=(-1.2, 0.87),
         parent=6, damping=3.0, stiffness=120.0, armature=0.1, gear=60.0,
         geoms=[_cap(0.046, (0.065, 0, -0.09), -0.6, 0.106)]),   # fshin
    dict(pos=(0.13, 0, -0.18), axis=(0, 1, 0), range=(-0.5, 0.5),
         parent=7, damping=1.5, stiffness=60.0, armature=0.1, gear=30.0,
         geoms=[_cap(0.046, (0.045, 0, -0.07), -0.6, 0.07)]),    # ffoot
]


def _end(center, hl, angle, sign):
    """An endpoint of a capsule about y: center + sign * hl * (sin, 0, cos)."""
    return np.asarray(center) + sign * hl * np.array([np.sin(angle), 0.0, np.cos(angle)])


# Contact sample points (body index, body-local point): both capsule
# endpoints of each foot, the shins' low ends and the head, so that face
# plants do not tunnel.
_CONTACTS = [
    (5, _end((0.03, 0, -0.097), 0.094, -0.27, -1)),
    (5, _end((0.03, 0, -0.097), 0.094, -0.27, 1)),
    (8, _end((0.045, 0, -0.07), 0.07, -0.6, -1)),
    (8, _end((0.045, 0, -0.07), 0.07, -0.6, 1)),
    (4, _end((-0.14, 0, -0.07), 0.15, -2.03, -1)),
    (7, _end((0.065, 0, -0.09), 0.106, -0.6, -1)),
    (2, np.array([0.6, 0, 0.1])),
]
_CONTACT_BODIES = [b for b, _ in _CONTACTS]
_CONTACT_R = 0.046                  # capsule radius at the sample points


@dataclasses.dataclass(frozen=True)
class CheetahParams:
    model: rb.ChainModel
    kp: torch.Tensor     # contact normal stiffness (scalar)
    kd: torch.Tensor     # contact normal damping (scalar)
    mu: torch.Tensor     # friction coefficient (scalar)
    bodies: torch.Tensor   # [7] int64, the contact points' bodies (_CONTACT_BODIES): made
                           # with the params, a step indexes them without a host copy


@dataclasses.dataclass(frozen=True)
class CheetahState:
    qpos: torch.Tensor   # [..., 9]
    qvel: torch.Tensor   # [..., 9]


def build_model(device="cuda") -> rb.ChainModel:
    model = rb.build_chain(_BODIES, dt=_DT, site_body=2, site_pos=(0.0, 0.0, 0.0),
                           gravity=_G, device=device)
    # settotalmass="14": rescale masses and inertias (MuJoCo compiler option)
    scale = _TOTAL_MASS / float(np.sum(model.mass.cpu().numpy()))
    return dataclasses.replace(model, mass=model.mass * scale,
                               inertia=model.inertia * scale)


@functools.lru_cache(maxsize=None)
def _contact_points(device: torch.device) -> torch.Tensor:
    """The contact points [7, 3] in their bodies' frames."""
    return torch.as_tensor(np.asarray([p for _, p in _CONTACTS], np.float32), device=device)


def _ext_forces(params: CheetahParams):
    """Generalized contact forces of all seven points through one jvp and
    one vjp of their world positions."""
    pts = _contact_points(params.kp.device)

    def fn(model, q, qd):
        pos, vel = rb.point_state(model, q, qd, params.bodies, pts)
        depth = _CONTACT_R - pos[..., 2]             # penetration below z = r
        push = torch.clamp(params.kp * depth - params.kd * vel[..., 2], min=0.0)
        fn_mag = torch.where(depth > 0.0, push, torch.zeros_like(push))
        # saturated Coulomb friction opposing tangential slip
        ft = -params.mu * fn_mag * torch.tanh(vel[..., 0] / 0.1)
        f = torch.stack([ft, 0.0 * ft, fn_mag], -1)
        return rb.point_force_to_generalized(model, q, params.bodies, pts, f)

    return fn


def _init(params: CheetahParams, seed: int) -> CheetahState:
    device = params.kp.device
    gen = lambda k: rng.generator(rng.derive_seed(seed, k), device)
    return CheetahState(
        qpos=0.2 * torch.rand(N_Q, generator=gen(0), device=device) - 0.1,
        qvel=0.1 * torch.randn(N_Q, generator=gen(1), device=device))


def _observe(params: CheetahParams, state: CheetahState) -> torch.Tensor:
    return torch.cat([state.qpos[..., 1:], state.qvel], -1)


def _step(params: CheetahParams, state: CheetahState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    x_before = state.qpos[..., 0]
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, pad_base(ctrl),
                         n_substeps=_FRAME_SKIP, ext_force_fn=_ext_forces(params))
    new = CheetahState(qpos=qpos, qvel=qvel)
    reward = ((qpos[..., 0] - x_before) / (_DT * _FRAME_SKIP)
              - 0.1 * torch.sum(ctrl ** 2, -1))
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def build_rollout(params: CheetahParams) -> ChainExtRollout:
    """Kernel #5 for these params (ops/chain_rollout.py ChainExtRollout;
    the template's tree recursions take the branched legs): ground
    contact at the seven points and the step cost 0.1 sum u^2 - forward
    progress / control dt. The contact gains are baked into the kernel, so
    planning against other gains must bypass it (build_solve_fn's `fused`)."""
    task = ExtTask("cheetah", GroundContact(
        bodies=tuple(_CONTACT_BODIES),
        points=tuple(tuple(float(x) for x in p) for _, p in _CONTACTS),
        radius=_CONTACT_R, kp=float(params.kp), kd=float(params.kd), mu=float(params.mu)),
        ctrl_weight=0.1, inv_dt=1.0 / (_DT * _FRAME_SKIP))
    return build_chain_ext_rollout(params.model, _FRAME_SKIP, task)


def _build_fused(params: CheetahParams) -> dict:
    """Kernel #5 built from params: the model and the contact gains
    (Env.build_fused)."""
    roll = build_rollout(params)

    def fused(p, state, mean, noise):
        return roll(state.qpos, state.qvel, pad_base(mean), pad_base(noise))

    def fused_batch(p, states, means, noises):
        """B states (each field with a leading [B]), means [B, H, 6] and
        noise [B, N, H, 6] -> costs [B, N, H] in one launch of #5."""
        return roll.batch(states.qpos, states.qvel, pad_base(means), pad_base(noises))

    fused.kernel = roll   # the wrapper, for checks against its plain version
    fused.batched = fused_batch
    return dict(fused_rollout=fused)


def make(device="cuda") -> Env:
    device = torch.device(device)
    params = CheetahParams(model=build_model(device), kp=torch.tensor(6000.0, device=device),
                           kd=torch.tensor(150.0, device=device),
                           mu=torch.tensor(0.4, device=device),
                           bodies=rb.constant(_CONTACT_BODIES, device))
    return Env(
        name="HalfCheetah-v0", d_obs=D_OBS, d_action=6,
        action_lows=torch.full((6,), -1.0, device=device),
        action_highs=torch.full((6,), 1.0, device=device),
        params=params, init=_init, step=_step, observe=_observe, device=device,
        max_episode_steps=500, build_fused=_build_fused, **_build_fused(params))


from .randomize import register_param_paths as _register_param_paths  # noqa: E402

# the ground contact's friction coefficient is a params leaf, which the
# geom_friction axis maps onto; kernel #5 bakes the contact gains, so a
# perturbed env rebuilds it (Env.with_params)
_register_param_paths("HalfCheetah-v0", {"geom_friction": {"floor": "mu", "ground": "mu"}})
