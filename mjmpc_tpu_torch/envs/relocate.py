"""relocate-v0: grasp a free ball and carry it to a target in the air.

Counterpart of mjmpc_tpu/envs/relocate.py: the 3-slide arm carrying the
24-DOF grip hand of envs/adroit.py (27 actuated dofs) and a FREE ball
(7 qpos: position and unit quaternion, wxyz; 6 qvel: linear and body-frame
angular velocity), moved only through frictional fingertip, palm and
table contact. One kinematic forest, nq = 34, nv = 33, dt 0.002 x
frame_skip 5.

- contact: the 10 finger spheres (tip and mid of each distal phalanx), the
  ball's centre and the palm pad (12 points, one batched
  engine.chain.points_frame pass per substep). Each finger sphere and the
  palm pad push the ball and are held up by the table z = 0; the ball
  rests on the table. Only the finger-on-ball and palm-on-ball forces
  react onto the ball: the table's push on a finger never reaches it;
- the arm's z slide carries the whole hand's weight as a generalized force
  (exact gravity compensation; without it zero action drops the hand);
- reward = -0.1 |palm - ball|, once the ball is lifted (z > 0.04) 1 -
  0.5 |palm - target| - 0.5 |ball - target|, +10 and +20 once the ball is
  within 0.10 and 0.05 of the target;
- success: the ball within 0.10 of the target;
- obs (69): arm and hand qpos (27) and qvel (27), ball position and linear
  velocity, palm - ball, ball - target, palm - target;
- the start: the hand raised to z = 0.18, the ball on the table at a
  U(-0.10, 0.10) xy, the target U([-0.15, -0.15, 0.18], [0.15, 0.15,
  0.32]), drawn with an explicit torch.Generator.

The fused rollout is kernel #6 (ops/forest_rollout.py, the forest rollout
with the relocate task): the target, kp, kd, mu and the ball radius ride
its extras and are read at call time (`dynamic_fields`); the rigid-body
constants are baked. The JAX package's dynamics-randomisation name tables
wait for the port of envs/randomize.py.

State = RelocateState(qpos, qvel, target, timestep), with leading batch
dimensions on the tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..engine import chain as rb
from ..ops import forest_rollout as fr
from . import adroit, contact
from .base import Env, forest_fused

_DT = 0.002
_FRAME_SKIP = 5
BALL_R = 0.035
N_ARM = 3
BALL_BODY = N_ARM + adroit.N_HAND_BODIES     # body index 27
BALL_Q = N_ARM + adroit.N_HAND_DOF            # qpos and qvel offset 27
N_ACT = N_ARM + adroit.N_HAND_DOF             # 27
N_TIPS = 2 * adroit.N_DIGITS                  # tip and mid sphere per digit
PALM_LOCAL = np.asarray(adroit.PALM_LOCAL, np.float32)
PALM_R = adroit.PALM_R
LIFT_Z = 0.04                                 # the ball counts as lifted above it


@dataclasses.dataclass(frozen=True)
class RelocateParams:
    model: rb.ChainModel
    kp: torch.Tensor      # contact normal stiffness (scalar)
    kd: torch.Tensor      # contact normal damping (scalar)
    mu: torch.Tensor      # friction coefficient (scalar)
    ball_r: torch.Tensor  # ball radius (contact only; the inertia is baked)
    consts: "RelocateConsts"   # the task's fixed geometry on the params' device


@dataclasses.dataclass(frozen=True)
class RelocateState:
    qpos: torch.Tensor    # [..., 34] = 3 slides + 24 hinges + ball (pos 3, quat 4)
    qvel: torch.Tensor    # [..., 33]
    target: torch.Tensor  # [..., 3] carry goal
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


BODIES, DIGITS = adroit.arm_hand_bodies()
BODIES.append(dict(pos=(0.0, 0.0, 0.0), type="free", parent=-1, damping=0.01, armature=0.0,
                   gear=0.0, geoms=[rb.sphere_geom(BALL_R)]))

# Contact points: (tip, mid) of each digit's distal body, the ball's centre
# and the palm pad on the z slide.
C_BODIES = tuple(int(b) for (b, _, _) in DIGITS for _ in range(2)) + (BALL_BODY, 2)
C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in DIGITS]
    + [np.zeros((1, 3), np.float32), PALM_LOCAL[None]]).astype(np.float32)
C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)


class RelocateConsts(NamedTuple):
    """The task's fixed geometry as tensors, made once with the params
    (constants) so that a step copies nothing from the host."""
    bodies: torch.Tensor       # [12] int64, C_BODIES
    points: torch.Tensor       # [12, 3] C_POINTS
    radii: torch.Tensor        # [10] C_RADII
    palm_local: torch.Tensor   # [3] PALM_LOCAL


def constants(device) -> RelocateConsts:
    return RelocateConsts(*(rb.constant(v, device)
                            for v in (C_BODIES, C_POINTS, C_RADII, PALM_LOCAL)))


def build_model(device="cuda") -> rb.ChainModel:
    """The arm, hand and free-ball ChainModel on `device`."""
    return rb.build_chain(BODIES, dt=_DT, site_body=BALL_BODY, site_pos=(0.0, 0.0, 0.0),
                          gravity=(0.0, 0.0, -9.81), device=device)


def relocate_forces(pos, vel, kp, kd, mu, ball_r, c: RelocateConsts):
    """World forces [..., 12, 3] at the contact points from their world
    positions and velocities [..., 12, 3] (the relocate task's force law,
    shared by the env's step and the forest rollout's plain version)."""
    radii = c.radii
    ball_p, ball_v = pos[..., N_TIPS, :], vel[..., N_TIPS, :]
    palm_p, palm_v = pos[..., N_TIPS + 1, :], vel[..., N_TIPS + 1, :]
    # the ball on the table
    f_ball = contact.sphere_plane_force(ball_p, ball_v, ball_r, kp, kd, mu)
    forces = []
    for k in range(N_TIPS):
        p, v = pos[..., k, :], vel[..., k, :]
        f_fb = contact.sphere_sphere_force(p, v, radii[k], ball_p, ball_v, ball_r, kp, kd, mu)
        # only the finger-on-ball force reacts onto the ball
        f_ball = f_ball - f_fb
        forces.append(f_fb + contact.sphere_plane_force(p, v, radii[k], kp, kd, mu))
    # the palm pad against the ball and the table
    f_palm = contact.sphere_sphere_force(palm_p, palm_v, PALM_R, ball_p, ball_v, ball_r,
                                         kp, kd, mu)
    f_ball = f_ball - f_palm
    f_palm = f_palm + contact.sphere_plane_force(palm_p, palm_v, PALM_R, kp, kd, mu)
    forces += [f_ball, f_palm]
    return torch.stack(forces, -2)


def _ext_forces(params: RelocateParams):
    c = params.consts
    weight = 9.81 * params.model.mass[:BALL_BODY].sum()

    def fn(model, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, c.bodies, c.points)
        tau = apply(relocate_forces(pos, vel, params.kp, params.kd, params.mu, params.ball_r,
                                    c))
        # the z slide carries the hand's weight
        return torch.cat([tau[..., :2], tau[..., 2:3] + weight, tau[..., 3:]], -1)

    return fn


def palm_position(rots, poss, c: RelocateConsts):
    """The palm pad's world position [..., 3] from the bodies' frames."""
    return poss[..., 2, :] + (rots[..., 2, :, :] @ c.palm_local[:, None])[..., 0]


def _palm_and_ball(params: RelocateParams, qpos):
    rots, poss = rb.forward_kinematics(params.model, qpos)
    return palm_position(rots, poss, params.consts), qpos[..., BALL_Q:BALL_Q + 3]


def relocate_reward(palm, ball, target):
    """The relocate reward [...] from the palm's and the ball's positions
    and the target."""
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    reach, carry = norm(palm - ball), norm(ball - target)
    lifted = ball[..., 2] > LIFT_Z
    zero = torch.zeros_like(reach)
    return (-0.1 * reach
            + torch.where(lifted, 1.0 - 0.5 * norm(palm - target) - 0.5 * carry, zero)
            + torch.where(carry < 0.10, zero + 10.0, zero)
            + torch.where(carry < 0.05, zero + 20.0, zero))


def _init(params: RelocateParams, seed: int) -> RelocateState:
    device = params.kp.device
    gen = rng.generator(rng.derive_seed(seed, 0), device)
    ball_xy = 0.2 * torch.rand(2, generator=gen, device=device) - 0.10
    lo = torch.tensor([-0.15, -0.15, 0.18], device=device)
    hi = torch.tensor([0.15, 0.15, 0.32], device=device)
    target = lo + (hi - lo) * torch.rand(3, generator=gen, device=device)
    qpos = params.model.neutral_qpos().clone()
    qpos[2] = 0.18                                  # the hand raised
    qpos[BALL_Q:BALL_Q + 2] = ball_xy
    qpos[BALL_Q + 2] = BALL_R                       # the ball on the table
    return RelocateState(qpos=qpos, qvel=torch.zeros(params.model.nv, device=device),
                         target=target, timestep=rng.step_tensor(0, device))


def _observe(params: RelocateParams, state: RelocateState) -> torch.Tensor:
    palm, ball = _palm_and_ball(params, state.qpos)
    return torch.cat([state.qpos[..., :N_ACT], state.qvel[..., :N_ACT], ball,
                      state.qvel[..., BALL_Q:BALL_Q + 3], palm - ball, ball - state.target,
                      palm - state.target], -1)


def _step(params: RelocateParams, state: RelocateState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    ctrl = torch.cat([ctrl, ctrl.new_zeros(ctrl.shape[:-1] + (6,))], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    palm, ball = _palm_and_ball(params, qpos)
    reward = relocate_reward(palm, ball, state.target)
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: RelocateParams, state: RelocateState) -> torch.Tensor:
    ball = state.qpos[..., BALL_Q:BALL_Q + 3]
    return torch.linalg.vector_norm(ball - state.target, dim=-1) < 0.10


def grasp_qpos(qpos: torch.Tensor) -> torch.Tensor:
    """qpos with the ball raised 0.1 above the table and the hand closed on
    it: the palm pad over the ball's centre and 2 mm into it, each finger
    turned 0.3 rad about its abduction axis toward the ball and
    the thumb 0.2 rad with its curls opened by 0.05, so that every tip
    sphere sits about 4 mm and every mid sphere about 2 mm deep in the
    ball. The hand's motion then reaches the ball (and the cost) through
    contact from the first substep: a start state for checks of the
    contact path."""
    q = qpos.clone()
    q[..., BALL_Q + 2] = BALL_R + 0.1
    q[..., 0:2] = q[..., BALL_Q:BALL_Q + 2]
    q[..., 2] = 0.108
    for d, (bx, _, _, side) in enumerate(adroit.GRIP_BASES):
        turn = -np.sign(bx) * side * 0.3 if bx != 0.0 else 0.2
        q[..., N_ARM + adroit.digit_abduct_index(d)] = turn
    thumb = N_ARM + np.array(adroit.digit_curl_indices(adroit.N_DIGITS - 1))
    q[..., thumb] = -0.05
    return q


def build_rollout(model: rb.ChainModel) -> fr.ForestRollout:
    """Kernel #6 with the relocate task (ops/forest_rollout.py): the arm and
    hand tree, the free ball, the 12 contact points of relocate_forces,
    the hand's weight on the z slide and the relocate cost, 5 substeps per
    control step, actions on the arm's slides and the hand's hinges."""
    return fr.build_forest_rollout(model, _FRAME_SKIP, list(range(N_ACT)),
                                   fr.relocate_task(adroit.arm_hand_weight(model)))


def relocate_extras(params: RelocateParams, state: RelocateState) -> torch.Tensor:
    """The kernel's extras [target 3, kp, kd, mu, ball_r] ([B, 7] for B
    states)."""
    gains = torch.stack([params.kp, params.kd, params.mu, params.ball_r])
    return torch.cat([state.target, gains.expand(state.target.shape[:-1] + gains.shape)], -1)


def _build_fused(params: RelocateParams) -> dict:
    """Kernel #6 built from params.model (Env.build_fused)."""
    return dict(fused_rollout=forest_fused(build_rollout(params.model), relocate_extras,
                                           dynamic_fields=("kp", "kd", "mu", "ball_r")))


def make(device="cuda") -> Env:
    device = torch.device(device)
    model = build_model(device)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    params = RelocateParams(model=model, kp=t(800.0), kd=t(2.0), mu=t(1.2), ball_r=t(BALL_R),
                            consts=constants(device))
    return Env(name="relocate-v0", d_obs=2 * N_ACT + 15, d_action=N_ACT,
               action_lows=torch.full((N_ACT,), -1.0, device=device),
               action_highs=torch.full((N_ACT,), 1.0, device=device),
               params=params, init=_init, step=_step, observe=_observe, device=device,
               success=_success, max_episode_steps=200, build_fused=_build_fused,
               **_build_fused(params))


from .randomize import (register_names as _register_names,  # noqa: E402
                        register_param_paths as _register_param_paths)

_register_names("relocate-v0",
                ["arm_x", "arm_y", "arm_z"] + adroit.hand_joint_names() + ["Object"],
                extra={"sphere": BALL_BODY})
# the contact model's own leaves for the geom fields ('sphere' is the
# mj_envs ball geom's name); both ride the kernel's extras
_register_param_paths("relocate-v0", {"geom_friction": {"sphere": "mu"},
                                      "geom_size": {"sphere": "ball_r"}})
