"""door-v0: press a latched handle down and pull a door open with the hand.

Counterpart of mjmpc_tpu/envs/hand_door.py: the 3-slide arm carrying the
24-DOF grip hand of envs/adroit.py (27 actuated dofs), a door on a vertical
hinge and the latch, a hinge on the door that carries the handle bar. All
29 joints are scalar: two trees, the arm and hand, and the door with its
latch; nq = nv = 29, dt 0.002 x frame_skip 5.

- contact: the 10 finger spheres (tip and mid of each distal phalanx), the
  handle capsule's two ends and the palm pad (13 points, one batched
  engine.chain.points_frame pass per substep). Each finger sphere and the
  palm pad push the handle; the reaction is split by the contact's weight
  t onto the capsule's two ends. There is no table;
- joint forces: the z slide carries the hand's weight; the latch has a
  return spring -0.3 q_latch; the door a closing spring -0.25 q_door and,
  while the latch is below 0.55 rad and the door near closed, a strike
  plate -4 tanh(q_door / 0.03) gated by sigmoid((0.55 - q_latch) / 0.05)
  sigmoid((0.12 - q_door) / 0.04);
- reward = -0.1 |palm - handle| + 0.5 q_latch + 2 q_door, +2, +8 and +10
  once the door passes 0.2, 1.0 and 1.35 rad;
- success: the door past 1.35 rad;
- obs (64): arm and hand qpos (27) and qvel (27), the handle's middle,
  palm - handle, the door's and the latch's qpos and qvel;
- the start: the hand's neutral pose raised to z = 0.10 at a U(-0.05,
  0.05) y drawn with an explicit torch.Generator, the door and the latch
  closed, at rest.

The fused rollout is kernel #6 (ops/forest_rollout.py, the forest rollout
with the door task): kp, kd and mu ride its extras and are read at call
time (`dynamic_fields`); the rigid-body constants are baked. The JAX
package's dynamics-randomisation name tables wait for the port of
envs/randomize.py.

State = DoorState(qpos, qvel, timestep), with leading batch dimensions on
the tensors.
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
N_ARM = 3
DOOR_BODY = N_ARM + adroit.N_HAND_BODIES       # body, qpos and qvel index 27
LATCH_BODY = DOOR_BODY + 1                      # 28
N_ACT = N_ARM + adroit.N_HAND_DOF               # 27
N_TIPS = 2 * adroit.N_DIGITS

# The door's hinge at x = 0.35, its panel reaching toward -x; the latch's
# pivot at the panel's free edge; the handle bar along the latch body's -x,
# toward the hand.
DOOR_HINGE_POS = (0.35, 0.25, 0.04)
PANEL = (-0.30, -0.04, 0.0)
HANDLE_A = np.array([-0.01, 0.0, 0.0], np.float32)    # the handle's ends in the
HANDLE_B = np.array([-0.12, 0.0, 0.0], np.float32)    # latch body's frame
HANDLE_MID = (0.5 * (HANDLE_A + HANDLE_B)).astype(np.float32)
HANDLE_R = 0.014
PALM_LOCAL = np.asarray(adroit.PALM_LOCAL, np.float32)
PALM_R = adroit.PALM_R

LATCH_THRESH = 0.55     # rad the latch must turn before the door frees
LATCH_SPRING = 0.3      # the handle's return spring
DOOR_SPRING = 0.25      # the door's closing spring
BLOCK_K = 4.0           # the strike plate's torque cap [N m]


@dataclasses.dataclass(frozen=True)
class DoorParams:
    model: rb.ChainModel
    kp: torch.Tensor     # contact normal stiffness (scalar)
    kd: torch.Tensor     # contact normal damping (scalar)
    mu: torch.Tensor     # friction coefficient (scalar)
    consts: "DoorConsts"   # the task's fixed geometry on the params' device


@dataclasses.dataclass(frozen=True)
class DoorState:
    qpos: torch.Tensor   # [..., 29] = 3 slides + 24 hinges + door + latch
    qvel: torch.Tensor   # [..., 29]
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


BODIES, DIGITS = adroit.arm_hand_bodies()
BODIES.append(dict(   # the door panel on a vertical hinge
    pos=DOOR_HINGE_POS, axis=(0, 0, 1), range=(0.0, 1.8), parent=-1, damping=1.2,
    armature=0.05, gear=0.0, geoms=[rb.box_geom((0.14, 0.015, 0.10), (-0.15, 0.0, 0.0))]))
BODIES.append(dict(   # the latch's hinge carrying the handle bar
    pos=PANEL, axis=(0, -1, 0), range=(0.0, 1.5), parent=DOOR_BODY, damping=0.15,
    armature=0.01, gear=0.0,
    geoms=[rb.capsule_geom(HANDLE_R, tuple(HANDLE_A) + tuple(HANDLE_B))]))

# Contact points: (tip, mid) of each digit's distal body, the handle's two
# ends and the palm pad.
C_BODIES = (tuple(int(b) for (b, _, _) in DIGITS for _ in range(2))
            + (LATCH_BODY, LATCH_BODY, 2))
C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in DIGITS]
    + [HANDLE_A[None], HANDLE_B[None], PALM_LOCAL[None]]).astype(np.float32)
C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)
CAP_A, CAP_B, PALM = range(N_TIPS, N_TIPS + 3)   # their point indices


class DoorConsts(NamedTuple):
    """The task's fixed geometry as tensors, made once with the params
    (constants) so that a step copies nothing from the host."""
    bodies: torch.Tensor       # [13] int64, C_BODIES
    points: torch.Tensor       # [13, 3] C_POINTS
    radii: torch.Tensor        # [10] C_RADII
    palm_local: torch.Tensor   # [3] PALM_LOCAL
    handle_mid: torch.Tensor   # [3] HANDLE_MID


def constants(device) -> DoorConsts:
    return DoorConsts(*(rb.constant(v, device)
                        for v in (C_BODIES, C_POINTS, C_RADII, PALM_LOCAL, HANDLE_MID)))


def build_model(device="cuda") -> rb.ChainModel:
    """The arm, hand, door and latch ChainModel on `device`; the site is
    the handle's middle."""
    return rb.build_chain(BODIES, dt=_DT, site_body=LATCH_BODY, site_pos=tuple(HANDLE_MID),
                          gravity=(0.0, 0.0, -9.81), device=device)


def door_forces(pos, vel, kp, kd, mu, c: DoorConsts):
    """World forces [..., 13, 3] at the contact points from their world
    positions and velocities [..., 13, 3] (the door task's force law,
    shared by the env step and the forest rollout's plain version)."""
    radii = c.radii
    cap_a, cap_b, palm = (pos[..., k, :] for k in (CAP_A, CAP_B, PALM))
    vcap_a, vcap_b, vpalm = (vel[..., k, :] for k in (CAP_A, CAP_B, PALM))
    f_cap_a = torch.zeros_like(cap_a)
    f_cap_b = torch.zeros_like(cap_b)
    forces = []
    for k in range(N_TIPS):
        f, t = contact.sphere_segment_force(pos[..., k, :], vel[..., k, :], radii[k], cap_a,
                                            cap_b, vcap_a, vcap_b, HANDLE_R, kp, kd, mu)
        forces.append(f)
        f_cap_a = f_cap_a - (1.0 - t)[..., None] * f
        f_cap_b = f_cap_b - t[..., None] * f
    f_palm, tp = contact.sphere_segment_force(palm, vpalm, PALM_R, cap_a, cap_b, vcap_a, vcap_b,
                                              HANDLE_R, kp, kd, mu)
    f_cap_a = f_cap_a - (1.0 - tp)[..., None] * f_palm
    f_cap_b = f_cap_b - tp[..., None] * f_palm
    forces += [f_cap_a, f_cap_b, f_palm]
    return torch.stack(forces, -2)


def latch_torque(q_latch):
    """The latch's return spring [...]."""
    return -LATCH_SPRING * q_latch


def door_torque(q_door, q_latch):
    """The door's closing spring and the strike plate [...]: the plate's
    saturating torque acts while the latch is below its threshold and the
    door near closed (smooth gates)."""
    gate = (torch.sigmoid((LATCH_THRESH - q_latch) / 0.05)
            * torch.sigmoid((0.12 - q_door) / 0.04))
    return -DOOR_SPRING * q_door - BLOCK_K * torch.tanh(q_door / 0.03) * gate


def _ext_forces(params: DoorParams):
    c = params.consts
    weight = 9.81 * params.model.mass[:DOOR_BODY].sum()

    def fn(model, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, c.bodies, c.points)
        tau = apply(door_forces(pos, vel, params.kp, params.kd, params.mu, c))
        q_door, q_latch = q[..., DOOR_BODY:DOOR_BODY + 1], q[..., LATCH_BODY:LATCH_BODY + 1]
        # the hand's weight on the z slide, the door's and the latch's springs
        return torch.cat([tau[..., :2], tau[..., 2:3] + weight, tau[..., 3:DOOR_BODY],
                          tau[..., DOOR_BODY:DOOR_BODY + 1] + door_torque(q_door, q_latch),
                          tau[..., LATCH_BODY:] + latch_torque(q_latch)], -1)

    return fn


def door_frames(rots, poss, c: DoorConsts):
    """(palm pad, handle middle) world positions [..., 3] from the bodies'
    frames."""
    palm = poss[..., 2, :] + (rots[..., 2, :, :] @ c.palm_local[:, None])[..., 0]
    handle = (poss[..., LATCH_BODY, :]
              + (rots[..., LATCH_BODY, :, :] @ c.handle_mid[:, None])[..., 0])
    return palm, handle


def _frames(params: DoorParams, qpos):
    return door_frames(*rb.forward_kinematics(params.model, qpos), params.consts)


def door_reward(palm, handle, q_door, q_latch):
    """The door reward [...] from the palm pad, the handle's middle and the
    door's and the latch's angles."""
    zero = torch.zeros_like(q_door)
    return (-0.1 * torch.linalg.vector_norm(palm - handle, dim=-1)
            + 0.5 * q_latch + 2.0 * q_door
            + torch.where(q_door > 0.2, zero + 2.0, zero)
            + torch.where(q_door > 1.0, zero + 8.0, zero)
            + torch.where(q_door > 1.35, zero + 10.0, zero))


def _init(params: DoorParams, seed: int) -> DoorState:
    device = params.kp.device
    gen = rng.generator(rng.derive_seed(seed, 0), device)
    qpos = params.model.neutral_qpos().clone()
    qpos[2] = 0.10
    qpos[1] = 0.1 * torch.rand((), generator=gen, device=device) - 0.05
    return DoorState(qpos=qpos, qvel=torch.zeros(params.model.nv, device=device), timestep=rng.step_tensor(0, device))


def _observe(params: DoorParams, state: DoorState) -> torch.Tensor:
    palm, handle = _frames(params, state.qpos)
    return torch.cat([state.qpos[..., :N_ACT], state.qvel[..., :N_ACT], handle, palm - handle,
                      state.qpos[..., DOOR_BODY:], state.qvel[..., DOOR_BODY:]], -1)


def _step(params: DoorParams, state: DoorState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    ctrl = torch.cat([ctrl, ctrl.new_zeros(ctrl.shape[:-1] + (2,))], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    reward = door_reward(*_frames(params, qpos), qpos[..., DOOR_BODY], qpos[..., LATCH_BODY])
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: DoorParams, state: DoorState) -> torch.Tensor:
    return state.qpos[..., DOOR_BODY] > 1.35


def hook_qpos(model: rb.ChainModel, qpos: torch.Tensor, latch: float,
              door: float = 0.0) -> torch.Tensor:
    """qpos with the door at `door`, the latch at `latch` and the hand
    hooking the handle: the wrist turned about y by -latch (within its
    range) so that the finger rows run along the pressed-down handle, and
    the hand moved so that the four fingers' tips lie 13 mm below the
    handle's axis, under its middle. Every finger sphere then presses the
    handle from its side, so that the hand's motion reaches the latch and
    the door through contact from the first substep: a start state for
    checks of the contact path, the latch's spring and the strike plate."""
    q = qpos.clone()
    q[..., DOOR_BODY] = door
    q[..., LATCH_BODY] = latch
    q[..., N_ARM + 1] = -min(latch, 0.45)        # the wrist's deviation about y
    q[..., 0:3] = 0.0
    rots, poss = rb.forward_kinematics(model, q)
    _, handle = door_frames(rots, poss, constants(q.device))
    # the handle's up normal: the latch body's z axis
    up = rots[..., LATCH_BODY, :, 2]
    local = lambda a: torch.as_tensor(a, device=q.device)
    tips = torch.stack([poss[..., b, :] + rots[..., b, :, :] @ local(tip)
                        for b, tip, _ in DIGITS[:4]], -2).mean(-2)
    q[..., 0:3] = handle - 0.013 * up - tips
    return q


def build_rollout(model: rb.ChainModel) -> fr.ForestRollout:
    """Kernel #6 with the door task (ops/forest_rollout.py): the arm and hand
    tree, the door and latch tree, the 13 contact points of door_forces,
    the hand's weight, the latch's spring and the strike plate as joint
    torques and the door cost, 5 substeps per control step, actions on the
    arm's slides and the hand's hinges."""
    return fr.build_forest_rollout(model, _FRAME_SKIP, list(range(N_ACT)),
                                   fr.door_task(adroit.arm_hand_weight(model)))


def door_extras(params: DoorParams) -> torch.Tensor:
    """The kernel's extras [kp, kd, mu]."""
    return torch.stack([params.kp, params.kd, params.mu])


def _build_fused(params: DoorParams) -> dict:
    """Kernel #6 built from params.model (Env.build_fused)."""
    return dict(fused_rollout=forest_fused(build_rollout(params.model),
                                           lambda p, state: door_extras(p),
                                           dynamic_fields=("kp", "kd", "mu")))


def make(device="cuda") -> Env:
    """door-v0 (max 150 steps)."""
    device = torch.device(device)
    model = build_model(device)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    params = DoorParams(model=model, kp=t(800.0), kd=t(2.0), mu=t(1.2),
                        consts=constants(device))
    return Env(name="door-v0", d_obs=2 * N_ACT + 10, d_action=N_ACT,
               action_lows=torch.full((N_ACT,), -1.0, device=device),
               action_highs=torch.full((N_ACT,), 1.0, device=device),
               params=params, init=_init, step=_step, observe=_observe, device=device,
               success=_success, max_episode_steps=150, build_fused=_build_fused,
               **_build_fused(params))


from .randomize import register_names as _register_names  # noqa: E402

_register_names("door-v0",
                ["arm_x", "arm_y", "arm_z"] + adroit.hand_joint_names() + ["frame", "latch"],
                extra={"door_hinge": DOOR_BODY, "handle": LATCH_BODY})
