"""hammer-v0: pick up a free hammer and drive a nail with it.

Counterpart of mjmpc_tpu/envs/hammer.py: the 3-slide arm carrying the
24-DOF grip hand of envs/adroit.py (27 actuated dofs), a FREE hammer (a
light handle capsule and a heavy head sphere, so its com sits off the
joint origin: 7 qpos, 6 qvel) and the nail, a vertical slide with heavy
damping and dry friction that only advances under the hammer head's
impact. One kinematic forest, nq = 35, nv = 34, dt 0.002 x frame_skip 5.

- contact: the 10 finger spheres (tip and mid of each distal phalanx), the
  handle capsule's two ends, the head's centre, the nail's head and the
  palm pad (15 points, one batched engine.chain.points_frame pass per
  substep). Each finger sphere and the palm pad push the handle (the
  reaction split by the contact's weight t onto the two ends); the table
  z = 0 holds up the fingers, the handle's ends and the head; the head
  strikes the nail sphere to sphere, and the strike reacts onto the nail.
  Only the finger-on-handle and palm-on-handle forces react onto the
  hammer;
- joint forces: the z slide carries the hand's weight, and the nail's dry
  friction -10 tanh(qd_nail / 0.02) resists its motion, never drives it;
- reward = -0.1 |palm - hammer| - |head - nail| + 2 depth / 0.05, +25 and
  +75 once the nail is driven past half and 95% of its 0.05 travel;
- success: the nail driven past 95% of its travel;
- obs (73): arm and hand qpos (27) and qvel (27), the hammer's position and
  linear velocity, the head, the nail, palm - hammer, head - nail and the
  nail's qpos;
- the start: the hand raised to z = 0.18, the hammer flat on the table at
  x = -0.02 and a U(-0.06, 0.06) y drawn with an explicit torch.Generator.

The fused rollout is kernel #6 (ops/forest_rollout.py, the forest rollout
with the hammer task, its free body on the coupled 6x6 solve): kp, kd and
mu ride its extras and are read at call time (`dynamic_fields`); the
rigid-body constants are baked. The JAX package's dynamics-randomisation
name tables wait for the port of envs/randomize.py.

State = HammerState(qpos, qvel, timestep), with leading batch dimensions
on the tensors.
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
HAMMER_BODY = N_ARM + adroit.N_HAND_BODIES     # body index 27
NAIL_BODY = HAMMER_BODY + 1                     # 28
HAMMER_Q = N_ARM + adroit.N_HAND_DOF            # qpos 27..33, qvel 27..32
NAIL_Q = HAMMER_Q + 7                           # qpos 34 (the last)
NAIL_V = HAMMER_Q + 6                           # qvel 33
N_ACT = N_ARM + adroit.N_HAND_DOF               # 27
N_TIPS = 2 * adroit.N_DIGITS

HANDLE_R = 0.011
HANDLE_HL = 0.06
HEAD_R = 0.02
HEAD_LOCAL = np.array([0.075, 0.0, 0.0], np.float32)
PALM_LOCAL = np.asarray(adroit.PALM_LOCAL, np.float32)
PALM_R = adroit.PALM_R

NAIL_POS = np.array([0.22, 0.0, 0.09], np.float32)   # the nail's head at the start
NAIL_TRAVEL = 0.05
NAIL_R = 0.015
NAIL_RESIST = 10.0      # dry-friction resistance [N]
NAIL_V_SLIP = 0.02      # its tanh's velocity scale [m/s]


@dataclasses.dataclass(frozen=True)
class HammerParams:
    model: rb.ChainModel
    kp: torch.Tensor     # contact normal stiffness (scalar)
    kd: torch.Tensor     # contact normal damping (scalar)
    mu: torch.Tensor     # friction coefficient (scalar)
    consts: "HammerConsts"   # the task's fixed geometry on the params' device


@dataclasses.dataclass(frozen=True)
class HammerState:
    qpos: torch.Tensor   # [..., 35] = 3 slides + 24 hinges + hammer (7) + nail
    qvel: torch.Tensor   # [..., 34]
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


BODIES, DIGITS = adroit.arm_hand_bodies()
BODIES.append(dict(   # the hammer: a light handle, a heavy head
    pos=(0.0, 0.0, 0.0), type="free", parent=-1, damping=0.01, armature=0.0, gear=0.0,
    geoms=[rb.capsule_geom(HANDLE_R, (-HANDLE_HL, 0, 0, HANDLE_HL, 0, 0)),
           rb.sphere_geom(HEAD_R, tuple(HEAD_LOCAL))]))
BODIES.append(dict(   # the nail: a vertical slide, heavily damped
    pos=tuple(NAIL_POS), axis=(0, 0, 1), type="slide", range=(-NAIL_TRAVEL, 0.0), parent=-1,
    damping=25.0, armature=0.0, gear=0.0, geoms=[rb.sphere_geom(NAIL_R)]))

# Contact points: (tip, mid) of each digit's distal body, the handle's two
# ends, the head, the nail's head and the palm pad.
C_BODIES = (tuple(int(b) for (b, _, _) in DIGITS for _ in range(2))
            + (HAMMER_BODY, HAMMER_BODY, HAMMER_BODY, NAIL_BODY, 2))
C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in DIGITS]
    + [np.array([[-HANDLE_HL, 0, 0], [HANDLE_HL, 0, 0]], np.float32), HEAD_LOCAL[None],
       np.zeros((1, 3), np.float32), PALM_LOCAL[None]]).astype(np.float32)
C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)
CAP_A, CAP_B, HEAD, NAIL, PALM = range(N_TIPS, N_TIPS + 5)   # their point indices


class HammerConsts(NamedTuple):
    """The task's fixed geometry as tensors, made once with the params
    (constants) so that a step copies nothing from the host."""
    bodies: torch.Tensor       # [15] int64, C_BODIES
    points: torch.Tensor       # [15, 3] C_POINTS
    radii: torch.Tensor        # [10] C_RADII
    palm_local: torch.Tensor   # [3] PALM_LOCAL
    head_local: torch.Tensor   # [3] HEAD_LOCAL


def constants(device) -> HammerConsts:
    return HammerConsts(*(rb.constant(v, device)
                          for v in (C_BODIES, C_POINTS, C_RADII, PALM_LOCAL, HEAD_LOCAL)))


def build_model(device="cuda") -> rb.ChainModel:
    """The arm, hand, free-hammer and nail ChainModel on `device`."""
    return rb.build_chain(BODIES, dt=_DT, site_body=HAMMER_BODY, site_pos=tuple(HEAD_LOCAL),
                          gravity=(0.0, 0.0, -9.81), device=device)


def nail_friction(qd_nail):
    """The nail's dry friction [...] at its velocity qd_nail [...]."""
    return -NAIL_RESIST * torch.tanh(qd_nail / NAIL_V_SLIP)


def hammer_forces(pos, vel, kp, kd, mu, c: HammerConsts):
    """World forces [..., 15, 3] at the contact points from their world
    positions and velocities [..., 15, 3] (the hammer task's force law,
    shared by the env's step and the forest rollout's plain version)."""
    radii = c.radii
    cap_a, cap_b, head, nail, palm = (pos[..., k, :] for k in (CAP_A, CAP_B, HEAD, NAIL, PALM))
    vcap_a, vcap_b, vhead, vnail, vpalm = (vel[..., k, :]
                                           for k in (CAP_A, CAP_B, HEAD, NAIL, PALM))
    f_cap_a = contact.sphere_plane_force(cap_a, vcap_a, HANDLE_R, kp, kd, mu)
    f_cap_b = contact.sphere_plane_force(cap_b, vcap_b, HANDLE_R, kp, kd, mu)
    forces = []
    for k in range(N_TIPS):
        p, v = pos[..., k, :], vel[..., k, :]
        f_fh, t = contact.sphere_segment_force(p, v, radii[k], cap_a, cap_b, vcap_a, vcap_b,
                                               HANDLE_R, kp, kd, mu)
        # only the finger-on-handle force reacts onto the hammer
        f_cap_a = f_cap_a - (1.0 - t)[..., None] * f_fh
        f_cap_b = f_cap_b - t[..., None] * f_fh
        forces.append(f_fh + contact.sphere_plane_force(p, v, radii[k], kp, kd, mu))
    # the head on the table, and its strike onto the nail's head
    f_head = contact.sphere_plane_force(head, vhead, HEAD_R, kp, kd, mu)
    f_strike = contact.sphere_sphere_force(head, vhead, HEAD_R, nail, vnail, NAIL_R, kp, kd, mu)
    f_head = f_head + f_strike
    f_nail = -f_strike
    # the palm pad against the handle
    f_palm, tp = contact.sphere_segment_force(palm, vpalm, PALM_R, cap_a, cap_b, vcap_a, vcap_b,
                                              HANDLE_R, kp, kd, mu)
    f_cap_a = f_cap_a - (1.0 - tp)[..., None] * f_palm
    f_cap_b = f_cap_b - tp[..., None] * f_palm
    forces += [f_cap_a, f_cap_b, f_head, f_nail, f_palm]
    return torch.stack(forces, -2)


def _ext_forces(params: HammerParams):
    c = params.consts
    weight = 9.81 * params.model.mass[:HAMMER_BODY].sum()

    def fn(model, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, c.bodies, c.points)
        tau = apply(hammer_forces(pos, vel, params.kp, params.kd, params.mu, c))
        # the nail's dry friction, and the z slide carrying the hand's weight
        return torch.cat([tau[..., :2], tau[..., 2:3] + weight, tau[..., 3:NAIL_V],
                          tau[..., NAIL_V:] + nail_friction(qd[..., NAIL_V:])], -1)

    return fn


def hammer_frames(rots, poss, c: HammerConsts):
    """(palm pad, hammer origin, head, nail head) world positions [..., 3]
    from the bodies' frames."""
    palm = poss[..., 2, :] + (rots[..., 2, :, :] @ c.palm_local[:, None])[..., 0]
    hammer = poss[..., HAMMER_BODY, :]
    head = hammer + (rots[..., HAMMER_BODY, :, :] @ c.head_local[:, None])[..., 0]
    return palm, hammer, head, poss[..., NAIL_BODY, :]


def _frames(params: HammerParams, qpos):
    return hammer_frames(*rb.forward_kinematics(params.model, qpos), params.consts)


def hammer_reward(palm, hammer, head, nail, depth):
    """The hammer reward [...] from the frames of hammer_frames and the
    nail's depth -q_nail."""
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    zero = torch.zeros_like(depth)
    return (-0.1 * norm(palm - hammer) - norm(head - nail) + 2.0 * depth / NAIL_TRAVEL
            + torch.where(depth > 0.5 * NAIL_TRAVEL, zero + 25.0, zero)
            + torch.where(depth > 0.95 * NAIL_TRAVEL, zero + 75.0, zero))


def _init(params: HammerParams, seed: int) -> HammerState:
    device = params.kp.device
    gen = rng.generator(rng.derive_seed(seed, 0), device)
    hy = 0.12 * torch.rand((), generator=gen, device=device) - 0.06
    qpos = params.model.neutral_qpos().clone()
    qpos[2] = 0.18                                  # the hand raised
    qpos[HAMMER_Q] = -0.02                          # the hammer flat on the table
    qpos[HAMMER_Q + 1] = hy
    qpos[HAMMER_Q + 2] = HANDLE_R + 0.001
    return HammerState(qpos=qpos, qvel=torch.zeros(params.model.nv, device=device), timestep=rng.step_tensor(0, device))


def _observe(params: HammerParams, state: HammerState) -> torch.Tensor:
    palm, hammer, head, nail = _frames(params, state.qpos)
    return torch.cat([state.qpos[..., :N_ACT], state.qvel[..., :N_ACT], hammer,
                      state.qvel[..., HAMMER_Q:HAMMER_Q + 3], head, nail, palm - hammer,
                      head - nail, state.qpos[..., NAIL_Q:NAIL_Q + 1]], -1)


def _step(params: HammerParams, state: HammerState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    ctrl = torch.cat([ctrl, ctrl.new_zeros(ctrl.shape[:-1] + (7,))], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    reward = hammer_reward(*_frames(params, qpos), -qpos[..., NAIL_Q])
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: HammerParams, state: HammerState) -> torch.Tensor:
    return -state.qpos[..., NAIL_Q] > 0.95 * NAIL_TRAVEL


def held_qpos(qpos: torch.Tensor) -> torch.Tensor:
    """qpos with the hammer held level over the nail, its head 2 mm into the
    nail's head, and the hand on its handle: the palm over the handle's
    middle and the neutral fingertips 13 mm below the handle's axis, so that
    every finger sphere presses the handle from its side by 2-3 mm. The
    hand's motion then reaches the hammer, the strike the nail and the
    nail's dry friction its slide from the first substep: a start state
    for checks of the contact path."""
    q = qpos.clone()
    origin = NAIL_POS + np.array([-HEAD_LOCAL[0], 0.0, HEAD_R + NAIL_R - 0.002], np.float32)
    q[..., HAMMER_Q:HAMMER_Q + 3] = torch.as_tensor(origin, device=q.device)
    q[..., HAMMER_Q + 3:HAMMER_Q + 7] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=q.device)
    q[..., NAIL_Q] = 0.0
    # a neutral fingertip's height above the z slide: the knuckles less the
    # phalanges' drop
    tip_z = adroit.GRIP_BASES[0][2] - sum(dz for _, dz in adroit.SEGS_GRIP)
    q[..., 0] = float(origin[0])
    q[..., 1] = 0.0
    q[..., 2] = float(origin[2]) - 0.013 - tip_z
    return q


def strike_qvel(qvel: torch.Tensor) -> torch.Tensor:
    """qvel with the hand and the hammer moving down at 0.3 m/s: from
    held_qpos, a strike in progress, which drives the nail against its dry
    friction."""
    qd = qvel.clone()
    qd[..., 2] = -0.3
    qd[..., HAMMER_Q + 2] = -0.3
    return qd


def spin_state(qpos: torch.Tensor, qvel: torch.Tensor):
    """(qpos, qvel) with the hammer 0.1 above where held_qpos holds it,
    clear of the hand and the nail, spinning at (3, -2, 4) rad/s (body frame):
    its offset com couples the linear and angular equations, so the free
    body's motion tells the coupled 6x6 solve from the decoupled one."""
    q, qd = held_qpos(qpos).clone(), qvel.clone()
    q[..., HAMMER_Q + 2] = q[..., HAMMER_Q + 2] + 0.1
    qd[..., HAMMER_Q + 3:HAMMER_Q + 6] = torch.tensor([3.0, -2.0, 4.0], device=qd.device)
    return q, qd


def build_rollout(model: rb.ChainModel) -> fr.ForestRollout:
    """Kernel #6 with the hammer task (ops/forest_rollout.py): the arm and
    hand tree, the free hammer (the coupled 6x6 solve), the nail's slide,
    the 15 contact points of hammer_forces, the hand's weight and the
    nail's dry friction as joint torques and the hammer cost, 5 substeps
    per control step, actions on the arm's slides and the hand's hinges."""
    return fr.build_forest_rollout(model, _FRAME_SKIP, list(range(N_ACT)),
                                   fr.hammer_task(adroit.arm_hand_weight(model)))


def hammer_extras(params: HammerParams) -> torch.Tensor:
    """The kernel's extras [kp, kd, mu]."""
    return torch.stack([params.kp, params.kd, params.mu])


def _build_fused(params: HammerParams) -> dict:
    """Kernel #6 built from params.model (Env.build_fused)."""
    return dict(fused_rollout=forest_fused(build_rollout(params.model),
                                           lambda p, state: hammer_extras(p),
                                           dynamic_fields=("kp", "kd", "mu")))


def make(device="cuda") -> Env:
    device = torch.device(device)
    model = build_model(device)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    params = HammerParams(model=model, kp=t(800.0), kd=t(2.0), mu=t(1.2),
                          consts=constants(device))
    return Env(name="hammer-v0", d_obs=2 * N_ACT + 19, d_action=N_ACT,
               action_lows=torch.full((N_ACT,), -1.0, device=device),
               action_highs=torch.full((N_ACT,), 1.0, device=device),
               params=params, init=_init, step=_step, observe=_observe, device=device,
               success=_success, max_episode_steps=75, build_fused=_build_fused,
               **_build_fused(params))


from .randomize import register_names as _register_names  # noqa: E402

_register_names("hammer-v0",
                ["arm_x", "arm_y", "arm_z"] + adroit.hand_joint_names() + ["Object", "nail"],
                extra={"hammer": HAMMER_BODY})
