"""pen-v0: in-hand pen reorientation with the 24-DOF dexterous hand.

Counterpart of mjmpc_tpu/envs/pen.py: the Adroit-counterpart hand of
envs/adroit.py (2-DOF wrist, three 4-DOF fingers, a 5-DOF little finger
and a 5-DOF thumb) and a FREE pen (7 qpos: position and unit quaternion,
wxyz; 6 qvel: linear and body-frame angular velocity), moved only through
frictional contact: actions actuate the hand's 24 hinges. One kinematic
forest, nq = 31, nv = 30, dt 0.002 x frame_skip 5.

- contact: the 10 finger spheres (tip and mid of each distal phalanx)
  against the pen capsule and the palm plane z = 0, the pen's capsule
  ends against the palm plane, and the pen against the static cradle
  ridge it see-saws on (12 points, one batched engine.chain.points_frame
  pass per substep). Only the finger-on-pen forces react onto the pen;
  the ridge's force splits between the capsule ends by its weight s;
- reward = -|pen - desired_pos| + axis . desired, +10 and +50 bonuses at
  axis . desired > 0.90 and > 0.95 while the pen is within 0.075 of its
  rest position, -5 once the pen's horizontal distance exceeds 0.15;
- success: axis . desired > 0.90 and within 0.075 of the rest position;
- obs (69): hand qpos (24), hand qvel (24), pen position, linear
  velocity, long axis, angular velocity, desired axis, axis - desired,
  position - rest position;
- the desired long axis: yaw and pitch of e_x drawn from U(-1, 1) rad
  with an explicit torch.Generator.

The fused rollout is kernel #6 (ops/forest_rollout.py, the forest rollout
with the pen task): kp, kd, mu and the pen radius ride its extras and are
read at call time (`dynamic_fields`); the rigid-body constants are baked.
The JAX package's dynamics-randomisation name tables wait for the port of
envs/randomize.py.

State = PenState(qpos, qvel, desired, timestep), with leading batch
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
_FRAME_SKIP = 5              # control dt 10 ms
PEN_R = 0.012
PEN_HL = 0.065               # half-length
PEN_BODY = adroit.N_HAND_BODIES          # body index 24
PEN_Q = adroit.N_HAND_DOF                # qpos and qvel offset 24
N_TIPS = 2 * adroit.N_DIGITS             # tip and mid sphere per digit

# The static palm cradle: a ridge capsule across y at x = 0, raised so that
# the full +-1 rad pitch envelope stays clear of the palm plane.
RIDGE_R = 0.012
RIDGE_A = np.array([0.0, -0.12, 0.048], np.float32)
RIDGE_B = np.array([0.0, 0.12, 0.048], np.float32)
REST_Z = 0.048 + RIDGE_R + PEN_R         # pen centre at rest: 0.072
DESIRED_POS = np.array([0.0, 0.0, REST_Z], np.float32)


@dataclasses.dataclass(frozen=True)
class PenParams:
    model: rb.ChainModel
    kp: torch.Tensor     # contact normal stiffness (scalar)
    kd: torch.Tensor     # contact normal damping (scalar)
    mu: torch.Tensor     # friction coefficient (scalar)
    pen_r: torch.Tensor  # pen capsule radius (contact only; the inertia is baked)
    consts: "PenConsts"  # the task's fixed geometry on the params' device


@dataclasses.dataclass(frozen=True)
class PenState:
    qpos: torch.Tensor      # [..., 31] = 24 hand hinges + pen (pos 3, quat 4)
    qvel: torch.Tensor      # [..., 30]
    desired: torch.Tensor   # [..., 3] unit target of the pen's long axis
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


BODIES, DIGITS = adroit.hand_bodies()
BODIES.append(dict(
    pos=(0.0, 0.0, 0.0), type="free", parent=-1, damping=0.005, armature=0.0, gear=0.0,
    geoms=[rb.capsule_geom(PEN_R, (-PEN_HL, 0, 0, PEN_HL, 0, 0))]))

# Contact points: (tip, mid) of each digit's distal body, then the pen
# capsule's two ends.
C_BODIES = tuple(int(b) for (b, _, _) in DIGITS for _ in range(2)) + (PEN_BODY, PEN_BODY)
C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in DIGITS]
    + [np.array([[-PEN_HL, 0, 0], [PEN_HL, 0, 0]], np.float32)]).astype(np.float32)
C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)


class PenConsts(NamedTuple):
    """The task's fixed geometry as tensors, made once with the params
    (constants) so that a step copies nothing from the host."""
    bodies: torch.Tensor        # [12] int64, C_BODIES
    points: torch.Tensor        # [12, 3] C_POINTS
    radii: torch.Tensor         # [10] C_RADII
    ridge_a: torch.Tensor       # [3] RIDGE_A
    ridge_b: torch.Tensor       # [3] RIDGE_B
    desired_pos: torch.Tensor   # [3] DESIRED_POS


def constants(device) -> PenConsts:
    return PenConsts(*(rb.constant(v, device) for v in (C_BODIES, C_POINTS, C_RADII, RIDGE_A,
                                                         RIDGE_B, DESIRED_POS)))


def build_model(device="cuda") -> rb.ChainModel:
    """The hand and free-pen ChainModel on `device`."""
    return rb.build_chain(BODIES, dt=_DT, site_body=PEN_BODY, site_pos=(0.0, 0.0, 0.0),
                          gravity=(0.0, 0.0, -9.81), device=device)


def pen_forces(pos, vel, kp, kd, mu, pen_r, c: PenConsts):
    """World forces [..., 12, 3] at the contact points from their world
    positions and velocities [..., 12, 3] (the pen task's force law, shared
    by the env's step and the forest rollout's plain version)."""
    ridge_a, ridge_b, radii = c.ridge_a, c.ridge_b, c.radii
    cap_a, cap_b = pos[..., N_TIPS, :], pos[..., N_TIPS + 1, :]
    vcap_a, vcap_b = vel[..., N_TIPS, :], vel[..., N_TIPS + 1, :]
    f_cap_a = contact.sphere_plane_force(cap_a, vcap_a, pen_r, kp, kd, mu)
    f_cap_b = contact.sphere_plane_force(cap_b, vcap_b, pen_r, kp, kd, mu)
    # the pen on the static cradle ridge
    f_ridge, sr = contact.capsule_capsule_force(cap_a, cap_b, vcap_a, vcap_b, pen_r,
                                                ridge_a, ridge_b, RIDGE_R, kp, kd, mu)
    f_cap_a = f_cap_a + (1.0 - sr)[..., None] * f_ridge
    f_cap_b = f_cap_b + sr[..., None] * f_ridge
    forces = []
    for k in range(N_TIPS):
        p, v = pos[..., k, :], vel[..., k, :]
        f_pen, t = contact.sphere_segment_force(p, v, radii[k], cap_a, cap_b, vcap_a, vcap_b,
                                                pen_r, kp, kd, mu)
        # only the finger-on-pen force reacts onto the pen; the palm's push
        # on a finger belongs to the palm
        f_cap_a = f_cap_a - (1.0 - t)[..., None] * f_pen
        f_cap_b = f_cap_b - t[..., None] * f_pen
        # the palm keeps fingers from punching through z = 0
        forces.append(f_pen + contact.sphere_plane_force(p, v, radii[k], kp, kd, mu))
    forces += [f_cap_a, f_cap_b]
    return torch.stack(forces, -2)


def _ext_forces(params: PenParams):
    c = params.consts

    def fn(model, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, c.bodies, c.points)
        return apply(pen_forces(pos, vel, params.kp, params.kd, params.mu, params.pen_r, c))

    return fn


def _pen_frame(qpos, qvel):
    """(pen centre, long axis, linear velocity, body angular velocity)."""
    axis = rb._quat_to_mat(qpos[..., PEN_Q + 3:PEN_Q + 7])[..., :, 0]
    return (qpos[..., PEN_Q:PEN_Q + 3], axis, qvel[..., PEN_Q:PEN_Q + 3],
            qvel[..., PEN_Q + 3:PEN_Q + 6])


def pen_reward(pen_pos, axis, desired, desired_pos):
    """The pen reward [...] from the pen's centre and long axis, the
    desired axis and the rest position DESIRED_POS as a tensor (dense
    position and similarity terms, staged bonuses at 0.90 and 0.95
    similarity, a drop penalty)."""
    pos_err = torch.linalg.vector_norm(pen_pos - desired_pos, dim=-1)
    orien = torch.sum(axis * desired, -1)
    close = pos_err < 0.075
    dropped = torch.linalg.vector_norm(pen_pos[..., :2], dim=-1) > 0.15
    zero = torch.zeros_like(orien)
    return (-pos_err + orien
            + torch.where(close & (orien > 0.90), zero + 10.0, zero)
            + torch.where(close & (orien > 0.95), zero + 50.0, zero)
            - torch.where(dropped, zero + 5.0, zero))


def sample_desired(gen: torch.Generator, device) -> torch.Tensor:
    """Target long axis [3]: yaw and pitch of e_x, each U(-1, 1) rad."""
    a, b = 2.0 * torch.rand(2, generator=gen, device=device) - 1.0
    return torch.stack([torch.cos(a) * torch.cos(b), torch.sin(a) * torch.cos(b), -torch.sin(b)])


def _init(params: PenParams, seed: int) -> PenState:
    device = params.kp.device
    qpos = params.model.neutral_qpos().clone()
    qpos[PEN_Q + 2] = REST_Z                       # balanced on the cradle
    return PenState(qpos=qpos, qvel=torch.zeros(params.model.nv, device=device),
                    desired=sample_desired(rng.generator(rng.derive_seed(seed, 0), device),
                                           device),
                    timestep=rng.step_tensor(0, device))


def _observe(params: PenParams, state: PenState) -> torch.Tensor:
    pen_pos, axis, lin_vel, ang_vel = _pen_frame(state.qpos, state.qvel)
    n = adroit.N_HAND_DOF
    desired_pos = params.consts.desired_pos
    return torch.cat([state.qpos[..., :n], state.qvel[..., :n], pen_pos, lin_vel, axis,
                      ang_vel, state.desired, axis - state.desired, pen_pos - desired_pos], -1)


def _step(params: PenParams, state: PenState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    ctrl = torch.cat([ctrl, ctrl.new_zeros(ctrl.shape[:-1] + (6,))], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    pen_pos, axis, _, _ = _pen_frame(qpos, qvel)
    reward = pen_reward(pen_pos, axis, state.desired, params.consts.desired_pos)
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: PenParams, state: PenState) -> torch.Tensor:
    pen_pos, axis, _, _ = _pen_frame(state.qpos, state.qvel)
    close = (torch.linalg.vector_norm(pen_pos - params.consts.desired_pos, dim=-1)
             < 0.075)
    return (torch.sum(axis * state.desired, -1) > 0.90) & close


def pinch_qpos(qpos: torch.Tensor, curl: float = 0.08) -> torch.Tensor:
    """qpos with every digit's three phalanx curls set to `curl` rad toward
    the pen's resting line: each tip sphere then sits 6 mm and each mid
    sphere 2.4 mm deep in a resting pen, so that the hand's motion reaches
    the pen (and its cost) through contact from the first substep. A start
    state for checks of the contact path."""
    q = qpos.clone()
    for d, (_, _, _, side) in enumerate(adroit.digit_bases()):
        q[..., adroit.digit_curl_indices(d)] = -side * curl
    return q


def build_rollout(model: rb.ChainModel) -> fr.ForestRollout:
    """Kernel #6 with the pen task (ops/forest_rollout.py): the wrist-rooted
    24-DOF hand tree, the free pen, the 12 contact points of pen_forces and
    the pen cost, 5 substeps per control step, actions on the hand's
    hinges."""
    return fr.build_forest_rollout(model, _FRAME_SKIP, list(range(adroit.N_HAND_DOF)),
                                   fr.pen_task())


def pen_extras(params: PenParams, state: PenState) -> torch.Tensor:
    """The kernel's extras [desired 3, kp, kd, mu, pen_r] ([B, 7] for B
    states)."""
    gains = torch.stack([params.kp, params.kd, params.mu, params.pen_r])
    return torch.cat([state.desired, gains.expand(state.desired.shape[:-1] + gains.shape)], -1)


def _build_fused(params: PenParams) -> dict:
    """Kernel #6 built from params.model (Env.build_fused)."""
    # kp, kd, mu and pen_r are read at call time, through extras: planning
    # against params that differ from the env's only in these keeps the
    # fused path
    return dict(fused_rollout=forest_fused(build_rollout(params.model), pen_extras,
                                           dynamic_fields=("kp", "kd", "mu", "pen_r")))


def make(device="cuda") -> Env:
    # kp and kd sized for the light distal links at dt = 0.002: the explicit
    # contact damper needs kd dt / m_eff << 2
    device = torch.device(device)
    model = build_model(device)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    params = PenParams(model=model, kp=t(800.0), kd=t(2.0), mu=t(1.2), pen_r=t(PEN_R),
                       consts=constants(device))
    n = adroit.N_HAND_DOF
    return Env(name="pen-v0", d_obs=2 * n + 21, d_action=n,
               action_lows=torch.full((n,), -1.0, device=device),
               action_highs=torch.full((n,), 1.0, device=device),
               params=params, init=_init, step=_step, observe=_observe, device=device,
               success=_success, max_episode_steps=75, build_fused=_build_fused,
               **_build_fused(params))


from .randomize import (register_names as _register_names,  # noqa: E402
                        register_param_paths as _register_param_paths)

# the reference dyn-randomize names (hand/pen-v0.yml): Object = the pen
# body, pen = its geom
_register_names("pen-v0", adroit.hand_joint_names() + ["Object"], extra={"pen": PEN_BODY})
# geom_friction / geom_size perturb the contact model's own leaves; both
# ride the kernel's extras (dynamic_fields)
_register_param_paths("pen-v0", {"geom_friction": {"pen": "mu"},
                                 "geom_size": {"pen": "pen_r"}})
