"""Sawyer-arm tasks: the pusher, the door and the peg-insertion family.

Counterpart of mjmpc_tpu/envs/sawyer_tasks.py: the reacher arm plus extra
bodies in the same kinematic forest (the parent table takes several
roots), with smooth spring and penalty forces mapped through point
Jacobians.

- sawyer_pusher-v0 (alias pusher-v0): the arm and a block on two slides
  from the world (x, then y; a sphere of radius 0.05 at z = 0); the hand
  sphere (radius 0.08, the wrist's origin) pushes the block by a
  sphere-sphere penalty force, -f on the hand and +f on the block; obs =
  [qpos(9), qvel(9), hand(3), block_xy - target(2), hand - block(3)];
  reward = -|hand - block| - 2 |block_xy - target|; success: the block
  within 0.05 of the target, drawn at the start from U([-0.25, -0.35],
  [0.25, 0.15]).
- sawyer_door-v0: the arm and a door on a vertical hinge (range [0,
  1.57]); a grab spring k_grab (hand - handle), gated on |hand - handle| <
  grab_radius, acts on the handle only (the hand feels nothing); obs =
  [qpos(8), qvel(8), hand - handle(3), target_angle - q_door]; reward =
  -2 |target_angle - q_door| - 0.5 |hand - handle|; success within 0.1
  rad of the target angle.
- sawyer_peg_insertion-v0: the arm with the site moved to the tip of a
  wrist-mounted peg (site_pos = (0.12, 0, 0) on the last body), guided
  into a hole: obs = [qpos(7), qvel(7), tip - entry(3), depth, lateral],
  where depth (along the hole axis, > 0 once inside) and lateral
  (off-axis distance) are taken from the sensed entry, entry +
  sensor_bias; reward = -|tip - bottom| - 5 * lateral * inserted +
  inserted, with inserted = clip(depth, 0, hole_depth) / hole_depth;
  success: depth > 0.8 hole_depth and lateral < 0.025; v1 is the
  sensed-target variant: the real hole sits at a fixed sensor offset from
  the nominal entry that v0's model does not know.

Fused rollouts: the pusher and the door plan on kernel #6
(ops/forest_rollout.py, the forest rollout) with their tasks, their force
laws and costs those of the env step (pusher_forces, door_forces and the
rewards below), their gains and targets in the extras. The peg plans on
the closed-loop-linear kernel (Reinforce) and the open-loop kernel with
observations, both with the peg task (ops/chain_rollout.py); its
costs-only open-loop slot is kernel #6 with the peg task: the arm alone,
no contact, the same peg cost. The rigid-body constants are baked.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..engine import chain as rb
from ..ops.chain_rollout import build_chain_cl_rollout, build_chain_obs_rollout
from ..ops.forest_rollout import (ForestRollout, build_forest_rollout, peg_task, pusher_task,
                                  sawyer_door_task)
from .base import Env, forest_fused
from .reacher_7dof import _BODIES as _ARM_BODIES
from .reacher_7dof import _DT, _FRAME_SKIP

_N_ARM = 7
D_OBS = 2 * _N_ARM + 5
_HOLE_ENTRY = (0.2, -0.25, -0.1)
_HOLE_AXIS = (0.0, 0.0, -1.0)
_HOLE_DEPTH = 0.08
V1_SENSOR_BIAS = (0.01, -0.012, 0.008)


@dataclasses.dataclass(frozen=True)
class PegParams:
    model: rb.ChainModel
    hole_entry: torch.Tensor    # [3] nominal (sensed) hole position
    hole_axis: torch.Tensor     # [3] unit, pointing into the hole
    hole_depth: torch.Tensor    # []
    sensor_bias: torch.Tensor   # [3] true-hole offset from the sensed one


@dataclasses.dataclass(frozen=True)
class PegState:
    qpos: torch.Tensor   # [..., 7]
    qvel: torch.Tensor   # [..., 7]
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


def _peg_model(device="cuda") -> rb.ChainModel:
    return rb.build_chain(list(_ARM_BODIES), dt=_DT, site_body=6,
                          site_pos=(0.12, 0.0, 0.0), device=device)


def _peg_init(params: PegParams, seed: int) -> PegState:
    device = params.hole_entry.device
    return PegState(qpos=torch.zeros(_N_ARM, device=device),
                    qvel=torch.zeros(_N_ARM, device=device), timestep=rng.step_tensor(0, device))


def _peg_metrics(params: PegParams, q: torch.Tensor):
    tip = rb.site_position(params.model, q)
    rel = tip - (params.hole_entry + params.sensor_bias)
    depth = rel @ params.hole_axis                  # > 0 once inside
    lateral = torch.linalg.vector_norm(rel - depth[..., None] * params.hole_axis, dim=-1)
    return tip, depth, lateral


def _observe(params: PegParams, state: PegState) -> torch.Tensor:
    tip, depth, lateral = _peg_metrics(params, state.qpos)
    return torch.cat([state.qpos, state.qvel, tip - params.hole_entry,
                      depth[..., None], lateral[..., None]], -1)


def _step(params: PegParams, state: PegState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl,
                         n_substeps=_FRAME_SKIP)
    new = PegState(qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    tip, depth, lateral = _peg_metrics(params, qpos)
    bottom = params.hole_entry + params.hole_depth * params.hole_axis
    inserted = (torch.minimum(torch.clamp(depth, min=0.0), params.hole_depth)
                / torch.clamp(params.hole_depth, min=1e-6))
    reward = (-torch.linalg.vector_norm(tip - bottom, dim=-1)
              - 5.0 * lateral * inserted + 1.0 * inserted)
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: PegParams, state: PegState) -> torch.Tensor:
    _, depth, lateral = _peg_metrics(params, state.qpos)
    return (depth > 0.8 * params.hole_depth) & (lateral < 0.025)


def peg_extras(params: PegParams) -> torch.Tensor:
    """The kernels' extras [entry 3, axis 3, hole depth, sensor bias 3]."""
    return torch.cat([params.hole_entry, params.hole_axis, params.hole_depth[None],
                      params.sensor_bias])


def build_rollout(model: rb.ChainModel) -> ForestRollout:
    """Kernel #6 with the peg task: the 7-joint arm, actions on every
    joint, 2 substeps per control step, the peg cost of the site."""
    return build_forest_rollout(model, _FRAME_SKIP, list(range(_N_ARM)), peg_task())


def _build_peg_fused(params: PegParams) -> dict:
    """Kernels #6, #3 and #4 built from params.model (Env.build_fused); the
    hole and the sensor bias ride the extras."""
    model = params.model
    roll_cl = build_chain_cl_rollout(model, n_substeps=_FRAME_SKIP, task="peg")
    roll_obs = build_chain_obs_rollout(model, n_substeps=_FRAME_SKIP, task="peg")
    fused = forest_fused(build_rollout(model), lambda p, state: peg_extras(p))

    def fused_cl(p: PegParams, state: PegState, weights, noise):
        return roll_cl(state.qpos, state.qvel, peg_extras(p), weights, noise)

    def fused_obs(p: PegParams, state: PegState, mean, noise):
        return roll_obs(state.qpos, state.qvel, peg_extras(p), mean, noise)

    fused_cl.kernel, fused_obs.kernel = roll_cl, roll_obs
    return dict(fused_rollout=fused, fused_cl_rollout=fused_cl, fused_obs_rollout=fused_obs)


def make_peg_insertion(device="cuda") -> Env:
    """sawyer_peg_insertion-v0 (max 100 steps)."""
    device = torch.device(device)
    model = _peg_model(device)
    t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    params = PegParams(model=model, hole_entry=t(_HOLE_ENTRY), hole_axis=t(_HOLE_AXIS),
                       hole_depth=t(_HOLE_DEPTH), sensor_bias=torch.zeros(3, device=device))
    return Env(
        name="sawyer_peg_insertion-v0", d_obs=D_OBS, d_action=_N_ARM,
        action_lows=torch.full((_N_ARM,), -1.0, device=device),
        action_highs=torch.full((_N_ARM,), 1.0, device=device),
        params=params, init=_peg_init, step=_step, observe=_observe,
        device=device, success=_success, max_episode_steps=100,
        build_fused=_build_peg_fused, **_build_peg_fused(params))


def make_peg_insertion_v1(device="cuda", sensor_bias=V1_SENSOR_BIAS) -> Env:
    """sawyer_peg_insertion-v1: v0 with the real hole at a fixed sensor
    offset; the same state type and kernels (the bias rides the extras)."""
    env = make_peg_insertion(device)
    bias = torch.as_tensor(sensor_bias, dtype=torch.float32, device=env.device)
    return dataclasses.replace(env, name="sawyer_peg_insertion-v1",
                               params=dataclasses.replace(env.params, sensor_bias=bias))


# ---------------------------------------------------------------------------
# pusher
# ---------------------------------------------------------------------------

HAND_BODY = 6                   # the hand sphere sits at the wrist's origin
BLOCK_BODY = _N_ARM + 1         # the block's y slide (its x slide is body 7)
HAND_R = 0.08
BLOCK_R = 0.05
BLOCK_BASE = (0.0, -0.1, 0.0)
PUSHER_D_OBS = 9 + 9 + 3 + 2 + 3
_UNLIMITED = (-1e6, 1e6)
PUSHER_BODIES = list(_ARM_BODIES) + [
    dict(pos=BLOCK_BASE, axis=(1, 0, 0), type="slide", range=_UNLIMITED, parent=-1,
         damping=2.0, geoms=[]),
    dict(pos=(0, 0, 0), axis=(0, 1, 0), type="slide", range=_UNLIMITED, parent=_N_ARM,
         damping=2.0, geoms=[rb.sphere_geom(BLOCK_R)]),
]
_PUSHER_TARGET_LOW = (-0.25, -0.35)
_PUSHER_TARGET_HIGH = (0.25, 0.15)


@dataclasses.dataclass(frozen=True)
class PusherParams:
    model: rb.ChainModel
    k_contact: torch.Tensor     # [] hand-block penalty stiffness
    bodies: torch.Tensor        # [2] int64 (HAND_BODY, BLOCK_BODY): made with the params,
                                # a step's contact points index them without a host copy


@dataclasses.dataclass(frozen=True)
class PusherState:
    qpos: torch.Tensor     # [..., 9] = 7 arm + block (x, y)
    qvel: torch.Tensor     # [..., 9]
    target: torch.Tensor   # [..., 2] the block's goal on the plane
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


def pusher_model(device="cuda") -> rb.ChainModel:
    return rb.build_chain(PUSHER_BODIES, dt=_DT, site_body=HAND_BODY,
                          site_pos=(0.0, 0.0, 0.0), device=device)


def pusher_forces(pos, k_contact):
    """World forces [..., 2, 3] on the hand and the block from their
    centres pos [..., 2, 3]: the sphere-sphere overlap's penalty k_contact
    * overlap along the centres' line, -f on the hand and +f on the block
    (the pusher task's force law, shared by the env step and the forest
    rollout's plain version)."""
    hand, block = pos[..., 0, :], pos[..., 1, :]
    diff = block - hand
    dist = torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + 1e-8
    overlap = (HAND_R + BLOCK_R) - dist
    fmag = torch.where(overlap > 0.0, k_contact * overlap, torch.zeros_like(overlap))
    f = fmag / dist * diff
    return torch.stack([-f, f], -2)


def pusher_reward(hand, block, target):
    """-|hand - block| - 2 |block_xy - target| [...]."""
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    return -norm(hand - block) - 2.0 * norm(block[..., :2] - target)


def _hand_and_block(model, q):
    _, poss = rb.forward_kinematics(model, q)
    return poss[..., HAND_BODY, :], poss[..., BLOCK_BODY, :]


def _pusher_ext_forces(params: PusherParams):
    points = torch.zeros(2, 3, device=params.k_contact.device)

    def fn(model, q, qd):
        pos, _, apply = rb.points_frame(model, q, qd, params.bodies, points)
        return apply(pusher_forces(pos, params.k_contact))

    return fn


def _pusher_init(params: PusherParams, seed: int) -> PusherState:
    device = params.k_contact.device
    gen = rng.generator(rng.derive_seed(seed, 0), device)
    lo = torch.tensor(_PUSHER_TARGET_LOW, device=device)
    hi = torch.tensor(_PUSHER_TARGET_HIGH, device=device)
    target = lo + (hi - lo) * torch.rand(2, generator=gen, device=device)
    return PusherState(qpos=torch.zeros(9, device=device), qvel=torch.zeros(9, device=device),
                       target=target, timestep=rng.step_tensor(0, device))


def _pusher_observe(params: PusherParams, state: PusherState) -> torch.Tensor:
    hand, block = _hand_and_block(params.model, state.qpos)
    return torch.cat([state.qpos, state.qvel, hand, block[..., :2] - state.target,
                      hand - block], -1)


def _pusher_step(params: PusherParams, state: PusherState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    ctrl = torch.cat([ctrl, ctrl.new_zeros(ctrl.shape[:-1] + (2,))], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP,
                         ext_force_fn=_pusher_ext_forces(params))
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    reward = pusher_reward(*_hand_and_block(params.model, qpos), state.target)
    return new, _pusher_observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _pusher_success(params: PusherParams, state: PusherState) -> torch.Tensor:
    _, block = _hand_and_block(params.model, state.qpos)
    return torch.linalg.vector_norm(block[..., :2] - state.target, dim=-1) < 0.05


def pusher_contact_qpos(model: rb.ChainModel, qpos: torch.Tensor) -> torch.Tensor:
    """qpos with the block beside the hand, 0.08 along x from the hand's
    centre on the plane z = 0, so that the hand and block spheres overlap
    by |hand_z| less than 0.05 and the contact force acts from the first
    substep: a start state for checks of the contact path."""
    q = qpos.clone()
    hand, _ = _hand_and_block(model, q)
    q[..., _N_ARM] = hand[..., 0] + 0.08 - BLOCK_BASE[0]
    q[..., _N_ARM + 1] = hand[..., 1] - BLOCK_BASE[1]
    return q


def pusher_extras(params: PusherParams, state: PusherState) -> torch.Tensor:
    """The kernel's extras [target 2, k_contact] ([B, 3] for B states)."""
    gain = params.k_contact.expand(state.target.shape[:-1] + (1,))
    return torch.cat([state.target, gain], -1)


def build_pusher_rollout(model: rb.ChainModel) -> ForestRollout:
    """Kernel #6 with the pusher task: the arm tree and the block's two
    slides, the hand-block contact, actions on the arm's joints, 2 substeps
    per control step."""
    return build_forest_rollout(model, _FRAME_SKIP, list(range(_N_ARM)), pusher_task())


def _build_pusher_fused(params: PusherParams) -> dict:
    """Kernel #6 built from params.model (Env.build_fused)."""
    return dict(fused_rollout=forest_fused(build_pusher_rollout(params.model), pusher_extras))


def make_pusher(device="cuda") -> Env:
    """sawyer_pusher-v0 (max 100 steps)."""
    device = torch.device(device)
    model = pusher_model(device)
    params = PusherParams(model=model, k_contact=torch.tensor(500.0, device=device),
                          bodies=rb.constant((HAND_BODY, BLOCK_BODY), device))
    return Env(name="sawyer_pusher-v0", d_obs=PUSHER_D_OBS, d_action=_N_ARM,
               action_lows=torch.full((_N_ARM,), -1.0, device=device),
               action_highs=torch.full((_N_ARM,), 1.0, device=device),
               params=params, init=_pusher_init, step=_pusher_step, observe=_pusher_observe,
               device=device, success=_pusher_success, max_episode_steps=100,
               build_fused=_build_pusher_fused, **_build_pusher_fused(params))


# ---------------------------------------------------------------------------
# door
# ---------------------------------------------------------------------------

DOOR_BODY = _N_ARM              # the door's hinge, body 7, qpos 7
DOOR_HINGE = (0.25, -0.05, 0.0)
HANDLE_LOCAL = (0.3, 0.0, 0.0)
DOOR_D_OBS = 8 + 8 + 3 + 1
DOOR_BODIES = list(_ARM_BODIES) + [
    dict(pos=DOOR_HINGE, axis=(0, 0, 1), range=(0.0, 1.57), parent=-1, damping=1.0,
         geoms=[rb.capsule_geom(0.02, (0, 0, 0, 0.3, 0, 0))]),
]


@dataclasses.dataclass(frozen=True)
class DoorParams:
    model: rb.ChainModel
    k_grab: torch.Tensor        # [] grab spring stiffness
    grab_radius: torch.Tensor   # [] the spring acts while |hand - handle| < it
    target_angle: torch.Tensor  # [] the door's goal angle
    handle_local: torch.Tensor  # [3] HANDLE_LOCAL, made with the params (no host copy a step)


@dataclasses.dataclass(frozen=True)
class DoorState:
    qpos: torch.Tensor     # [..., 8] = 7 arm + door hinge
    qvel: torch.Tensor     # [..., 8]
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


def door_model(device="cuda") -> rb.ChainModel:
    return rb.build_chain(DOOR_BODIES, dt=_DT, site_body=HAND_BODY,
                          site_pos=(0.0, 0.0, 0.0), device=device)


def handle_position(rots, poss, handle_local):
    """The handle's world position [..., 3] from the bodies' frames and
    HANDLE_LOCAL as a tensor."""
    return (poss[..., DOOR_BODY, :]
            + (rots[..., DOOR_BODY, :, :] @ handle_local[:, None])[..., 0])


def door_forces(pos, k_grab, grab_radius):
    """World forces [..., 2, 3] on the hand and the handle from their
    positions pos [..., 2, 3]: the grab spring k_grab (hand - handle) while
    |hand - handle| + 1e-8 < grab_radius, on the handle only; the hand
    gets none (the door task's force law, shared by the env step and the
    forest rollout's plain version)."""
    diff = pos[..., 0, :] - pos[..., 1, :]
    dist = torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + 1e-8
    gain = torch.where(dist < grab_radius, k_grab, torch.zeros_like(dist))
    return torch.stack([torch.zeros_like(diff), gain * diff], -2)


def door_reward(hand, handle, q_door, target_angle):
    """-2 |target_angle - q_door| - 0.5 |hand - handle| [...]."""
    return (-torch.abs(target_angle - q_door) * 2.0
            - 0.5 * torch.linalg.vector_norm(hand - handle, dim=-1))


def _door_points(model, q, handle_local):
    rots, poss = rb.forward_kinematics(model, q)
    return poss[..., HAND_BODY, :], handle_position(rots, poss, handle_local)


def _door_ext_forces(params: DoorParams):
    handle = params.handle_local

    def fn(model, q, qd):
        hand, handle_w = _door_points(model, q, handle)
        f = door_forces(torch.stack([hand, handle_w], -2), params.k_grab,
                        params.grab_radius)[..., 1, :]
        return rb.point_force_to_generalized(model, q, DOOR_BODY, handle, f)

    return fn


def _door_init(params: DoorParams, seed: int) -> DoorState:
    device = params.k_grab.device
    return DoorState(qpos=torch.zeros(8, device=device), qvel=torch.zeros(8, device=device),
                     timestep=rng.step_tensor(0, device))


def _door_observe(params: DoorParams, state: DoorState) -> torch.Tensor:
    hand, handle = _door_points(params.model, state.qpos, params.handle_local)
    return torch.cat([state.qpos, state.qvel, hand - handle,
                      (params.target_angle - state.qpos[..., DOOR_BODY])[..., None]], -1)


def _door_step(params: DoorParams, state: DoorState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    ctrl = torch.cat([ctrl, ctrl.new_zeros(ctrl.shape[:-1] + (1,))], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP,
                         ext_force_fn=_door_ext_forces(params))
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    hand, handle = _door_points(params.model, qpos, params.handle_local)
    reward = door_reward(hand, handle, qpos[..., DOOR_BODY], params.target_angle)
    return new, _door_observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _door_success(params: DoorParams, state: DoorState) -> torch.Tensor:
    return torch.abs(params.target_angle - state.qpos[..., DOOR_BODY]) < 0.1


def door_grab_state(params: DoorParams, qpos: torch.Tensor):
    """(params, qpos) with the grab radius widened to 1.0 (it rides the
    extras) and the door opened to 0.3 rad: the spring then pulls the
    handle toward the hand from the first substep and slams the door shut
    within a few steps, the hand's motion moving the door through it (at
    the start, 0.56 from the handle, the hand is far outside the nominal
    0.12). A start state for checks of the grab spring."""
    q = qpos.clone()
    q[..., DOOR_BODY] = 0.3
    return dataclasses.replace(params, grab_radius=torch.ones_like(params.grab_radius)), q


def door_extras(params: DoorParams) -> torch.Tensor:
    """The kernel's extras [k_grab, grab_radius, target_angle]."""
    return torch.stack([params.k_grab, params.grab_radius, params.target_angle])


def build_door_rollout(model: rb.ChainModel) -> ForestRollout:
    """Kernel #6 with the sawyer door task: the arm tree and the door's
    hinge, the grab spring on the handle, actions on the arm's joints, 2
    substeps per control step."""
    return build_forest_rollout(model, _FRAME_SKIP, list(range(_N_ARM)), sawyer_door_task())


def _build_door_fused(params: DoorParams) -> dict:
    """Kernel #6 built from params.model (Env.build_fused)."""
    return dict(fused_rollout=forest_fused(build_door_rollout(params.model),
                                           lambda p, state: door_extras(p)))


def make_door(device="cuda") -> Env:
    """sawyer_door-v0 (max 100 steps)."""
    device = torch.device(device)
    model = door_model(device)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    params = DoorParams(model=model, k_grab=t(60.0), grab_radius=t(0.12), target_angle=t(1.2),
                        handle_local=rb.constant(HANDLE_LOCAL, device))
    return Env(name="sawyer_door-v0", d_obs=DOOR_D_OBS, d_action=_N_ARM,
               action_lows=torch.full((_N_ARM,), -1.0, device=device),
               action_highs=torch.full((_N_ARM,), 1.0, device=device),
               params=params, init=_door_init, step=_door_step, observe=_door_observe,
               device=device, success=_door_success, max_episode_steps=100,
               build_fused=_build_door_fused, **_build_door_fused(params))


# Dynamics-randomization name tables: the names of the reference's
# dyn_randomize_configs/sawyer/*.yml (body_mass: object/peg,
# geom_friction: obj_cylinder/table, sensor_noise: target_pos).
from .reacher_7dof import BODY_NAMES as _ARM_BODY_NAMES  # noqa: E402
from .reacher_7dof import JOINT_NAMES as _ARM_JOINT_NAMES  # noqa: E402
from .randomize import register_names as _register_names  # noqa: E402
from .randomize import register_param_paths as _register_param_paths  # noqa: E402

for _n in ("sawyer_pusher-v0", "pusher-v0"):
    _register_names(_n, _ARM_BODY_NAMES + ["object_x", "object"],
                    _ARM_JOINT_NAMES + ["obj_slide_x", "obj_slide_y"],
                    extra={"obj_cylinder": _N_ARM + 1, "obj_sphere": _N_ARM + 1,
                           "table": _N_ARM})
for _n in ("sawyer_peg_insertion-v0", "sawyer_peg_insertion-v1"):
    # the peg is welded to the wrist (body 6): its mass rides that row
    _register_names(_n, _ARM_BODY_NAMES, _ARM_JOINT_NAMES, extra={"peg": 6})
    # sensor_noise: target_pos scales the true-hole sensor offset
    _register_param_paths(_n, {"sensor_noise": {"target_pos": "sensor_bias"}})
