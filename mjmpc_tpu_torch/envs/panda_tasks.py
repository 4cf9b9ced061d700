"""Panda task family: carry a glass on a wrist-mounted tray.

Counterpart of mjmpc_tpu/envs/panda_tasks.py: the 7-DOF reacher arm
carries a tray at the wrist; the glass rides two slide joints parented to
the wrist (body 6), so that it lives in the tray's own plane and the
whole model is one 9-DOF tree. Slide damping models the tray's friction;
tilting the tray loads the glass through the same generalized dynamics,
under gravity (0, 0, -9.81).

- feed-forward: the arm's joints get grad V(q) = -sum_i m_i g . dc_i/dq
  (the glass's slides none): a payload-calibrated gravity compensation,
  so that the motors shape the motion while the glass still slides
  downhill when the tray tilts;
- reward = -|tray - target| - 2 |glass offset| - fall_penalty once the
  glass is more than 0.12 (the tray's radius) from the tray's centre;
- success: the tray within 0.075 of the target and the glass on the tray;
- obs (24) = [qpos(9), qvel(9), tray - target(3), glass - tray(3)];
- v0 starts with the glass at the tray's centre and a target drawn from
  U([0.3, -0.85, -0.1], [0.8, -0.35, 0.3]); v1 halves the glass's slide
  damping (a slipperier tray) and starts the glass at a U(-0.05, 0.05)
  offset; fixed-v1 is v1 with the glass's slides clamped to [0, 0] (the
  glass welded to the tray): the biased planning model of
  configs/panda/tray_glass-v1_biased_model.yml, whose real env is v1.

The fused rollout is kernel #6 (ops/forest_rollout.py) with the tray task:
the feed-forward as its joint-torque hook, computed from the kernel's own
frames, and the cost of the reward above; the target and the fall penalty
ride its extras. Each variant bakes its own model, so each builds its own
kernel. The JAX package's dynamics-randomisation name tables wait for the
port of envs/randomize.py.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..engine import chain as rb
from ..ops import forest_rollout as fr
from .base import Env, forest_fused
from .reacher_7dof import _BODIES as _ARM_BODIES
from .reacher_7dof import _DT, _FRAME_SKIP

N_ARM = 7
TRAY_BODY = 6
GLASS_Q = N_ARM                 # the glass's x and y slides, qpos 7 and 8
TRAY_R = 0.12
GLASS_R = 0.03
TRAY_LOCAL = (0.03, 0.0, 0.09)  # the tray's centre on the wrist: the site
D_OBS = 9 + 9 + 3 + 3
_TARGET_LOW = (0.3, -0.85, -0.1)
_TARGET_HIGH = (0.8, -0.35, 0.3)
BODIES = list(_ARM_BODIES) + [
    # the glass slides in the wrist's (the tray's) x-y plane; the range only
    # stops runaway coordinates: falling off is the reward's business
    dict(pos=TRAY_LOCAL, axis=(1, 0, 0), type="slide", range=(-0.5, 0.5), parent=TRAY_BODY,
         damping=0.6, geoms=[]),
    dict(pos=(0, 0, 0), axis=(0, 1, 0), type="slide", range=(-0.5, 0.5), parent=N_ARM,
         damping=0.6, geoms=[rb.capsule_geom(GLASS_R, (0, 0, 0, 0, 0, 0.1))]),
]


@dataclasses.dataclass(frozen=True)
class TrayGlassParams:
    model: rb.ChainModel
    fall_penalty: torch.Tensor   # []


@dataclasses.dataclass(frozen=True)
class TrayGlassState:
    qpos: torch.Tensor     # [..., 9] = 7 arm + glass (tray-local x, y)
    qvel: torch.Tensor     # [..., 9]
    target: torch.Tensor   # [..., 3] the tray's goal position
    timestep: torch.Tensor   # int64, [] or the batch's leading dims


def build_model(device="cuda") -> rb.ChainModel:
    """v0's model: the arm, the tray's site and the glass's two slides."""
    return rb.build_chain(BODIES, dt=_DT, site_body=TRAY_BODY, site_pos=TRAY_LOCAL,
                          gravity=(0.0, 0.0, -9.81), device=device)


def v1_model(device="cuda") -> rb.ChainModel:
    """v1's model: v0's with the glass's slide damping halved."""
    model = build_model(device)
    damping = model.damping.clone()
    damping[N_ARM:] = damping[N_ARM:] * 0.5
    return dataclasses.replace(model, damping=damping)


def fixed_v1_model(device="cuda") -> rb.ChainModel:
    """fixed-v1's model: v1's with the glass's slides clamped to [0, 0]."""
    model = v1_model(device)
    low, high = model.qpos_low.clone(), model.qpos_high.clone()
    low[N_ARM:] = 0.0
    high[N_ARM:] = 0.0
    return dataclasses.replace(model, qpos_low=low, qpos_high=high)


def _tray_and_glass(model, q):
    rots, poss = rb.forward_kinematics(model, q)
    tray = poss[..., TRAY_BODY, :] + (rots[..., TRAY_BODY, :, :]
                                      @ model.site_pos[:, None])[..., 0]
    return tray, poss[..., N_ARM + 1, :]


def gravity_compensation(model: rb.ChainModel, q: torch.Tensor) -> torch.Tensor:
    """The arm's feed-forward [..., 9]: grad V(q) on the arm's joints, zero
    on the glass's slides."""
    # the rows of a batch are independent: the gradient of their sum is
    # each row's gradient
    grad = torch.func.grad(lambda qq: torch.sum(rb.potential_energy(model, qq)))(q)
    mask = torch.zeros(q.shape[-1], device=q.device)
    mask[:N_ARM].fill_(1.0)      # a device fill: a step stays capturable
    return grad * mask


def glass_offset(q: torch.Tensor) -> torch.Tensor:
    """The glass's distance from the tray's centre [...]."""
    return torch.linalg.vector_norm(q[..., GLASS_Q:GLASS_Q + 2], dim=-1)


def tray_reward(tray, target, slide, fall_penalty):
    """-|tray - target| - 2 slide - (fall_penalty once slide > TRAY_R) [...]."""
    off = slide > TRAY_R
    return (-torch.linalg.vector_norm(tray - target, dim=-1) - 2.0 * slide
            - torch.where(off, fall_penalty, torch.zeros_like(slide)))


def _draw_target(gen, device):
    lo = torch.tensor(_TARGET_LOW, device=device)
    hi = torch.tensor(_TARGET_HIGH, device=device)
    return lo + (hi - lo) * torch.rand(3, generator=gen, device=device)


def _init(params: TrayGlassParams, seed: int) -> TrayGlassState:
    device = params.fall_penalty.device
    gen = rng.generator(rng.derive_seed(seed, 0), device)
    return TrayGlassState(qpos=torch.zeros(9, device=device), qvel=torch.zeros(9, device=device),
                          target=_draw_target(gen, device), timestep=rng.step_tensor(0, device))


def _init_v1(params: TrayGlassParams, seed: int) -> TrayGlassState:
    """v1 starts with the glass displaced from the tray's centre."""
    device = params.fall_penalty.device
    gen = rng.generator(rng.derive_seed(seed, 0), device)
    target = _draw_target(gen, device)
    qpos = torch.zeros(9, device=device)
    qpos[GLASS_Q:] = 0.1 * torch.rand(2, generator=gen, device=device) - 0.05
    return TrayGlassState(qpos=qpos, qvel=torch.zeros(9, device=device), target=target,
                          timestep=rng.step_tensor(0, device))


def _observe(params: TrayGlassParams, state: TrayGlassState) -> torch.Tensor:
    tray, glass = _tray_and_glass(params.model, state.qpos)
    return torch.cat([state.qpos, state.qvel, tray - state.target, glass - tray], -1)


def _step(params: TrayGlassParams, state: TrayGlassState, action: torch.Tensor):
    ctrl = torch.clamp(action, -1.0, 1.0)
    ctrl = torch.cat([ctrl, ctrl.new_zeros(ctrl.shape[:-1] + (2,))], -1)
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl, n_substeps=_FRAME_SKIP,
                         ext_force_fn=lambda model, q, qd: gravity_compensation(model, q))
    new = dataclasses.replace(state, qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    tray, _ = _tray_and_glass(params.model, qpos)
    reward = tray_reward(tray, state.target, glass_offset(qpos), params.fall_penalty)
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: TrayGlassParams, state: TrayGlassState) -> torch.Tensor:
    tray, _ = _tray_and_glass(params.model, state.qpos)
    return ((torch.linalg.vector_norm(tray - state.target, dim=-1) < 0.075)
            & (glass_offset(state.qpos) < TRAY_R))


def fallen_qpos(qpos: torch.Tensor) -> torch.Tensor:
    """qpos with the glass at (0.2, 0.02) in the tray's plane, 0.201 from its
    centre: past the tray's edge by more than the arm's motion slides it back
    in a few steps, so that the fall penalty is live from the first step (a
    start state for checks of the gated cost)."""
    q = qpos.clone()
    q[..., GLASS_Q] = 0.2
    q[..., GLASS_Q + 1] = 0.02
    return q


def tray_extras(params: TrayGlassParams, state: TrayGlassState) -> torch.Tensor:
    """The kernel's extras [target 3, fall_penalty] ([B, 4] for B states)."""
    penalty = params.fall_penalty.expand(state.target.shape[:-1] + (1,))
    return torch.cat([state.target, penalty], -1)


def build_rollout(model: rb.ChainModel) -> fr.ForestRollout:
    """Kernel #6 with the tray task (ops/forest_rollout.py): the 9-DOF tree,
    the arm's gravity feed-forward as the joint-torque hook, the tray cost,
    2 substeps per control step, actions on the arm's joints."""
    return fr.build_forest_rollout(model, _FRAME_SKIP, list(range(N_ARM)), fr.tray_task(model))


def _build_fused(params: TrayGlassParams) -> dict:
    """Kernel #6 built from params.model (Env.build_fused)."""
    return dict(fused_rollout=forest_fused(build_rollout(params.model), tray_extras))


def _make(model: rb.ChainModel, name: str, init, max_episode_steps: int) -> Env:
    device = model.device
    params = TrayGlassParams(model=model, fall_penalty=torch.tensor(5.0, device=device))
    return Env(name=name, d_obs=D_OBS, d_action=N_ARM,
               action_lows=torch.full((N_ARM,), -1.0, device=device),
               action_highs=torch.full((N_ARM,), 1.0, device=device),
               params=params, init=init, step=_step, observe=_observe, device=device,
               success=_success, max_episode_steps=max_episode_steps,
               build_fused=_build_fused, **_build_fused(params))


def make(device="cuda") -> Env:
    """panda_tray_glass-v0 (max 100 steps)."""
    return _make(build_model(torch.device(device)), "panda_tray_glass-v0", _init, 100)


def make_v1(device="cuda") -> Env:
    """panda_tray_glass-v1 (max 75 steps): the slipperier tray, the glass
    displaced at the start."""
    return _make(v1_model(torch.device(device)), "panda_tray_glass-v1", _init_v1, 75)


def make_fixed_v1(device="cuda") -> Env:
    """panda_tray_glass_fixed-v1 (max 75 steps): v1 with the glass welded
    to the tray; the same state type as v1, so that it plans for v1."""
    return _make(fixed_v1_model(torch.device(device)), "panda_tray_glass_fixed-v1", _init_v1,
                 75)


# tray_collision / glass_collision are the reference's geom names
# (dyn_randomize_configs/panda/tray_glass-v1.yml); geom friction maps onto
# the glass slides' viscous damping rows of the chain.
from .randomize import register_names as _register_names  # noqa: E402
from .reacher_7dof import BODY_NAMES as _ARM_BODY_NAMES  # noqa: E402
from .reacher_7dof import JOINT_NAMES as _ARM_JOINT_NAMES  # noqa: E402

for _name in ("panda_tray_glass-v0", "panda_tray_glass-v1", "panda_tray_glass_fixed-v1"):
    _register_names(_name, _ARM_BODY_NAMES + ["glass_x", "glass"],
                    _ARM_JOINT_NAMES + ["glass_slide_x", "glass_slide_y"],
                    extra={"tray_collision": N_ARM, "glass_collision": N_ARM + 1})
