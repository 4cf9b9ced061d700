"""Fused rollouts of a scalar-joint chain: kernel wrappers and their plain
PyTorch version.

Counterpart of mjmpc_tpu/ops/pallas_chain.py build_chain_rollout (costs
only), build_chain_obs_rollout (costs and per-step observations),
build_chain_cl_rollout (closed-loop-linear: observations, the policy
product u = W^T [obs; 1] + eps, actions and costs) and
build_chain_ext_rollout (the locomotion rollout: external forces in every
substep, a velocity limit and a step cost per control step). The kernels
are csrc/chain_rollout.cu's four entries, each a team of lanes per
particle with its state in shared memory (csrc/chain_team.cuh, work tables
from team_schedule): the closed-loop and locomotion rollouts at
DEFAULT_TEAM lanes, the costs and obs rollouts at the size open_loop_team
picks from N and the card's SM count. The model constants, the task and
the team's tables are compile-time constants in a header generated here
from the ChainModel, one library per team size.

Semantics (identical to the Pallas builders): for every particle b and
step t, the action is held for n_substeps semi-implicit Euler substeps
(FK, Jacobian-composed mass matrix with armature + dt*damping on the
diagonal, zero-qdd RNEA bias, Cholesky solve of M qdd = gear*u - bias -
damping*qd - stiffness*q - frictionloss*tanh(50 qd), then the joint-limit
clamp with qd zeroed where clamped), and cost[b, t] is the task's cost of
the post-step state. Open loop, u = clip(mean[t] + noise[b, t]); closed
loop, a = W^T [obs_b(t); 1] + noise[b, t] is recorded before the clip and
u = clip(a). obs[b, t] is the observation of the pre-step state (the
state entering step t).

Tasks (chosen when a wrapper is built; `extras` carries their data):
- reacher: extras = target [3]; obs [q, qd, site, site - target],
  d_obs = 2 nv + 6; cost l1 + 5 * sqrt(|d|^2 + 1e-12), d = site - target.
- peg: extras = [hole entry 3, hole axis 3, hole depth, sensor bias 3];
  obs [q, qd, tip - entry, depth, lateral], d_obs = 2 nv + 5, with depth
  and lateral taken from the sensed (biased) entry; cost the depth-progress
  insertion cost (envs/sawyer_tasks.py).

Locomotion tasks (ExtTask, external-force mode; mean and noise carry all
nv dofs, the unactuated base dofs as zeros):
- capsule drag (the swimmer): anisotropic quadratic drag at sample points
  along x-aligned capsule links, |qd| clamped per dof after each control
  step; cost 1e-4 sum u^2 - (x_out - x_in) / control dt.
- ground contact (the half cheetah): spring-damper normal force below
  z = radius and tanh-saturated Coulomb friction at body-local points;
  cost 0.1 sum u^2 - (x_out - x_in) / control dt.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, ClassVar, Tuple, Union

import numpy as np
import torch

from ..engine import chain
from ..engine.chain import ChainModel
from ..kernels import build


# ---------------------------------------------------------------------------
# Plain PyTorch version, batched over particles: q, qd, u are [N, nv]. FK
# and the Jacobian-composed mass matrix are the engine's (engine/chain.py);
# the bias is a hand RNEA, as in the kernel.
# ---------------------------------------------------------------------------

def _mass_and_bias(model: ChainModel, fk, qd):
    """Mass matrix [N, nv, nv] by Jacobian composition and the RNEA bias
    [N, nv] at zero qdd: a forward velocity/acceleration recursion from
    the root, then a backward force recursion (oracle.cpp bias_impl,
    scalar joints)."""
    rots, poss, axes, _ = fk
    m = chain.mass_from_fk(model, *fk)
    rc = torch.einsum("...nij,nj->...ni", rots, model.com)         # R c
    iw = torch.einsum("...nab,nbc,...ndc->...nad", rots, model.inertia, rots)
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    mv = lambda mat, v: (mat @ v[..., None])[..., 0]
    zero = torch.zeros_like(poss[..., 0, :])
    w, dw, ao, fc, nc = [], [], [], [], []
    for i in range(model.n_joints):
        pi = model.parent[i]
        wp, dwp, ap, pp = ((w[pi], dw[pi], ao[pi], poss[..., pi, :]) if pi >= 0
                           else (zero, zero, zero, zero))
        r = poss[..., i, :] - pp
        a = axes[..., i, :] * qd[..., i, None]
        wj, vj = (a, zero) if model.joint_types[i] == "hinge" else (zero, a)
        w.append(wp + wj)
        dw.append(dwp + cross(wp, wj))
        ao.append(ap + cross(dwp, r)
                  + (cross(wp, cross(wp, r)) + 2.0 * cross(wp, vj)))
        rci = rc[..., i, :]
        acc_c = ao[i] + (cross(dw[i], rci) + cross(w[i], cross(w[i], rci)))
        fc.append(model.mass[i] * (acc_c - model.gravity))
        nc.append(mv(iw[..., i, :, :], dw[i])
                  + cross(w[i], mv(iw[..., i, :, :], w[i])))
    bias = [None] * model.n_joints
    fa = [zero] * model.n_joints
    na = [zero] * model.n_joints
    for i in range(model.n_joints - 1, -1, -1):
        pi = model.parent[i]
        f = fc[i] + fa[i]
        nmom = nc[i] + cross(rc[..., i, :], fc[i]) + na[i]
        moment = nmom if model.joint_types[i] == "hinge" else f
        bias[i] = torch.sum(axes[..., i, :] * moment, dim=-1)
        if pi >= 0:
            fa[pi] = fa[pi] + f
            na[pi] = na[pi] + (nmom + cross(poss[..., i, :] - poss[..., pi, :], f))
    return m, torch.stack(bias, -1)


def _chol_solve(m, rhs):
    """Solve the SPD systems m [N, nv, nv] x = rhs [N, nv]."""
    chol = torch.linalg.cholesky_ex(m).L
    return torch.cholesky_solve(rhs[..., None], chol)[..., 0]


def _substep(model: ChainModel, q, qd, u, fk, ext=None):
    """One semi-implicit Euler substep from fk = chain.fk_dofs(model, q);
    `ext` [N, nv] are external generalized forces added to the rhs."""
    m, bias = _mass_and_bias(model, fk, qd)
    m = m + torch.diag(model.armature + model.dt * model.damping)
    rhs = (model.gear * u - bias - model.damping * qd - model.stiffness * q
           - model.frictionloss * torch.tanh(qd * 50.0))
    if ext is not None:
        rhs = rhs + ext
    qd_new = qd + model.dt * _chol_solve(m, rhs)
    q_new = q + model.dt * qd_new
    clamped = torch.clamp(q_new, model.qpos_low, model.qpos_high)
    return clamped, torch.where(clamped == q_new, qd_new, torch.zeros_like(qd_new))


def _site(model: ChainModel, fk):
    """World position of the model's site [N, 3]."""
    rots, poss, _, _ = fk
    sb = model.site_body
    return poss[..., sb, :] + rots[..., sb, :, :] @ model.site_pos


def _reacher_obs(model: ChainModel, fk, q, qd, extras):
    """[q, qd, site, site - target] (envs/reacher_7dof.py _observe)."""
    site = _site(model, fk)
    return torch.cat([q, qd, site, site - extras], -1)


def _reacher_cost(model: ChainModel, fk, extras):
    """l1 + 5 * l2 of (site - target), l2 smoothed by 1e-12 under the
    square root."""
    diff = _site(model, fk) - extras
    l2 = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    return torch.sum(torch.abs(diff), dim=-1) + 5.0 * l2


def _peg_sensed(tip, extras):
    """Depth along the hole axis and lateral offset [N] of the tip from the
    sensed entry (entry + bias)."""
    entry, axis, bias = extras[0:3], extras[3:6], extras[7:10]
    rel = tip - (entry + bias)
    depth = torch.sum(rel * axis, dim=-1)
    off = rel - depth[..., None] * axis
    return depth, torch.sqrt(torch.sum(off * off, dim=-1) + 1e-12)


def _peg_obs(model: ChainModel, fk, q, qd, extras):
    """[q, qd, tip - entry, depth, lateral] (envs/sawyer_tasks.py _peg_obs;
    the third block uses the unbiased entry)."""
    tip = _site(model, fk)
    depth, lateral = _peg_sensed(tip, extras)
    return torch.cat([q, qd, tip - extras[0:3], depth[..., None], lateral[..., None]], -1)


def _peg_cost(model: ChainModel, fk, extras):
    """The depth-progress insertion cost, _peg_step's reward negated:
    |tip - bottom| + 5 * lateral * inserted - inserted."""
    tip = _site(model, fk)
    depth, lateral = _peg_sensed(tip, extras)
    entry, axis, hole_depth = extras[0:3], extras[3:6], extras[6]
    d = tip - (entry + hole_depth * axis)
    inserted = (torch.minimum(torch.clamp(depth, min=0.0), hole_depth)
                / torch.clamp(hole_depth, min=1e-6))
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12) + 5.0 * lateral * inserted - inserted


@dataclasses.dataclass(frozen=True)
class ChainTask:
    """A chain task: its observation and cost in the plain version, the
    kernel's task type (model::TASK selects csrc/chain_rollout.cuh's
    Reacher or Peg) and its operation counts, taken from that source as
    written (a multiply, an add, a compare or a transcendental is one)."""
    name: str
    index: int          # model::TASK in the generated header
    n_extras: int
    obs_extra: int      # d_obs = 2 nv + obs_extra
    obs: Callable       # (model, fk, q, qd, extras) -> [N, d_obs]
    cost: Callable      # (model, fk, extras) -> [N]
    obs_ops: int        # per observation
    cost_ops: int       # per cost

    def d_obs(self, nv: int) -> int:
        return 2 * nv + self.obs_extra


# site_of: a 3x3 matrix-vector product (15) and an add (3) = 18.
# Reacher obs: site + site - target (3) = 21; cost: site, d (3), l1 (5),
# l2 (7), l1 + 5 l2 (2) = 35. Peg: sensed = entry + bias, rel, depth (5),
# off (6), lateral (7) = 24; obs: tip + sensed + tip - entry (3) = 45;
# cost: tip + sensed + bottom (6) + d (3) + its norm (7) + inserted (4) +
# the sum (4) = 66.
REACHER = ChainTask("reacher", 0, 3, 6, _reacher_obs, _reacher_cost, 21, 35)
PEG = ChainTask("peg", 1, 10, 5, _peg_obs, _peg_cost, 45, 66)
TASKS = {t.name: t for t in (REACHER, PEG)}


def _task(task: Union[str, ChainTask]) -> ChainTask:
    if isinstance(task, ChainTask):
        return task
    if task not in TASKS:
        raise ValueError(f"unknown chain task {task!r}; known: {sorted(TASKS)}")
    return TASKS[task]


def rollout_plain(model: ChainModel, n_substeps: int, ulow: float, uhigh: float,
                  q0, qd0, extras, ctrl, noise, mode: str = "costs",
                  task: Union[str, ChainTask] = REACHER):
    """Plain PyTorch rollout. ctrl is the mean [H, nv] ("costs", "obs") or
    the policy W [d_obs + 1, nv] ("cl"). Returns costs [N, H] ("costs"),
    (obs [N, H, d_obs], costs) ("obs") or (obs, pre-clip actions
    [N, H, nv], costs) ("cl"). The state after step t is the state before
    step t + 1, so one FK serves that step's cost, the next step's obs and
    the next step's first substep (as in the kernel)."""
    task = _task(task)
    n, horizon, nv = noise.shape
    q = q0.expand(n, nv)
    qd = qd0.expand(n, nv)
    fk = chain.fk_dofs(model, q)
    costs, obs, acts = [], [], []
    for t in range(horizon):
        if mode == "costs":
            a = ctrl[t] + noise[:, t]
        else:
            o = task.obs(model, fk, q, qd, extras)
            obs.append(o)
            if mode == "cl":
                a = o @ ctrl[:-1] + ctrl[-1] + noise[:, t]
                acts.append(a)
            else:
                a = ctrl[t] + noise[:, t]
        u = torch.clamp(a, ulow, uhigh)
        q, qd = _substep(model, q, qd, u, fk)
        for _ in range(n_substeps - 1):
            q, qd = _substep(model, q, qd, u, chain.fk_dofs(model, q))
        fk = chain.fk_dofs(model, q)
        costs.append(task.cost(model, fk, extras))
    costs = torch.stack(costs, 1)
    if mode == "costs":
        return costs
    if mode == "obs":
        return torch.stack(obs, 1), costs
    return torch.stack(obs, 1), torch.stack(acts, 1), costs


def _physics_flops(model: ChainModel):
    """(fk, substep) operations of one particle (a multiply, an add, a
    compare or a transcendental is one; the chain's topology as the header
    bakes it): what the function needs, once each, as a single thread would
    compute it (FK, the Jacobian-composed mass matrix, the RNEA bias, the
    Cholesky solve and the Euler step). The team kernel
    (csrc/chain_team.cuh) repeats some to save a phase (the upper FK levels
    that a tree's branches share, on each branch's lane); that is not
    counted."""
    add, dot, cross, mv, mm = 3, 5, 9, 15, 45
    rodrigues = 2 + 1 + 3 * 3 + 6 * 4        # sin, cos, 1-c, 9 entries
    world_inertia = mm + 9 * 5
    hinge = [t == "hinge" for t in model.joint_types]
    anc = model.ancestor_mask()
    nb = model.n_joints
    fk = 0
    for i in range(nb):
        root = model.parent[i] < 0
        if hinge[i]:
            fk += (0 if root else mv + add + mm) + rodrigues + mv
        else:
            fk += (0 if root else mv + add + mv) + add + add
    mass = 0
    for i in range(nb):
        mass += mv + add + world_inertia                      # rc, ci, iw
        mass += sum(cross + add for d in range(i + 1) if anc[i, d] and hinge[d])
        for a in range(i + 1):
            for b in range(a, i + 1):
                if anc[i, a] and anc[i, b]:
                    mass += 1 + dot + 1 + ((dot + mv + 1) if hinge[a] and hinge[b] else 0)
    bias_fwd = nb * (add + add + add + (add + cross) + (4 * cross + add + 3 * add)
                     + (3 * cross + 2 * add) + 2 * add + (2 * mv + cross + add))
    bias_bwd = sum(add + (cross + 2 * add) + dot
                   + ((add + cross + 3 * add) if model.parent[i] >= 0 else 0)
                   for i in range(nb))
    friction = int((model.frictionloss.detach().cpu().numpy() != 0).sum())
    rest = nb * (1 + 6 + 7) + 4 * friction
    chol = nb * (nb + 1) * (2 * nb + 1) // 6 + 2 * nb * nb
    return fk, mass + bias_fwd + bias_bwd + rest + chol


def rollout_flops(model: ChainModel, n_substeps: int, n: int, horizon: int,
                  mode: str = "costs", task: Union[str, ChainTask] = REACHER) -> int:
    """Floating-point operations of one kernel call, what the function
    needs once each (_physics_flops; the task's d_obs and its obs and cost
    counts). Used for the card-time bound: the work is the same for every
    input."""
    task = _task(task)
    fk, substep = _physics_flops(model)
    nb = model.n_joints
    if mode == "cl":    # per action: bias + eps, d_obs products and sums, clip
        act = nb * (1 + 2 * task.d_obs(nb) + 2)
    else:               # per action: mean + eps, clip
        act = 3 * nb
    obs = 0 if mode == "costs" else task.obs_ops
    step = n_substeps * (substep + fk) + task.cost_ops + act + obs
    return n * (fk + horizon * step)


def rollout_bytes(nv: int, n: int, horizon: int, mode: str = "costs",
                  task: Union[str, ChainTask] = REACHER) -> int:
    """Bytes one kernel call must move: q0, qd0, extras, the mean (or W)
    and the noise in; costs (and obs, and actions) out, f32."""
    task = _task(task)
    d_obs = task.d_obs(nv)
    nh = n * horizon
    ctrl = (d_obs + 1) * nv if mode == "cl" else horizon * nv
    out = nh * (1 + (0 if mode == "costs" else d_obs) + (nv if mode == "cl" else 0))
    return 4 * (2 * nv + task.n_extras + ctrl + nh * nv + out)


# ---------------------------------------------------------------------------
# The locomotion (external-force) rollout's plain version and work counts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CapsuleDrag:
    """Slender-body quadratic drag on x-aligned capsule links (the swimmer,
    pallas_chain.py make_capsule_drag): at each sample point s along link
    l's axis, F = -c_perp/2 min(|v_n|, vcap) v_n - c_par/2 min(|v_t|, vcap) v_t."""
    link_bodies: Tuple[int, ...]
    sample_offsets: Tuple[float, ...]
    drag_perp: Tuple[float, ...]    # per link
    drag_par: Tuple[float, ...]     # per link
    vcap: float = 4.0

    def points(self):
        """(bodies, offsets, halved perpendicular and parallel coefficients)
        per sample point, link-major, as f32 numpy."""
        ns = len(self.sample_offsets)
        half = lambda c: [np.float32(0.5 * np.float32(x)) for x in c for _ in range(ns)]
        return ([b for b in self.link_bodies for _ in range(ns)],
                np.asarray(list(self.sample_offsets) * len(self.link_bodies), np.float32),
                np.asarray(half(self.drag_perp), np.float32),
                np.asarray(half(self.drag_par), np.float32))


@dataclasses.dataclass(frozen=True)
class GroundContact:
    """Planar compliant ground contact at body-local points (the half
    cheetah, pallas_chain.py make_ground_contact): below z = radius a normal
    force max(kp depth - kd v_z, 0) and friction -mu f_n tanh(v_x / slip_vel)."""
    bodies: Tuple[int, ...]
    points: Tuple[Tuple[float, float, float], ...]   # body-local
    radius: float
    kp: float
    kd: float
    mu: float
    slip_vel: float = 0.1


@dataclasses.dataclass(frozen=True)
class ExtTask:
    """A locomotion task of the external-force kernel: its force law, and
    the step cost ctrl_weight * sum_{j >= U0} u_j^2 - (x_out - x_in) *
    inv_dt (the env's negated reward; x is dof 0)."""
    name: str
    force: Union[CapsuleDrag, GroundContact]
    ctrl_weight: float
    inv_dt: float
    U0: ClassVar[int] = 3     # the first actuated dof, after the planar base's three

    @property
    def index(self) -> int:
        """model::TASK and CHAIN_EXT_TASK of the generated header: 2 builds
        csrc/chain_rollout.cuh's Swimmer (capsule drag), 3 its Cheetah
        (ground contact)."""
        return 2 if isinstance(self.force, CapsuleDrag) else 3


def _point_jac_cols(model: ChainModel, fk, bodies, pts):
    """Translational point-Jacobian columns [N, K, nv, 3] of world points
    pts [N, K, 3] on `bodies` (K indices): a_d x (p - o_d) for a hinge d,
    a_d for a slide, zero for joints that do not move the body
    (pallas_chain.py _point_jac_cols)."""
    _, _, axes, origins = fk
    anc, rot = model._masks
    mask = anc[list(bodies)]                                   # [K, nv, 1]
    arm = pts[..., :, None, :] - origins[..., None, :, :]     # [N, K, nv, 3]
    ax = axes[..., None, :, :].expand(arm.shape)
    return (rot * torch.linalg.cross(ax, arm, dim=-1) + (1.0 - rot) * ax) * mask


def capsule_drag(model: ChainModel, fk, qd, law: CapsuleDrag):
    """Generalized drag forces [N, nv] of the swimmer's capsule links."""
    rots, poss, _, _ = fk
    bodies, offsets, c_perp, c_par = law.points()
    t = lambda a: torch.as_tensor(a, device=qd.device)
    axis = rots[..., bodies, :, 0]                            # R e_x  [N, K, 3]
    pts = poss[..., bodies, :] + t(offsets)[:, None] * axis
    cols = _point_jac_cols(model, fk, bodies, pts)
    v = torch.einsum("...d,...kdc->...kc", qd, cols)
    v_ax = torch.sum(v * axis, dim=-1)
    v_par = v_ax[..., None] * axis
    v_perp = v - v_par
    n_perp = torch.sqrt(torch.sum(v_perp * v_perp, dim=-1))
    force = ((-t(c_perp) * torch.clamp(n_perp, max=law.vcap))[..., None] * v_perp
             + (-t(c_par) * torch.clamp(torch.abs(v_ax), max=law.vcap))[..., None] * v_par)
    return torch.einsum("...kdc,...kc->...d", cols, force)


def ground_contact(model: ChainModel, fk, qd, law: GroundContact):
    """Generalized contact forces [N, nv] of the cheetah's contact points."""
    rots, poss, _, _ = fk
    bodies = list(law.bodies)
    pts_local = torch.as_tensor(np.asarray(law.points, np.float32), device=qd.device)
    pts = poss[..., bodies, :] + torch.einsum("...kij,kj->...ki", rots[..., bodies, :, :],
                                              pts_local)
    cols = _point_jac_cols(model, fk, bodies, pts)
    v = torch.einsum("...d,...kdc->...kc", qd, cols)
    f32 = lambda x: float(np.float32(x))
    depth = f32(law.radius) - pts[..., 2]
    push = torch.clamp(f32(law.kp) * depth - f32(law.kd) * v[..., 2], min=0.0)
    fn = torch.where(depth > 0.0, push, torch.zeros_like(push))
    ft = -f32(law.mu) * fn * torch.tanh(v[..., 0] * f32(1.0 / law.slip_vel))
    return torch.einsum("...kd,...k->...d", cols[..., 0], ft) + torch.einsum(
        "...kd,...k->...d", cols[..., 2], fn)


def _ext_forces(model: ChainModel, fk, qd, task: ExtTask):
    law = task.force
    if isinstance(law, CapsuleDrag):
        return capsule_drag(model, fk, qd, law)
    return ground_contact(model, fk, qd, law)


def loco_step_cost(task: ExtTask, q_in, q_out, u):
    """The step cost [N] of (state in, state out, clipped action [N, nv])."""
    ctrl = torch.sum(u[..., task.U0:] * u[..., task.U0:], dim=-1)
    fwd = (q_out[..., 0] - q_in[..., 0]) * float(np.float32(task.inv_dt))
    return float(np.float32(task.ctrl_weight)) * ctrl - fwd


def rollout_ext_plain(model: ChainModel, n_substeps: int, task: ExtTask, vel_limit,
                      ulow: float, uhigh: float, q0, qd0, mean, noise):
    """Plain PyTorch locomotion rollout: costs [N, H] of mean [H, nv] +
    noise [N, H, nv] from (q0, qd0). Every substep takes FK, the task's
    external forces at that substep's state, then the semi-implicit Euler
    step; after a control step's substeps |qd| <= vel_limit [nv] (None: no
    limit); costs of (state in, state out, u)."""
    n, horizon, nv = noise.shape
    q = q0.expand(n, nv)
    qd = qd0.expand(n, nv)
    costs = []
    for t in range(horizon):
        u = torch.clamp(mean[t] + noise[:, t], ulow, uhigh)
        q_in = q
        for _ in range(n_substeps):
            fk = chain.fk_dofs(model, q)
            q, qd = _substep(model, q, qd, u, fk, _ext_forces(model, fk, qd, task))
        if vel_limit is not None:
            qd = torch.minimum(torch.maximum(qd, -vel_limit), vel_limit)
        costs.append(loco_step_cost(task, q_in, q, u))
    return torch.stack(costs, 1)


def ext_force_flops(model: ChainModel, task: ExtTask) -> int:
    """Operations of one particle's external forces (csrc/chain_team.cuh
    point_terms and gather_tau): per point its world position, the Jacobian
    columns (12 per hinge ancestor), the velocity (6 per ancestor), the
    force law and its terms on the dofs with their sums (6 per ancestor for
    drag: a dot and an add; 4 for contact)."""
    anc = model.ancestor_mask()
    hinge = np.array([t == "hinge" for t in model.joint_types])
    law = task.force
    if isinstance(law, CapsuleDrag):
        bodies = law.points()[0]
        per_point, per_anc = 6 + 31, 6 + 6      # p; v_ax, v_par, v_perp, norms, force
    else:
        bodies = list(law.bodies)
        per_point, per_anc = 18 + 1 + 4 + 2 + 4, 6 + 4   # p; depth, push, fn, ft
    total = 0
    for b in bodies:
        total += per_point + 12 * int((anc[b] * hinge).sum()) + per_anc * int(anc[b].sum())
    return total


def ext_rollout_flops(model: ChainModel, n_substeps: int, n: int, horizon: int,
                      task: ExtTask, vel_limit: bool) -> int:
    """Operations of one external-force kernel call: per control step the
    action (3 per dof), n_substeps of FK, forces, their addition to the rhs
    and the substep, the velocity limit (2 per dof) and the step cost."""
    fk, substep = _physics_flops(model)
    nb = model.n_joints
    sub = fk + ext_force_flops(model, task) + nb + substep
    cost = 2 * (nb - task.U0) + 4
    step = 3 * nb + n_substeps * sub + (2 * nb if vel_limit else 0) + cost
    return n * horizon * step


def ext_rollout_bytes(nv: int, n: int, horizon: int) -> int:
    """Bytes one external-force kernel call must move: q0, qd0, the mean
    and the noise in, costs out, f32."""
    return 4 * (2 * nv + horizon * nv + n * horizon * nv + n * horizon)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _f(x) -> str:
    return f"{float(np.float32(x)):.9e}f"


def _array(name: str, ctype: str, values, fmt) -> str:
    arr = np.asarray(values)
    dims = "".join(f"[{d}]" for d in arr.shape)
    idx = ", ".join(f"int i{k}" for k in range(arr.ndim))
    sub = "".join(f"[i{k}]" for k in range(arr.ndim))

    def init(a):
        if a.ndim == 0:
            return fmt(a)
        return "{" + ", ".join(init(x) for x in a) + "}"

    return (f"__host__ __device__ constexpr {ctype} {name}({idx}) {{\n"
            f"    constexpr {ctype} v{dims} = {init(arr)};\n"
            f"    return v{sub};\n}}\n")


def _loco_header(task: ExtTask, vel_limit, nv: int) -> list:
    """The locomotion constants (namespace loco) of an ExtTask's header."""
    i = lambda v: str(int(v))
    law = task.force
    limit = np.zeros(nv, np.float32) if vel_limit is None else np.asarray(vel_limit, np.float32)
    lines = [
        "namespace loco {",
        f"constexpr int U0 = {int(task.U0)};",
        f"constexpr float CTRL_WEIGHT = {_f(task.ctrl_weight)};",
        f"constexpr float INV_DT = {_f(task.inv_dt)};",
        f"constexpr bool HAS_VEL_LIMIT = {'false' if vel_limit is None else 'true'};",
        _array("vel_limit", "float", limit, _f),
    ]
    if isinstance(law, CapsuleDrag):
        lines += [
            f"constexpr int N_LINKS = {len(law.link_bodies)};",
            f"constexpr int N_SAMPLES = {len(law.sample_offsets)};",
            f"constexpr float VCAP = {_f(law.vcap)};",
            _array("link_body", "int", list(law.link_bodies), i),
            _array("sample", "float", np.asarray(law.sample_offsets, np.float32), _f),
            _array("drag_perp", "float",   # halved, as the force law uses them
                   [np.float32(0.5 * np.float32(c)) for c in law.drag_perp], _f),
            _array("drag_par", "float",
                   [np.float32(0.5 * np.float32(c)) for c in law.drag_par], _f),
        ]
    else:
        lines += [
            f"constexpr int N_CONTACTS = {len(law.bodies)};",
            f"constexpr float RADIUS = {_f(law.radius)};",
            f"constexpr float KP = {_f(law.kp)};",
            f"constexpr float KD = {_f(law.kd)};",
            f"constexpr float MU = {_f(law.mu)};",
            f"constexpr float INV_SLIP = {_f(1.0 / law.slip_vel)};",
            _array("contact_body", "int", list(law.bodies), i),
            _array("contact_point", "float", np.asarray(law.points, np.float32), _f),
        ]
    return lines + ["}  // namespace loco"]


# A particle's lanes in the closed-loop and locomotion rollouts (#4, #5;
# csrc/chain_team.cuh): a whole warp, for every chain up to 15 dofs.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): 32
# lanes beat 8 and 16 on the peg's N=64 (0.254 / 0.352 / 0.294 ms), the
# swimmer's and the cheetah's N=512; at the reacher's N=4096, where four
# particles a warp issue fewer instructions, 8 lanes take 0.445 ms against
# 0.825 (a team chosen from N for #4 is still open).
DEFAULT_TEAM = 32
# The team sizes the kernel takes (lanes of one warp).
TEAM_SIZES = (4, 8, 16, 32)


def open_loop_team(n: int, sm_count: int) -> int:
    """Lanes per particle of the costs and obs rollouts (#1, #3) over n
    particles on a card of sm_count SMs. While the particles are few
    against the SMs, warps are to spare and more lanes shorten each
    particle's chain: a whole warp up to 4 particles per SM. As they grow,
    fewer lanes put more particles in each warp, so the card issues fewer
    instructions per particle: 16 lanes up to 24 per SM, 8 up to 48. Past
    that the 8-lane launch no longer fits the card at once (its costs
    kernel takes 153 registers a thread, so an SM holds 12 of its one-warp
    blocks, 48 particles) and 16 lanes win again. From a sweep of 4-32
    lanes over N = 64 to 8192 on an H100 of 132 SMs (tools/kernel_ab.py
    --sweep; PERF.md §6): within 4% of the fastest team size at
    every N measured. The team size changes no bit of the result."""
    per_sm = n / max(1, sm_count)
    if per_sm <= 4:
        return 32
    if per_sm <= 24:
        return 16
    if per_sm <= 48:
        return 8
    return 16


def _point_bodies(task) -> list:
    """The body of each contact point of an ExtTask's force law, in the
    kernel's point order (none for the other tasks)."""
    if not isinstance(task, ExtTask):
        return []
    law = task.force
    return list(law.points()[0] if isinstance(law, CapsuleDrag) else law.bodies)


def team_schedule(model: ChainModel, team: int, point_bodies=()) -> dict:
    """The work tables of a team of `team` lanes per particle, as the
    generated header carries them (csrc/chain_team.cuh says which phase
    reads which). Item x of a list of items goes to lane x % team in round
    x // team; an empty place holds -1.

    - branches: for every leaf its root path, FK's walk on one lane; the
      first branch through a body stores it;
    - runs: the RNEA's backward pass, from each leaf or branching body up
      to below the next branching body, in segments that run one after
      the other (a run's children in earlier segments), each body's
      children in decreasing order;
    - slots: (body i, its k-th ancestor d) for the Jacobian columns of i's
      com;
    - entries: the mass entries (a, b), a on b's root path, longest sums
      (the bodies below b) first, so that a round's lanes sum about as many
      terms;
    - points: each contact point's body, depth and root path (4 bits a
      level), and for every dof the points that it moves.

    The tree must have one root, body 0, parents before children and each
    subtree contiguous (the bodies below b are b .. end(b) - 1)."""
    n, par = model.n_joints, [int(p) for p in model.parent]
    if team not in (4, 8, 16, 32):
        raise ValueError(f"team must be 4, 8, 16 or 32 lanes, not {team}")
    if n > 15 or len(point_bodies) > 32:
        raise ValueError("the team kernel takes at most 15 dofs and 32 contact points")
    if par[0] != -1 or any(not 0 <= par[i] < i for i in range(1, n)):
        raise ValueError(f"the team kernel needs one root, body 0, and parents first: {par}")
    paths = []
    for i in range(n):
        path, k = [i], par[i]
        while k >= 0:
            path.append(k)
            k = par[k]
        paths.append(path[::-1])
    depth = [len(path) - 1 for path in paths]
    levels = max(depth) + 1
    if levels > 8:
        raise ValueError("the team kernel takes trees of at most 8 levels")
    children = [[k for k in range(n - 1, -1, -1) if par[k] == i] for i in range(n)]
    end = []
    for i in range(n):
        below = [k for k in range(n) if i in paths[k]]
        if below != list(range(i, i + len(below))):
            raise ValueError(f"the bodies below {i} are not contiguous: {below}")
        end.append(i + len(below))
    branches = [paths[i] for i in range(n) if not children[i]]
    owner = {}
    for b_, path in enumerate(branches):
        for i in path:
            owner.setdefault(i, b_)
    fk_body = [[path[lv] if lv < len(path) else -1 for lv in range(levels)]
               for path in branches]
    fk_store = [[int(lv < len(path) and owner[path[lv]] == b_) for lv in range(levels)]
                for b_, path in enumerate(branches)]
    runs = []
    for head in range(n):
        if len(children[head]) == 1:
            continue
        run, x = [head], head
        while par[x] >= 0 and len(children[par[x]]) == 1:
            x = par[x]
            run.append(x)
        runs.append(run)
    run_of = {i: k for k, run in enumerate(runs) for i in run}

    def segment(k):
        head = runs[k][0]
        return 1 + max(segment(run_of[c]) for c in children[head]) if children[head] else 0

    segs = [segment(k) for k in range(len(runs))]
    segments = [[runs[k] for k in range(len(runs)) if segs[k] == sg] for sg in range(max(segs) + 1)]
    if len(segments) > 3:
        raise ValueError("the team kernel takes at most three segments of RNEA runs")
    n_runs = max(len(sg) for sg in segments)
    run_len = max(len(run) for run in runs)
    max_children = max(1, max(len(c) for c in children))
    run_body = [[(sg[r] + [-1] * run_len)[:run_len] if r < len(sg) else [-1] * run_len
                 for r in range(n_runs)] for sg in segments]
    run_child = [[[(children[i] + [-1] * max_children)[:max_children] if i >= 0
                   else [-1] * max_children for i in row] for row in sg] for sg in run_body]

    def deal(items, pad):
        rounds = max(1, -(-len(items) // team))
        return [[items[r * team + l] if r * team + l < len(items) else pad
                 for l in range(team)] for r in range(rounds)]

    slots = deal([(i, k, d) for i in range(n) for k, d in enumerate(paths[i])], (-1, 0, 0))
    pairs = sorted(((a, b_) for b_ in range(n) for a in paths[b_]),
                   key=lambda e: (-(end[e[1]] - e[1]), e[1], e[0]))
    entries = deal([(a, b_, depth[a], depth[b_], end[b_]) for a, b_ in pairs], (-1, 0, 0, 0, 0))
    points = deal([(p, b_, depth[b_], sum(d << (4 * k) for k, d in enumerate(paths[b_])))
                   for p, b_ in enumerate(point_bodies)], (-1, 0, 0, 0))
    dof_points = [sum(1 << p for p, b_ in enumerate(point_bodies) if i in paths[b_])
                  for i in range(n)]
    return dict(team=team, depth=depth, levels=levels, fk_body=fk_body,
                fk_store=fk_store, run_body=run_body, run_child=run_child, slots=slots,
                entries=entries, points=points, dof_points=dof_points,
                n_points=len(point_bodies),
                hinge_mask=sum(1 << i for i, t in enumerate(model.joint_types) if t == "hinge"))


def _team_header(sched: dict) -> list:
    """The team namespace of the generated header (team_schedule)."""
    i = lambda v: str(int(v))
    u = lambda v: f"{int(v)}u"
    col = lambda table, k: [[item[k] for item in row] for row in table]
    return [
        "namespace team {",
        f"constexpr int TEAM = {sched['team']};  // a particle's lanes",
        f"constexpr int MAXD = {sched['levels']};  // levels of the tree",
        f"constexpr unsigned HINGE_MASK = {sched['hinge_mask']}u;",
        f"constexpr int N_BRANCHES = {len(sched['fk_body'])};",
        f"constexpr int N_SEGMENTS = {len(sched['run_body'])};",
        f"constexpr int N_RUNS = {len(sched['run_body'][0])};",
        f"constexpr int RUN_LEN = {len(sched['run_body'][0][0])};",
        f"constexpr int MAX_CHILDREN = {len(sched['run_child'][0][0][0])};",
        f"constexpr int SLOT_ROUNDS = {len(sched['slots'])};",
        f"constexpr int ENTRY_ROUNDS = {len(sched['entries'])};",
        f"constexpr int N_POINTS = {sched['n_points']};",
        f"constexpr int POINT_ROUNDS = {len(sched['points']) if sched['n_points'] else 0};",
        _array("depth", "int", sched["depth"], i),
        _array("fk_body", "int", sched["fk_body"], i),
        _array("fk_store", "int", sched["fk_store"], i),
        _array("run_body", "int", sched["run_body"], i),
        _array("run_child", "int", sched["run_child"], i),
        _array("slot_i", "int", col(sched["slots"], 0), i),
        _array("slot_k", "int", col(sched["slots"], 1), i),
        _array("slot_d", "int", col(sched["slots"], 2), i),
        _array("entry_a", "int", col(sched["entries"], 0), i),
        _array("entry_b", "int", col(sched["entries"], 1), i),
        _array("entry_ka", "int", col(sched["entries"], 2), i),
        _array("entry_kb", "int", col(sched["entries"], 3), i),
        _array("entry_end", "int", col(sched["entries"], 4), i),
        _array("entry_terms", "int", [max([e[4] - e[1] for e in row if e[0] >= 0] or [0])
                                      for row in sched["entries"]], i),
        _array("point_p", "int", col(sched["points"], 0), i),
        _array("point_body", "int", col(sched["points"], 1), i),
        _array("point_depth", "int", col(sched["points"], 2), i),
        _array("point_anc", "unsigned", col(sched["points"], 3), u),
        _array("dof_points", "unsigned", sched["dof_points"], u),
        "}  // namespace team",
    ]


def model_header(model: ChainModel, n_substeps: int, ulow: float,
                 uhigh: float, task: Union[str, ChainTask, ExtTask] = REACHER,
                 vel_limit=None) -> str:
    """C++ header of the model's constants, the task and the work tables of
    a team of DEFAULT_TEAM lanes (team_schedule) for csrc/chain_rollout.cu;
    an ExtTask adds CHAIN_EXT_TASK and its constants (force law, step cost,
    the per-dof velocity limit `vel_limit`, None for none)."""
    return _model_header(model, n_substeps, ulow, uhigh, task, vel_limit, DEFAULT_TEAM)


def _model_header(model: ChainModel, n_substeps: int, ulow: float, uhigh: float, task,
                  vel_limit, team: int) -> str:
    """model_header for a team of `team` lanes (ChainRollout's header for
    each team size; the tests)."""
    npf = lambda t: t.detach().cpu().numpy().astype(np.float32)
    task = task if isinstance(task, ExtTask) else _task(task)
    n = model.n_joints
    i = lambda v: str(int(v))
    arrays = [
        ("parent", "int", list(model.parent), i),
        ("jtype", "int", [0 if t == "hinge" else 1 for t in model.joint_types], i),
        ("ancestor", "int", model.ancestor_mask().astype(np.int64), i),
        ("axis", "float", npf(model.joint_axis), _f),
        ("body_pos", "float", npf(model.body_pos), _f),
        ("mass", "float", npf(model.mass), _f),
        ("com", "float", npf(model.com), _f),
        ("inertia", "float", npf(model.inertia).reshape(n, 9), _f),
        ("armature", "float", npf(model.armature), _f),
        ("damping", "float", npf(model.damping), _f),
        ("frictionloss", "float", npf(model.frictionloss), _f),
        ("stiffness", "float", npf(model.stiffness), _f),
        ("gear", "float", npf(model.gear), _f),
        ("qlow", "float", npf(model.qpos_low), _f),
        ("qhigh", "float", npf(model.qpos_high), _f),
        ("gravity", "float", npf(model.gravity), _f),
        ("site_pos", "float", npf(model.site_pos), _f),
    ]
    lines = [
        "// Generated by mjmpc_tpu_torch/ops/chain_rollout.py from a ChainModel.",
        "#pragma once",
    ]
    if isinstance(task, ExtTask):
        lines.append(f"#define CHAIN_EXT_TASK {task.index}")
    lines += [
        "namespace model {",
        f"constexpr int N = {n};",
        f"constexpr int N_SUBSTEPS = {int(n_substeps)};",
        f"constexpr int SITE_BODY = {int(model.site_body)};",
        f"constexpr int TASK = {task.index};  // {task.name}",
        f"constexpr float DT = {_f(model.dt)};",
        f"constexpr float ULOW = {_f(ulow)};",
        f"constexpr float UHIGH = {_f(uhigh)};",
    ]
    lines += [_array(*a) for a in arrays]
    lines.append("}  // namespace model")
    if isinstance(task, ExtTask):
        lines += _loco_header(task, vel_limit, n)
    lines += _team_header(team_schedule(model, team, _point_bodies(task)))
    return "\n".join(lines) + "\n"


def _vp(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_args(args: dict, nv: int, shapes) -> dict:
    """Raise unless every argument is a float32 tensor on the noise's
    device, the noise is [N>=1, H>=1, nv] and the others have the shapes
    that shapes(H) gives by name."""
    noise = args["noise"]
    for name, x in args.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != noise.device:
            raise ValueError(f"{name} is on {x.device}, noise on {noise.device}")
    if noise.dim() != 3 or noise.shape[2] != nv or noise.shape[0] < 1 or noise.shape[1] < 1:
        raise ValueError(f"noise must be [N>=1, H>=1, {nv}], got {tuple(noise.shape)}")
    for name, shape in shapes(noise.shape[1]).items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(args[name].shape)}")
    return args


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


class ChainRollout:
    """rollout(q0 [nv], qd0 [nv], extras [n_extras], mean [H, nv],
    noise [N, H, nv]) -> costs [N, H], all float32 on one device; extras
    is the task's (the reacher's target [3]).

    The kernel runs a team of lanes per particle. Its size is team_for(N):
    for the costs and obs rollouts open_loop_team(N, the card's SM count),
    32 lanes up to 4 particles per SM, 16 up to 24, 8 up to 48, 16 above
    (on an H100's 132 SMs: 32 up to N=528, 16 to 3168, 8 to 6336); for the
    closed loop DEFAULT_TEAM. Each size has its library, built at its first
    launch; the size changes no bit of the result.

    `batch` runs B such rollouts (B starts, extras and means, noise
    [B, N, H, nv]) in one launch over B N particles, at team_for(B N)
    lanes; element b equals the single rollout of element b's inputs bit
    for bit (costs mode only).

    `ChainRollout.launches` counts kernel launches over all instances; it
    rises by one per launch and nowhere else (the plain version on CPU
    tensors does not count); `ChainRollout.batch_launches` likewise counts
    the batched entry's.
    """
    launches = 0
    batch_launches = 0
    mode = "costs"
    nvcc_flags: Tuple[str, ...] = ()   # added to the build's (a measurement tool's hook)

    def __init__(self, model: ChainModel, n_substeps: int,
                 ulow: float = -1.0, uhigh: float = 1.0,
                 task: Union[str, ChainTask] = REACHER):
        self.model = model
        self.n_substeps = int(n_substeps)
        self.ulow = float(ulow)
        self.uhigh = float(uhigh)
        self.task = _task(task)
        self.d_obs = self.task.d_obs(model.nv)
        # a header per team size, made here: from a CUDA model it reads the
        # model to the host, which must not happen inside a sync-free solve
        self.headers = {t: _model_header(model, n_substeps, ulow, uhigh, self.task, None, t)
                        for t in TEAM_SIZES}
        self.header = self.headers[DEFAULT_TEAM]
        self._libs = {}

    def team_for(self, n: int, device=None) -> int:
        """The lanes per particle of a launch over n particles on the CUDA
        `device` (default: the current one)."""
        index = None if device is None else torch.device(device).index
        return open_loop_team(n, _sm_count(torch.cuda.current_device() if index is None
                                           else index))

    def library(self, team: int = DEFAULT_TEAM) -> build.KernelLibrary:
        """Build (at first use) and load the kernels for this model and
        task at `team` lanes per particle (one library holds the three
        entries)."""
        if team not in self._libs:
            if team not in self.headers:
                raise ValueError(f"team must be one of {TEAM_SIZES}, not {team}")
            lib = build.load("chain_rollout", "chain_rollout.cu",
                             {"chain_model.h": self.headers[team]}, self.nvcc_flags)
            tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            for entry, n_ptrs in (("chain_rollout_launch", 6),
                                  ("chain_obs_rollout_launch", 7),
                                  ("chain_cl_rollout_launch", 8)):
                getattr(lib.lib, entry).argtypes = [ctypes.c_void_p] * n_ptrs + tail
                getattr(lib.lib, entry).restype = ctypes.c_int
            batch_entry = lib.lib.chain_rollout_batch_launch
            batch_entry.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + tail
            batch_entry.restype = ctypes.c_int
            lib.lib.chain_rollout_error_string.argtypes = [ctypes.c_int]
            lib.lib.chain_rollout_error_string.restype = ctypes.c_char_p
            for entry in (lib.lib.chain_rollout_d_obs, lib.lib.chain_rollout_n_extras,
                          lib.lib.chain_rollout_team):
                entry.argtypes, entry.restype = [], ctypes.c_int
            layout = (lib.lib.chain_rollout_d_obs(), lib.lib.chain_rollout_n_extras(),
                      lib.lib.chain_rollout_team())
            want = (self.d_obs, self.task.n_extras, team)
            if layout != want:
                raise RuntimeError(f"{lib.path} was built for (d_obs, n_extras, team) = "
                                   f"{layout}, not {want}")
            self._libs[team] = lib
        return self._libs[team]

    def _ctrl_shape(self, horizon: int) -> tuple:
        return (horizon, self.model.nv)

    def _check(self, q0, qd0, extras, ctrl, noise):
        nv = self.model.nv
        ctrl_name = "weights" if self.mode == "cl" else "mean"
        args = {"q0": q0, "qd0": qd0, "extras": extras, ctrl_name: ctrl, "noise": noise}
        return _check_args(args, nv, lambda h: {"q0": (nv,), "qd0": (nv,),
                                                "extras": (self.task.n_extras,),
                                                ctrl_name: self._ctrl_shape(h)})

    def plain(self, q0, qd0, extras, ctrl, noise):
        """The plain PyTorch version (any device)."""
        self._check(q0, qd0, extras, ctrl, noise)
        return rollout_plain(self.model, self.n_substeps, self.ulow, self.uhigh,
                             q0, qd0, extras, ctrl, noise, self.mode, self.task)

    def __call__(self, q0, qd0, extras, ctrl, noise, *, team=None):
        """The rollout; on a CUDA device the kernel at `team` lanes per
        particle, by default team_for(N) (the checks and the team-size
        sweep set another)."""
        args = self._check(q0, qd0, extras, ctrl, noise)
        device = noise.device
        if device.type == "cpu":
            return rollout_plain(self.model, self.n_substeps, self.ulow, self.uhigh,
                                 q0, qd0, extras, ctrl, noise, self.mode, self.task)
        if device.type != "cuda":
            raise ValueError(f"no chain-rollout kernel for device {device}")
        for name, x in args.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        n, horizon, nv = noise.shape
        lib = self.library(self.team_for(n, device) if team is None else team).lib
        with torch.cuda.device(device):
            empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
            costs = empty(n, horizon)
            ptrs = [_vp(q0), _vp(qd0), _vp(extras), _vp(ctrl), _vp(noise), _vp(costs)]
            outs = (costs,)
            if self.mode == "costs":
                launch = lib.chain_rollout_launch
            elif self.mode == "obs":
                obs = empty(n, horizon, self.d_obs)
                launch, outs = lib.chain_obs_rollout_launch, (obs, costs)
                ptrs.append(_vp(obs))
            else:
                obs, acts = empty(n, horizon, self.d_obs), empty(n, horizon, nv)
                launch, outs = lib.chain_cl_rollout_launch, (obs, acts, costs)
                ptrs += [_vp(obs), _vp(acts)]
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = launch(*ptrs, n, horizon, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{type(self).__name__} kernel launch failed: "
                               + lib.chain_rollout_error_string(rc).decode())
        type(self).launches += 1
        return outs[0] if self.mode == "costs" else outs


    def _check_batch(self, q0, qd0, extras, mean, noise):
        if self.mode != "costs":
            raise NotImplementedError(f"{type(self).__name__} has no batched entry "
                                      f"(ROADMAP Queue 1 item 5)")
        if not isinstance(noise, torch.Tensor) or noise.dim() != 4 or noise.shape[0] < 1:
            raise ValueError("noise must be a [B>=1, N, H, nv] torch.Tensor")
        nv, batch = self.model.nv, noise.shape[0]
        args = {"q0": q0, "qd0": qd0, "extras": extras, "mean": mean,
                "noise": noise.reshape(-1, *noise.shape[2:])}
        _check_args(args, nv, lambda h: {"q0": (batch, nv), "qd0": (batch, nv),
                                         "extras": (batch, self.task.n_extras),
                                         "mean": (batch, h, nv)})
        return dict(args, noise=noise)

    def batch_plain(self, q0, qd0, extras, mean, noise):
        """batch in plain PyTorch (any device): the plain rollout of
        each element, stacked."""
        self._check_batch(q0, qd0, extras, mean, noise)
        return torch.stack([rollout_plain(self.model, self.n_substeps, self.ulow, self.uhigh,
                                          q0[b], qd0[b], extras[b], mean[b], noise[b],
                                          self.mode, self.task)
                            for b in range(noise.shape[0])])

    def batch(self, q0, qd0, extras, mean, noise, *, team=None):
        """B rollouts: q0, qd0 [B, nv], extras [B, n_extras], mean
        [B, H, nv], noise [B, N, H, nv] -> costs [B, N, H]; on a CUDA
        device one launch of the kernel over the B N particles at `team`
        lanes (default team_for(B N)), the plain version per element on
        the CPU."""
        args = self._check_batch(q0, qd0, extras, mean, noise)
        device = noise.device
        if device.type == "cpu":
            return self.batch_plain(q0, qd0, extras, mean, noise)
        if device.type != "cuda":
            raise ValueError(f"no chain-rollout kernel for device {device}")
        for name, x in args.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        batch, n, horizon, _ = noise.shape
        lib = self.library(self.team_for(batch * n, device) if team is None else team).lib
        with torch.cuda.device(device):
            costs = torch.empty((batch, n, horizon), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.chain_rollout_batch_launch(_vp(q0), _vp(qd0), _vp(extras), _vp(mean),
                                                _vp(noise), _vp(costs), batch, n, horizon,
                                                ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{type(self).__name__} batched kernel launch failed: "
                               + lib.chain_rollout_error_string(rc).decode())
        ChainRollout.batch_launches += 1
        return costs


class ChainObsRollout(ChainRollout):
    """rollout(q0, qd0, extras, mean, noise) -> (obs [N, H, d_obs],
    costs [N, H]): ChainRollout's costs plus the observation of the state
    entering every step. Counts its own `ChainObsRollout.launches`."""
    launches = 0
    mode = "obs"


class ChainClRollout(ChainRollout):
    """rollout(q0, qd0, extras, weights [d_obs + 1, nv], noise [N, H, nv])
    -> (obs [N, H, d_obs], actions [N, H, nv], costs [N, H]): the
    closed-loop-linear rollout, a = W^T [obs; 1] + noise recorded before
    the clip (rollout_closed_loop_linear's records). Counts its own
    `ChainClRollout.launches`."""
    launches = 0
    mode = "cl"

    def team_for(self, n: int, device=None) -> int:
        return DEFAULT_TEAM

    def _ctrl_shape(self, horizon: int) -> tuple:
        return (self.d_obs + 1, self.model.nv)


def build_chain_rollout(model: ChainModel, n_substeps: int, ulow: float = -1.0,
                        uhigh: float = 1.0, task="reacher") -> ChainRollout:
    """Fused rollout for a scalar-joint ChainModel (see ChainRollout)."""
    return ChainRollout(model, n_substeps, ulow, uhigh, task)


def build_chain_obs_rollout(model: ChainModel, n_substeps: int, ulow: float = -1.0,
                            uhigh: float = 1.0, task="reacher") -> ChainObsRollout:
    """Fused rollout that also emits observations (see ChainObsRollout)."""
    return ChainObsRollout(model, n_substeps, ulow, uhigh, task)


def build_chain_cl_rollout(model: ChainModel, n_substeps: int, ulow: float = -1.0,
                           uhigh: float = 1.0, task="reacher") -> ChainClRollout:
    """Fused closed-loop-linear rollout (see ChainClRollout)."""
    return ChainClRollout(model, n_substeps, ulow, uhigh, task)


def rollout_cl_plain(model: ChainModel, n_substeps: int, ulow: float, uhigh: float,
                     q0, qd0, extras, weights, noise, task="reacher"):
    """The closed-loop kernel's plain version: (obs, pre-clip actions,
    costs) under the policy weights [d_obs + 1, nv]."""
    return rollout_plain(model, n_substeps, ulow, uhigh, q0, qd0, extras, weights,
                         noise, "cl", task)


class ChainExtRollout:
    """rollout(q0 [nv], qd0 [nv], mean [H, nv], noise [N, H, nv]) -> costs
    [N, H], all float32 on one device: the locomotion rollout of an ExtTask
    (external forces every substep, the velocity limit, the step cost).

    `batch` runs B such rollouts (B starts and means, noise [B, N, H, nv])
    in one launch over B N particles; element b equals the single rollout
    of element b's inputs bit for bit.

    `ChainExtRollout.launches` counts kernel launches over all instances;
    it rises by one per launch and nowhere else (the plain version on CPU
    tensors does not count); `ChainExtRollout.batch_launches` likewise
    counts the batched entry's.
    """
    launches = 0
    batch_launches = 0
    nvcc_flags: Tuple[str, ...] = ()   # added to the build's (a measurement tool's hook)

    def __init__(self, model: ChainModel, n_substeps: int, task: ExtTask, vel_limit=None,
                 ulow: float = -1.0, uhigh: float = 1.0):
        self.model = model
        self.n_substeps = int(n_substeps)
        self.task = task
        self.ulow = float(ulow)
        self.uhigh = float(uhigh)
        self.vel_limit = (None if vel_limit is None else torch.as_tensor(
            np.asarray(vel_limit, np.float32), device=model.device))
        self.team = DEFAULT_TEAM
        self.header = model_header(model, n_substeps, ulow, uhigh, task, vel_limit)
        self._lib = None

    def library(self) -> build.KernelLibrary:
        """Build (at first use) and load the external-force kernel for this
        model and task."""
        if self._lib is None:
            lib = build.load("chain_rollout", "chain_rollout.cu",
                             {"chain_model.h": self.header}, self.nvcc_flags)
            entry = lib.lib.chain_ext_rollout_launch
            entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_void_p]
            entry.restype = ctypes.c_int
            entry = lib.lib.chain_ext_rollout_batch_launch
            entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            entry.restype = ctypes.c_int
            lib.lib.chain_rollout_error_string.argtypes = [ctypes.c_int]
            lib.lib.chain_rollout_error_string.restype = ctypes.c_char_p
            for entry in (lib.lib.chain_rollout_task, lib.lib.chain_rollout_team):
                entry.argtypes, entry.restype = [], ctypes.c_int
            layout = (lib.lib.chain_rollout_task(), lib.lib.chain_rollout_team())
            if layout != (self.task.index, self.team):
                raise RuntimeError(f"{lib.path} was built for (task, team) = {layout}, "
                                   f"not {(self.task.index, self.team)}")
            self._lib = lib
        return self._lib

    def _check(self, q0, qd0, mean, noise):
        nv = self.model.nv
        args = {"q0": q0, "qd0": qd0, "mean": mean, "noise": noise}
        return _check_args(args, nv, lambda h: {"q0": (nv,), "qd0": (nv,), "mean": (h, nv)})

    def plain(self, q0, qd0, mean, noise):
        """The plain PyTorch version (any device)."""
        self._check(q0, qd0, mean, noise)
        return rollout_ext_plain(self.model, self.n_substeps, self.task, self.vel_limit,
                                 self.ulow, self.uhigh, q0, qd0, mean, noise)

    def __call__(self, q0, qd0, mean, noise):
        args = self._check(q0, qd0, mean, noise)
        device = noise.device
        if device.type == "cpu":
            return rollout_ext_plain(self.model, self.n_substeps, self.task, self.vel_limit,
                                     self.ulow, self.uhigh, q0, qd0, mean, noise)
        if device.type != "cuda":
            raise ValueError(f"no chain-rollout kernel for device {device}")
        for name, x in args.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        n, horizon, _ = noise.shape
        lib = self.library().lib
        with torch.cuda.device(device):
            costs = torch.empty((n, horizon), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.chain_ext_rollout_launch(_vp(q0), _vp(qd0), _vp(mean), _vp(noise),
                                              _vp(costs), n, horizon, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError("ChainExtRollout kernel launch failed: "
                               + lib.chain_rollout_error_string(rc).decode())
        type(self).launches += 1
        return costs

    def _check_batch(self, q0, qd0, mean, noise):
        if not isinstance(noise, torch.Tensor) or noise.dim() != 4 or noise.shape[0] < 1:
            raise ValueError("noise must be a [B>=1, N, H, nv] torch.Tensor")
        nv, batch = self.model.nv, noise.shape[0]
        args = {"q0": q0, "qd0": qd0, "mean": mean, "noise": noise.reshape(-1, *noise.shape[2:])}
        _check_args(args, nv, lambda h: {"q0": (batch, nv), "qd0": (batch, nv),
                                         "mean": (batch, h, nv)})
        return dict(args, noise=noise)

    def batch_plain(self, q0, qd0, mean, noise):
        """batch in plain PyTorch (any device): the plain rollout of each
        element, stacked."""
        self._check_batch(q0, qd0, mean, noise)
        return torch.stack([rollout_ext_plain(self.model, self.n_substeps, self.task,
                                              self.vel_limit, self.ulow, self.uhigh, q0[b],
                                              qd0[b], mean[b], noise[b])
                            for b in range(noise.shape[0])])

    def batch(self, q0, qd0, mean, noise):
        """B rollouts: q0, qd0 [B, nv], mean [B, H, nv], noise [B, N, H, nv]
        -> costs [B, N, H]; on a CUDA device one launch of the kernel over
        the B N particles, the plain version per element on the CPU."""
        args = self._check_batch(q0, qd0, mean, noise)
        device = noise.device
        if device.type == "cpu":
            return self.batch_plain(q0, qd0, mean, noise)
        if device.type != "cuda":
            raise ValueError(f"no chain-rollout kernel for device {device}")
        for name, x in args.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        batch, n, horizon, _ = noise.shape
        lib = self.library().lib
        with torch.cuda.device(device):
            costs = torch.empty((batch, n, horizon), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.chain_ext_rollout_batch_launch(_vp(q0), _vp(qd0), _vp(mean), _vp(noise),
                                                    _vp(costs), batch, n, horizon,
                                                    ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError("ChainExtRollout batched kernel launch failed: "
                               + lib.chain_rollout_error_string(rc).decode())
        ChainExtRollout.batch_launches += 1
        return costs


def build_chain_ext_rollout(model: ChainModel, n_substeps: int, task: ExtTask,
                            vel_limit=None, ulow: float = -1.0,
                            uhigh: float = 1.0) -> ChainExtRollout:
    """Fused locomotion rollout (see ChainExtRollout): external forces of
    `task` in every substep, |qd| <= vel_limit [nv] after each control step
    (None: no limit), the task's step cost. Unactuated dofs take zero mean
    and noise (gear * 0 = 0, the env's zero-padded control)."""
    return ChainExtRollout(model, n_substeps, task, vel_limit, ulow, uhigh)
