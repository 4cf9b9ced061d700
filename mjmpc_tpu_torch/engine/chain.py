"""Rigid-body dynamics for kinematic trees, in PyTorch.

Counterpart of mjmpc_tpu/engine/chain.py, all four joint types:

    hinge  -- 1 qpos / 1 qvel, rotation about a body-frame axis
    slide  -- 1 qpos / 1 qvel, translation along a body-frame axis
    ball   -- 4 qpos (unit quaternion, wxyz) / 3 qvel (body-frame angular
              velocity)
    free   -- 7 qpos (parent-frame position + unit quaternion) / 6 qvel
              (parent-frame linear velocity + body-frame angular velocity)

Every function takes leading batch dimensions: q [..., nq] gives
rots [..., n, 3, 3] and so on, so one call advances N particles.

As in the JAX design, the Coriolis/centrifugal/gyroscopic/gravity bias is
DERIVED from a tangent-space Lagrangian by automatic differentiation
(torch.func), never by a hand RNEA: local coordinates delta [nv] sit at the
current configuration (additive for scalar joints and translations, a
right-multiplied exp-map for rotation blocks, whose DOF axes carry the
right Jacobian J_r(delta)), and

    bias = (dM_t/d delta . qd) qd - grad_delta [KE - V]   at delta = 0.

The rollout kernels' hand RNEA and Euler equations (ops/chain_rollout.py,
ops/forest_rollout.py, csrc/) are then checked against an independent
derivation.

Integration mirrors MuJoCo's Euler: semi-implicit Euler with implicit
joint damping, solve (M + dt*D) qdd = tau - bias - D qd, then qd += dt qdd,
retract q by dt*qd (additive, or quaternion right-multiplication by
exp(dt w) and renormalisation), and project the scalar joints' limits
(clamp q, zero qd where clamped).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.control import capturable_linalg

_SCALAR_JOINTS = ("hinge", "slide")
_JOINT_NQ = {"hinge": 1, "slide": 1, "ball": 4, "free": 7}
_JOINT_NV = {"hinge": 1, "slide": 1, "ball": 3, "free": 6}


@dataclasses.dataclass(frozen=True)
class ChainModel:
    """A kinematic tree of n joints (n joints == n bodies).

    Body i's frame is offset `body_pos[i]` from its parent's frame
    (`parent[i]`, -1 = world); joint i moves body i's frame per its type.
    Topology (`parent`, `joint_types`, `dt`, `site_body`) is host data; the
    physical parameters are f32 tensors on one device. Per-DOF arrays have
    length nv, the limits length nq (quaternion and free-joint entries are
    unbounded, +-1e9). For scalar-joint chains nq == nv == n.
    """
    joint_axis: torch.Tensor    # [n, 3] unit axes, child-body frame (scalar joints)
    body_pos: torch.Tensor      # [n, 3] frame offset from parent frame
    mass: torch.Tensor          # [n]
    com: torch.Tensor           # [n, 3] body-frame COM
    inertia: torch.Tensor       # [n, 3, 3] about COM, body frame
    armature: torch.Tensor      # [nv] rotor inertia added to M diagonal
    damping: torch.Tensor       # [nv] viscous joint damping
    frictionloss: torch.Tensor  # [nv] smooth Coulomb friction torque
    stiffness: torch.Tensor     # [nv] joint spring stiffness (rest q = 0, scalar joints)
    gear: torch.Tensor          # [nv] actuator torque scaling
    qpos_low: torch.Tensor      # [nq]
    qpos_high: torch.Tensor     # [nq]
    gravity: torch.Tensor       # [3] world gravity vector
    site_pos: torch.Tensor      # [3] site offset in site_body's frame
    parent: Tuple[int, ...]
    joint_types: Tuple[str, ...]
    dt: float
    site_body: int

    def __post_init__(self):
        for t in self.joint_types:
            if t not in _JOINT_NQ:
                raise ValueError(f"unknown joint type {t!r}")
        # the device constants now, with the model: built at first use
        # inside a solve, their host-to-device copies would sync it and
        # break its capture as a CUDA graph
        self._masks, self._scalar_index

    @property
    def n_joints(self) -> int:
        return len(self.parent)

    @property
    def nq(self) -> int:
        return sum(_JOINT_NQ[t] for t in self.joint_types)

    @property
    def nv(self) -> int:
        return sum(_JOINT_NV[t] for t in self.joint_types)

    @property
    def q_offsets(self) -> Tuple[int, ...]:
        return _offsets(self.joint_types, "q")

    @property
    def v_offsets(self) -> Tuple[int, ...]:
        return _offsets(self.joint_types, "v")

    @property
    def scalar_only(self) -> bool:
        return all(t in _SCALAR_JOINTS for t in self.joint_types)

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def ancestor_mask(self) -> np.ndarray:
        """mask[i, k] = 1 if velocity DOF k moves body i (k's joint is on
        i's root path); [n, nv]."""
        return _dof_ancestor_mask(self.parent, self.joint_types)

    def neutral_qpos(self) -> torch.Tensor:
        """All-zero scalar joints and translations; identity quaternions."""
        return torch.as_tensor(_neutral_qpos(self.joint_types), device=self.device)

    @functools.cached_property
    def _masks(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ancestor mask [n, nv, 1], rotational-DOF mask [nv, 1]) as
        tensors on the model's device, built once."""
        anc = torch.as_tensor(self.ancestor_mask(), device=self.device)
        rot = torch.as_tensor(_rot_dof_mask(self.joint_types), device=self.device)
        return anc[..., None], rot[:, None]

    @functools.cached_property
    def _scalar_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q index [nv], scalar [nv]): the qpos entry of each scalar DOF
        (nq, one past the end, for the DOFs of ball and free joints) and a
        1/0 mask of the scalar DOFs, as tensors on the model's device."""
        qi, vi = _scalar_maps(self.joint_types)
        index = np.full(self.nv, self.nq, np.int64)
        index[vi] = qi
        scalar = np.zeros(self.nv, np.float32)
        scalar[vi] = 1.0
        return (torch.as_tensor(index, device=self.device),
                torch.as_tensor(scalar, device=self.device))


@functools.lru_cache(maxsize=None)
def _offsets(joint_types: Tuple[str, ...], kind: str) -> Tuple[int, ...]:
    sizes = _JOINT_NQ if kind == "q" else _JOINT_NV
    out, acc = [], 0
    for t in joint_types:
        out.append(acc)
        acc += sizes[t]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _body_ancestor_mask(parent: Tuple[int, ...]) -> np.ndarray:
    n = len(parent)
    mask = np.zeros((n, n), np.float32)
    for i in range(n):
        k = i
        while k >= 0:
            mask[i, k] = 1.0
            k = parent[k]
    return mask


@functools.lru_cache(maxsize=None)
def _dof_ancestor_mask(parent: Tuple[int, ...],
                       joint_types: Tuple[str, ...]) -> np.ndarray:
    body = _body_ancestor_mask(parent)
    voff = _offsets(joint_types, "v")
    mask = np.zeros((len(parent), sum(_JOINT_NV[t] for t in joint_types)), np.float32)
    for j, t in enumerate(joint_types):
        mask[:, voff[j]:voff[j] + _JOINT_NV[t]] = body[:, j:j + 1]
    return mask


@functools.lru_cache(maxsize=None)
def _rot_dof_mask(joint_types: Tuple[str, ...]) -> np.ndarray:
    """[nv] 1.0 where the velocity DOF is rotational."""
    out = {"hinge": [1.0], "slide": [0.0], "ball": [1.0] * 3, "free": [0.0] * 3 + [1.0] * 3}
    return np.concatenate([out[t] for t in joint_types]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _scalar_maps(joint_types: Tuple[str, ...]):
    """(q indices, v indices) of the 1-DOF joints: the set that limits and
    stiffness act on."""
    qoff, voff = _offsets(joint_types, "q"), _offsets(joint_types, "v")
    scalar = [j for j, t in enumerate(joint_types) if t in _SCALAR_JOINTS]
    return (np.asarray([qoff[j] for j in scalar], np.int64),
            np.asarray([voff[j] for j in scalar], np.int64))


@functools.lru_cache(maxsize=None)
def _neutral_qpos(joint_types: Tuple[str, ...]) -> np.ndarray:
    out = {"hinge": [0.0], "slide": [0.0], "ball": [1.0, 0.0, 0.0, 0.0],
           "free": [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]}
    return np.concatenate([out[t] for t in joint_types]).astype(np.float32)


# ---------------------------------------------------------------------------
# SO(3) primitives, batched over leading dimensions: branch-free and
# differentiable at the identity (the tangent Lagrangian evaluates them at
# delta = 0, so every guarded branch keeps finite values and derivatives).
# ---------------------------------------------------------------------------

def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrices [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    z0 = torch.zeros_like(x)
    return torch.stack([torch.stack([z0, -z, y], -1),
                        torch.stack([z, z0, -x], -1),
                        torch.stack([-y, x, z0], -1)], -2)


def _rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] about a constant unit axis [3] by angle [...]."""
    k = _skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * k + (1.0 - c) * (k @ k)


def _sincc(t2: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) from t^2, with
    Taylor forms near 0. t2 keeps a trailing axis of 1: a 0-dim tensor
    beside a Python float gets a float64 tangent under torch.func.jvp."""
    small = t2 < 1e-8
    safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(safe)
    s = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    c = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / safe)
    d = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (safe * t))
    return s, c, d


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """exp of the axis-angle vectors w [..., 3]: rotations [..., 3, 3]."""
    s, c, _ = _sincc(torch.sum(w * w, -1, keepdim=True))
    k = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s[..., None] * k + c[..., None] * (k @ k)


def _so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_r(w) [..., 3, 3]: body angular velocity = J_r(w) dw/dt for
    R(t) = R0 exp(w(t)). J_r(0) = I; its first-order term -w^/2 feeds the
    gyroscopic force through the tangent Lagrangian."""
    _, c, d = _sincc(torch.sum(w * w, -1, keepdim=True))
    k = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - c[..., None] * k + d[..., None] * (k @ k)


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) [..., 4] -> rotations [..., 3, 3]
    (normalises first)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _exp_quat(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors [..., 3] -> unit quaternions exp(w/2) [..., 4],
    with the small-angle series below |w|^2 = 1e-8."""
    t2 = torch.sum(w * w, -1, keepdim=True)
    small = t2 < 1e-8
    safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(safe)
    half = 0.5 * t
    sinc_half = torch.where(small, 0.5 - t2 / 48.0, torch.sin(half) / t)
    cos_half = torch.where(small, 1.0 - t2 / 8.0, torch.cos(half))
    return torch.cat([cos_half, sinc_half * w], -1)


# ---------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------

def fk_dofs(model: ChainModel, q: torch.Tensor,
            delta: Optional[torch.Tensor] = None):
    """Forward kinematics at q (+) delta, plus per-DOF world axes.

    Returns (rots [..., n, 3, 3] body->world, poss [..., n, 3] frame
    origins, axes [..., nv, 3] world DOF directions, origins [..., nv, 3]
    world DOF anchor points). For rotation blocks the DOF axes carry the
    right Jacobian J_r(delta), which the tangent-Lagrangian bias needs to
    be exact. A Python unroll over the (small, fixed) tree.
    """
    batch = q.shape[:-1]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(batch + (3, 3))
    zero = q.new_zeros(batch + (3,))
    qoff, voff = model.q_offsets, model.v_offsets
    rots, poss = [], []
    axes = [None] * model.nv
    origins = [None] * model.nv
    for i in range(model.n_joints):
        pi = model.parent[i]
        r_p = eye if pi < 0 else rots[pi]
        p_p = zero if pi < 0 else poss[pi]
        t = model.joint_types[i]
        qi, vi = qoff[i], voff[i]
        if t in _SCALAR_JOINTS:
            qs = q[..., qi] if delta is None else q[..., qi] + delta[..., vi]
            axis = model.joint_axis[i]
            base = p_p + r_p @ model.body_pos[i]
            if t == "slide":
                axis_w = r_p @ axis
                p = base + axis_w * qs[..., None]
                r = r_p
            else:  # hinge
                p = base
                r = r_p @ _rodrigues(axis, qs)
                axis_w = r @ axis
            axes[vi] = axis_w
            origins[vi] = p
        else:
            if t == "ball":
                p = p_p + r_p @ model.body_pos[i]
                quat, rv = q[..., qi:qi + 4], vi
            else:  # free
                trans = q[..., qi:qi + 3]
                if delta is not None:
                    trans = trans + delta[..., vi:vi + 3]
                p = p_p + (r_p @ (model.body_pos[i] + trans)[..., None])[..., 0]
                quat, rv = q[..., qi + 3:qi + 7], vi + 3
                for k in range(3):
                    axes[vi + k] = r_p[..., :, k]       # parent-frame slide
                    origins[vi + k] = p
            r = r_p @ _quat_to_mat(quat)
            if delta is None:
                jr = r
            else:
                d = delta[..., rv:rv + 3]
                r = r @ _exp_so3(d)
                jr = r @ _so3_right_jacobian(d)
            for k in range(3):
                axes[rv + k] = jr[..., :, k]
                origins[rv + k] = p
        rots.append(r)
        poss.append(p)
    poss = torch.stack(poss, -2)
    origins = poss if model.scalar_only else torch.stack(origins, -2)
    return torch.stack(rots, -3), poss, torch.stack(axes, -2), origins


def forward_kinematics(model: ChainModel, q: torch.Tensor):
    """World-frame pose of every body: (rot [..., n, 3, 3], pos [..., n, 3])."""
    rots, poss, _, _ = fk_dofs(model, q)
    return rots, poss


def site_position(model: ChainModel, q: torch.Tensor) -> torch.Tensor:
    """World position [..., 3] of the end-effector site."""
    rots, poss = forward_kinematics(model, q)
    sb = model.site_body
    return poss[..., sb, :] + rots[..., sb, :, :] @ model.site_pos


def mass_from_fk(model: ChainModel, rots, poss, axes_w, origins) -> torch.Tensor:
    """Joint-space inertia M [..., nv, nv] by velocity-Jacobian
    composition, M = sum_i m_i Jv_i^T Jv_i + Jw_i^T I_i Jw_i, from a
    forward-kinematics result: a rotational DOF k gives body i the
    velocity column a_k x (c_i - o_k) and the angular column a_k, a
    translational one the velocity column a_k."""
    anc, rot = model._masks
    coms_w = poss + torch.einsum("...nij,nj->...ni", rots, model.com)
    arm = coms_w[..., :, None, :] - origins[..., None, :, :]   # [..., n, nv, 3]
    axes_b = axes_w[..., None, :, :].expand(arm.shape)
    jv = (rot * torch.linalg.cross(axes_b, arm, dim=-1)
          + (1.0 - rot) * axes_b) * anc
    jw = rot * axes_b * anc
    iw = torch.einsum("...nab,nbc,...ndc->...nad", rots, model.inertia, rots)
    m_lin = torch.einsum("n,...nka,...nla->...kl", model.mass, jv, jv)
    m_ang = torch.einsum("...nka,...nab,...nlb->...kl", jw, iw, jw)
    return m_lin + m_ang


def _mass_matrix_at(model: ChainModel, q, delta) -> torch.Tensor:
    return mass_from_fk(model, *fk_dofs(model, q, delta))


def mass_matrix(model: ChainModel, q: torch.Tensor) -> torch.Tensor:
    return _mass_matrix_at(model, q, None)


def kinetic_energy(model: ChainModel, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    return 0.5 * (qd[..., None, :] @ mass_matrix(model, q) @ qd[..., None])[..., 0, 0]


def _potential_energy_at(model: ChainModel, q, delta) -> torch.Tensor:
    """V(q (+) delta) = -sum_i m_i g . c_i."""
    rots, poss, _, _ = fk_dofs(model, q, delta)
    coms_w = poss + torch.einsum("...nij,nj->...ni", rots, model.com)
    return -torch.sum(model.mass * (coms_w @ model.gravity), dim=-1)


def potential_energy(model: ChainModel, q: torch.Tensor) -> torch.Tensor:
    """V(q) = -sum_i m_i g . c_i(q) [...] (zero when model.gravity is zero,
    as in the reference arm model)."""
    return _potential_energy_at(model, q, None)


def bias_forces(model: ChainModel, q: torch.Tensor,
                qd: torch.Tensor) -> torch.Tensor:
    """Coriolis/centrifugal/gyroscopic + gravity generalized forces
    [..., nv]:

        bias = (dM_t/d delta . qd) qd - grad_delta KE + grad_delta V,

    a jvp of delta -> M_t(q, delta) qd along qd plus the gradient of the
    Lagrangian, both at delta = 0 (Boltzmann-Hamel in quasi-coordinates:
    Euler's w x I w for a free body). Batch rows are independent, so the
    gradient of the batch sum is the per-row gradient.
    """
    zero = torch.zeros_like(qd)

    def m_qd(d):
        return (_mass_matrix_at(model, q, d) @ qd[..., None])[..., 0]

    _, mdot_qd = torch.func.jvp(m_qd, (zero,), (qd,))

    def lagrangian(d):
        m = _mass_matrix_at(model, q, d)
        ke = 0.5 * (qd[..., None, :] @ m @ qd[..., None])[..., 0, 0]
        return torch.sum(ke - _potential_energy_at(model, q, d))

    return mdot_qd - torch.func.grad(lagrangian)(zero)


def _scalar_q(model: ChainModel, q: torch.Tensor) -> torch.Tensor:
    """The scalar joints' positions in velocity space [..., nv] (zero at
    the DOFs of ball and free joints)."""
    if model.scalar_only:
        return q
    index, scalar = model._scalar_index
    padded = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], -1)
    return padded[..., index] * scalar


def _project_limits(model: ChainModel, q, qd):
    """Clamp the scalar joints' positions to their range and zero the
    velocity of a clamped joint; quaternion blocks are unlimited (their
    limits are +-1e9, and the integrator normalises them)."""
    clamped = torch.clamp(q, model.qpos_low, model.qpos_high)
    kept = clamped == q
    if not model.scalar_only:
        index, _ = model._scalar_index
        kept = torch.cat([kept, kept.new_ones(kept.shape[:-1] + (1,))], -1)[..., index]
    return clamped, torch.where(kept, qd, torch.zeros_like(qd))


def integrate_qpos(model: ChainModel, q: torch.Tensor, qd: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """Retract q by dt*qd: additive for scalar joints and free-joint
    translations, quaternion right-multiplication by exp(dt w) for
    rotation blocks (body-frame angular velocity, MuJoCo's semantics),
    renormalised."""
    if model.scalar_only:
        return q + dt * qd
    qoff, voff = model.q_offsets, model.v_offsets
    parts = []
    for i, t in enumerate(model.joint_types):
        qi, vi = qoff[i], voff[i]
        if t in _SCALAR_JOINTS:
            parts.append(q[..., qi:qi + 1] + dt * qd[..., vi:vi + 1])
            continue
        if t == "free":
            parts.append(q[..., qi:qi + 3] + dt * qd[..., vi:vi + 3])
            qi, vi = qi + 3, vi + 3
        quat = _quat_mul(q[..., qi:qi + 4], _exp_quat(dt * qd[..., vi:vi + 3]))
        parts.append(quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True))
    return torch.cat(parts, -1)


def constant(value, device) -> torch.Tensor:
    """A host constant (a numpy array, a list or tuple of numbers) as a
    tensor on `device`, floats as float32 and integers as int64. An env
    makes its constants (body indices among them) with its params, so that
    its step copies nothing from the host and can be captured in a CUDA
    graph."""
    arr = np.asarray(value)
    return torch.as_tensor(arr.astype(np.float32 if arr.dtype.kind == "f" else np.int64),
                           device=device)


def _world_points(model: ChainModel, q, delta, bodies, points_local):
    """World positions [..., K, 3] of body-local points [K, 3] on `bodies`
    (K body indices: an int64 tensor on q's device, which a step captured
    in a CUDA graph needs, a slice, or a sequence of ints, which indexes
    through a copy from the host) at q (+) delta."""
    rots, poss, _, _ = fk_dofs(model, q, delta)
    idx = list(bodies) if isinstance(bodies, (tuple, list)) else bodies
    return poss[..., idx, :] + torch.einsum("...kij,kj->...ki", rots[..., idx, :, :],
                                            points_local)


def _as_points(body, point_local):
    """(bodies, points [K, 3], single): one body and point [3], or K bodies
    and points [K, 3]."""
    if isinstance(body, int):
        return slice(body, body + 1), point_local[None], True
    return body, point_local, False


def point_state(model: ChainModel, q: torch.Tensor, qd: torch.Tensor, body,
                point_local: torch.Tensor):
    """(world position, world velocity) of a body-local point: the
    velocity is a jvp of the point's world position over the tangent
    `delta` along qd (valid for quaternion joints too). `body` is one
    index with point_local [3] (results [..., 3]) or K indices with
    point_local [K, 3] (results [..., K, 3]), so that K contact or drag
    points cost one jvp."""
    bodies, pts, single = _as_points(body, point_local)
    zero = torch.zeros_like(qd)
    pos, vel = torch.func.jvp(lambda d: _world_points(model, q, d, bodies, pts),
                              (zero,), (qd,))
    return (pos[..., 0, :], vel[..., 0, :]) if single else (pos, vel)


def point_force_to_generalized(model: ChainModel, q: torch.Tensor, body,
                               point_local: torch.Tensor,
                               force_world: torch.Tensor) -> torch.Tensor:
    """Generalized force J^T f [..., nv] of world-frame forces applied at
    body-local points: a vjp of the points' world positions over the
    tangent `delta`. `body`/`point_local` as for point_state, force_world
    [..., 3] or [..., K, 3] (the K forces summed)."""
    bodies, pts, single = _as_points(body, point_local)
    if single:
        force_world = force_world[..., None, :]
    zero = q.new_zeros(q.shape[:-1] + (model.nv,))
    _, vjp = torch.func.vjp(lambda d: _world_points(model, q, d, bodies, pts), zero)
    return vjp(force_world)[0]


def points_frame(model: ChainModel, q: torch.Tensor, qd: torch.Tensor,
                 bodies, points_local: torch.Tensor):
    """The batched kinematic front and back end of the contact models: for
    K body-local points (`bodies` K indices as _world_points takes them,
    points_local [K, 3]) returns
    (pos [..., K, 3], vel [..., K, 3], apply), where apply(forces
    [..., K, 3]) is the generalized force [..., nv] = sum_k J_k^T f_k. One
    vjp of the points' world positions gives the positions and the
    scatter, one jvp along qd the velocities."""
    zero = q.new_zeros(q.shape[:-1] + (model.nv,))

    def world(d):
        return _world_points(model, q, d, bodies, points_local)

    pos, vjp = torch.func.vjp(world, zero)
    _, vel = torch.func.jvp(world, (zero,), (qd,))
    return pos, vel, lambda forces: vjp(forces)[0]


def step(model: ChainModel, q: torch.Tensor, qd: torch.Tensor,
         ctrl: torch.Tensor, n_substeps: int = 1, ext_force_fn=None):
    """Advance (q [..., nq], qd [..., nv]) by n_substeps of dt under motor
    controls ctrl [..., nv] (tau = gear * ctrl, held for every substep).
    ext_force_fn(model, q, qd) -> generalized force [..., nv] adds
    environment forces (fluid drag, contact) in every substep."""
    tau = model.gear * ctrl
    diag = torch.diag(model.armature + model.dt * model.damping)
    for _ in range(n_substeps):
        m = mass_matrix(model, q) + diag
        rhs = (tau - bias_forces(model, q, qd) - model.damping * qd
               - model.frictionloss * torch.tanh(qd / 0.02)
               - model.stiffness * _scalar_q(model, q))
        if ext_force_fn is not None:
            rhs = rhs + ext_force_fn(model, q, qd)
        with capturable_linalg(q.device):   # a rollout's steps stay capturable
            chol = torch.linalg.cholesky_ex(m).L
            qacc = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        qd = qd + model.dt * qacc
        q = integrate_qpos(model, q, qd, model.dt)
        q, qd = _project_limits(model, q, qd)
    return q, qd


# ---------------------------------------------------------------------------
# Model construction from geom primitives (MuJoCo inertiafromgeom
# semantics, density 1000 kg/m^3) — host-side numpy, as in the JAX package.
# ---------------------------------------------------------------------------

_DENSITY = 1000.0


def sphere_geom(radius: float, pos=(0.0, 0.0, 0.0)):
    m = _DENSITY * 4.0 / 3.0 * np.pi * radius ** 3
    i = 0.4 * m * radius ** 2
    return dict(mass=m, com=np.asarray(pos, np.float64),
                inertia=np.diag([i, i, i]))


def box_geom(half_extents, pos=(0.0, 0.0, 0.0)):
    hx, hy, hz = half_extents
    m = _DENSITY * 8.0 * hx * hy * hz
    return dict(mass=m, com=np.asarray(pos, np.float64),
                inertia=np.diag([m / 3.0 * (hy ** 2 + hz ** 2),
                                 m / 3.0 * (hx ** 2 + hz ** 2),
                                 m / 3.0 * (hx ** 2 + hy ** 2)]))


def capsule_geom(radius: float, fromto):
    """Capsule between two points: cylinder plus two hemispherical caps
    (exact rigid-body values)."""
    a = np.asarray(fromto[:3], np.float64)
    b = np.asarray(fromto[3:], np.float64)
    center = 0.5 * (a + b)
    d = b - a
    length = np.linalg.norm(d)
    h = length / 2.0
    axis = d / length if length > 0 else np.array([0.0, 0.0, 1.0])

    m_cyl = _DENSITY * np.pi * radius ** 2 * length
    m_sph = _DENSITY * 4.0 / 3.0 * np.pi * radius ** 3
    m = m_cyl + m_sph
    i_ax = m_cyl * radius ** 2 / 2.0 + m_sph * 0.4 * radius ** 2
    i_perp = (m_cyl * (radius ** 2 / 4.0 + length ** 2 / 12.0)
              + m_sph * (0.4 * radius ** 2 + h ** 2 + 0.75 * radius * h))

    # rotate the axis-aligned inertia into the body frame
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, axis)
    c = float(z @ axis)
    if np.linalg.norm(v) < 1e-12:
        r = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        r = np.eye(3) + k + k @ k / (1.0 + c)
    i_local = np.diag([i_perp, i_perp, i_ax])
    return dict(mass=m, com=center, inertia=r @ i_local @ r.T)


def combine_geoms(geoms: Sequence[dict]):
    """Merge geoms into one (mass, com, inertia-about-com) body."""
    mass = sum(g["mass"] for g in geoms)
    com = sum(g["mass"] * g["com"] for g in geoms) / mass
    inertia = np.zeros((3, 3))
    for g in geoms:
        d = g["com"] - com
        shift = g["mass"] * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        inertia = inertia + g["inertia"] + shift
    return mass, com, inertia


def build_chain(bodies: Sequence[dict], dt: float, site_body: int,
                site_pos, gravity=(0.0, 0.0, 0.0), device="cuda") -> ChainModel:
    """Assemble a ChainModel on `device` from per-body dicts
    {pos, axis, geoms, damping, armature, gear, frictionloss, stiffness,
    range, type, parent}; type 'hinge' (default), 'slide', 'ball' or
    'free', parent default i-1. Bodies with geoms=[] are massless virtual
    links. Per-body damping, armature, gear, frictionloss and stiffness
    apply to every velocity DOF of the joint; `range` to scalar joints
    only."""
    n = len(bodies)
    mass = np.zeros(n)
    com = np.zeros((n, 3))
    inertia = np.zeros((n, 3, 3))
    for i, b in enumerate(bodies):
        if b.get("geoms"):
            mass[i], com[i], inertia[i] = combine_geoms(b["geoms"])
        else:
            # a tiny regularizing mass keeps M positive definite
            mass[i] = 1e-6
            inertia[i] = 1e-9 * np.eye(3)

    types = tuple(b.get("type", "hinge") for b in bodies)
    for t in types:
        if t not in _JOINT_NQ:
            raise ValueError(f"unknown joint type {t!r}")

    def per_dof(key, default):
        return [b.get(key, default) for b, t in zip(bodies, types) for _ in range(_JOINT_NV[t])]

    qlow, qhigh = [], []
    for b, t in zip(bodies, types):
        if t in _SCALAR_JOINTS:
            qlow.append(b["range"][0])
            qhigh.append(b["range"][1])
        else:
            qlow += [-1e9] * _JOINT_NQ[t]
            qhigh += [1e9] * _JOINT_NQ[t]

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return ChainModel(
        joint_axis=t([b.get("axis", (0, 0, 1)) for b in bodies]),
        body_pos=t([b["pos"] for b in bodies]),
        mass=t(mass), com=t(com), inertia=t(inertia),
        armature=t(per_dof("armature", 0.0)),
        damping=t(per_dof("damping", 0.0)),
        frictionloss=t(per_dof("frictionloss", 0.0)),
        stiffness=t(per_dof("stiffness", 0.0)),
        gear=t(per_dof("gear", 1.0)),
        qpos_low=t(qlow), qpos_high=t(qhigh),
        gravity=t(gravity), site_pos=t(site_pos),
        parent=tuple(int(b.get("parent", i - 1)) for i, b in enumerate(bodies)),
        joint_types=types, dt=float(dt), site_body=int(site_body))
