"""Rigid-body dynamics for scalar-joint kinematic trees, in PyTorch.

Counterpart of mjmpc_tpu/engine/chain.py for hinge and slide joints (the
reacher / sawyer-arm family, the swimmer and the half cheetah). Ball and
free joints raise NotImplementedError for now.

Every function takes leading batch dimensions: q [..., nv] gives
rots [..., n, 3, 3] and so on, so one call advances N particles.

As in the JAX design, the Coriolis/centrifugal/gravity bias is DERIVED
from the Lagrangian by automatic differentiation (torch.func), never by a
hand RNEA: the rollout kernel's hand RNEA (ops/chain_rollout.py,
csrc/chain_rollout.cu) is then checked against an independent derivation.

Integration mirrors MuJoCo's Euler: semi-implicit Euler with implicit
joint damping, solve (M + dt*D) qdd = tau - bias - D qd, then qd += dt qdd,
q += dt qd, and project the joint limits (clamp q, zero qd where clamped).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_SCALAR_JOINTS = ("hinge", "slide")


@dataclasses.dataclass(frozen=True)
class ChainModel:
    """A kinematic tree of n scalar joints (n joints == n bodies == nv).

    Body i's frame is offset `body_pos[i]` from its parent's frame
    (`parent[i]`, -1 = world); joint i rotates (hinge) or translates
    (slide) body i's frame about / along `joint_axis[i]`. Topology
    (`parent`, `joint_types`, `dt`, `site_body`) is host data; the
    physical parameters are f32 tensors on one device.
    """
    joint_axis: torch.Tensor    # [n, 3] unit axes, child-body frame
    body_pos: torch.Tensor      # [n, 3] frame offset from parent frame
    mass: torch.Tensor          # [n]
    com: torch.Tensor           # [n, 3] body-frame COM
    inertia: torch.Tensor       # [n, 3, 3] about COM, body frame
    armature: torch.Tensor      # [nv] rotor inertia added to M diagonal
    damping: torch.Tensor       # [nv] viscous joint damping
    frictionloss: torch.Tensor  # [nv] smooth Coulomb friction torque
    stiffness: torch.Tensor     # [nv] joint spring stiffness (rest q = 0)
    gear: torch.Tensor          # [nv] actuator torque scaling
    qpos_low: torch.Tensor      # [nv]
    qpos_high: torch.Tensor     # [nv]
    gravity: torch.Tensor       # [3] world gravity vector
    site_pos: torch.Tensor      # [3] site offset in site_body's frame
    parent: Tuple[int, ...]
    joint_types: Tuple[str, ...]
    dt: float
    site_body: int

    def __post_init__(self):
        for t in self.joint_types:
            if t not in _SCALAR_JOINTS:
                raise NotImplementedError(
                    f"{t} joints are not ported yet (scalar joints only)")

    @property
    def n_joints(self) -> int:
        return len(self.parent)

    @property
    def nv(self) -> int:
        return self.n_joints

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def ancestor_mask(self) -> np.ndarray:
        """mask[i, k] = 1 if joint k is on body i's root path."""
        return _ancestor_mask(self.parent)

    @functools.cached_property
    def _masks(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ancestor mask [n, nv, 1], rotational-DOF mask [nv, 1]) as
        tensors on the model's device, built once."""
        anc = torch.as_tensor(self.ancestor_mask(), device=self.device)
        rot = torch.as_tensor(
            [1.0 if t == "hinge" else 0.0 for t in self.joint_types],
            dtype=torch.float32, device=self.device)
        return anc[..., None], rot[:, None]


@functools.lru_cache(maxsize=None)
def _ancestor_mask(parent: Tuple[int, ...]) -> np.ndarray:
    n = len(parent)
    mask = np.zeros((n, n), np.float32)
    for i in range(n):
        k = i
        while k >= 0:
            mask[i, k] = 1.0
            k = parent[k]
    return mask


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[0], v[1], v[2]
    z0 = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([z0, -z, y]),
                        torch.stack([z, z0, -x]),
                        torch.stack([-y, x, z0])])


def _rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] about a constant unit axis [3] by angle [...]."""
    k = _skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * k + (1.0 - c) * (k @ k)


def fk_dofs(model: ChainModel, q: torch.Tensor,
             delta: Optional[torch.Tensor] = None):
    """Forward kinematics at q + delta, plus per-DOF world axes.

    Returns (rots [..., n, 3, 3] body->world, poss [..., n, 3] frame
    origins, axes [..., nv, 3] world DOF directions, origins [..., nv, 3]
    world DOF anchor points). A Python unroll over the (small, fixed)
    tree.
    """
    batch = q.shape[:-1]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(batch + (3, 3))
    zero = q.new_zeros(batch + (3,))
    rots, poss, axes = [], [], []
    for i in range(model.n_joints):
        pi = model.parent[i]
        r_p = eye if pi < 0 else rots[pi]
        p_p = zero if pi < 0 else poss[pi]
        qi = q[..., i] if delta is None else q[..., i] + delta[..., i]
        axis = model.joint_axis[i]
        base = p_p + r_p @ model.body_pos[i]
        if model.joint_types[i] == "slide":
            axis_w = r_p @ axis
            p = base + axis_w * qi[..., None]
            r = r_p
        else:  # hinge
            p = base
            r = r_p @ _rodrigues(axis, qi)
            axis_w = r @ axis
        rots.append(r)
        poss.append(p)
        axes.append(axis_w)
    poss = torch.stack(poss, -2)
    # a scalar joint's DOF anchor is its body's frame origin
    return torch.stack(rots, -3), poss, torch.stack(axes, -2), poss


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
    forward-kinematics result."""
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


def _potential_energy_at(model: ChainModel, q, delta) -> torch.Tensor:
    """V(q + delta) = -sum_i m_i g . c_i."""
    rots, poss, _, _ = fk_dofs(model, q, delta)
    coms_w = poss + torch.einsum("...nij,nj->...ni", rots, model.com)
    return -torch.sum(model.mass * (coms_w @ model.gravity), dim=-1)


def bias_forces(model: ChainModel, q: torch.Tensor,
                qd: torch.Tensor) -> torch.Tensor:
    """Coriolis/centrifugal + gravity generalized forces [..., nv]:

        bias = (dM/dq . qd) qd - grad_q KE + grad_q V,

    a jvp of delta -> M(q + delta) qd along qd plus the gradient of the
    Lagrangian, both at delta = 0. Batch rows are independent, so the
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


def _project_limits(model: ChainModel, q, qd):
    """Clamp joint positions to their range and zero the velocity of a
    clamped joint."""
    clamped = torch.clamp(q, model.qpos_low, model.qpos_high)
    qd = torch.where(clamped == q, qd, torch.zeros_like(qd))
    return clamped, qd


def _world_points(model: ChainModel, q, delta, bodies, points_local):
    """World positions [..., K, 3] of body-local points [K, 3] on `bodies`
    (K body indices) at q + delta."""
    rots, poss, _, _ = fk_dofs(model, q, delta)
    idx = list(bodies)
    return poss[..., idx, :] + torch.einsum("...kij,kj->...ki", rots[..., idx, :, :],
                                            points_local)


def _as_points(body, point_local):
    """(bodies, points [K, 3], single): one body and point [3], or K bodies
    and points [K, 3]."""
    if isinstance(body, int):
        return (body,), point_local[None], True
    return tuple(int(b) for b in body), point_local, False


def point_state(model: ChainModel, q: torch.Tensor, qd: torch.Tensor, body,
                point_local: torch.Tensor):
    """(world position, world velocity) of a body-local point: the
    velocity is a jvp of the point's world position over the tangent
    `delta` along qd. `body` is one index with point_local [3] (results
    [..., 3]) or K indices with point_local [K, 3] (results [..., K, 3]),
    so that K contact or drag points cost one jvp."""
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
    zero = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    _, vjp = torch.func.vjp(lambda d: _world_points(model, q, d, bodies, pts), zero)
    return vjp(force_world)[0]


def step(model: ChainModel, q: torch.Tensor, qd: torch.Tensor,
         ctrl: torch.Tensor, n_substeps: int = 1, ext_force_fn=None):
    """Advance (q [..., nv], qd [..., nv]) by n_substeps of dt under motor
    controls ctrl [..., nv] (tau = gear * ctrl, held for every substep).
    ext_force_fn(model, q, qd) -> generalized force [..., nv] adds
    environment forces (fluid drag, contact) in every substep."""
    tau = model.gear * ctrl
    diag = torch.diag(model.armature + model.dt * model.damping)
    for _ in range(n_substeps):
        m = mass_matrix(model, q) + diag
        rhs = (tau - bias_forces(model, q, qd) - model.damping * qd
               - model.frictionloss * torch.tanh(qd / 0.02)
               - model.stiffness * q)
        if ext_force_fn is not None:
            rhs = rhs + ext_force_fn(model, q, qd)
        chol = torch.linalg.cholesky_ex(m).L
        qacc = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        qd = qd + model.dt * qacc
        q = q + model.dt * qd
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
    range, type, parent}; type 'hinge' (default) or 'slide', parent
    default i-1. Bodies with geoms=[] are massless virtual links."""
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

    def per_body(key, default):
        return [b.get(key, default) for b in bodies]

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return ChainModel(
        joint_axis=t(per_body("axis", (0, 0, 1))),
        body_pos=t(per_body("pos", None)),
        mass=t(mass), com=t(com), inertia=t(inertia),
        armature=t(per_body("armature", 0.0)),
        damping=t(per_body("damping", 0.0)),
        frictionloss=t(per_body("frictionloss", 0.0)),
        stiffness=t(per_body("stiffness", 0.0)),
        gear=t(per_body("gear", 1.0)),
        qpos_low=t([b["range"][0] for b in bodies]),
        qpos_high=t([b["range"][1] for b in bodies]),
        gravity=t(gravity), site_pos=t(site_pos),
        parent=tuple(int(b.get("parent", i - 1)) for i, b in enumerate(bodies)),
        joint_types=tuple(b.get("type", "hinge") for b in bodies),
        dt=float(dt), site_body=int(site_body))
