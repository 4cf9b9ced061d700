"""Smooth penalty-contact primitives shared by the contact-rich envs.

Counterpart of mjmpc_tpu/envs/contact.py: a compliant spring-damper normal
force with saturated Coulomb friction, branch-free (torch.where gates), so
that every particle of a batch does the same work. Points and vectors are
[..., 3] tensors with any leading batch dimensions; radii and gains are
floats or tensors that broadcast against the batch.

Each helper returns the force ON body A given the separation vector and
the relative surface velocity; the caller applies +-f through
engine.chain.points_frame (or, in the forest rollout, through the point
Jacobians). The forest kernel (csrc/forest_rollout.cuh) computes the same
formulas in the same order.
"""
from __future__ import annotations

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, -1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(v, v))


def closest_on_segment(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """(closest point on segment ab to p [..., 3], interpolation weight t [...])."""
    d = b - a
    t = torch.clamp(_dot(p - a, d) / (_dot(d, d) + 1e-12), 0.0, 1.0)
    return a + t[..., None] * d, t


def force_along(n: torch.Tensor, overlap: torch.Tensor, rel_vel: torch.Tensor,
                kp, kd, mu, v_slip: float = 0.02) -> torch.Tensor:
    """The friction law every contact shape shares: a spring-damper normal
    force along the unit normal n (non-negative, gated on overlap > 0)
    plus Coulomb friction with smooth slip regularisation (|f_t| <= mu f_n,
    direction -v_t)."""
    vn = _dot(rel_vel, n)
    push = torch.clamp(kp * overlap - kd * vn, min=0.0)
    fn = torch.where(overlap > 0.0, push, torch.zeros_like(push))
    vt = rel_vel - vn[..., None] * n
    ft = -mu * fn[..., None] * vt / (_norm(vt) + v_slip)[..., None]
    return fn[..., None] * n + ft


def penalty_force(sep: torch.Tensor, rel_vel: torch.Tensor, overlap: torch.Tensor,
                  kp, kd, mu, v_slip: float = 0.02) -> torch.Tensor:
    """Force on body A. sep: vector from the closest point on B to A's
    point (the contact normal); rel_vel: v_A - v_B; overlap: combined
    radius minus distance (> 0 when penetrating)."""
    n = sep / (_norm(sep) + 1e-9)[..., None]
    return force_along(n, overlap, rel_vel, kp, kd, mu, v_slip)


def sphere_segment_force(p: torch.Tensor, v: torch.Tensor, r_sphere,
                         seg_a: torch.Tensor, seg_b: torch.Tensor,
                         v_a: torch.Tensor, v_b: torch.Tensor, r_seg, kp, kd, mu):
    """Sphere (at p, velocity v) against a capsule segment (world endpoints
    a, b with velocities v_a, v_b, radius r_seg). Returns (force on the
    sphere, t), t the closest point's weight: the reaction applies to the
    capsule as (1 - t)(-f) at a and t(-f) at b."""
    c, t = closest_on_segment(p, seg_a, seg_b)
    v_c = (1.0 - t)[..., None] * v_a + t[..., None] * v_b
    sep = p - c
    overlap = (r_sphere + r_seg) - _norm(sep)
    return penalty_force(sep, v - v_c, overlap, kp, kd, mu), t


def sphere_plane_force(p: torch.Tensor, v: torch.Tensor, r_sphere, kp, kd, mu,
                       z_plane: float = 0.0, v_slip: float = 0.02) -> torch.Tensor:
    """Sphere against the horizontal plane z = z_plane (force on the
    sphere). The normal is the plane's fixed +z, so a centre below the
    plane is still pushed up."""
    overlap = r_sphere - (p[..., 2] - z_plane)
    n = torch.zeros_like(p)
    n.select(-1, 2).fill_(1.0)   # a device fill: a step stays capturable
    return force_along(n, overlap, v, kp, kd, mu, v_slip)


def segment_segment_closest(a0: torch.Tensor, a1: torch.Tensor,
                            b0: torch.Tensor, b1: torch.Tensor):
    """Closest points between segments a and b: (p_a, p_b, s, t) with
    p_a = lerp(a0, a1, s), p_b = lerp(b0, b1, t); the clamped pairwise
    recurrence, branch-free."""
    d1, d2, r = a1 - a0, b1 - b0, a0 - b0
    a, e, b = _dot(d1, d1) + 1e-12, _dot(d2, d2) + 1e-12, _dot(d1, d2)
    c, f = _dot(d1, r), _dot(d2, r)
    denom = a * e - b * b
    s = torch.clamp(torch.where(denom > 1e-12, (b * f - c * e) / denom,
                                torch.zeros_like(denom)), 0.0, 1.0)
    t = torch.clamp((b * s + f) / e, 0.0, 1.0)
    s = torch.clamp((b * t - c) / a, 0.0, 1.0)
    return a0 + s[..., None] * d1, b0 + t[..., None] * d2, s, t


def capsule_capsule_force(a0, a1, v_a0, v_a1, r_a, b0, b1, r_b, kp, kd, mu):
    """Moving capsule A (endpoint velocities v_a0, v_a1) against a STATIC
    capsule B. Returns (force on A at its closest point, s): it applies to
    A's endpoints as (1 - s) f and s f."""
    p_a, p_b, s, _ = segment_segment_closest(a0, a1, b0, b1)
    v = (1.0 - s)[..., None] * v_a0 + s[..., None] * v_a1
    sep = p_a - p_b
    overlap = (r_a + r_b) - _norm(sep)
    return penalty_force(sep, v, overlap, kp, kd, mu), s


def sphere_sphere_force(p_a: torch.Tensor, v_a: torch.Tensor, r_a,
                        p_b: torch.Tensor, v_b: torch.Tensor, r_b, kp, kd, mu):
    """Sphere A against sphere B (force on A)."""
    sep = p_a - p_b
    overlap = (r_a + r_b) - _norm(sep)
    return penalty_force(sep, v_a - v_b, overlap, kp, kd, mu)
