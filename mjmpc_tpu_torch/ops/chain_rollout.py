"""Fused open-loop rollout of a scalar-joint chain: kernel wrappers and
their plain PyTorch version.

Counterpart of mjmpc_tpu/ops/pallas_chain.py build_chain_rollout (costs
only) and build_chain_obs_rollout (costs and per-step observations). The
kernels (csrc/chain_rollout.cu, one template with two entries) run one
thread per particle with q and qd in registers across all H * n_substeps
substeps; the model constants are compile-time constants in a header
generated here from the ChainModel.

Semantics (identical to the Pallas builder): for every particle b and step
t, u = clip(mean[t] + noise[b, t], ulow, uhigh) is held for n_substeps
semi-implicit Euler substeps (FK, Jacobian-composed mass matrix with
armature + dt*damping on the diagonal, zero-qdd RNEA bias, Cholesky solve
of M qdd = gear*u - bias - damping*qd - stiffness*q - frictionloss*
tanh(50 qd), then the joint-limit clamp with qd zeroed where clamped), and
cost[b, t] = l1 + 5*sqrt(|d|^2 + 1e-12) of d = site - target on the
post-step state. The obs rollout also gives obs[b, t] = [q, qd, site,
site - target] of the pre-step state (the state entering step t).

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

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


def _substep(model: ChainModel, q, qd, u, fk):
    """One semi-implicit Euler substep from fk = chain.fk_dofs(model, q)."""
    m, bias = _mass_and_bias(model, fk, qd)
    m = m + torch.diag(model.armature + model.dt * model.damping)
    rhs = (model.gear * u - bias - model.damping * qd - model.stiffness * q
           - model.frictionloss * torch.tanh(qd * 50.0))
    qd_new = qd + model.dt * _chol_solve(m, rhs)
    q_new = q + model.dt * qd_new
    clamped = torch.clamp(q_new, model.qpos_low, model.qpos_high)
    return clamped, torch.where(clamped == q_new, qd_new, torch.zeros_like(qd_new))


def _site(model: ChainModel, fk):
    """World position of the model's site [N, 3]."""
    rots, poss, _, _ = fk
    sb = model.site_body
    return poss[..., sb, :] + rots[..., sb, :, :] @ model.site_pos


def _site_cost(model: ChainModel, fk, target):
    """Reacher-family cost l1 + 5 * l2 of (site - target), l2 smoothed by
    1e-12 under the square root."""
    diff = _site(model, fk) - target
    l2 = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    return torch.sum(torch.abs(diff), dim=-1) + 5.0 * l2


def _reacher_obs(model: ChainModel, fk, q, qd, target):
    """[q, qd, site, site - target], d_obs = 2 nv + 6 (envs/reacher_7dof.py
    _observe)."""
    site = _site(model, fk)
    return torch.cat([q, qd, site, site - target], -1)


def rollout_plain(model: ChainModel, n_substeps: int, ulow: float, uhigh: float,
                  q0, qd0, target, mean, noise, emit_obs: bool = False):
    """Plain PyTorch rollout -> costs [N, H], or (obs [N, H, 2 nv + 6],
    costs) with emit_obs. The state after step t is the state before step
    t + 1, so one FK serves that step's cost, the next step's obs and the
    next step's first substep (as in the kernel)."""
    n, horizon, nv = noise.shape
    q = q0.expand(n, nv)
    qd = qd0.expand(n, nv)
    fk = chain.fk_dofs(model, q)
    costs, obs = [], []
    for t in range(horizon):
        if emit_obs:
            obs.append(_reacher_obs(model, fk, q, qd, target))
        u = torch.clamp(mean[t] + noise[:, t], ulow, uhigh)
        q, qd = _substep(model, q, qd, u, fk)
        for _ in range(n_substeps - 1):
            q, qd = _substep(model, q, qd, u, chain.fk_dofs(model, q))
        fk = chain.fk_dofs(model, q)
        costs.append(_site_cost(model, fk, target))
    if emit_obs:
        return torch.stack(obs, 1), torch.stack(costs, 1)
    return torch.stack(costs, 1)


def rollout_flops(model: ChainModel, n_substeps: int, n: int, horizon: int,
                  emit_obs: bool = False) -> int:
    """Floating-point operations of one kernel call, counted from
    csrc/chain_rollout.cuh as written (a multiply, an add, a compare or a
    transcendental is one; the chain's topology as the header bakes it).
    Used for the card-time bound: the work is the same for every input."""
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
    substep = mass + bias_fwd + bias_bwd + rest + chol
    site = mv + add
    cost = site + add + 5 + 7 + 2
    step = (n_substeps * (substep + fk) + cost + 3 * nb
            + ((site + add) if emit_obs else 0))
    return n * (fk + horizon * step)


# ---------------------------------------------------------------------------
# Kernel wrapper
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


def model_header(model: ChainModel, n_substeps: int, ulow: float,
                 uhigh: float) -> str:
    """C++ header of the model's constants for csrc/chain_rollout.cu."""
    npf = lambda t: t.detach().cpu().numpy().astype(np.float32)
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
        "namespace model {",
        f"constexpr int N = {n};",
        f"constexpr int N_SUBSTEPS = {int(n_substeps)};",
        f"constexpr int SITE_BODY = {int(model.site_body)};",
        f"constexpr float DT = {_f(model.dt)};",
        f"constexpr float ULOW = {_f(ulow)};",
        f"constexpr float UHIGH = {_f(uhigh)};",
    ]
    lines += [_array(*a) for a in arrays]
    lines.append("}  // namespace model")
    return "\n".join(lines) + "\n"


def _vp(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class ChainRollout:
    """rollout(q0 [nv], qd0 [nv], target [3], mean [H, nv],
    noise [N, H, nv]) -> costs [N, H], all float32 on one device.

    `ChainRollout.launches` counts kernel launches over all instances; it
    rises by one per launch and nowhere else (the plain version on CPU
    tensors does not count).
    """
    launches = 0
    emit_obs = False

    def __init__(self, model: ChainModel, n_substeps: int,
                 ulow: float = -1.0, uhigh: float = 1.0):
        self.model = model
        self.n_substeps = int(n_substeps)
        self.ulow = float(ulow)
        self.uhigh = float(uhigh)
        self.d_obs = 2 * model.nv + 6
        self.header = model_header(model, n_substeps, ulow, uhigh)
        self._lib = None

    def library(self) -> build.KernelLibrary:
        """Build (at first use) and load the kernels for this model."""
        if self._lib is None:
            lib = build.load("chain_rollout", "chain_rollout.cu",
                             {"chain_model.h": self.header})
            tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.lib.chain_rollout_launch.argtypes = [ctypes.c_void_p] * 6 + tail
            lib.lib.chain_obs_rollout_launch.argtypes = [ctypes.c_void_p] * 7 + tail
            lib.lib.chain_rollout_launch.restype = ctypes.c_int
            lib.lib.chain_obs_rollout_launch.restype = ctypes.c_int
            lib.lib.chain_rollout_error_string.argtypes = [ctypes.c_int]
            lib.lib.chain_rollout_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _check(self, q0, qd0, target, mean, noise):
        nv = self.model.nv
        args = dict(q0=q0, qd0=qd0, target=target, mean=mean, noise=noise)
        for name, x in args.items():
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if x.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {x.dtype}")
            if x.device != noise.device:
                raise ValueError(f"{name} is on {x.device}, noise on {noise.device}")
        if noise.dim() != 3 or noise.shape[2] != nv or noise.shape[0] < 1 \
                or noise.shape[1] < 1:
            raise ValueError(f"noise must be [N>=1, H>=1, {nv}], got "
                             f"{tuple(noise.shape)}")
        horizon = noise.shape[1]
        want = dict(q0=(nv,), qd0=(nv,), target=(3,), mean=(horizon, nv))
        for name, shape in want.items():
            if tuple(args[name].shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got "
                                 f"{tuple(args[name].shape)}")

    def plain(self, q0, qd0, target, mean, noise):
        """The plain PyTorch version (any device)."""
        self._check(q0, qd0, target, mean, noise)
        return rollout_plain(self.model, self.n_substeps, self.ulow,
                             self.uhigh, q0, qd0, target, mean, noise,
                             emit_obs=self.emit_obs)

    def __call__(self, q0, qd0, target, mean, noise):
        self._check(q0, qd0, target, mean, noise)
        device = noise.device
        if device.type == "cpu":
            return rollout_plain(self.model, self.n_substeps, self.ulow,
                                 self.uhigh, q0, qd0, target, mean, noise,
                                 emit_obs=self.emit_obs)
        if device.type != "cuda":
            raise ValueError(f"no chain-rollout kernel for device {device}")
        for name, x in dict(q0=q0, qd0=qd0, target=target, mean=mean,
                            noise=noise).items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        n, horizon, _ = noise.shape
        lib = self.library().lib
        with torch.cuda.device(device):
            costs = torch.empty((n, horizon), dtype=torch.float32, device=device)
            ptrs = [_vp(q0), _vp(qd0), _vp(target), _vp(mean), _vp(noise), _vp(costs)]
            if self.emit_obs:
                obs = torch.empty((n, horizon, self.d_obs), dtype=torch.float32,
                                  device=device)
                launch = lib.chain_obs_rollout_launch
                ptrs.append(_vp(obs))
            else:
                launch = lib.chain_rollout_launch
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = launch(*ptrs, n, horizon, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{type(self).__name__} kernel launch failed: "
                               + lib.chain_rollout_error_string(rc).decode())
        type(self).launches += 1
        return (obs, costs) if self.emit_obs else costs


class ChainObsRollout(ChainRollout):
    """rollout(q0, qd0, target, mean, noise) -> (obs [N, H, 2 nv + 6],
    costs [N, H]): ChainRollout's costs plus the observation of the state
    entering every step. Counts its own `ChainObsRollout.launches`."""
    launches = 0
    emit_obs = True


def build_chain_rollout(model: ChainModel, n_substeps: int, ulow: float = -1.0,
                        uhigh: float = 1.0) -> ChainRollout:
    """Fused rollout for a scalar-joint ChainModel (see ChainRollout)."""
    return ChainRollout(model, n_substeps, ulow, uhigh)


def build_chain_obs_rollout(model: ChainModel, n_substeps: int, ulow: float = -1.0,
                            uhigh: float = 1.0) -> ChainObsRollout:
    """Fused rollout that also emits observations (see ChainObsRollout)."""
    return ChainObsRollout(model, n_substeps, ulow, uhigh)
