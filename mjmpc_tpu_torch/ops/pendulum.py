"""The analytic pendulum's fused kernels: wrappers and plain PyTorch versions.

Counterpart of the pendulum half of mjmpc_tpu/ops/pallas_kernels.py:

- `pendulum_rollout(params, state, mean [H, 1], noise [N, H, 1])` -> costs
  [N, H]: kernel #7 (`pendulum_rollout_pallas`), SimplePendulum-v0's
  fused rollout. Its costs are those of the general rollout
  (rollout_open_loop), taken at each step's pre-step state.
- `mppi_pendulum_solve(params, state, mean [H, 1], seed, num_particles,
  filter_coeffs, sigma, lam, step_size, gamma)` -> new mean [H, 1]: kernel
  #8 (`mppi_pendulum_solve_pallas`), one whole MPPI solve (alpha = 1, one
  weight per particle) in one launch. Like the TPU kernel it samples n =
  round_up(max(N, 128), 128) particles, all of them live.

Both kernels (csrc/pendulum.cu) read the start state and the six params
from device memory at call time, packed by one device-side stack; no
wrapper reads a tensor back to the host. The plain versions below run the
kernels' float32 operations in the kernels' order: `step_cost` is also the
env's step (envs/pendulum.py). The wrappers run the plain version for CPU
tensors only; for CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from ..kernels import build
from .noise import _check_coeffs, ar_filter, noise_flops, philox_normals

_TWO_PI = 2.0 * math.pi
# The params the kernels read at call time (harness/episode.py _fused_mode).
PARAM_FIELDS = ("g", "m", "l", "dt", "max_speed", "max_torque")


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """x wrapped to [-pi, pi) by the floor modulo (torch.remainder, JAX's
    %): x + pi < 0 wraps into [0, 2 pi) before pi is taken off."""
    return torch.remainder(x + math.pi, _TWO_PI) - math.pi


def step_cost(params, th: torch.Tensor, thdot: torch.Tensor, a: torch.Tensor):
    """One control step under the commanded torque a: (cost of the pre-step
    state, th, thdot after the step). The torque is clipped, th advances
    with the unclamped new thdot and thdot is clamped last."""
    u = torch.clamp(a, -params.max_torque, params.max_torque)
    ang = angle_normalize(th)
    cost = ang * ang + 0.1 * (thdot * thdot) + 0.001 * (u * u)
    c_grav = (-3.0 * params.g) / (2.0 * params.l)
    c_torque = 3.0 / (params.m * (params.l * params.l))
    thdot = thdot + (c_grav * torch.sin(th + math.pi) + c_torque * u) * params.dt
    th = th + thdot * params.dt
    return cost, th, torch.clamp(thdot, -params.max_speed, params.max_speed)


def pendulum_rollout_plain(params, state, mean: torch.Tensor,
                           noise: torch.Tensor) -> torch.Tensor:
    """Kernel #7's plain PyTorch version (any device): costs [N, H] of the
    rollouts of mean[t] + noise[b, t] from state (th, thdot)."""
    n, horizon = noise.shape[0], noise.shape[1]
    th, thdot = state.th.expand(n), state.thdot.expand(n)
    costs = []
    for t in range(horizon):
        cost, th, thdot = step_cost(params, th, thdot, mean[t, 0] + noise[:, t, 0])
        costs.append(cost)
    return torch.stack(costs, 1)


def sampled_particles(num_particles: int) -> int:
    """Kernel #8's particle count: num_particles rounded up to a multiple of
    128, at least 128 (the TPU kernel's lane panel)."""
    return -(-max(int(num_particles), 128) // 128) * 128


def mppi_blend_plain(mean: torch.Tensor, eps: torch.Tensor, costs: torch.Tensor, lam: float,
                     step_size: float, gamma: float) -> torch.Tensor:
    """Kernel #8's update from its rollouts: the cost-to-go at t = 0 of
    costs [n, H] by backward recurrence, softmax weights of -ctg / lam, and
    the step-size blend of mean [H, 1] with the weighted mean of mean + eps
    [n, H, 1] (the actions before the clip)."""
    acc = costs[:, -1]
    for t in range(costs.shape[1] - 2, -1, -1):
        acc = costs[:, t] + gamma * acc
    neg = -acc * (1.0 / lam)
    ex = torch.exp(neg - neg.max())
    weighted = ((ex / ex.sum())[:, None] * (mean[:, 0] + eps[..., 0])).sum(0)
    return ((1.0 - step_size) * mean[:, 0] + step_size * weighted)[:, None]


def mppi_pendulum_update_plain(params, state, mean: torch.Tensor, white: torch.Tensor,
                               filter_coeffs=(1.0, 0.0, 0.0), sigma: float = 1.0,
                               lam: float = 0.01, step_size: float = 0.55,
                               gamma: float = 1.0) -> torch.Tensor:
    """Kernel #8's update on given white normals [n, H]: eps = sigma *
    AR(2)(white), the rollouts of mean + eps, then mppi_blend_plain."""
    eps = sigma * ar_filter(white[..., None], _check_coeffs(filter_coeffs))
    return mppi_blend_plain(mean, eps, pendulum_rollout_plain(params, state, mean, eps), lam,
                            step_size, gamma)


def mppi_pendulum_solve_plain(params, state, mean: torch.Tensor, seed: int,
                              num_particles: int, filter_coeffs=(1.0, 0.0, 0.0),
                              sigma: float = 1.0, lam: float = 0.01, step_size: float = 0.55,
                              gamma: float = 1.0) -> torch.Tensor:
    """Kernel #8's plain PyTorch version (any device): the update on the
    kernel's own normals, Philox under `seed` (ops/noise.py philox_normals),
    for sampled_particles(num_particles) particles."""
    n, horizon = sampled_particles(num_particles), mean.shape[0]
    white = philox_normals(seed, n, horizon, 1, mean.device)[..., 0]
    return mppi_pendulum_update_plain(params, state, mean, white, filter_coeffs, sigma, lam,
                                      step_size, gamma)


# ---------------------------------------------------------------------------
# Work counts, from csrc/pendulum.cuh (one per integer or float operation
# or transcendental).
# ---------------------------------------------------------------------------

# step(): the clip (2), the wrap (add, fmodf, compare, add, subtract: 5), the
# cost (3 products, 2 scalings, 2 adds: 7), the velocity update (add, sinf,
# 2 products, add, product, add: 7), th (2) and the clamp (2); plus the
# action's add.
_STEP_OPS = 26


def rollout_flops(n: int, horizon: int) -> int:
    return n * horizon * _STEP_OPS


def rollout_bytes(n: int, horizon: int) -> int:
    """The eight scalars and mean in, noise in and costs out."""
    return 4 * (8 + horizon + 2 * n * horizon)


def solve_flops(num_particles: int, horizon: int) -> int:
    """Per sampled particle-step: the noise (ops/noise.py noise_flops), the
    sigma scale (1), the step (26), the recurrence (2) and the weighted sum
    (divide, add, multiply, add: 4); per particle the scale by 1/lam, the
    max, the exp's subtract and exp and the sum (5); per row the blend (3)."""
    n = sampled_particles(num_particles)
    return (noise_flops(n, horizon, 1) + n * horizon * (1 + _STEP_OPS + 2 + 4)
            + 5 * n + 3 * horizon)


def solve_bytes(horizon: int) -> int:
    """The eight scalars and mean in, the new mean out."""
    return 4 * (8 + 2 * horizon)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_LIB: Optional[build.KernelLibrary] = None


def library() -> build.KernelLibrary:
    """Build (at first use) and load both kernels. -fmad=false keeps every
    multiply and add rounded on its own, as the plain version's operations
    are."""
    global _LIB
    if _LIB is None:
        lib = build.load("pendulum", "pendulum.cu", {}, flags=("-fmad=false",))
        p = ctypes.c_void_p
        lib.lib.pendulum_rollout_launch.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, p]
        lib.lib.pendulum_rollout_launch.restype = ctypes.c_int
        lib.lib.mppi_pendulum_solve_launch.argtypes = (
            [ctypes.c_ulonglong, p, p, p, p, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3
            + [ctypes.c_int] + [ctypes.c_float] * 5 + [p])
        lib.lib.mppi_pendulum_solve_launch.restype = ctypes.c_int
        lib.lib.pendulum_error_string.argtypes = [ctypes.c_int]
        lib.lib.pendulum_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _scalars(params, state, device: torch.device) -> torch.Tensor:
    """[th0, thdot0, g, m, l, dt, max_speed, max_torque] on `device`, by
    one stack (csrc/pendulum.cuh Scalar)."""
    parts = [state.th, state.thdot] + [getattr(params, f) for f in PARAM_FIELDS]
    for name, x in zip(("th", "thdot") + PARAM_FIELDS, parts):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.dim() != 0:
            raise TypeError(f"{name} must be a 0-d float32 tensor")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
    return torch.stack(parts)


def _check(mean: torch.Tensor, device: torch.device, horizon: int):
    if not isinstance(mean, torch.Tensor) or mean.dtype != torch.float32:
        raise TypeError("mean must be a float32 torch.Tensor")
    if tuple(mean.shape) != (horizon, 1) or horizon < 1:
        raise ValueError(f"mean must be [H>=1, 1], got {tuple(mean.shape)}")
    if mean.device != device:
        raise ValueError(f"mean is on {mean.device}, expected {device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + library().lib.pendulum_error_string(rc).decode())


def _cuda_launch_setup(device: torch.device, what: str):
    if device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {device}")
    return library().lib


class PendulumRollout:
    """rollout(params, state, mean [H, 1], noise [N, H, 1]) -> costs [N, H],
    float32 on the noise's device: kernel #7 on a CUDA device, its plain
    version on the CPU. It reads all six params at call time
    (`dynamic_fields`), so it plans against any PendulumParams.

    `PendulumRollout.launches` counts kernel launches; it rises by one per
    launch and nowhere else (the plain version on CPU tensors does not
    count).
    """
    launches = 0
    dynamic_fields = PARAM_FIELDS
    plain = staticmethod(pendulum_rollout_plain)

    def __call__(self, params, state, mean, noise):
        if not isinstance(noise, torch.Tensor) or noise.dtype != torch.float32:
            raise TypeError("noise must be a float32 torch.Tensor")
        if noise.dim() != 3 or noise.shape[2] != 1 or noise.shape[0] < 1:
            raise ValueError(f"noise must be [N>=1, H>=1, 1], got {tuple(noise.shape)}")
        n, horizon = noise.shape[0], noise.shape[1]
        _check(mean, noise.device, horizon)
        scalars = _scalars(params, state, noise.device)
        if noise.device.type == "cpu":
            return pendulum_rollout_plain(params, state, mean, noise)
        lib = _cuda_launch_setup(noise.device, "pendulum-rollout")
        if not (mean.is_contiguous() and noise.is_contiguous()):
            raise ValueError("mean and noise must be contiguous")
        with torch.cuda.device(noise.device):
            costs = torch.empty((n, horizon), dtype=torch.float32, device=noise.device)
            stream = torch.cuda.current_stream(noise.device).cuda_stream
            rc = lib.pendulum_rollout_launch(
                scalars.data_ptr(), mean.data_ptr(), noise.data_ptr(), costs.data_ptr(), n,
                horizon, stream)
        _raise_on(rc, "pendulum-rollout")
        PendulumRollout.launches += 1
        return costs


class MppiPendulumSolve:
    """solve(params, state, mean [H, 1], seed, num_particles, filter_coeffs,
    sigma, lam, step_size, gamma) -> new mean [H, 1]: kernel #8 on a CUDA
    device, its plain version (the same Philox normals) on the CPU. `seed`
    is a host integer (64 bits); the state and params are read on the
    device.

    `MppiPendulumSolve.launches` counts kernel launches, as
    PendulumRollout's does.
    """
    launches = 0
    plain = staticmethod(mppi_pendulum_solve_plain)

    def __call__(self, params, state, mean, seed: int, num_particles: int,
                 filter_coeffs: Sequence[float] = (1.0, 0.0, 0.0), sigma: float = 1.0,
                 lam: float = 0.01, step_size: float = 0.55, gamma: float = 1.0):
        coeffs = _check_coeffs(filter_coeffs)
        if not isinstance(mean, torch.Tensor):
            raise TypeError("mean must be a float32 torch.Tensor")
        horizon, device = mean.shape[0], mean.device
        _check(mean, device, horizon)
        if int(num_particles) < 1:
            raise ValueError(f"num_particles must be >= 1, got {num_particles}")
        if not lam > 0:
            raise ValueError(f"lam must be > 0, got {lam}")
        scalars = _scalars(params, state, device)
        if device.type == "cpu":
            return mppi_pendulum_solve_plain(params, state, mean, seed, num_particles, coeffs,
                                             sigma, lam, step_size, gamma)
        lib = _cuda_launch_setup(device, "one-kernel MPPI solve")
        mean = mean.contiguous()
        n = sampled_particles(num_particles)
        use_filter = coeffs != (1.0, 0.0, 0.0) and horizon > 2
        with torch.cuda.device(device):
            out = torch.empty((horizon, 1), dtype=torch.float32, device=device)
            scratch = torch.empty((2 * n * horizon + n,), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.mppi_pendulum_solve_launch(
                int(seed) & 0xFFFFFFFFFFFFFFFF, scalars.data_ptr(), mean.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), n, horizon, *coeffs, int(use_filter),
                float(sigma), 1.0 / float(lam), 1.0 - float(step_size), float(step_size),
                float(gamma), stream)
        _raise_on(rc, "one-kernel MPPI solve")
        MppiPendulumSolve.launches += 1
        return out


pendulum_rollout = PendulumRollout()
mppi_pendulum_solve = MppiPendulumSolve()
