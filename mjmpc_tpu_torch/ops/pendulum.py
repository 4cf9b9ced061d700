"""The analytic pendulum's fused kernels: wrappers and plain PyTorch versions.

Counterpart of the pendulum half of mjmpc_tpu/ops/pallas_kernels.py:

- `pendulum_rollout(params, state, mean [H, 1], noise [N, H, 1])` -> costs
  [N, H]: kernel #7 (`pendulum_rollout_pallas`), SimplePendulum-v0's
  fused rollout. Its costs are those of the general rollout
  (rollout_open_loop), taken at each step's pre-step state.
- `mppi_pendulum_solve(params, state, mean [H, 1], key, step, num_particles,
  filter_coeffs, sigma, lam, step_size, gamma)` -> new mean [H, 1]: kernel
  #8 (`mppi_pendulum_solve_pallas`), one whole MPPI solve (alpha = 1, one
  weight per particle) in one launch of one thread-block cluster. Like the
  TPU kernel it samples n = round_up(max(N, 128), 128) particles, all of
  them live. Its noise is Philox under the 64-bit stream `key` at `step`, a
  0-d int64 tensor that the kernel reads from device memory, so a launch
  captured in a CUDA graph draws anew on every replay once the caller
  advances the step on the device.

Both kernels (csrc/pendulum.cu) read the start state and the six params
from device memory at call time, packed by one device-side stack; no
wrapper reads a tensor back to the host. The plain versions below run the
kernels' float32 operations in the kernels' order: `step_cost` is also the
env's step (envs/pendulum.py). The wrappers run the plain version for CPU
tensors only; for CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from ..kernels import build
from .noise import _check_coeffs, ar_filter, check_step, noise_flops, philox_normals

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
    costs [n, H] by backward recurrence, softmax weights ex * (1 / sum(ex))
    of -ctg / lam, and the step-size blend of mean [H, 1] with the weighted
    mean of mean + eps [n, H, 1] (the actions before the clip)."""
    acc = costs[:, -1]
    for t in range(costs.shape[1] - 2, -1, -1):
        acc = costs[:, t] + gamma * acc
    neg = -acc * (1.0 / lam)
    ex = torch.exp(neg - neg.max())
    weighted = ((ex * (1.0 / ex.sum()))[:, None] * (mean[:, 0] + eps[..., 0])).sum(0)
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


def mppi_pendulum_solve_plain(params, state, mean: torch.Tensor, key: int,
                              step: torch.Tensor, num_particles: int,
                              filter_coeffs=(1.0, 0.0, 0.0), sigma: float = 1.0,
                              lam: float = 0.01, step_size: float = 0.55,
                              gamma: float = 1.0) -> torch.Tensor:
    """Kernel #8's plain PyTorch version (any device): the update on the
    kernel's own normals, Philox under `key` at `step` (ops/noise.py
    philox_normals), for sampled_particles(num_particles) particles."""
    n, horizon = sampled_particles(num_particles), mean.shape[0]
    white = philox_normals(key, step, n, horizon, 1)[..., 0]
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
    (add, multiply, add: 3); per particle the scale by 1/lam, the max, the
    exp's subtract and exp, the sum and the weight's multiply (6); per row
    the blend (3)."""
    n = sampled_particles(num_particles)
    return (noise_flops(n, horizon, 1) + n * horizon * (1 + _STEP_OPS + 2 + 3)
            + 6 * n + 3 * horizon)


def solve_bytes(horizon: int) -> int:
    """The eight scalars and mean in, the new mean out."""
    return 4 * (8 + 2 * horizon)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_LIB: Optional[build.KernelLibrary] = None
# Kernel #7's particles a block that the sweep times (tools/kernel_ab.py
# --pendulum-sweep) and that chip_smoke.py checks.
ROLLOUT_PER_BLOCK = (1, 2, 4, 8, 16, 32, 64, 128)
# Kernel #8's cluster sizes (CTAs of one cluster): 16 needs the card's
# non-portable cluster sizes, which csrc/pendulum.cu's setup allows.
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def solve_cluster(n: int) -> int:
    """Kernel #8's cluster size for n sampled particles (a multiple of
    128): one CTA per 128 particles, at least 4 and at most 16. From the
    sweep of 1-16 CTAs at N = 128, 1024, 2048 and 8192 on an H100
    (tools/kernel_ab.py --cluster-sweep; PERF.md §6): 4 CTAs fastest at
    N=128 (0.0163 ms against 0.0181 for one), 8 at 1024, 16 at 2048; only
    16 hold N=8192 (512 particles a CTA). A CTA's particles each run their
    H steps on one thread, so fewer per CTA shorten only the noise and the
    sums."""
    return max(4, min(16, n // 128))


def library() -> build.KernelLibrary:
    """Build (at first use) and load both kernels, let both take the card's
    largest shared memory and #8 clusters of 16 (before any launch, so that
    no launch does it inside a captured graph). -fmad=false keeps every
    multiply and add rounded on its own, as the plain version's operations
    are."""
    global _LIB
    if _LIB is None:
        lib = build.load("pendulum", "pendulum.cu", {}, flags=("-fmad=false",))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lib.pendulum_rollout_launch.argtypes = [p, p, p, p, i, i, i, p]
        lib.lib.pendulum_rollout_batch_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.lib.pendulum_rollout_per_block.argtypes = [i, i]
        lib.lib.mppi_pendulum_solve_launch.argtypes = (
            [ctypes.c_ulonglong, p, p, p, p, i, i, i] + [ctypes.c_float] * 3 + [i]
            + [ctypes.c_float] * 5 + [p])
        lib.lib.mppi_pendulum_solve_shape.argtypes = [i, i, i, p, p]
        lib.lib.mppi_pendulum_solve_max_clusters.argtypes = [i, i, i, p]
        for fn in (lib.lib.pendulum_rollout_launch, lib.lib.pendulum_rollout_batch_launch,
                   lib.lib.pendulum_rollout_per_block,
                   lib.lib.mppi_pendulum_solve_launch, lib.lib.pendulum_setup,
                   lib.lib.mppi_pendulum_solve_shape, lib.lib.mppi_pendulum_solve_max_clusters):
            fn.restype = i
        lib.lib.pendulum_error_string.argtypes = [i]
        lib.lib.pendulum_error_string.restype = ctypes.c_char_p
        rc = lib.lib.pendulum_setup()
        if rc != 0:
            raise RuntimeError("pendulum kernels' setup failed: "
                               + lib.lib.pendulum_error_string(rc).decode())
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=64)
def solve_shape(n: int, horizon: int, ctas: int):
    """(threads a CTA, dynamic shared memory bytes) of kernel #8's launch
    over n sampled particles in clusters of `ctas`; raises ValueError where
    the CTA's particles or tiles do not fit (csrc/pendulum.cu
    mppi_pendulum_solve_shape)."""
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = library().lib.mppi_pendulum_solve_shape(n, horizon, ctas, ctypes.byref(threads),
                                                 ctypes.byref(smem))
    if rc != 0:
        raise ValueError(f"kernel #8 cannot hold N={n} H={horizon} in clusters of {ctas} CTAs "
                         f"(at most 1024 particles a CTA, its tiles in shared memory)")
    return threads.value, smem.value


def rollout_per_block(n: int, horizon: int) -> int:
    """Kernel #7's particles a block at n particles, H steps: the fewest of
    4, 8, 16, ... that keeps the grid within 8 blocks an SM (4 up to N =
    4224 on an H100; csrc/pendulum.cu pendulum_rollout_per_block)."""
    return int(library().lib.pendulum_rollout_per_block(int(n), int(horizon)))


def max_active_clusters(n: int, horizon: int, ctas: int) -> int:
    """The clusters of kernel #8's shape the card holds at once (0: none)."""
    solve_shape(n, horizon, ctas)
    out = ctypes.c_int(0)
    rc = library().lib.mppi_pendulum_solve_max_clusters(n, horizon, ctas, ctypes.byref(out))
    _raise_on(rc, "one-kernel MPPI solve occupancy")
    return out.value


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

    `per_block` is the particles a block of the kernel owns (0: the
    kernel's rule, rollout_per_block); it changes no bit of the costs,
    since each particle's arithmetic is the same in every partition.

    `batch` runs B such rollouts (B states, each param 0-d or [B], means
    [B, H, 1], noise [B, N, H, 1]) in one launch, each element on blocks
    of its own; element b equals the single rollout of element b's inputs
    bit for bit. `batched` is the same call: the env's batched fused
    rollout (Env.fused_rollout's `batched`).

    `PendulumRollout.launches` counts kernel launches; it rises by one per
    launch and nowhere else (the plain version on CPU tensors does not
    count); `PendulumRollout.batch_launches` likewise counts the batched
    entry's.
    """
    launches = 0
    batch_launches = 0
    dynamic_fields = PARAM_FIELDS
    plain = staticmethod(pendulum_rollout_plain)

    def __call__(self, params, state, mean, noise, per_block: int = 0):
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
                horizon, int(per_block), stream)
        _raise_on(rc, "pendulum-rollout")
        PendulumRollout.launches += 1
        return costs

    @staticmethod
    def _check_batch(params, states, mean, noise):
        """The batch's scalars [B, 8] (th, thdot, then the six params, each
        0-d or [B]); raises on a bad shape, dtype or device."""
        if not isinstance(noise, torch.Tensor) or noise.dtype != torch.float32:
            raise TypeError("noise must be a float32 torch.Tensor")
        if noise.dim() != 4 or noise.shape[3] != 1 or min(noise.shape[:3]) < 1:
            raise ValueError(f"noise must be [B>=1, N>=1, H>=1, 1], got {tuple(noise.shape)}")
        batch, horizon = noise.shape[0], noise.shape[2]
        if not isinstance(mean, torch.Tensor) or mean.dtype != torch.float32:
            raise TypeError("mean must be a float32 torch.Tensor")
        if tuple(mean.shape) != (batch, horizon, 1):
            raise ValueError(f"mean must be [B, H, 1] = {(batch, horizon, 1)}, got "
                             f"{tuple(mean.shape)}")
        if mean.device != noise.device:
            raise ValueError(f"mean is on {mean.device}, expected {noise.device}")
        parts = [states.th, states.thdot] + [getattr(params, f) for f in PARAM_FIELDS]
        for name, x in zip(("th", "thdot") + PARAM_FIELDS, parts):
            if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
                raise TypeError(f"{name} must be a float32 tensor")
            if x.shape not in ((batch,), ()) or (name in ("th", "thdot") and x.dim() != 1):
                raise ValueError(f"{name} must be [{batch}]" + ("" if name in ("th", "thdot")
                                                                 else " or 0-d"))
            if x.device != noise.device:
                raise ValueError(f"{name} is on {x.device}, expected {noise.device}")
        return torch.stack([x.expand(batch) for x in parts], 1)

    @staticmethod
    def batch_plain(params, states, mean, noise):
        """batch in plain PyTorch (any device): the plain rollout of each
        element, stacked."""
        PendulumRollout._check_batch(params, states, mean, noise)
        rows = []
        for b in range(noise.shape[0]):
            p = type(params)(**{f: getattr(params, f) if getattr(params, f).dim() == 0
                                else getattr(params, f)[b] for f in PARAM_FIELDS})
            st = type(states)(th=states.th[b], thdot=states.thdot[b])
            rows.append(pendulum_rollout_plain(p, st, mean[b], noise[b]))
        return torch.stack(rows)

    def batch(self, params, states, mean, noise, per_block: int = 0):
        """B rollouts -> costs [B, N, H]: on a CUDA device one launch of
        the kernel, ceil(N / per_block) blocks an element (per_block 0:
        the rule's at B N particles), the plain version per element on the
        CPU."""
        scalars = self._check_batch(params, states, mean, noise)
        if noise.device.type == "cpu":
            return self.batch_plain(params, states, mean, noise)
        lib = _cuda_launch_setup(noise.device, "pendulum-rollout")
        if not (mean.is_contiguous() and noise.is_contiguous()):
            raise ValueError("mean and noise must be contiguous")
        batch, n, horizon = noise.shape[:3]
        with torch.cuda.device(noise.device):
            costs = torch.empty((batch, n, horizon), dtype=torch.float32, device=noise.device)
            stream = torch.cuda.current_stream(noise.device).cuda_stream
            rc = lib.pendulum_rollout_batch_launch(
                scalars.data_ptr(), mean.data_ptr(), noise.data_ptr(), costs.data_ptr(), batch,
                n, horizon, int(per_block), stream)
        _raise_on(rc, "batched pendulum-rollout")
        PendulumRollout.batch_launches += 1
        return costs

    batched = batch


class MppiPendulumSolve:
    """solve(params, state, mean [H, 1], key, step, num_particles,
    filter_coeffs, sigma, lam, step_size, gamma, ctas=None) -> new mean
    [H, 1]: kernel #8 on a CUDA device, its plain version (the same Philox
    normals) on the CPU. `key` is the stream's 64-bit key (a host integer);
    `step` a 0-d int64 tensor on the mean's device, read by the kernel from
    device memory; the state and params are read on the device too. `ctas`
    is the cluster's size (default solve_cluster(n)); it changes no bit of
    the particles' rollouts, only the order of the sums over them.

    `MppiPendulumSolve.launches` counts kernel launches, as
    PendulumRollout's does.
    """
    launches = 0
    plain = staticmethod(mppi_pendulum_solve_plain)

    def __call__(self, params, state, mean, key: int, step: torch.Tensor, num_particles: int,
                 filter_coeffs: Sequence[float] = (1.0, 0.0, 0.0), sigma: float = 1.0,
                 lam: float = 0.01, step_size: float = 0.55, gamma: float = 1.0,
                 ctas: Optional[int] = None):
        coeffs = _check_coeffs(filter_coeffs)
        if not isinstance(mean, torch.Tensor):
            raise TypeError("mean must be a float32 torch.Tensor")
        horizon, device = mean.shape[0], mean.device
        _check(mean, device, horizon)
        check_step(step)
        if step.device != device:
            raise ValueError(f"step is on {step.device}, expected {device}")
        if int(num_particles) < 1:
            raise ValueError(f"num_particles must be >= 1, got {num_particles}")
        if not lam > 0:
            raise ValueError(f"lam must be > 0, got {lam}")
        scalars = _scalars(params, state, device)
        if device.type == "cpu":
            return mppi_pendulum_solve_plain(params, state, mean, key, step, num_particles,
                                             coeffs, sigma, lam, step_size, gamma)
        lib = _cuda_launch_setup(device, "one-kernel MPPI solve")
        mean = mean.contiguous()
        n = sampled_particles(num_particles)
        ctas = solve_cluster(n) if ctas is None else int(ctas)
        solve_shape(n, horizon, ctas)
        use_filter = coeffs != (1.0, 0.0, 0.0) and horizon > 2
        with torch.cuda.device(device):
            out = torch.empty((horizon, 1), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.mppi_pendulum_solve_launch(
                int(key) & 0xFFFFFFFFFFFFFFFF, step.data_ptr(), scalars.data_ptr(),
                mean.data_ptr(), out.data_ptr(), n, horizon, ctas, *coeffs, int(use_filter),
                float(sigma), 1.0 / float(lam), 1.0 - float(step_size), float(step_size),
                float(gamma), stream)
        _raise_on(rc, "one-kernel MPPI solve")
        MppiPendulumSolve.launches += 1
        return out


pendulum_rollout = PendulumRollout()
mppi_pendulum_solve = MppiPendulumSolve()
