"""Autoregressive-filtered Gaussian action noise, keyed by (key, step).

Counterpart of mjmpc_tpu/ops/noise.py. The AR(2) IIR filter along the
horizon

    eps[:, i] = b0*eps[:, i] + b1*eps[:, i-1] + b2*eps[:, i-2]   for i >= 2

(previous values already filtered; eps[:, 0] and eps[:, 1] unfiltered) is a
Python loop over H on [N, dA] slices. Randomness is Philox4x32-10 under a
stream's 64-bit key with the solver state's step, a 0-d int64 tensor on
the device, as the last counter word (rng.py), so the same (key, step)
gives the same noise, no draw reads the device, and a draw captured in a
CUDA graph draws anew on every replay. The streams differ from JAX's, so
parity tests inject noise made with numpy.

`FilteredNoise` is the counterpart of mjmpc_tpu/ops/pallas_kernels.py
filtered_noise_pallas: Philox bits, Box-Muller normals and the AR(2)
filter in one CUDA kernel (csrc/filtered_noise.cu), then colouring by
chol(cov) as one matmul. Its plain version below draws the same Philox
bits in int64 tensor arithmetic, so kernel and plain agree to rounding.
`filtered_noise` is the plain sampler (the JAX package's "xla" noise): the
same kernel's normals with the filter off, coloured, then the filter as a
loop of tensor operations.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels import build


def ar_filter(eps: torch.Tensor, filter_coeffs: Sequence[float]) -> torch.Tensor:
    """Apply the AR(2) filter along dim 1 (horizon) of eps [N, H, dA].

    Returns a new tensor; eps is not modified.
    """
    b0, b1, b2 = (float(c) for c in filter_coeffs)
    if (b0, b1, b2) == (1.0, 0.0, 0.0) or eps.shape[1] <= 2:
        return eps
    out = eps.clone()
    for i in range(2, eps.shape[1]):
        out[:, i] = b0 * eps[:, i] + b1 * out[:, i - 1] + b2 * out[:, i - 2]
    return out


def colour(white: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Colour white noise [..., dA] by chol(cov + 1e-6 I); with B
    covariances [B, dA, dA], element b of white [B, ..., dA] by cov[b].

    The jitter keeps the factorization defined when a covariance collapses
    toward singular (CEM/DMD adaptation can drive variances to ~0).
    `cholesky_ex` skips the info check, which would sync the host on CUDA.
    """
    d_action = cov.shape[-1]
    jitter = 1e-6 * torch.eye(d_action, dtype=cov.dtype, device=cov.device)
    chol = torch.linalg.cholesky_ex(cov + jitter).L
    if cov.dim() == 3:   # B covariances, white [B, ..., dA]
        chol = chol.reshape(cov.shape[:1] + (1,) * (white.dim() - 3) + chol.shape[1:])
    return white @ chol.transpose(-1, -2).to(white.dtype)


# ---------------------------------------------------------------------------
# Philox4x32-10 (csrc/philox.cuh) on int64 tensors holding 32-bit words.
# A 32 x 32-bit product is split at 16 bits so that no intermediate leaves
# int64: the results are the kernel's bits exactly.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x."""
    a = x * (m >> 16)              # < 2^48
    c = x * (m & 0xFFFF)           # < 2^48
    hi = (a + (c >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + c) & _MASK32
    return hi, lo


def philox4x32_10(counter: Tuple[torch.Tensor, ...], key: Tuple[int, int]):
    """Ten Philox rounds on the counter words (c0, c1, c2, c3), int64
    tensors of values < 2^32, under the key (k0, k1); returns four words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """U[2^-25, 1) from the top 24 bits (filtered_noise.cuh uniform01)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)


_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def _box_muller(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(_uniform01(a))) * torch.cos(_TWO_PI_F32 * _uniform01(b))


def _key_words(key: int) -> Tuple[int, int]:
    key = int(key) & 0xFFFFFFFFFFFFFFFF
    return key & _MASK32, key >> 32


def check_step(step) -> torch.Tensor:
    """A solver state's step: a 0-d int64 tensor (rng.step_tensor)."""
    if not isinstance(step, torch.Tensor) or step.dtype != torch.int64 or step.dim() != 0:
        raise TypeError("step must be a 0-d int64 torch.Tensor (rng.step_tensor)")
    return step


def philox_normals(key: int, step: torch.Tensor, n: int, horizon: int,
                   d_action: int) -> torch.Tensor:
    """The kernel's standard normals [n, horizon, d_action] before the
    filter, on step's device: Philox counter (b, d, t // 2, step) under the
    64-bit key, words (x, y) for even t and (z, w) for odd t."""
    step = check_step(step)
    pairs = (horizon + 1) // 2
    idx = dict(dtype=torch.int64, device=step.device)
    shape = (n, d_action, pairs)
    b = torch.arange(n, **idx).view(n, 1, 1).expand(shape)
    d = torch.arange(d_action, **idx).view(1, d_action, 1).expand(shape)
    t = torch.arange(pairs, **idx).view(1, 1, pairs).expand(shape)
    x, y, z, w = philox4x32_10((b, d, t, (step & _MASK32).expand(shape)), _key_words(key))
    normals = torch.stack([_box_muller(x, y), _box_muller(z, w)], -1)
    return normals.reshape(n, d_action, 2 * pairs)[..., :horizon].transpose(1, 2)


def philox_uniforms(key: int, step: torch.Tensor, n: int) -> torch.Tensor:
    """The uniforms kernel's [n] uniforms in [2^-25, 1) on step's device:
    counter (q, 0xFFFFFFFF, 0, step) under the key gives uniforms 4q to
    4q + 3 (csrc/filtered_noise.cuh uniform_quad)."""
    step = check_step(step)
    quads = (n + 3) // 4
    q = torch.arange(quads, dtype=torch.int64, device=step.device)
    words = philox4x32_10((q, torch.full_like(q, _MASK32), torch.zeros_like(q),
                           (step & _MASK32).expand(quads)), _key_words(key))
    return _uniform01(torch.stack(words, -1)).reshape(-1)[:n]


def noise_flops(n: int, horizon: int, d_action: int) -> int:
    """Operations of one noise-kernel call, counted from
    csrc/filtered_noise.cuh (one per integer or float operation or
    transcendental): per element half a Philox call (10 rounds of two wide
    multiplies counted as two each, 4 xors and 2 key adds: 100), two
    uniforms (shift, convert, multiply, add: 8), Box-Muller (log, two
    multiplies, sqrt, cos, multiply: 6) and the filter (5)."""
    return n * horizon * d_action * (100 // 2 + 8 + 6 + 5)


def check_batch(keys, steps) -> int:
    """B, for the keys [B] (int64 holding each 64-bit key's bits,
    key_tensor) and steps [B] (int64) of a batch of draws on one device."""
    for name, x in (("keys", keys), ("steps", steps)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-d int64 torch.Tensor")
    if keys.shape != steps.shape or keys.shape[0] < 1 or keys.device != steps.device:
        raise ValueError(f"keys {tuple(keys.shape)} on {keys.device} and steps "
                         f"{tuple(steps.shape)} on {steps.device} must be [B>=1] on one device")
    return keys.shape[0]


def key_tensor(keys: Sequence[int], device) -> torch.Tensor:
    """64-bit stream keys as an int64 tensor [B] on `device` (each key's
    bits, two's complement), made once, outside any solve."""
    words = [int(k) & 0xFFFFFFFFFFFFFFFF for k in keys]
    return torch.tensor([w - (1 << 64) if w >= 1 << 63 else w for w in words],
                        dtype=torch.int64, device=device)


def _check_coeffs(filter_coeffs) -> Tuple[float, float, float]:
    coeffs = tuple(float(c) for c in filter_coeffs)
    if len(coeffs) != 3:
        raise ValueError(f"filter_coeffs must be (b0, b1, b2), got {filter_coeffs!r}")
    return coeffs


_NO_FILTER = (1.0, 0.0, 0.0)
_LIB = None


def library() -> build.KernelLibrary:
    """Build (at first use) and load the noise and uniforms kernels, and
    let the noise kernel take the card's largest shared memory (before any
    launch, so that no launch does it inside a captured graph)."""
    global _LIB
    if _LIB is None:
        lib = build.load("filtered_noise", "filtered_noise.cu", {})
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lib.filtered_noise_launch.argtypes = (
            [ctypes.c_ulonglong, p] + [ctypes.c_float] * 3 + [i] * 5 + [p, p])
        lib.lib.filtered_noise_batch_launch.argtypes = (
            [p, p] + [ctypes.c_float] * 3 + [i] * 6 + [p, p])
        lib.lib.philox_uniforms_launch.argtypes = [ctypes.c_ulonglong, p, i, p, p]
        for fn in (lib.lib.filtered_noise_launch, lib.lib.filtered_noise_batch_launch,
                   lib.lib.philox_uniforms_launch, lib.lib.filtered_noise_setup,
                   lib.lib.filtered_noise_max_smem):
            fn.restype = i
        lib.lib.filtered_noise_error_string.argtypes = [i]
        lib.lib.filtered_noise_error_string.restype = ctypes.c_char_p
        _raise_on(lib, lib.lib.filtered_noise_setup(), "filtered_noise setup")
        _LIB = lib
    return _LIB


def _raise_on(lib: build.KernelLibrary, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: " + lib.lib.filtered_noise_error_string(rc).decode())


def _cuda_device(step: torch.Tensor) -> torch.device:
    if step.device.type != "cuda":
        raise ValueError(f"no noise kernel for device {step.device}")
    return step.device


class FilteredNoise:
    """sampler(key, step, cov [dA, dA], (N, H), filter_coeffs) -> [N, H, dA]
    float32 on cov's device: AR(2)-filtered normals from Philox under the
    64-bit `key` at `step` (a 0-d int64 tensor on cov's device, read by the
    kernel from device memory), coloured by chol(cov + 1e-6 I). Filter and
    colouring commute (one acts along H, the other along dA), so this is the
    plain sampler's distribution: colour-then-filter there, filter-then-
    colour here, as the TPU kernel does it.

    `white_batch` / `batch` draw for B solver states in one launch of the
    same kernel (keys [B] and steps [B] on the device): element b is the
    single draw under (keys[b], steps[b]) bit for bit.

    `FilteredNoise.launches` counts kernel launches over all instances; it
    rises by one per launch and nowhere else (the plain version on CPU
    tensors does not count); `FilteredNoise.batch_launches` likewise counts
    the batched entry's.
    """
    launches = 0
    batch_launches = 0

    @staticmethod
    def library() -> build.KernelLibrary:
        """Build (at first use) and load the kernel."""
        return library()

    @staticmethod
    def _check(cov, shape):
        if not isinstance(cov, torch.Tensor) or cov.dtype != torch.float32:
            raise TypeError("cov must be a float32 torch.Tensor")
        if cov.dim() != 2 or cov.shape[0] != cov.shape[1] or cov.shape[0] < 1:
            raise ValueError(f"cov must be [dA, dA], got {tuple(cov.shape)}")
        n, horizon = (int(s) for s in shape)
        if n < 1 or horizon < 1:
            raise ValueError(f"shape must be (N>=1, H>=1), got {tuple(shape)}")
        return n, horizon, cov.shape[0]

    def white_plain(self, key: int, step: torch.Tensor, n: int, horizon: int, d_action: int,
                    filter_coeffs) -> torch.Tensor:
        """The kernel's output (filtered, not coloured) in plain PyTorch."""
        z = philox_normals(key, step, n, horizon, d_action)
        return ar_filter(z, _check_coeffs(filter_coeffs)).contiguous()

    def white(self, key: int, step: torch.Tensor, n: int, horizon: int, d_action: int,
              filter_coeffs, per_block: int = 0) -> torch.Tensor:
        """Filtered standard normals [n, horizon, d_action] on step's device:
        the kernel on a CUDA device, the plain version on the CPU.
        per_block: the particles a block of the kernel owns (0: the
        kernel's default for (H, dA)); it changes no bit of the result."""
        coeffs = _check_coeffs(filter_coeffs)
        step = check_step(step)
        if step.device.type == "cpu":
            return self.white_plain(key, step, n, horizon, d_action, coeffs)
        device = _cuda_device(step)
        lib = self.library()
        span = 4 * horizon * d_action * max(1, per_block)
        if span > 48 * 1024 and span > lib.lib.filtered_noise_max_smem():
            raise ValueError(f"{max(1, per_block)} particles' noise ({horizon} x {d_action} "
                             f"floats each) do not fit in a block's shared memory")
        use_filter = coeffs != _NO_FILTER and horizon > 2
        with torch.cuda.device(device):
            out = torch.empty((n, horizon, d_action), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.lib.filtered_noise_launch(
                int(key) & 0xFFFFFFFFFFFFFFFF, step.data_ptr(), *coeffs, int(use_filter), n,
                horizon, d_action, int(per_block), out.data_ptr(), stream)
        _raise_on(lib, rc, "filtered_noise kernel launch")
        FilteredNoise.launches += 1
        return out

    def white_batch_plain(self, keys: torch.Tensor, steps: torch.Tensor, n: int, horizon: int,
                          d_action: int, filter_coeffs) -> torch.Tensor:
        """white_batch in plain PyTorch: white_plain per element, stacked
        (reads the keys to the host)."""
        check_batch(keys, steps)
        return torch.stack([self.white_plain(k, steps[b], n, horizon, d_action, filter_coeffs)
                            for b, k in enumerate(keys.tolist())])

    def white_batch(self, keys: torch.Tensor, steps: torch.Tensor, n: int, horizon: int,
                    d_action: int, filter_coeffs) -> torch.Tensor:
        """white for B draws, [B, n, horizon, d_action], on the keys'
        device: keys [B] (key_tensor) and steps [B] int64, read by the
        kernel from device memory, one launch for any B; the plain version
        per element on the CPU."""
        coeffs = _check_coeffs(filter_coeffs)
        batch = check_batch(keys, steps)
        if steps.device.type == "cpu":
            return self.white_batch_plain(keys, steps, n, horizon, d_action, coeffs)
        device = _cuda_device(steps)
        for name, x in (("keys", keys), ("steps", steps)):
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        lib = self.library()
        use_filter = coeffs != _NO_FILTER and horizon > 2
        with torch.cuda.device(device):
            out = torch.empty((batch, n, horizon, d_action), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.lib.filtered_noise_batch_launch(
                keys.data_ptr(), steps.data_ptr(), *coeffs, int(use_filter), batch, n, horizon,
                d_action, 0, out.data_ptr(), stream)
        _raise_on(lib, rc, "filtered_noise batched kernel launch")
        FilteredNoise.batch_launches += 1
        return out

    def batch(self, keys: torch.Tensor, steps: torch.Tensor, cov: torch.Tensor, shape,
              filter_coeffs=_NO_FILTER) -> torch.Tensor:
        """The sampler for B draws: white_batch [B, N, H, dA] coloured by
        each element's chol(cov[b] + 1e-6 I), cov [B, dA, dA]."""
        n, horizon, d_action = self._check(cov[0], shape)
        if cov.shape != (keys.shape[0], d_action, d_action):
            raise ValueError(f"cov must be [B, dA, dA], got {tuple(cov.shape)}")
        return colour(self.white_batch(keys, steps, n, horizon, d_action, filter_coeffs), cov)

    def plain(self, key: int, step: torch.Tensor, cov: torch.Tensor, shape,
              filter_coeffs=_NO_FILTER) -> torch.Tensor:
        """The plain PyTorch version (any device)."""
        n, horizon, d_action = self._check(cov, shape)
        return colour(self.white_plain(key, step, n, horizon, d_action, filter_coeffs), cov)

    def __call__(self, key: int, step: torch.Tensor, cov: torch.Tensor, shape,
                 filter_coeffs=_NO_FILTER) -> torch.Tensor:
        n, horizon, d_action = self._check(cov, shape)
        return colour(self.white(key, step, n, horizon, d_action, filter_coeffs), cov)


class PhiloxUniforms:
    """uniforms(key, step, n) -> [n] float32 uniforms in [2^-25, 1) on
    step's device: the uniforms kernel (csrc/filtered_noise.cu) on a CUDA
    device, its plain version (philox_uniforms) on the CPU.

    `PhiloxUniforms.launches` counts kernel launches, as
    FilteredNoise.launches does.
    """
    launches = 0
    plain = staticmethod(philox_uniforms)

    def __call__(self, key: int, step: torch.Tensor, n: int) -> torch.Tensor:
        step = check_step(step)
        if int(n) < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if step.device.type == "cpu":
            return philox_uniforms(key, step, n)
        device = _cuda_device(step)
        lib = library()
        with torch.cuda.device(device):
            out = torch.empty((n,), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.lib.philox_uniforms_launch(int(key) & 0xFFFFFFFFFFFFFFFF, step.data_ptr(),
                                                n, out.data_ptr(), stream)
        _raise_on(lib, rc, "philox_uniforms kernel launch")
        PhiloxUniforms.launches += 1
        return out


_SAMPLER = FilteredNoise()
uniforms = PhiloxUniforms()


def standard_normals(key: int, step: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard normals of `shape` (at least one dim) on step's device: the
    noise kernel's with the filter off, [prod(shape[:-1]), 1, shape[-1]]
    reshaped (its plain version on the CPU)."""
    shape = tuple(int(s) for s in shape)
    lead = int(np.prod(shape[:-1], dtype=np.int64))
    return _SAMPLER.white(key, step, lead, 1, shape[-1], _NO_FILTER).reshape(shape)


def standard_normals_batch(keys: torch.Tensor, steps: torch.Tensor, d: int) -> torch.Tensor:
    """standard_normals(keys[b], steps[b], (d,)) for B elements, [B, d], in
    one batched launch of the noise kernel (its plain version on the CPU)."""
    return _SAMPLER.white_batch(keys, steps, 1, 1, d, _NO_FILTER).reshape(keys.shape[0], d)


def filtered_noise_batch(keys: torch.Tensor, steps: torch.Tensor, cov: torch.Tensor, shape,
                         filter_coeffs: Sequence[float] = _NO_FILTER) -> torch.Tensor:
    """The plain sampler for B draws, [B, N, H, dA]: the noise kernel's
    normals with the filter off in one batched launch (white_batch), each
    element coloured by its cov[b] ([B, dA, dA]), then the filter along H."""
    n, horizon, d_action = FilteredNoise._check(cov[0], shape)
    white = _SAMPLER.white_batch(keys, steps, n, horizon, d_action, _NO_FILTER)
    batch = keys.shape[0]
    coloured = colour(white, cov).reshape(batch * n, horizon, d_action)
    return ar_filter(coloured, filter_coeffs).reshape(batch, n, horizon, d_action)


def filtered_noise(key: int, step: torch.Tensor, cov: torch.Tensor, shape,
                   filter_coeffs: Sequence[float] = _NO_FILTER) -> torch.Tensor:
    """The plain sampler: AR(2)-filtered N(0, cov) noise [N, H, dA] from the
    stream (key, step): the noise kernel's normals with the filter off (its
    plain version on the CPU), coloured by chol(cov + 1e-6 I), then the
    filter as a loop of tensor operations (ar_filter)."""
    n, horizon, d_action = FilteredNoise._check(cov, shape)
    white = _SAMPLER.white(key, step, n, horizon, d_action, _NO_FILTER)
    return ar_filter(colour(white, cov), filter_coeffs)
