"""Autoregressive-filtered Gaussian action noise.

Counterpart of mjmpc_tpu/ops/noise.py. The AR(2) IIR filter along the
horizon

    eps[:, i] = b0*eps[:, i] + b1*eps[:, i-1] + b2*eps[:, i-2]   for i >= 2

(previous values already filtered; eps[:, 0] and eps[:, 1] unfiltered) is a
Python loop over H on [N, dA] slices. Randomness comes from an explicit
`torch.Generator`; the streams differ from JAX's, so parity tests inject
noise made with numpy.

`FilteredNoise` is the counterpart of mjmpc_tpu/ops/pallas_kernels.py
filtered_noise_pallas: Philox bits, Box-Muller normals and the AR(2)
filter in one CUDA kernel (csrc/filtered_noise.cu), then colouring by
chol(cov) as one matmul. Its plain version below draws the same Philox
bits in int64 tensor arithmetic, so kernel and plain agree to rounding.
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
    """Colour white noise [..., dA] by chol(cov + 1e-6 I).

    The jitter keeps the factorization defined when a covariance collapses
    toward singular (CEM/DMD adaptation can drive variances to ~0).
    `cholesky_ex` skips the info check, which would sync the host on CUDA.
    """
    d_action = cov.shape[0]
    jitter = 1e-6 * torch.eye(d_action, dtype=cov.dtype, device=cov.device)
    chol = torch.linalg.cholesky_ex(cov + jitter).L
    return white @ chol.T.to(white.dtype)


def gaussian_noise(generator: torch.Generator, cov: torch.Tensor, shape: tuple,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Draw eps ~ N(0, cov) of shape [*shape, dA] on cov's device."""
    white = torch.randn(tuple(shape) + (cov.shape[0],), generator=generator,
                        dtype=dtype, device=cov.device)
    return colour(white, cov)


def filtered_noise(generator: torch.Generator, cov: torch.Tensor, shape: tuple,
                   filter_coeffs: Sequence[float] = (1.0, 0.0, 0.0),
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """AR(2)-filtered Gaussian noise [*shape, dA]."""
    return ar_filter(gaussian_noise(generator, cov, shape, dtype), filter_coeffs)


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


def philox_normals(seed: int, n: int, horizon: int, d_action: int,
                   device) -> torch.Tensor:
    """The kernel's standard normals [n, horizon, d_action] before the
    filter: Philox counter (b, d, t // 2, 0) under the 64-bit seed, words
    (x, y) for even t and (z, w) for odd t."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (seed & _MASK32, seed >> 32)
    pairs = (horizon + 1) // 2
    idx = dict(dtype=torch.int64, device=device)
    shape = (n, d_action, pairs)
    b = torch.arange(n, **idx).view(n, 1, 1).expand(shape)
    d = torch.arange(d_action, **idx).view(1, d_action, 1).expand(shape)
    t = torch.arange(pairs, **idx).view(1, 1, pairs).expand(shape)
    x, y, z, w = philox4x32_10((b, d, t, torch.zeros_like(b)), key)
    normals = torch.stack([_box_muller(x, y), _box_muller(z, w)], -1)
    return normals.reshape(n, d_action, 2 * pairs)[..., :horizon].transpose(1, 2)


def noise_flops(n: int, horizon: int, d_action: int) -> int:
    """Operations of one noise-kernel call, counted from
    csrc/filtered_noise.cuh (one per integer or float operation or
    transcendental): per element half a Philox call (10 rounds of two wide
    multiplies counted as two each, 4 xors and 2 key adds: 100), two
    uniforms (shift, convert, multiply, add: 8), Box-Muller (log, two
    multiplies, sqrt, cos, multiply: 6) and the filter (5)."""
    return n * horizon * d_action * (100 // 2 + 8 + 6 + 5)


def _check_coeffs(filter_coeffs) -> Tuple[float, float, float]:
    coeffs = tuple(float(c) for c in filter_coeffs)
    if len(coeffs) != 3:
        raise ValueError(f"filter_coeffs must be (b0, b1, b2), got {filter_coeffs!r}")
    return coeffs


class FilteredNoise:
    """sampler(seed, cov [dA, dA], (N, H), filter_coeffs) -> [N, H, dA]
    float32 on cov's device: AR(2)-filtered normals from Philox under the
    64-bit `seed`, coloured by chol(cov + 1e-6 I). Filter and colouring
    commute (one acts along H, the other along dA), so this is the plain
    sampler's distribution: colour-then-filter there, filter-then-colour
    here, as the TPU kernel does it.

    `FilteredNoise.launches` counts kernel launches over all instances; it
    rises by one per launch and nowhere else (the plain version on CPU
    tensors does not count).
    """
    launches = 0

    def __init__(self):
        self._lib = None

    def library(self) -> build.KernelLibrary:
        """Build (at first use) and load the kernel."""
        if self._lib is None:
            lib = build.load("filtered_noise", "filtered_noise.cu", {})
            lib.lib.filtered_noise_launch.argtypes = (
                [ctypes.c_ulonglong] + [ctypes.c_float] * 3
                + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p])
            lib.lib.filtered_noise_launch.restype = ctypes.c_int
            lib.lib.filtered_noise_error_string.argtypes = [ctypes.c_int]
            lib.lib.filtered_noise_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

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

    def white_plain(self, seed: int, n: int, horizon: int, d_action: int,
                    filter_coeffs, device) -> torch.Tensor:
        """The kernel's output (filtered, not coloured) in plain PyTorch."""
        z = philox_normals(seed, n, horizon, d_action, device)
        return ar_filter(z, _check_coeffs(filter_coeffs)).contiguous()

    def white(self, seed: int, n: int, horizon: int, d_action: int,
              filter_coeffs, device) -> torch.Tensor:
        """Filtered standard normals [n, horizon, d_action]: the kernel on a
        CUDA device, the plain version on the CPU."""
        coeffs = _check_coeffs(filter_coeffs)
        device = torch.device(device)
        if device.type == "cpu":
            return self.white_plain(seed, n, horizon, d_action, coeffs, device)
        if device.type != "cuda":
            raise ValueError(f"no filtered-noise kernel for device {device}")
        lib = self.library().lib
        use_filter = coeffs != (1.0, 0.0, 0.0) and horizon > 2
        with torch.cuda.device(device):
            out = torch.empty((n, horizon, d_action), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.filtered_noise_launch(
                int(seed) & 0xFFFFFFFFFFFFFFFF, *coeffs, int(use_filter), n, horizon,
                d_action, ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError("filtered_noise kernel launch failed: "
                               + lib.filtered_noise_error_string(rc).decode())
        FilteredNoise.launches += 1
        return out

    def plain(self, seed: int, cov: torch.Tensor, shape,
              filter_coeffs=(1.0, 0.0, 0.0)) -> torch.Tensor:
        """The plain PyTorch version (any device)."""
        n, horizon, d_action = self._check(cov, shape)
        return colour(self.white_plain(seed, n, horizon, d_action, filter_coeffs,
                                       cov.device), cov)

    def __call__(self, seed: int, cov: torch.Tensor, shape,
                 filter_coeffs=(1.0, 0.0, 0.0)) -> torch.Tensor:
        n, horizon, d_action = self._check(cov, shape)
        return colour(self.white(seed, n, horizon, d_action, filter_coeffs,
                                 cov.device), cov)
