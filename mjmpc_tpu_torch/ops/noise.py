"""Autoregressive-filtered Gaussian action noise.

Counterpart of mjmpc_tpu/ops/noise.py. The AR(2) IIR filter along the
horizon

    eps[:, i] = b0*eps[:, i] + b1*eps[:, i-1] + b2*eps[:, i-2]   for i >= 2

(previous values already filtered; eps[:, 0] and eps[:, 1] unfiltered) is a
Python loop over H on [N, dA] slices. Randomness comes from an explicit
`torch.Generator`; the streams differ from JAX's, so parity tests inject
noise made with numpy.
"""
from __future__ import annotations

from typing import Sequence

import torch


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
