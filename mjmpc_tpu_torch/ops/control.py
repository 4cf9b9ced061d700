"""Core control math as plain PyTorch functions.

Counterpart of mjmpc_tpu/ops/control.py (same names, same semantics).
Constants of a solve (the discount matrix) are built once, on the
solve's device, so that a solve makes no host-to-device copies.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def capturable_linalg(device: torch.device):
    """On a CUDA device, let batched factorisations and solves take
    cuSOLVER, whose calls run on the current stream and can be captured in
    a CUDA graph; at some sizes the default backend picks MAGMA's batched
    routines (the Reinforce fit's LU on 11 systems of ~170 x 170, the
    engine's Cholesky solve over N particles), which allocate or
    synchronise and invalidate a capture. Restores the caller's choice
    after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def gamma_sequence(gamma: float, horizon: int) -> np.ndarray:
    """Discount sequence [1, gamma, gamma^2, ...] of shape [1, horizon]
    (a host constant of the solve, as in the JAX package)."""
    return np.cumprod([1.0] + [float(gamma)] * (horizon - 1)).reshape(1, horizon)


def discount_matrix(gamma_seq, device=None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Upper-triangular [H, H] matrix M with M[s, t] = gamma_seq[s - t]
    for s >= t, else 0. Exact for every gamma, 0 included (M is then the
    identity), and for generalized weight sequences."""
    g = np.asarray(gamma_seq, np.float64).reshape(-1)
    h = g.shape[0]
    s = np.arange(h)[:, None]
    t = np.arange(h)[None, :]
    m = np.where(s >= t, g[np.abs(s - t)], 0.0)
    return torch.as_tensor(m, dtype=dtype, device=device)


def cost_to_go(cost_seq: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """Discounted cost-to-go: out[..., t] = sum_{s>=t} gamma^(s-t) c_s.

    `discount` is `discount_matrix(gamma_seq)` on cost_seq's device. One
    [.., H] @ [H, H] product in full f32 (TF32 is off package-wide), exact
    at gamma = 0; the reversed-cumsum-and-divide form is not used because
    it gives NaN at gamma = 0 and underflows for small gamma.
    """
    return torch.matmul(cost_seq, discount.to(cost_seq.dtype))


def scale_ctrl(ctrl: torch.Tensor, action_lows, action_highs,
               squash_fn: str = "clip") -> torch.Tensor:
    """Squash normalized controls into action bounds ('clip' to [-1, 1],
    'tanh', or 'none'), then map affinely into [lows, highs]."""
    half = (action_highs - action_lows) / 2.0
    mid = (action_highs + action_lows) / 2.0
    if squash_fn == "clip":
        ctrl = torch.clamp(ctrl, -1.0, 1.0)
    elif squash_fn == "tanh":
        ctrl = torch.tanh(ctrl)
    elif squash_fn != "none":
        raise ValueError(f"unknown squash_fn {squash_fn!r}")
    return mid + ctrl * half


def clip_ctrl(ctrl: torch.Tensor, action_lows, action_highs) -> torch.Tensor:
    """Hard-clip actions to bounds (what env.step does)."""
    return torch.clamp(ctrl, action_lows, action_highs)


# ---------------------------------------------------------------------------
# Gaussian utilities. Column convention as in the JAX package: x and mean
# are [N, num_samples] with N the event dimension.
# ---------------------------------------------------------------------------

def _cov_inv_logdet(cov: torch.Tensor, cov_type: str):
    if cov_type == "diagonal":
        d = torch.diagonal(cov)
        return torch.diag(1.0 / d), torch.sum(torch.log(d))
    chol = torch.linalg.cholesky_ex(cov).L
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return torch.cholesky_solve(eye, chol), logdet


def gaussian_logprob(mean, cov, x, cov_type: str = "full"):
    """log N(x; mean, cov) for samples in columns; returns [num_samples]."""
    n = cov.shape[0]
    cov_inv, cov_logdet = _cov_inv_logdet(cov, cov_type)
    diff = (x - mean).T
    maha = -0.5 * torch.sum((diff @ cov_inv) * diff, dim=1)
    return maha - 0.5 * n * math.log(2.0 * math.pi) - 0.5 * cov_logdet


def gaussian_logprobgrad(mean, cov, x, cov_type: str = "full"):
    """d log N(x) / d mean, shape [num_samples, N]."""
    cov_inv, _ = _cov_inv_logdet(cov, cov_type)
    return (x - mean).T @ cov_inv


def gaussian_entropy(cov, cov_type: str = "full"):
    """Entropy of N(., cov)."""
    n = cov.shape[0]
    _, cov_logdet = _cov_inv_logdet(cov, cov_type)
    return 0.5 * cov_logdet + 0.5 * n * (1.0 + math.log(2.0 * math.pi))


def gaussian_kl(mean0, cov0, mean1, cov1, cov_type: str = "full"):
    """KL(N0 || N1) per sample column."""
    n = cov0.shape[0]
    cov1_inv, cov1_logdet = _cov_inv_logdet(cov1, cov_type)
    if cov_type == "diagonal":
        cov0_logdet = torch.sum(torch.log(torch.diagonal(cov0)))
    else:
        _, cov0_logdet = _cov_inv_logdet(cov0, cov_type)
    term1 = 0.5 * torch.trace(cov1_inv @ cov0)
    diff = (mean1 - mean0).T
    maha = 0.5 * torch.sum((diff @ cov1_inv) * diff, dim=1)
    term3 = 0.5 * (-1.0 * n + cov1_logdet - cov0_logdet)
    return term1 + maha + term3
