"""LQR-v0: linear dynamics under a quadratic cost.

Counterpart of mjmpc_tpu/envs/lqr.py: x' = A x + B u, reward = -(x'Qx +
u'Ru) at the pre-step state and the unclipped action, obs = x, never done.
The ground-truth fixture of iLQR (solvers/ilqr.py), whose plan equals the
finite-horizon dynamic-programming solution here.

State = LQRState(x [..., d]).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from .base import Env


@dataclasses.dataclass(frozen=True)
class LQRParams:
    A: torch.Tensor   # [d, d]
    B: torch.Tensor   # [d, dA]
    Q: torch.Tensor   # [d, d]
    R: torch.Tensor   # [dA, dA]


@dataclasses.dataclass(frozen=True)
class LQRState:
    x: torch.Tensor   # [..., d]


def init(params: LQRParams, seed: int) -> LQRState:
    """x ~ U(-100, 100) from a stream keyed by seed."""
    device = params.A.device
    u = torch.rand(params.A.shape[0], generator=rng.generator(rng.derive_seed(seed, 0), device),
                   device=device)
    return LQRState(x=200.0 * u - 100.0)


def observe(params: LQRParams, state: LQRState) -> torch.Tensor:
    return state.x


def _quad(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x' M x over the leading dimensions of x."""
    return torch.sum((x @ m) * x, -1)


def step(params: LQRParams, state: LQRState, action: torch.Tensor):
    x = state.x
    cost = _quad(x, params.Q) + _quad(action, params.R)
    new_x = x @ params.A.T + action @ params.B.T
    return LQRState(x=new_x), new_x, -cost, torch.zeros_like(cost, dtype=torch.bool)


def riccati_gain(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray,
                 iters: int = 500) -> np.ndarray:
    """The infinite-horizon discrete LQR gain K (u* = -K x) by value
    iteration, in numpy: the analytic oracle of the tests."""
    P = Q.copy()
    for _ in range(iters):
        BtP = B.T @ P
        K = np.linalg.solve(R + BtP @ B, BtP @ A)
        P = Q + A.T @ P @ (A - B @ K)
    return np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)


def make(A=None, B=None, Q=None, R=None, max_episode_steps: int = 100,
         device="cuda") -> Env:
    """LQR-v0; the default is a mildly unstable 2-D double integrator."""
    if A is None:
        A = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32)
        B = np.array([[0.0], [0.1]], np.float32)
        Q = np.eye(2, dtype=np.float32)
        R = 0.1 * np.eye(1, dtype=np.float32)
    device = torch.device(device)
    t = lambda m: torch.as_tensor(np.asarray(m, np.float32), device=device)
    params = LQRParams(A=t(A), B=t(B), Q=t(Q), R=t(R))
    d_action = params.B.shape[-1]
    return Env(name="LQR-v0", d_obs=params.A.shape[0], d_action=d_action,
               action_lows=torch.full((d_action,), -float("inf"), device=device),
               action_highs=torch.full((d_action,), float("inf"), device=device),
               params=params, init=init, step=step, observe=observe, device=device,
               max_episode_steps=max_episode_steps)
