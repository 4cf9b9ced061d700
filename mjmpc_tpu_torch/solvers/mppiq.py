"""MPPI with Q-function estimates: TD(lambda)-blended returns.

Counterpart of mjmpc_tpu/solvers/mppiq.py, the value-blending controller
of the ICLR'21 paper ("Blending MPC & Value Function Approximation..."):
per-step control costs, blended returns q_lam = q + lam * ctg(td_errors,
(gamma * lam)^t) and time-based softmax weights. Q estimates come from an
injected `q_fn(observations [N, H, d_obs], actions [N, H, dA]) -> [N, H]`,
any torch callable applied on the device; with one set the solver reads
observations, so build_solve_fn takes the env's obs-emitting rollout.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import ops
from ..rollout.engine import Trajectories
from .base import GaussianMPC, GaussianState


@dataclasses.dataclass(frozen=True)
class MPPIQ(GaussianMPC):
    beta: float = 1.0     # temperature
    td_lam: float = 1.0
    alpha: int = 0
    time_based_weights: bool = True
    q_fn: Optional[Callable] = None

    @property
    def uses_observations(self) -> bool:
        """A plugged Q function reads rollout observations, which the
        costs-only fused rollout does not produce."""
        return self.q_fn is not None

    @functools.cached_property
    def td_discount(self) -> Optional[torch.Tensor]:
        """The [H-1, H-1] discount matrix of the TD errors, weights
        (gamma * td_lam)^t, on the solver's device, built once (None at
        H = 1, which has no TD errors)."""
        if self.horizon == 1:
            return None
        weight_seq = np.cumprod([1.0] + [self.gamma * self.td_lam] * (self.horizon - 2))
        return ops.discount_matrix(weight_seq, device=self.device)

    def build_constants(self) -> None:
        super().build_constants()
        self.td_discount

    def calculate_returns(self, costs: torch.Tensor,
                          qvals: Optional[torch.Tensor]) -> torch.Tensor:
        """TD(lambda) blended returns [N, H]."""
        if qvals is None:
            qvals = torch.zeros_like(costs)
            qvals[:, -1] = costs[:, -1]
        if self.horizon == 1:
            # no TD errors at H = 1: the blended return is the terminal q
            # estimate (the terminal cost when no Q is plugged in)
            return qvals
        td_errors = costs[:, :-1] + self.gamma * qvals[:, 1:] - qvals[:, :-1]
        q_lam = qvals[:, :-1] + self.td_lam * ops.cost_to_go(td_errors, self.td_discount)
        return torch.cat([q_lam, qvals[:, -1:]], dim=1)

    def _control_costs(self, state: GaussianState, delta: torch.Tensor) -> torch.Tensor:
        """Per-step (undiscounted) control costs [N, H]; `inv_ex` skips the
        host-side info check."""
        if self.alpha == 1:
            return torch.zeros(delta.shape[:2], dtype=delta.dtype, device=delta.device)
        u_normalized = (state.mean @ torch.linalg.inv_ex(state.cov).inverse)[None]
        return torch.sum(0.5 * u_normalized * (state.mean[None] + 2.0 * delta), dim=-1)

    def _qvals(self, traj: Trajectories) -> Optional[torch.Tensor]:
        if self.q_fn is None:
            return None
        return self.q_fn(traj.observations, traj.actions)

    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        delta = traj.actions - state.mean[None]
        total = traj.costs + self.beta * self._control_costs(state, delta)
        q_hat = self.calculate_returns(total, self._qvals(traj))
        if self.time_based_weights:
            w = torch.softmax((-1.0 / self.beta) * q_hat, dim=0)
            weighted = torch.einsum("nh,nhd->hd", w, traj.actions)
        else:
            w = torch.softmax((-1.0 / self.beta) * q_hat[:, 0], dim=0)
            weighted = torch.einsum("n,nhd->hd", w, traj.actions)
        return dataclasses.replace(state, mean=self._interp_mean(state.mean, weighted))

    def value(self, state: GaussianState, traj: Trajectories) -> torch.Tensor:
        """Blended free energy."""
        delta = traj.actions - state.mean[None]
        total = traj.costs + self.beta * self._control_costs(state, delta)
        q_hat = self.calculate_returns(total, self._qvals(traj))[:, 0]
        return -self.beta * (torch.logsumexp((-1.0 / self.beta) * q_hat, dim=0)
                             - math.log(q_hat.shape[0]))
