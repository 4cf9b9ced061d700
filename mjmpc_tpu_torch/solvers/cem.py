"""Cross-Entropy Method MPC.

Counterpart of mjmpc_tpu/solvers/cem.py: elites by lowest cost-to-go
(torch.topk of the negated costs), step-size-blended mean and covariance
updates over the elites reshaped to [H * n_elite, dA] (diagonal: the
population variance, ddof 0, as jnp.var; full: the unbiased covariance,
ddof 1, as np.cov), and covariance growth by beta * diag(init_cov) on
shift.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .. import ops
from ..rollout.engine import Trajectories
from .base import GaussianMPC, GaussianState


@dataclasses.dataclass(frozen=True)
class CEM(GaussianMPC):
    elite_frac: float = 0.1
    beta: float = 0.0   # covariance growth on shift

    @property
    def num_elite(self) -> int:
        # floor at 1: int(N * frac) == 0 for small N would select an empty
        # elite set whose mean and variance are NaN
        return max(1, int(self.num_particles * self.elite_frac))

    @functools.cached_property
    def cov_growth(self) -> torch.Tensor:
        """beta * diag(init_cov) on the solver's device, built once."""
        return (self.beta * self.init_cov) * torch.eye(self.d_action, device=self.device)

    def build_constants(self) -> None:
        super().build_constants()
        self.cov_growth

    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        q = ops.cost_to_go(traj.costs, self.discount)[:, 0]
        elite_ids = torch.topk(-q, self.num_elite).indices
        elite_actions = traj.actions.index_select(0, elite_ids)        # [k, H, dA]
        flat = (elite_actions - state.mean[None]).reshape(
            self.horizon * self.num_elite, self.d_action)
        if self.cov_type == "diagonal":
            cov_update = torch.diag(torch.var(flat, dim=0, correction=0))
        elif self.cov_type == "full":
            centered = flat - torch.mean(flat, dim=0, keepdim=True)
            cov_update = centered.T @ centered / (flat.shape[0] - 1)
        else:
            raise ValueError(f"unknown cov_type {self.cov_type!r}")
        new_cov = (1.0 - self.step_size) * state.cov + self.step_size * cov_update
        new_mean = self._interp_mean(state.mean, torch.mean(elite_actions, dim=0))
        return dataclasses.replace(state, mean=new_mean, cov=new_cov)

    def shift(self, state: GaussianState, last=None) -> GaussianState:
        """Shift the mean and grow the covariance."""
        state = super().shift(state, last)
        return dataclasses.replace(state, cov=state.cov + self.cov_growth)

    def value(self, state: GaussianState, traj: Trajectories) -> torch.Tensor:
        """Average cost-to-go."""
        return torch.mean(ops.cost_to_go(traj.costs, self.discount)[:, 0])
