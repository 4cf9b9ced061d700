"""Dynamic Mirror Descent MPC with Gaussian sampling (Wagener et al. 2019).

Counterpart of mjmpc_tpu/solvers/dmd.py: exponentiated-utility weights,
optional covariance adaptation (diagonal: the weighted second moment
averaged over H; full: the sqrt-weighted outer product over H), beta * I
covariance growth on shift when adapting, and the free-energy value.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import ops
from ..rollout.engine import Trajectories
from .base import GaussianMPC, GaussianState


@dataclasses.dataclass(frozen=True)
class DMDMPC(GaussianMPC):
    lam: float = 1.0
    beta: float = 0.0
    update_cov: bool = False

    @functools.cached_property
    def cov_growth(self) -> torch.Tensor:
        """beta * I on the solver's device, built once."""
        return self.beta * torch.eye(self.d_action, device=self.device)

    def build_constants(self) -> None:
        super().build_constants()
        self.cov_growth

    def _traj_costs(self, costs: torch.Tensor) -> torch.Tensor:
        return ops.cost_to_go(costs, self.discount)[:, 0]

    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        delta = traj.actions - state.mean[None]
        w = torch.softmax((-1.0 / self.lam) * self._traj_costs(traj.costs), dim=0)
        new_cov = state.cov
        if self.update_cov:
            if self.cov_type == "diagonal":
                second_moment = torch.einsum("n,nhd->hd", w, delta * delta)
                cov_update = torch.diag(torch.mean(second_moment, dim=0))
            elif self.cov_type == "full":
                wd = torch.sqrt(w)[:, None, None] * delta
                flat = wd.reshape(self.num_particles * self.horizon, self.d_action)
                cov_update = flat.T @ flat / self.horizon
            else:
                raise ValueError(f"unknown cov_type {self.cov_type!r}")
            new_cov = (1.0 - self.step_size) * state.cov + self.step_size * cov_update
        weighted = torch.einsum("n,nhd->hd", w, traj.actions)
        return dataclasses.replace(state, mean=self._interp_mean(state.mean, weighted),
                                   cov=new_cov)

    def shift(self, state: GaussianState, last=None) -> GaussianState:
        """Shift the mean; grow the covariance by beta * I when adapting."""
        state = super().shift(state, last)
        if self.update_cov:
            state = dataclasses.replace(state, cov=state.cov + self.cov_growth)
        return state

    def value(self, state: GaussianState, traj: Trajectories) -> torch.Tensor:
        """Free energy -lam * (logsumexp(-cost / lam) - log N)."""
        traj_costs = self._traj_costs(traj.costs)
        return -self.lam * (torch.logsumexp((-1.0 / self.lam) * traj_costs, dim=0)
                            - math.log(traj_costs.shape[0]))
