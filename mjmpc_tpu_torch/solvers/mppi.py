"""Model Predictive Path Integral control (Williams et al. 2017).

Counterpart of mjmpc_tpu/solvers/mppi.py: exponential-utility weights over
the discounted cost-to-go plus an optional control cost, a step-size
blended mean update and the free-energy value. Softmax and sums run over
the particle axis (dim 0); the products run in full f32.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import ops
from ..rollout.engine import Trajectories
from .base import GaussianMPC, GaussianState


@dataclasses.dataclass(frozen=True)
class MPPI(GaussianMPC):
    lam: float = 1.0
    alpha: int = 0                    # 0: control cost on; 1: off
    time_based_weights: bool = False

    def _control_costs(self, state: GaussianState,
                       delta: torch.Tensor) -> torch.Tensor:
        """0.5 * (mean cov^-1) . (mean + 2 delta), summed over action dims
        and discounted. `inv_ex` skips the host-side info check."""
        if self.alpha == 1:
            shape = (delta.shape[:2] if self.time_based_weights
                     else delta.shape[:1])
            return torch.zeros(shape, dtype=delta.dtype, device=delta.device)
        u_normalized = (state.mean @ torch.linalg.inv_ex(state.cov).inverse)[None]
        cc = 0.5 * u_normalized * (state.mean[None] + 2.0 * delta)
        cc = ops.cost_to_go(torch.sum(cc, dim=-1), self.discount)
        if not self.time_based_weights:
            cc = cc[:, 0]
        return cc

    def _exp_util(self, state: GaussianState, costs, delta) -> torch.Tensor:
        """softmax(-(ctg + lam * control_cost) / lam) over particles."""
        traj_costs = ops.cost_to_go(costs, self.discount)
        if not self.time_based_weights:
            traj_costs = traj_costs[:, 0]
        total = traj_costs + self.lam * self._control_costs(state, delta)
        return torch.softmax((-1.0 / self.lam) * total, dim=0)

    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        delta = traj.actions - state.mean[None]
        w = self._exp_util(state, traj.costs, delta)
        if self.time_based_weights:
            weighted = torch.einsum("nh,nhd->hd", w, traj.actions)
        else:
            weighted = torch.einsum("n,nhd->hd", w, traj.actions)
        return dataclasses.replace(
            state, mean=self._interp_mean(state.mean, weighted))

    def value(self, state: GaussianState, traj: Trajectories) -> torch.Tensor:
        """Free energy -lam * (logsumexp(-cost / lam) - log N)."""
        delta = traj.actions - state.mean[None]
        traj_costs = ops.cost_to_go(traj.costs, self.discount)[:, 0]
        cc = self._control_costs(state, delta)
        if self.time_based_weights:
            cc = cc[:, 0]
        total = traj_costs + self.lam * cc
        n = total.shape[0]
        return -self.lam * (torch.logsumexp((-1.0 / self.lam) * total, dim=0)
                            - math.log(n))
