"""Naive random-shooting MPC.

Counterpart of mjmpc_tpu/solvers/random_shooting.py: step-size
interpolation of the mean toward the action sequence of lowest
cost-to-go. The argmin stays on the device: the row is picked with
index_select, since a 0-d CUDA tensor used as a Python index would read
it back to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import ops
from ..rollout.engine import Trajectories
from .base import GaussianMPC, GaussianState


@dataclasses.dataclass(frozen=True)
class RandomShooting(GaussianMPC):
    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        q = ops.cost_to_go(traj.costs, self.discount)
        best = torch.argmin(q[:, 0]).reshape(1)
        best_actions = traj.actions.index_select(0, best)[0]
        return dataclasses.replace(state, mean=self._interp_mean(state.mean, best_actions))

    def value(self, state: GaussianState, traj: Trajectories) -> torch.Tensor:
        """Average cost-to-go."""
        return torch.mean(ops.cost_to_go(traj.costs, self.discount)[:, 0])
