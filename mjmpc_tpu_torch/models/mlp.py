"""Plain MLP policy (counterpart of mjmpc_tpu/models/mlp.py): the network
that closed-loop controllers roll out, and SAC's actor and critic bodies."""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Sequence

import torch

from .ensemble import _activation


class MLPLayerParams(NamedTuple):
    weight: torch.Tensor   # [n_in, n_out]
    bias: torch.Tensor     # [n_out]


@dataclasses.dataclass(frozen=True)
class MLPPolicy:
    d_obs: int
    d_action: int
    hidden: Sequence[int] = (64, 64)
    activation: str = "tanh"
    squash: bool = True      # tanh-squash the outputs into [-1, 1]

    def _dims(self):
        sizes = [self.d_obs, *self.hidden, self.d_action]
        return list(zip(sizes[:-1], sizes[1:]))

    def init_params(self, generator: torch.Generator, device="cuda") -> List[MLPLayerParams]:
        """Xavier-uniform weights drawn on the CPU from `generator`, then
        moved to `device`; zero biases."""
        params = []
        for n_in, n_out in self._dims():
            lim = math.sqrt(6.0 / (n_in + n_out))
            w = (2.0 * torch.rand((n_in, n_out), generator=generator) - 1.0) * lim
            params.append(MLPLayerParams(weight=w.to(device),
                                         bias=torch.zeros((n_out,), device=device)))
        return params

    def __call__(self, params: Sequence[MLPLayerParams], obs: torch.Tensor) -> torch.Tensor:
        act = _activation(self.activation)
        h = obs
        for i, lyr in enumerate(params):
            h = h @ lyr.weight + lyr.bias
            if i < len(params) - 1:
                h = act(h)
        return torch.tanh(h) if self.squash else h
