"""Batched-ensemble MLP.

Counterpart of mjmpc_tpu/models/ensemble.py: E independent MLPs whose
weights carry the ensemble as a leading axis ([E, in, out]), so that a
layer is one batched product (torch.baddbmm) over the ensemble.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Sequence

import torch


class EnsembleLayerParams(NamedTuple):
    weight: torch.Tensor  # [E, n_in, n_out]
    bias: torch.Tensor    # [E, 1, n_out]


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "swish":
        return torch.nn.functional.silu
    if name == "relu":
        return torch.relu
    if name == "leaky_relu":
        return lambda x: torch.nn.functional.leaky_relu(x, 0.01)
    if name == "tanh":
        return torch.tanh
    if name == "linear":
        return lambda x: x
    raise ValueError(f"unknown non_linearity {name!r}")


def _init_weight(shape, non_linearity: str, generator: torch.Generator) -> torch.Tensor:
    """The JAX package's initialisers: xavier uniform (swish, tanh),
    kaiming normal (relu, leaky_relu), xavier normal (linear)."""
    fan_in, fan_out = shape[1], shape[2]
    if non_linearity in ("swish", "tanh"):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return (2.0 * torch.rand(shape, generator=generator) - 1.0) * lim
    if non_linearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / fan_in) * torch.randn(shape, generator=generator)
    return math.sqrt(2.0 / (fan_in + fan_out)) * torch.randn(shape, generator=generator)


@dataclasses.dataclass(frozen=True)
class EnsembleMLP:
    d_in: int
    d_out: int
    n_hidden: int
    n_layers: int
    ensemble_size: int
    non_linearity: str = "leaky_relu"

    def __post_init__(self):
        if self.n_layers < 2:
            raise ValueError("minimum depth of model is 2")

    def _layer_dims(self):
        dims = []
        for i in range(self.n_layers + 1):
            n_in = self.d_in if i == 0 else self.n_hidden
            n_out = self.d_out if i == self.n_layers else self.n_hidden
            act = "linear" if i == self.n_layers else self.non_linearity
            dims.append((n_in, n_out, act))
        return dims

    def init_params(self, generator: torch.Generator, device="cuda") -> List[EnsembleLayerParams]:
        """Weights drawn on the CPU from `generator`, then moved to
        `device`; zero biases."""
        return [EnsembleLayerParams(
            weight=_init_weight((self.ensemble_size, n_in, n_out), act, generator).to(device),
            bias=torch.zeros((self.ensemble_size, 1, n_out), device=device))
            for n_in, n_out, act in self._layer_dims()]

    def __call__(self, params: Sequence[EnsembleLayerParams], x: torch.Tensor) -> torch.Tensor:
        """x [E, B, d_in] -> [E, B, d_out]: one batched product a layer."""
        for (_, _, act), lyr in zip(self._layer_dims(), params):
            x = _activation(act)(torch.baddbmm(lyr.bias, x, lyr.weight))
        return x


def init_ensemble(generator: torch.Generator, d_in: int, d_out: int, n_hidden: int,
                  n_layers: int, ensemble_size: int, non_linearity: str = "leaky_relu",
                  device="cuda"):
    model = EnsembleMLP(d_in, d_out, n_hidden, n_layers, ensemble_size, non_linearity)
    return model, model.init_params(generator, device)
