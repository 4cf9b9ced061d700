"""Linear-Gaussian policy: a frozen spec plus plain functions over its
parameters.

Counterpart of mjmpc_tpu/policies/linear_gaussian.py: mean = obs @ weight
+ bias, a learnable per-dimension log_std, zero-initialised mean. Its
rollout form is the [d_obs + 1, d_action] matrix W = [weight; bias] of the
closed-loop-linear rollout (u = [obs; 1] @ W).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LGPolicyParams:
    weight: torch.Tensor    # [d_obs, d_action]
    bias: torch.Tensor      # [d_action]
    log_std: torch.Tensor   # [d_action]


@dataclasses.dataclass(frozen=True)
class LinearGaussianPolicy:
    d_obs: int
    d_action: int
    min_log_std: float = -3.0
    init_log_std: float = 0.0
    device: object = "cuda"

    def init_params(self) -> LGPolicyParams:
        """Zero mean, init_log_std standard deviations."""
        return LGPolicyParams(
            weight=torch.zeros((self.d_obs, self.d_action), device=self.device),
            bias=torch.zeros((self.d_action,), device=self.device),
            log_std=torch.full((self.d_action,), float(self.init_log_std), device=self.device))

    def mean(self, params: LGPolicyParams, obs: torch.Tensor) -> torch.Tensor:
        return obs @ params.weight + params.bias

    def get_action(self, params: LGPolicyParams, obs: torch.Tensor, mode: str = "sample",
                   white_noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        """(action, info): the mean, or mean + std * white noise (given, or
        drawn from `generator`)."""
        mean = self.mean(params, obs)
        if mode == "mean":
            action = mean
        elif mode == "sample":
            if white_noise is None:
                white_noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            action = mean + torch.exp(params.log_std) * white_noise
        else:
            raise ValueError(f"unknown mode {mode!r}")
        log_prob = self.log_prob(params, obs, action)
        return action, dict(mean=mean, log_std=params.log_std, evaluation=mean,
                            log_prob=log_prob)

    def log_prob(self, params: LGPolicyParams, obs: torch.Tensor,
                 actions: torch.Tensor) -> torch.Tensor:
        """Per-dimension diagonal-Gaussian log probability."""
        mean = self.mean(params, obs)
        var = torch.exp(2.0 * params.log_std)
        return (-0.5 * (actions - mean) ** 2 / var - params.log_std
                - 0.5 * math.log(2.0 * math.pi))

    def entropy(self, params: LGPolicyParams) -> torch.Tensor:
        return torch.sum(params.log_std + 0.5 * (1.0 + math.log(2.0 * math.pi)))

    def clamp_cov(self, params: LGPolicyParams) -> LGPolicyParams:
        """log_std >= min_log_std."""
        return dataclasses.replace(params,
                                   log_std=torch.clamp(params.log_std, min=self.min_log_std))

    def grow_cov(self, params: LGPolicyParams, beta: float) -> LGPolicyParams:
        return dataclasses.replace(params, log_std=params.log_std + beta)

    def as_rollout_weights(self, params: LGPolicyParams) -> torch.Tensor:
        """W [d_obs + 1, d_action] of the closed-loop-linear rollout."""
        return torch.cat([params.weight, params.bias[None, :]], 0)

    @staticmethod
    def from_rollout_weights(w: torch.Tensor, log_std: torch.Tensor) -> LGPolicyParams:
        return LGPolicyParams(weight=w[:-1], bias=w[-1], log_std=log_std)
