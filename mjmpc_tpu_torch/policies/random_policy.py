"""Uniform random policy (counterpart of
mjmpc_tpu/policies/random_policy.py): actions uniform in the env's bounds,
from a generator on the env's device; returned as numpy arrays."""
from __future__ import annotations

import torch

from .. import rng
from ..envs.base import Env
from .base import Policy


class RandomPolicy(Policy):
    def __init__(self, env: Env, seed: int = 0):
        self.env = env
        self.reset(seed)

    def reset(self, seed=None):
        if seed is not None:
            self._generator = rng.generator(seed, self.env.device)

    def _draw(self, shape):
        lows, highs = self.env.action_lows, self.env.action_highs
        u = torch.rand(tuple(shape) + (self.env.d_action,), generator=self._generator,
                       device=self.env.device)
        return (lows + (highs - lows) * u).cpu().numpy()

    def get_action(self, env_state=None):
        return self._draw(())

    def get_action_seq(self, env_state=None, horizon: int = 1):
        return self._draw((horizon,))
