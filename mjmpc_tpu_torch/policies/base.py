"""Policy ABC (counterpart of mjmpc_tpu/policies/base.py)."""
from __future__ import annotations

import abc


class Policy(abc.ABC):
    """Host-side policy interface: the thin stateful shell around the solve
    functions, so that episode drivers are interchangeable. get_action is
    the host boundary: it returns numpy arrays."""

    @abc.abstractmethod
    def get_action(self, state):
        ...

    def get_action_seq(self, state, horizon: int):
        raise NotImplementedError

    def reset(self, seed=None):
        ...
