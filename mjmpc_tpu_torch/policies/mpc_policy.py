"""MPCPolicy: controller name -> solver, plus a stateful get_action shell.

Counterpart of mjmpc_tpu/policies/mpc_policy.py. The policy holds a frozen
solver config, its solve function and the solver state, so get_action is
one solve per control step on the env's device. get_action is the host
boundary, like the JAX policy's np.asarray: it reads the action back once;
nothing inside the solve does.
"""
from __future__ import annotations

from typing import Optional

from .. import solvers
from ..envs.base import Env
from .base import Policy


class MPCPolicy(Policy):
    def __init__(self, controller_type: str, env: Env, param_dict: dict,
                 seed: int = 0, batch_size: int = 1):
        self.controller_type = controller_type
        self.env = env
        params = dict(param_dict)
        params.setdefault("d_action", env.d_action)
        params.setdefault("action_lows", env.action_lows)
        params.setdefault("action_highs", env.action_highs)
        params.setdefault("device", env.device)
        self.solver = solvers.make_solver(controller_type, **params)
        self._solve = solvers.make_solve_fn(self.solver, env)
        self._seed = seed
        self.reset(seed)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._seed = seed
        self.solver_state = self.solver.init_state(self._seed)

    def get_action(self, env_state, calc_val: bool = False):
        """One MPC solve from the given env state. Returns (action np [dA],
        value float)."""
        action, value, self.solver_state = self._solve(
            self.env.params, env_state, self.solver_state)
        return action.cpu().numpy(), float(value)

    def get_action_seq(self, env_state, horizon: Optional[int] = None):
        mean = getattr(self.solver_state, "mean", None)
        if mean is None:
            raise NotImplementedError
        seq = mean.cpu().numpy()
        return seq if horizon is None else seq[:horizon]
