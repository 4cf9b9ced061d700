"""Random shooting over a learned MLP policy.

Counterpart of mjmpc_tpu/solvers/random_shooting_nn.py (reference
control/random_shooting_nn.py and its CLMPC base): N particles roll out
the MLP policy perturbed by AR(2)-filtered noise, the action sequence of
the rollout with the lowest cost-to-go is step-size-blended into the
open-loop mean (argmin and row pick on the device), the action is mean[0]
and the mean shifts left with a zero last row.

The noise is the plain sampler (ops.filtered_noise: the noise kernel's
normals, then colouring and the filter in tensor operations, one kernel
launch) under rng.stream_key(seed, 40) at the state's step. The policy's
initial weights come from a torch.Generator on the CPU seeded with the
state's seed, once per seed: init_state keeps them (as SoftQMPC keeps its
initial Q). guard_finite's reset draws fresh Xavier-uniform weights on the
device instead (reset_state: the uniforms kernel under
rng.stream_key(seed, 41) at the state's step), so that resets at different
steps give different policies, as JAX's fold_in(key, step) does, and the
reset copies nothing from the host.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import ops, rng
from ..envs.base import Env
from ..models.mlp import MLPLayerParams, MLPPolicy
from ..rollout.engine import Trajectories, rollout_closed_loop_policy

_TAG_ROLLOUT = 40
_TAG_RESET = 41


@dataclasses.dataclass(frozen=True)
class RSNNState:
    mean: torch.Tensor                  # [H, dA] best-rollout blended action sequence
    policy_params: List[MLPLayerParams]
    step: torch.Tensor                  # [] int64 on the device: solves taken so far
    seed: int                           # base seed of the solver's streams


@dataclasses.dataclass(frozen=True)
class RandomShootingNN:
    d_obs: int
    d_action: int
    horizon: int
    num_particles: int
    hidden: Tuple[int, ...] = (64, 64)
    gamma: float = 1.0
    n_iters: int = 1
    step_size: float = 1.0
    init_cov: float = 0.5
    filter_coeffs: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    sample_mode: str = "mean"
    action_lows: Optional[Any] = None
    action_highs: Optional[Any] = None
    device: Union[str, torch.device] = "cuda"

    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    @functools.cached_property
    def discount(self) -> torch.Tensor:
        return ops.discount_matrix(self.gamma_seq, device=self.device)

    @functools.cached_property
    def cov(self) -> torch.Tensor:
        """The noise covariance init_cov I on the solver's device."""
        return self.init_cov * torch.eye(self.d_action, device=self.device)

    @functools.cached_property
    def _initial_params(self) -> dict:
        return {}

    def build_constants(self) -> None:
        """Build the solve's device constants now, outside any solve."""
        self.discount
        self.cov

    @property
    def policy(self) -> MLPPolicy:
        return MLPPolicy(self.d_obs, self.d_action, tuple(self.hidden))

    def init_state(self, seed: int) -> RSNNState:
        """A zero mean, the seed's initial policy (drawn once, then kept)
        and step 0."""
        seed = int(seed)
        if seed not in self._initial_params:
            g = rng.generator(rng.derive_seed(seed, _TAG_ROLLOUT), "cpu")
            self._initial_params[seed] = self.policy.init_params(g, self.device)
        return RSNNState(mean=torch.zeros((self.horizon, self.d_action), device=self.device),
                         policy_params=self._initial_params[seed],
                         step=rng.step_tensor(0, self.device), seed=seed)

    def reset_state(self, seed: int, step: torch.Tensor) -> RSNNState:
        """guard_finite's reset: a zero mean and fresh Xavier-uniform
        weights (zero biases) from one draw of uniforms on the device under
        the stream (seed, 41) at `step`, which the state keeps."""
        dims = self.policy._dims()
        u = ops.uniforms(rng.stream_key(int(seed), _TAG_RESET), step,
                         sum(n_in * n_out for n_in, n_out in dims))
        params, off = [], 0
        for n_in, n_out in dims:
            lim = math.sqrt(6.0 / (n_in + n_out))
            w = (2.0 * u[off:off + n_in * n_out] - 1.0).reshape(n_in, n_out) * lim
            params.append(MLPLayerParams(weight=w, bias=torch.zeros_like(w[0])))
            off += n_in * n_out
        return RSNNState(mean=torch.zeros((self.horizon, self.d_action), device=self.device),
                         policy_params=params, step=step, seed=int(seed))

    def sample_noise(self, state: RSNNState) -> torch.Tensor:
        """AR(2)-filtered N(0, init_cov I) noise [N, H, dA] from the stream
        (seed, 40) at the state's step."""
        return ops.filtered_noise(rng.stream_key(state.seed, _TAG_ROLLOUT), state.step,
                                  self.cov, (self.num_particles, self.horizon),
                                  self.filter_coeffs)

    def update(self, state: RSNNState, traj: Trajectories) -> RSNNState:
        """The best rollout's action sequence blended into the mean."""
        ctg = ops.cost_to_go(traj.costs, self.discount)[:, 0]
        best = torch.argmin(ctg).reshape(1)
        target = traj.actions.index_select(0, best)[0]
        mean = (1.0 - self.step_size) * state.mean + self.step_size * target
        return dataclasses.replace(state, mean=mean)

    def act(self, state: RSNNState) -> torch.Tensor:
        return state.mean[0]

    def shift(self, state: RSNNState) -> RSNNState:
        """Roll the mean left one step, with a zero last row."""
        mean = torch.cat([state.mean[1:], torch.zeros_like(state.mean[:1])])
        return dataclasses.replace(state, mean=mean)


def build_solve_fn(solver: RandomShootingNN, env: Env):
    """One RandomShootingNN solve: n_iters of closed-loop MLP rollouts and
    best-rollout updates, act, then step + 1 and the shift. Returns
    solve(env_params, env_state, solver_state) -> (action [dA], value [],
    new solver_state)."""
    policy = solver.policy
    solver.build_constants()

    def solve(env_params, env_state, state: RSNNState):
        s = state
        for _ in range(solver.n_iters):
            noise = solver.sample_noise(s)
            traj = rollout_closed_loop_policy(
                env, env_params, env_state, lambda obs: policy(s.policy_params, obs), noise)
            s = solver.update(s, traj)
        action = solver.act(s)
        s = solver.shift(dataclasses.replace(s, step=s.step + 1))
        return action, torch.zeros((), device=action.device), s

    return solve
