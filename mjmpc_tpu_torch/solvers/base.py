"""Solver core: sampling-MPC controllers as frozen configs plus plain
functions over an explicit state.

Counterpart of mjmpc_tpu/solvers/base.py. One solve (noise, N-particle
H-step rollout, distribution update, act, shift) is a sequence of device
operations with no host round trips: no .item(), .cpu() or float() on a
tensor, no host-to-device copy (constants are built once, on the solver's
device), and no linalg call that checks its info on the host.

Seeding: each consumer draws from a generator seeded with
derive_seed(seed, tag, step), with `step` a host integer, so the same
solver state gives the same noise and seeding never reads the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .. import ops, rng
from ..envs.base import Env
from ..rollout.engine import Trajectories, rollout_open_loop

# Seed-derivation tags (disjoint streams per consumer).
_TAG_ROLLOUT = 0
_TAG_ACT = 1
_TAG_SHIFT = 2


@dataclasses.dataclass(frozen=True)
class GaussianState:
    """Open-loop Gaussian control distribution state."""
    mean: torch.Tensor   # [H, dA]
    cov: torch.Tensor    # [dA, dA]
    step: int            # solves taken so far (host counter)
    seed: int            # base seed of the solver's streams


def _stream(state: GaussianState, tag: int) -> torch.Generator:
    return rng.generator(rng.derive_seed(state.seed, tag, state.step),
                         state.mean.device)


@dataclasses.dataclass(frozen=True)
class GaussianMPC:
    """Base open-loop Gaussian MPC solver. Subclasses override
    `update(state, traj)` and `value(state, traj)`."""
    d_action: int
    horizon: int
    num_particles: int
    gamma: float = 1.0
    n_iters: int = 1
    step_size: float = 1.0
    init_cov: float = 1.0
    filter_coeffs: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    base_action: str = "null"            # random | null | repeat
    use_zero_control_seq: bool = False
    sample_mode: str = "mean"            # mean | sample
    device: Union[str, torch.device] = "cpu"

    # ---- derived constants ----------------------------------------------
    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    @functools.cached_property
    def discount(self) -> torch.Tensor:
        """The [H, H] discount matrix on the solver's device, built once."""
        return ops.discount_matrix(self.gamma_seq, device=self.device)

    @property
    def uses_observations(self) -> bool:
        """Whether update()/value() read traj.observations (gates the
        costs-only fused rollout)."""
        return False

    # ---- state lifecycle -------------------------------------------------
    def init_state(self, seed: int) -> GaussianState:
        """Zero mean, diagonal init_cov."""
        diag = torch.full((self.d_action,), float(self.init_cov),
                          device=self.device)
        return GaussianState(
            mean=torch.zeros((self.horizon, self.d_action), device=self.device),
            cov=torch.diag(diag), step=0, seed=int(seed))

    # ---- sampling --------------------------------------------------------
    def sample_noise(self, state: GaussianState) -> torch.Tensor:
        """AR(2)-filtered Gaussian noise [N, H, dA]."""
        delta = ops.filtered_noise(_stream(state, _TAG_ROLLOUT), state.cov,
                                   (self.num_particles, self.horizon),
                                   self.filter_coeffs)
        if self.use_zero_control_seq:
            # the last particle probes the zero-action sequence
            delta[-1] = -state.mean
        return delta

    # ---- to override -----------------------------------------------------
    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        raise NotImplementedError

    def value(self, state: GaussianState, traj: Trajectories) -> torch.Tensor:
        raise NotImplementedError

    # ---- action selection / hotstart -----------------------------------
    def act(self, state: GaussianState, mode: Optional[str] = None) -> torch.Tensor:
        """First mean action, or a sampled perturbation of it."""
        mode = mode or self.sample_mode
        if mode == "mean":
            return state.mean[0]
        if mode == "sample":
            delta = ops.filtered_noise(_stream(state, _TAG_ACT), state.cov,
                                       (1, 1), self.filter_coeffs)
            return state.mean[0] + delta.reshape(self.d_action)
        raise ValueError(f"unknown sample mode {mode!r}")

    def shift(self, state: GaussianState) -> GaussianState:
        """Hotstart: roll the mean left one step and set the last row to
        the base action ('repeat' repeats row -2 of the ROLLED mean)."""
        mean = torch.roll(state.mean, -1, 0)
        if self.base_action == "random":
            # as the reference does, init_cov (a variance) is the scale
            last = self.init_cov * torch.randn(
                self.d_action, generator=_stream(state, _TAG_SHIFT),
                device=mean.device)
        elif self.base_action == "null":
            last = torch.zeros(self.d_action, device=mean.device)
        elif self.base_action == "repeat":
            last = mean[-2]
        else:
            raise ValueError(f"invalid base_action {self.base_action!r}")
        mean[-1] = last
        return dataclasses.replace(state, mean=mean)

    # ---- shared update helpers -------------------------------------------
    def _interp_mean(self, mean, target):
        """(1 - a) * mean + a * target, every controller's step-size blend."""
        return (1.0 - self.step_size) * mean + self.step_size * target


def build_solve_fn(solver: GaussianMPC, env: Env, calc_val: bool = False,
                   hotstart: bool = True, fused: Any = "auto"):
    """One full MPC solve.

    Returns solve(env_params, env_state, solver_state) ->
    (action [dA], value scalar tensor, new solver_state).

    fused: use the env's fused rollout kernel. "auto" = yes when the env
    has one and the solver reads only costs. Pass False to plan against
    params other than the env's build-time params (the kernel bakes the
    model constants).
    """
    if fused == "auto":
        fused = env.fused_rollout is not None and not solver.uses_observations
    if fused and env.fused_rollout is None:
        raise ValueError(f"env {env.name!r} has no fused rollout")
    solver.discount  # build the device constants now, outside any solve

    def do_rollout(env_params, env_state, mean, noise):
        if fused:
            costs = env.fused_rollout(env_params, env_state, mean, noise)
            return Trajectories(observations=None, actions=mean[None] + noise,
                                costs=costs, dones=None,
                                next_observations=None, successes=None)
        return rollout_open_loop(env, env_params, env_state, mean, noise)

    def solve(env_params, env_state, solver_state: GaussianState):
        s = solver_state
        for _ in range(solver.n_iters):
            noise = solver.sample_noise(s)
            traj = do_rollout(env_params, env_state, s.mean, noise)
            s = solver.update(s, traj)

        action = solver.act(s)
        if calc_val:
            noise = solver.sample_noise(s)
            traj = do_rollout(env_params, env_state, s.mean, noise)
            value = solver.value(s, traj)
        else:
            value = torch.zeros((), device=s.mean.device)

        s = dataclasses.replace(s, step=s.step + 1)
        if hotstart:
            s = solver.shift(s)
        return action, value, s

    return solve


def build_optimal_value_fn(solver: GaussianMPC, env: Env):
    """State-value estimate: a full solve with calc_val from a fresh
    control distribution and no hotstart.

    Returns value(env_params, env_state, seed) -> scalar tensor.
    """
    solve = build_solve_fn(solver, env, calc_val=True, hotstart=False)

    def value(env_params, env_state, seed: int):
        _, val, _ = solve(env_params, env_state, solver.init_state(seed))
        return val

    return value


def evaluate_episode(solver: GaussianMPC, env: Env, episode_length: int,
                     calc_val: bool = False):
    """Closed-loop episode with MPC in the loop, as a Python loop over steps.

    Returns episode(env_params, seed) -> dict(reward [T], action [T, dA],
    value [T], done [T], success [T]) of tensors on the env's device.
    """
    solve = build_solve_fn(solver, env, calc_val=calc_val)

    def episode(env_params, seed: int):
        env_state = env.init(env_params, rng.derive_seed(seed, 0))
        solver_state = solver.init_state(rng.derive_seed(seed, 1))
        out = dict(reward=[], action=[], value=[], done=[], success=[])
        for _ in range(episode_length):
            action, value, solver_state = solve(env_params, env_state,
                                                solver_state)
            action = env.clip_action(action)
            env_state, _, reward, done = env.step(env_params, env_state, action)
            succ = (env.success(env_params, env_state)
                    if env.success is not None
                    else torch.zeros((), dtype=torch.bool, device=env.device))
            for key, val in zip(out, (reward, action, value, done, succ)):
                out[key].append(val)
        return {k: torch.stack(v) for k, v in out.items()}

    return episode
