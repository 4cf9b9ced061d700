"""Particle-filter MPC: a non-parametric control distribution.

Counterpart of mjmpc_tpu/solvers/pfmpc.py: a persistent set of
action-sequence particles, softmax-weighted by cost-to-go, low-variance
systematic resampling, a time shift with additive cov_shift noise, and a
reset by cov_resample noise. The resampler is the vectorized form of the
reference's sequential walk: u_m = r + m / M against the cumulative
weights via torch.searchsorted, with r drawn on the device.

Beyond the JAX config, `noise_impl` ("plain" or "kernel") picks the
sampler of the particles' noise, as for GaussianMPC, and `device` places
the state. Every stream (the particles' initial and shift noise, the
resampling offset, a random base action) is Philox under
rng.stream_key(seed, tag) at the state's device-side step, as for
GaussianMPC (base.py).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .. import ops, rng
from ..envs.base import Env
from ..rollout.engine import Trajectories
from .base import NOISE_IMPLS, open_loop_rollout, sample_filtered_noise

_TAG_RESAMPLE = 10
_TAG_SHIFT = 11
_TAG_INIT = 12
_TAG_SHIFT_RANDOM = 13


@dataclasses.dataclass(frozen=True)
class PFState:
    action_samples: torch.Tensor  # [N, H, dA]
    mean: torch.Tensor            # [H, dA]
    step: torch.Tensor            # [] int64 on the device: solves taken so far
    seed: int                     # base seed of the solver's streams


@dataclasses.dataclass(frozen=True)
class PFMPC:
    d_action: int
    horizon: int
    num_particles: int
    lam: float = 0.01
    gamma: float = 1.0
    n_iters: int = 1
    cov_shift: float = 0.01
    cov_resample: float = 0.5
    filter_coeffs: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    base_action: str = "repeat"
    sample_mode: str = "mean"
    action_lows: Optional[Any] = None
    action_highs: Optional[Any] = None
    noise_impl: str = "plain"
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if self.noise_impl not in NOISE_IMPLS:
            raise ValueError(f"noise_impl must be one of {NOISE_IMPLS}, got "
                             f"{self.noise_impl!r}")

    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    @functools.cached_property
    def discount(self) -> torch.Tensor:
        return ops.discount_matrix(self.gamma_seq, device=self.device)

    @functools.cached_property
    def noise_sampler(self) -> ops.FilteredNoise:
        return ops.FilteredNoise()

    def build_constants(self) -> None:
        self.discount

    def _cov(self, v: float) -> torch.Tensor:
        return torch.diag(torch.full((self.d_action,), float(v), device=self.device))

    def _noise(self, key: int, step: torch.Tensor, v: float) -> torch.Tensor:
        return sample_filtered_noise(self.noise_impl, self.noise_sampler, key, step,
                                     self._cov(v), (self.num_particles, self.horizon),
                                     self.filter_coeffs)

    def init_state(self, seed: int) -> PFState:
        """Particles ~ filtered N(0, cov_resample), zero mean."""
        step = rng.step_tensor(0, self.device)
        return PFState(action_samples=self._noise(rng.stream_key(seed, _TAG_INIT), step,
                                                  self.cov_resample),
                       mean=torch.zeros((self.horizon, self.d_action), device=self.device),
                       step=step, seed=int(seed))

    def systematic_resample(self, samples: torch.Tensor, weights: torch.Tensor,
                            r: torch.Tensor) -> torch.Tensor:
        """Low-variance resampling: with r ~ U[0, 1/M), index m receives the
        first particle whose cumulative weight reaches u_m = r + m/M
        (searchsorted side 'left' is right=False)."""
        m = samples.shape[0]
        cumw = torch.cumsum(weights, dim=0)
        u = r + torch.arange(m, dtype=weights.dtype, device=weights.device) / m
        idx = torch.clamp(torch.searchsorted(cumw, u, right=False), 0, m - 1)
        return samples.index_select(0, idx)

    def update(self, state: PFState, traj: Trajectories) -> PFState:
        """Weight, resample, mean."""
        traj_costs = ops.cost_to_go(traj.costs, self.discount)[:, 0]
        w = torch.softmax((-1.0 / self.lam) * traj_costs, dim=0)
        r = ops.uniforms(rng.stream_key(state.seed, _TAG_RESAMPLE), state.step,
                         1)[0] / self.num_particles
        samples = self.systematic_resample(state.action_samples, w, r)
        return dataclasses.replace(state, action_samples=samples,
                                   mean=torch.mean(samples, dim=0))

    def act(self, state: PFState, mode: str = "mean") -> torch.Tensor:
        """Mean of the particles at t = 0."""
        return torch.mean(state.action_samples[:, 0], dim=0)

    def shift(self, state: PFState) -> PFState:
        """Roll the particles one step, add cov_shift noise, set the last
        step to the base action. 'random' draws from N(0, cov_resample) with
        scale sqrt(cov_resample), as the JAX package does."""
        samples = torch.roll(state.action_samples, -1, 1) + self._noise(
            rng.stream_key(state.seed, _TAG_SHIFT), state.step, self.cov_shift)
        if self.base_action == "random":
            last = float(np.sqrt(self.cov_resample)) * ops.standard_normals(
                rng.stream_key(state.seed, _TAG_SHIFT_RANDOM), state.step,
                (self.num_particles, self.d_action))
        elif self.base_action == "null":
            last = torch.zeros((self.num_particles, self.d_action), device=samples.device)
        elif self.base_action == "repeat":
            last = samples[:, -2]
        else:
            raise ValueError(f"invalid base_action {self.base_action!r}")
        samples[:, -1] = last
        return dataclasses.replace(state, action_samples=samples)

    def value(self, state: PFState, traj: Trajectories):
        raise NotImplementedError("PFMPC has no value estimate")


def build_solve_fn(solver: PFMPC, env: Env, hotstart: bool = True, fused: Any = "auto"):
    """One PFMPC solve (optimize, act, shift).

    Returns solve(env_params, env_state, state) -> (action [dA], value 0,
    new state). PFMPC reads only costs, so the env's costs-only fused
    rollout applies as in base.build_solve_fn ("auto" = yes when the env
    has one).
    """
    do_rollout = open_loop_rollout(env, False, fused)
    solver.build_constants()

    def solve(env_params, env_state, state: PFState):
        s = state
        for _ in range(solver.n_iters):
            delta = s.action_samples - s.mean[None]
            traj = do_rollout(env_params, env_state, s.mean, delta)
            s = solver.update(s, traj)
        action = solver.act(s)
        s = dataclasses.replace(s, step=s.step + 1)
        if hotstart:
            s = solver.shift(s)
        return action, torch.zeros((), device=action.device), s

    return solve
