"""Reinforce: closed-loop linear-Gaussian policy-gradient MPC.

Counterpart of mjmpc_tpu/solvers/reinforce.py. The control distribution is
a linear-Gaussian feedback policy u = W^T [obs; 1] + eps, eps
AR(2)-filtered N(0, diag(cov_diag)); each iteration of a solve:

1. rolls out N closed-loop particles (the env's fused_cl_rollout kernel,
   or rollout_closed_loop_linear);
2. takes returns = cost-to-go, and a baseline: the per-step mean return,
   or one of the four least-squares value functions fit on the returns;
3. whitens the advantages with the population std;
4. forms the per-parameter policy gradient obs_cat^T ((a - mu) / cov * A)
   / (N H) and descends, W <- W - lr g (returns are costs);
5. with delta_kl, backs off lr by halves until the mean KL(new || old) <=
   delta_kl, at most max_linesearch_iters times.

The whole solve runs on the device with no host round trip. The state's
step is a 0-d int64 tensor on the device and its seed a host integer, and
its streams are Philox under rng.stream_key(seed, tag) at that step, as in
GaussianState (base.py).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .. import ops, rng
from ..envs.base import Env
from ..rollout.engine import Trajectories, rollout_closed_loop_linear
from ..value_functions import VFParams, make_vf

_TAG_ROLLOUT = 20
_TAG_ACT = 21


@dataclasses.dataclass(frozen=True)
class ReinforceState:
    mean_weights: torch.Tensor   # [d_obs + 1, dA]
    cov_diag: torch.Tensor       # [dA] action-noise variances
    vf_weights: torch.Tensor     # baseline params (zeros for the mean baseline)
    vf_bias: torch.Tensor
    fit_error: torch.Tensor      # [] last baseline relative fit error
    step: torch.Tensor           # [] int64 on the device: solves taken so far
    seed: int                    # base seed of the solver's streams


@dataclasses.dataclass(frozen=True)
class Reinforce:
    d_obs: int
    d_action: int
    horizon: int
    num_particles: int
    lr: float = 0.01
    beta: float = 0.0                     # cov growth (a reference field, unused)
    gamma: float = 1.0
    n_iters: int = 1
    init_cov: float = 1.0
    baseline_type: Optional[str] = "quadratic"   # None: the mean-return baseline
    delta_kl: Optional[float] = None
    max_linesearch_iters: int = 100
    delta_reg: float = 0.0
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
        """The [H, H] discount matrix on the solver's device, built once."""
        return ops.discount_matrix(self.gamma_seq, device=self.device)

    @functools.cached_property
    def vf(self):
        if self.baseline_type in (None, "constant", "none"):
            return None
        return make_vf(self.baseline_type, self.d_obs, self.horizon, device=self.device)

    def build_constants(self) -> None:
        """Build the solve's device constants now, outside any solve."""
        self.discount
        if self.vf is not None:
            self.vf.build_constants(self.delta_reg)

    def init_state(self, seed: int) -> ReinforceState:
        if self.vf is None:
            vw, vb = torch.zeros((1,), device=self.device), torch.zeros((), device=self.device)
        else:
            p = self.vf.init_params()
            vw, vb = p.weights, p.bias
        return ReinforceState(
            mean_weights=torch.zeros((self.d_obs + 1, self.d_action), device=self.device),
            cov_diag=torch.full((self.d_action,), float(self.init_cov), device=self.device),
            vf_weights=vw, vf_bias=vb, fit_error=torch.zeros((), device=self.device),
            step=rng.step_tensor(0, self.device), seed=int(seed))

    # ---- sampling ----------------------------------------------------------
    def sample_noise(self, state: ReinforceState) -> torch.Tensor:
        """AR(2)-filtered N(0, diag(cov_diag)) noise [N, H, dA] from the
        stream (seed, 20) at the state's step: every iteration of one solve
        draws the same noise, as in the JAX package."""
        return ops.filtered_noise(rng.stream_key(state.seed, _TAG_ROLLOUT), state.step,
                                  torch.diag(state.cov_diag),
                                  (self.num_particles, self.horizon), self.filter_coeffs)

    # ---- update, in its three stages ----------------------------------------
    def baseline(self, state: ReinforceState, traj: Trajectories, returns: torch.Tensor):
        """(baselines [N, H] or [1, H], new vf weights, new vf bias,
        fit error): the mean return, or the value function fit on the
        returns (its error after the fit)."""
        if self.vf is None:
            return (torch.mean(returns, dim=0, keepdim=True), state.vf_weights,
                    state.vf_bias, state.fit_error)
        params, _, fit_err = self.vf.fit(VFParams(state.vf_weights, state.vf_bias),
                                         traj.observations, returns,
                                         delta_reg=self.delta_reg, return_errors=True)
        return (self.vf.predict(params, traj.observations), params.weights, params.bias,
                fit_err)

    def gradient(self, state: ReinforceState, traj: Trajectories, advantages: torch.Tensor):
        """(obs_cat [N H, d_obs + 1], g [d_obs + 1, dA]): the policy
        gradient of the whitened advantages."""
        adv = (advantages - torch.mean(advantages)) / (
            torch.std(advantages, correction=0) + 1e-6)
        obs = traj.observations.reshape(-1, self.d_obs)
        acts = traj.actions.reshape(-1, self.d_action)
        obs_cat = torch.cat([obs, torch.ones_like(obs[:, :1])], -1)
        # d logprob / d mean of a diagonal Gaussian: (a - mu) / sigma^2
        grad_act = (acts - obs_cat @ state.mean_weights) / state.cov_diag
        return obs_cat, obs_cat.T @ (grad_act * adv.reshape(-1, 1)) / obs.shape[0]

    def step_size(self, state: ReinforceState, obs_cat: torch.Tensor, grad: torch.Tensor):
        """lr, or with delta_kl the KL line search's lr (a [] tensor).

        Both policies share the covariance and the old mean is obs_cat @ W,
        so KL(lr) = lr^2 K with K = mean(0.5 sum((obs_cat @ g)^2 / cov)).
        The JAX loop halves lr while KL(lr) > delta_kl, at most
        max_linesearch_iters times; here every candidate lr0 2^-k is tested
        at once on the device and the first that passes (else the last) is
        taken. This can differ from JAX only where a KL sits within
        rounding of delta_kl (JAX takes the KL of the difference of two
        products, not lr^2 K)."""
        if self.delta_kl is None:
            return self.lr
        step = obs_cat @ grad
        k_kl = torch.mean(0.5 * torch.sum(step * step / state.cov_diag, dim=-1))
        halvings = torch.arange(self.max_linesearch_iters + 1, device=grad.device)
        lrs = self.lr * torch.pow(0.5, halvings.to(grad.dtype))
        ok = lrs * lrs * k_kl <= self.delta_kl
        k = torch.where(ok.any(), torch.argmax(ok.to(torch.int32)),
                        torch.full_like(halvings[0], self.max_linesearch_iters))
        return torch.gather(lrs, 0, k[None])[0]   # a tensor index: no host read

    def update(self, state: ReinforceState, traj: Trajectories) -> ReinforceState:
        returns = ops.cost_to_go(traj.costs, self.discount)
        baselines, vw, vb, fit_err = self.baseline(state, traj, returns)
        obs_cat, grad = self.gradient(state, traj, returns - baselines)
        lr = self.step_size(state, obs_cat, grad)
        return dataclasses.replace(state, mean_weights=state.mean_weights - lr * grad,
                                   vf_weights=vw, vf_bias=vb, fit_error=fit_err)

    # ---- action selection ---------------------------------------------------
    def act(self, state: ReinforceState, obs: torch.Tensor,
            mode: Optional[str] = None) -> torch.Tensor:
        """u = W^T [obs; 1], plus a sampled perturbation in "sample" mode."""
        mode = mode or self.sample_mode
        mean = obs @ state.mean_weights[:-1] + state.mean_weights[-1]
        if mode == "mean":
            return mean
        if mode == "sample":
            eps = ops.filtered_noise(rng.stream_key(state.seed, _TAG_ACT), state.step,
                                     torch.diag(state.cov_diag), (1, 1), self.filter_coeffs)
            return mean + eps.reshape(self.d_action)
        raise ValueError(f"unknown sample mode {mode!r}")


def closed_loop_rollout(env: Env, fused: Any = "auto"):
    """The rollout of a Reinforce solve: rollout(env_params, env_state,
    weights [d_obs + 1, dA], noise [N, H, dA]) -> Trajectories.

    fused: use the env's closed-loop kernel (fused_cl_rollout). "auto" =
    yes when the env has one. Pass False to plan against params other than
    the env's build-time params (the kernel bakes the model constants).
    """
    if fused == "auto":
        fused = env.fused_cl_rollout is not None
    if not fused:
        return functools.partial(rollout_closed_loop_linear, env)
    if env.fused_cl_rollout is None:
        raise ValueError(f"env {env.name!r} has no fused closed-loop rollout")

    def rollout(env_params, env_state, weights, noise):
        obs, acts, costs = env.fused_cl_rollout(env_params, env_state, weights, noise)
        return Trajectories(observations=obs, actions=acts, costs=costs, dones=None,
                            next_observations=None, successes=None)

    return rollout


def build_solve_fn(solver: Reinforce, env: Env, fused: Any = "auto"):
    """One Reinforce solve: n_iters of closed-loop rollouts and policy-
    gradient updates, then act on the env's current observation. No shift
    (the reference's is a no-op); the value is 0.

    Returns solve(env_params, env_state, solver_state) -> (action [dA],
    value [], new solver_state)."""
    do_rollout = closed_loop_rollout(env, fused)
    solver.build_constants()

    def solve(env_params, env_state, state: ReinforceState):
        s = state
        for _ in range(solver.n_iters):
            noise = solver.sample_noise(s)
            s = solver.update(s, do_rollout(env_params, env_state, s.mean_weights, noise))
        action = solver.act(s, env.observe(env_params, env_state))
        s = dataclasses.replace(s, step=s.step + 1)
        return action, torch.zeros((), device=s.mean_weights.device), s

    return solve
