"""Soft-Q MPC: quadratic-Q-guided sampling control.

Counterpart of mjmpc_tpu/solvers/softq.py (reference
softqmpc/algs/softq_controller.py). Each iteration of a solve:

1. rolls out N particles under the Q-induced policy a ~ N(mu(s), Sigma),
   Sigma = lam Paa^-1: Sigma depends only on the Q parameters, so the
   per-step sampling is white noise [N, H, dA] times chol(Sigma)^T added to
   the closed-loop mean mu(s) (Paa factorised once a solve, then one
   cholesky_solve for the whole batch of observations at each step),
   through the env's general rollout, as in the JAX package (it has no
   fused SoftQ rollout);
2. forms the soft-Bellman targets: the last step's cost replaced by the
   terminal Q(s_H, a_H), targets = cost_to_go(costs - lam H) + lam H with
   H the policy's entropy;
3. takes n_grad_steps SGD steps on 0.5 MSE with weight decay `reg`, the
   gradient (torch.func.grad of the pure loss) scaled by min(1, grad_clip /
   |g|) (a global-norm clip, 0 disables it).

Then it acts on the env's observation (the mean, or a sample) and advances
the step. The white noise is the noise kernel's normals with the filter off
under rng.stream_key(seed, 30) at the state's step (ops.standard_normals),
a sampled act's under tag 31, so a solve reads nothing back to the host
and replays as a CUDA graph; its factorisations run under
ops.control.capturable_linalg.

The initial Q parameters (L, J ~ N(0, 1)) come from a torch.Generator on
the CPU seeded with the state's seed, once per seed: init_state keeps
them. guard_finite's reset draws a fresh Q on the device instead
(reset_state: L, J from the noise kernel's normals under
rng.stream_key(seed, 32) at the state's step), so that resets at
different steps give different Q's, as JAX's fold_in(key, step) does, and
the reset copies nothing from the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Union

import numpy as np
import torch

from .. import ops, rng
from ..envs.base import Env
from ..models.quadratic_q import QuadraticQFunc, QuadraticQParams
from ..ops.control import capturable_linalg
from ..rollout.engine import Trajectories, _scan_rollout

_TAG_ROLLOUT = 30
_TAG_ACT = 31
_TAG_RESET = 32


@dataclasses.dataclass(frozen=True)
class SoftQState:
    q_params: QuadraticQParams
    step: torch.Tensor   # [] int64 on the device: solves taken so far
    seed: int            # base seed of the solver's streams


@dataclasses.dataclass(frozen=True)
class SoftQMPC:
    d_obs: int
    d_action: int
    horizon: int
    num_particles: int        # the reference's n_rollouts
    lam: float = 0.1
    lr: float = 0.01
    reg: float = 0.0
    grad_clip: float = 10.0   # global-norm clip of the Q-fit gradient (0: off)
    gamma: float = 1.0
    n_iters: int = 1
    n_grad_steps: int = 1
    sample_mode: str = "mean"
    action_lows: Optional[Any] = None
    action_highs: Optional[Any] = None
    # Optional per-feature observation whitening before the quadratic
    # features: z = [(obs - shift) / scale; a] (harness/softq_diag.py).
    # None: the identity, the reference's behaviour.
    obs_shift: Optional[Any] = None
    obs_scale: Optional[Any] = None
    device: Union[str, torch.device] = "cuda"

    # ---- derived constants ----------------------------------------------
    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    @functools.cached_property
    def discount(self) -> torch.Tensor:
        return ops.discount_matrix(self.gamma_seq, device=self.device)

    @functools.cached_property
    def _whitening(self):
        """(shift, scale) on the solver's device, or None for the identity."""
        if self.obs_shift is None and self.obs_scale is None:
            return None
        as_t = lambda v, d: torch.as_tensor(np.asarray(d if v is None else v, np.float32),
                                            device=self.device)
        return as_t(self.obs_shift, 0.0), as_t(self.obs_scale, 1.0)

    @functools.cached_property
    def _initial_q(self) -> dict:
        return {}

    def build_constants(self) -> None:
        """Build the solve's device constants now, outside any solve."""
        self.discount
        self._whitening

    @property
    def model(self) -> QuadraticQFunc:
        return QuadraticQFunc(self.d_obs, self.d_action)

    def _whiten(self, obs: torch.Tensor) -> torch.Tensor:
        if self._whitening is None:
            return obs
        shift, scale = self._whitening
        return (obs - shift) / scale

    # ---- state ------------------------------------------------------------
    def init_state(self, seed: int) -> SoftQState:
        """The seed's initial Q (drawn once, then kept) and step 0."""
        seed = int(seed)
        if seed not in self._initial_q:
            g = rng.generator(rng.derive_seed(seed, _TAG_ROLLOUT), "cpu")
            self._initial_q[seed] = self.model.init_params(g, self.device)
        return SoftQState(q_params=self._initial_q[seed],
                          step=rng.step_tensor(0, self.device), seed=seed)

    def reset_state(self, seed: int, step: torch.Tensor) -> SoftQState:
        """guard_finite's reset: a fresh Q (L, J ~ N(0, 1), c = 0) drawn on
        the device from the stream (seed, 32) at `step`, which the state
        keeps."""
        d = self.model.d_total
        d_l = d * (d + 1) // 2          # L's packed lower triangle
        z = ops.standard_normals(rng.stream_key(int(seed), _TAG_RESET), step, (d_l + d,))
        q = QuadraticQParams(l_packed=z[:d_l], j=z[d_l:], c=torch.zeros_like(z[0]))
        return SoftQState(q_params=q, step=step, seed=int(seed))

    # ---- policy from Q ----------------------------------------------------
    def _policy(self, params: QuadraticQParams):
        """(mean_fn(obs [N, dO]) -> [N, dA], chol(Sigma) [dA, dA], entropy)."""
        model = self.model
        cond = model.conditional(params)          # Paa's factor, once a solve
        eye = torch.eye(self.d_action, device=cond[0].device)
        sigma = self.lam * torch.cholesky_solve(eye, cond[0])
        chol = torch.linalg.cholesky_ex(sigma + model.jitter * eye).L
        entropy = ops.gaussian_entropy(sigma)

        def mean_fn(obs):
            return model.conditional_mean(cond, self._whiten(obs))

        return mean_fn, chol, entropy

    def white_noise(self, state: SoftQState) -> torch.Tensor:
        """Standard normals [N, H, dA] of the stream (seed, 30) at the step."""
        return ops.standard_normals(rng.stream_key(state.seed, _TAG_ROLLOUT), state.step,
                                    (self.num_particles, self.horizon, self.d_action))

    # ---- update -------------------------------------------------------------
    def targets(self, params: QuadraticQParams, traj: Trajectories,
                entropy: torch.Tensor) -> torch.Tensor:
        """Soft-Bellman targets [N, H]: the terminal cost replaced by
        Q(s_H, a_H)."""
        term_q = self.model(params, self._whiten(traj.observations[:, -1]), traj.actions[:, -1])
        costs = torch.cat([traj.costs[:, :-1], term_q[:, None]], dim=1)
        ent = self.lam * entropy
        return ops.cost_to_go(costs - ent, self.discount) + ent

    def fit_inputs(self, traj: Trajectories, targets: torch.Tensor):
        """(obs, actions, targets) of every step but the last, flattened."""
        obs_in = self._whiten(traj.observations[:, :-1].reshape(-1, self.d_obs))
        act_in = traj.actions[:, :-1].reshape(-1, self.d_action)
        return obs_in, act_in, targets[:, :-1].reshape(-1)

    def clipped_gradient(self, params: QuadraticQParams, obs_in, act_in, tgt_in):
        """(the loss's gradient scaled by min(1, clip / |g|), |g| before
        the clip)."""
        g = torch.func.grad(self.model.loss)(params, obs_in, act_in, tgt_in, self.reg)
        gnorm = torch.sqrt(sum(torch.sum(gw ** 2) for gw in g))
        if self.grad_clip:
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            g = QuadraticQParams(*(gw * scale for gw in g))
        return g, gnorm

    def update(self, state: SoftQState, traj: Trajectories, entropy: torch.Tensor) -> SoftQState:
        params = state.q_params
        obs_in, act_in, tgt_in = self.fit_inputs(traj, self.targets(params, traj, entropy))
        for _ in range(self.n_grad_steps):
            g, _ = self.clipped_gradient(params, obs_in, act_in, tgt_in)
            params = QuadraticQParams(*(w - self.lr * gw for w, gw in zip(params, g)))
        return dataclasses.replace(state, q_params=params)

    # ---- action -------------------------------------------------------------
    def act(self, state: SoftQState, obs: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
        mode = mode or self.sample_mode
        mu, sigma = self.model.act_mean_sigma(state.q_params, self._whiten(obs), self.lam)
        if mode == "mean":
            return mu
        if mode == "sample":
            eye = torch.eye(self.d_action, device=sigma.device)
            chol = torch.linalg.cholesky_ex(sigma + self.model.jitter * eye).L
            z = ops.standard_normals(rng.stream_key(state.seed, _TAG_ACT), state.step,
                                     (self.d_action,))
            return mu + chol @ z
        raise ValueError(f"unknown sample mode {mode!r}")

    def iterate(self, env: Env, env_params, env_state, state: SoftQState,
                white: torch.Tensor):
        """One iteration on the given white noise [N, H, dA]: (new state,
        trajectories, entropy)."""
        mean_fn, chol, entropy = self._policy(state.q_params)
        traj = _scan_rollout(env, env_params, env_state, white @ chol.T,
                             lambda t, obs: mean_fn(obs))
        return self.update(state, traj, entropy), traj, entropy


def build_solve_fn(solver: SoftQMPC, env: Env):
    """One SoftQMPC solve: n_iters of rollouts and Q fits, then act on the
    env's observation. No shift (the reference's is a no-op); the value is
    0. Returns solve(env_params, env_state, solver_state) -> (action [dA],
    value [], new solver_state)."""
    solver.build_constants()

    def solve(env_params, env_state, state: SoftQState):
        s = state
        with capturable_linalg(torch.device(solver.device)):
            for _ in range(solver.n_iters):
                s, _, _ = solver.iterate(env, env_params, env_state, s, solver.white_noise(s))
            action = solver.act(s, env.observe(env_params, env_state))
        s = dataclasses.replace(s, step=s.step + 1)
        return action, torch.zeros((), device=action.device), s

    return solve
