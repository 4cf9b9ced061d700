"""Batched rollouts: a Python loop over the horizon of one batched env.step
over all N particles.

Counterpart of mjmpc_tpu/rollout/engine.py, with the same semantics:
- every particle starts from the same initial state;
- open loop, u[b, t] = mean[t] + noise[b, t];
- closed-loop-linear, u[b, t] = W^T [obs_b(t); 1] + noise[b, t], with
  obs_b(t) the observation of the state entering step t;
- closed-loop under any policy, u[b, t] = policy(obs_b(t)) + noise[b, t];
- recorded actions are the pre-clip commanded actions (the env clips);
- costs are negated rewards, taken on the post-step state.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..envs.base import Env


class Trajectories(NamedTuple):
    """Batch of rollout results. The costs-only fused path fills only
    `actions` and `costs`."""
    observations: Optional[torch.Tensor]       # [N, H, d_obs]
    actions: torch.Tensor                      # [N, H, dA]
    costs: torch.Tensor                        # [N, H]
    dones: Optional[torch.Tensor]              # [N, H]
    next_observations: Optional[torch.Tensor]  # [N, H, d_obs]
    successes: Optional[torch.Tensor]          # [N, H]


def _broadcast_state(state, n: int):
    """Give every tensor of a state dataclass, those of nested state
    dataclasses too (a wrapped env's inner state), a leading [n] axis."""
    if isinstance(state, torch.Tensor):
        return state.expand((n,) + tuple(state.shape))
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{f.name: _broadcast_state(getattr(state, f.name), n)
                                             for f in dataclasses.fields(state)})
    return state


def _scan_rollout(env: Env, params, state0, noise: torch.Tensor, action_fn) -> Trajectories:
    """The common loop: action_fn(t, obs [N, d_obs]) -> [N, dA] plus
    noise[:, t] is the step's commanded action."""
    n, horizon = noise.shape[0], noise.shape[1]
    state = _broadcast_state(state0, n)
    obs = env.observe(params, state)
    out = dict(observations=[], actions=[], costs=[], dones=[],
               next_observations=[], successes=[])
    for t in range(horizon):
        u = action_fn(t, obs) + noise[:, t]
        state, next_obs, reward, done = env.step(params, state, u)
        succ = (env.success(params, state) if env.success is not None
                else torch.zeros_like(reward, dtype=torch.bool))
        for key, val in zip(out, (obs, u, -reward, done, next_obs, succ)):
            out[key].append(val)
        obs = next_obs
    return Trajectories(**{k: torch.stack(v, 1) for k, v in out.items()})


def rollout_open_loop(env: Env, params, state0, mean: torch.Tensor,
                      noise: torch.Tensor) -> Trajectories:
    """Open-loop rollout of mean [H, dA] + noise [N, H, dA] from one env
    state."""
    return _scan_rollout(env, params, state0, noise, lambda t, obs: mean[t])


def rollout_closed_loop_linear(env: Env, params, state0, weights: torch.Tensor,
                               noise: torch.Tensor) -> Trajectories:
    """Closed-loop-linear rollout under weights [d_obs + 1, dA]:
    u = [obs; 1] @ weights + noise."""
    return _scan_rollout(env, params, state0, noise,
                         lambda t, obs: obs @ weights[:-1] + weights[-1])


def rollout_closed_loop_policy(env: Env, params, state0, policy_fn,
                               noise: torch.Tensor) -> Trajectories:
    """Closed-loop rollout under any policy: u = policy_fn(obs) + noise,
    policy_fn mapping an observation batch [N, d_obs] to actions [N, dA]
    (an MLP policy, SoftQMPC's Q-induced mean)."""
    return _scan_rollout(env, params, state0, noise, lambda t, obs: policy_fn(obs))


def make_rollout_fn(env: Env, mode: str = "open_loop"):
    """The env bound into a rollout (params, state0, mean, noise) ->
    Trajectories, the reference's injected rollout_fn contract; `mean` is
    the open-loop mean [H, dA], the linear weights [d_obs + 1, dA] or the
    policy callable, by mode."""
    rollouts = {"open_loop": rollout_open_loop,
                "closed_loop_linear": rollout_closed_loop_linear,
                "closed_loop_policy": rollout_closed_loop_policy}
    if mode not in rollouts:
        raise ValueError(f"unknown rollout mode {mode!r}")
    rollout = rollouts[mode]

    def fn(params, state0, mean, noise):
        return rollout(env, params, state0, mean, noise)

    return fn
