"""Episode runners: MPC in the loop, one episode after another.

Counterpart of mjmpc_tpu/harness/episode.py. The reference's main loop
alternates policy.get_action (a controller solve) and the real env.step.
The JAX package runs a batch of episodes as one jitted program (a scan
over steps, vmapped over episodes); here a host loop runs the episodes
and their steps. Each solve stays free of host syncs; an episode's
records stay on the device until it ends and are then read once. The
solver plans against sim_params (through sim_env's dynamics when given:
model-mismatch experiments) while the environment advances under its own
params.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import rng, solvers
from ..envs.base import Env

_RECORDS = ("reward", "action", "value", "done", "success")


def _build_step_fn(solver, env: Env, sim_env: Optional[Env] = None, guard: bool = True,
                   fused: Any = "auto"):
    """One MPC-in-the-loop control step: (real_params, sim_params,
    env_state, solver_state) -> (env_state, solver_state, records).

    guard=True (opt out with run_mpc --no_guard) wraps every solve in
    solvers.guard_finite: a solve with a non-finite result is discarded,
    the control distribution re-initialises and a zero action is played."""
    plan_env = sim_env if sim_env is not None else env
    solve = solvers.make_solve_fn(solver, plan_env, fused=fused)
    if guard:
        solve = solvers.guard_finite(solve, solver)

    def step_fn(real_params, sim_params, env_state, solver_state):
        action, value, solver_state = solve(sim_params, env_state, solver_state)
        action = env.clip_action(action)
        env_state, _, reward, done = env.step(real_params, env_state, action)
        succ = (env.success(real_params, env_state) if env.success is not None
                else torch.zeros((), dtype=torch.bool, device=env.device))
        return env_state, solver_state, dict(reward=reward, action=action, value=value,
                                             done=done, success=succ)

    return step_fn


def build_episode_fn(solver, env: Env, episode_length: int, sim_env: Optional[Env] = None,
                     guard: bool = True, fused: Any = "auto"):
    """episode(real_params, sim_params, seed) -> (records, states,
    final solver state): records maps reward, action, value, done and
    success to [T, ...] tensors on the device, states is the list of the T
    post-step env states. The env starts from env.init(real_params,
    derive_seed(seed, 0)), the solver from init_state(derive_seed(seed, 1))."""
    step_fn = _build_step_fn(solver, env, sim_env, guard, fused)

    def episode(real_params, sim_params, seed: int):
        env_state = env.init(real_params, rng.derive_seed(seed, 0))
        solver_state = solver.init_state(rng.derive_seed(seed, 1))
        records, states = {k: [] for k in _RECORDS}, []
        for _ in range(episode_length):
            env_state, solver_state, out = step_fn(real_params, sim_params, env_state,
                                                   solver_state)
            for k, v in out.items():
                records[k].append(v)
            states.append(env_state)
        return {k: torch.stack(v) for k, v in records.items()}, states, solver_state

    return episode


def _fused_mode(plan_env: Env, sim_params):
    """Whether the fused rollout may plan against `sim_params`. A kernel
    bakes the env's build-time model constants, but the params a kernel
    declares in its `dynamic_fields` it reads at call time (through its
    extras): planning against params that differ from the env's own only
    in those fields (pen's contact gains and radius) keeps the fused path
    ("auto"); any other difference (a perturbed model, other drag
    coefficients) takes the general rollout (False)."""
    base = plan_env.params
    if sim_params is base:
        return "auto"
    kernel = plan_env.fused_rollout
    dynamic = getattr(kernel, "dynamic_fields", ()) if kernel is not None else ()
    if not dynamic or type(sim_params) is not type(base) or not dataclasses.is_dataclass(base):
        return False
    for f in dataclasses.fields(base):
        if f.name not in dynamic and getattr(sim_params, f.name) is not getattr(base, f.name):
            return False
    return "auto"


def _stack_states(states):
    """T env states (dataclasses of tensors and host integers) as one state
    of numpy arrays [T, ...]."""
    first = states[0]
    fields = {}
    for f in dataclasses.fields(first):
        vals = [getattr(s, f.name) for s in states]
        fields[f.name] = (torch.stack(vals).cpu().numpy() if isinstance(vals[0], torch.Tensor)
                          else np.asarray(vals))
    return dataclasses.replace(first, **fields)


def run_episodes(solver, env: Env, n_episodes: int, episode_length: int,
                 base_seed: int = 123, sim_params=None, sim_env: Optional[Env] = None,
                 guard: bool = True) -> Dict[str, Any]:
    """Episodes with the reference's per-episode seeding (episode seed =
    base_seed + i * 12345).

    Returns rewards [B, T], actions [B, T, dA], values, dones, success
    flags, per-episode rewards and the aggregate metrics the reference
    logs (AverageReward, StdReward, SuccessMetric = % of episodes with more
    than 10 goal-achieved steps) as numpy, `states` (one env state of [T,
    ...] arrays per episode) and `final_solver_states` (one solver state
    per episode). sim_env / sim_params redirect planning to other dynamics.
    """
    if sim_params is None:
        sim_params = sim_env.params if sim_env is not None else env.params
    plan_env = sim_env if sim_env is not None else env
    episode = build_episode_fn(solver, env, episode_length, sim_env=sim_env, guard=guard,
                               fused=_fused_mode(plan_env, sim_params))
    per_episode, states, finals = [], [], []
    for i in range(n_episodes):
        records, ep_states, final = episode(env.params, sim_params, base_seed + i * 12345)
        per_episode.append({k: v.cpu().numpy() for k, v in records.items()})
        states.append(_stack_states(ep_states))
        finals.append(final)

    out = {k: np.stack([r[k] for r in per_episode]) for k in _RECORDS}
    ep_rewards = out["reward"].sum(axis=1)
    success_counts = out["success"].sum(axis=1)
    return dict(
        rewards=out["reward"], actions=out["action"], values=out["value"],
        dones=out["done"], successes=out["success"], ep_rewards=ep_rewards,
        average_reward=float(ep_rewards.mean()), reward_std=float(ep_rewards.std()),
        success_metric=100.0 * float((success_counts > 10).mean()),
        states=states, final_solver_states=finals)
