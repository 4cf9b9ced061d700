"""Episode runners: MPC in the loop.

Counterpart of mjmpc_tpu/harness/episode.py. The reference's main loop
alternates policy.get_action (a controller solve) and the real env.step.
The JAX package runs an episode as one jitted program (a scan over the
control steps). Here, on a CUDA device, an episode is one captured device
program too: the first control step runs eagerly (it builds the kernels
and any library state), then one whole control step (the solve under
guard_finite, the clip, the real env step, success, the writes of the
step's records into preallocated [T, ...] device buffers and the copy of
the new env and solver states into the step's static inputs) is captured
as a torch.cuda.CUDAGraph and replayed for the other T - 1 steps. The
records are read once, when the episode ends. A capture that fails
raises; nothing carries on eagerly. On the CPU (and with replay=False on
the card, the reference the replay is held against, bit for bit) the
same step runs in a host loop.

B episodes of one solver run as one batched episode where the batched
solve covers the solver and the planning env (run_episodes, the
counterpart of the JAX package's jax.vmap over the episode keys): one
control step advances every episode (solvers.build_batched_solve_fn under
the batched guard, the clip and the real env step on the stacked [B] env
state), captured once as one CUDA graph on the card and replayed, its
records written into [B, T, ...] device buffers. The CPU runs the same
batched step on the plain batched kernels; its vmapped reductions may sum
in another order than a single solve's, so a batched episode agrees with
the loop's to rounding.

The solver plans against sim_params (through sim_env's dynamics when
given: model-mismatch experiments, dynamics randomization) while the
environment advances under its own params.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import ops, rng, solvers
from ..envs.base import Env

_RECORDS = ("reward", "action", "value", "done", "success")


def _build_step_fn(solver, env: Env, sim_env: Optional[Env] = None, guard: bool = True,
                   fused: Any = "auto"):
    """One MPC-in-the-loop control step: (real_params, sim_params,
    env_state, solver_state) -> (env_state, solver_state, records).

    guard=True (opt out with run_mpc --no_guard) wraps every solve in
    solvers.guard_finite: a solve with a non-finite result is discarded,
    the solver's state is reset and a zero action is played."""
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


def _build_batched_step_fn(solver, env: Env, sim_env: Optional[Env] = None,
                           guard: bool = True):
    """One control step of B episodes at once: (real_params, sim_params,
    env_states, batch) -> (env_states, batch, records), env_states the B
    env states stacked (solvers.stack_states), batch a GaussianBatch and
    every record [B, ...].

    It runs one batched solve (build_batched_solve_fn's vectorised path,
    its linear algebra capturable) and one real env step on the stacked
    state, on every device: on the CPU through the plain batched kernels.
    guard wraps the solve in solvers.guard_finite, which checks and resets
    each episode on its own. A solver or planning env the batched solve
    does not cover raises NotImplementedError."""
    plan_env = sim_env if sim_env is not None else env
    vectorised = solvers.build_batched_solve_fn(solver, plan_env).vectorised

    def solve(env_params, env_states, batch):
        with ops.control.capturable_linalg(batch.mean.device):
            return vectorised(env_params, env_states, batch)
    if guard:
        solve = solvers.guard_finite(solve, solver)

    def step_fn(real_params, sim_params, env_states, batch):
        action, value, batch = solve(sim_params, env_states, batch)
        action = env.clip_action(action)
        env_states, _, reward, done = env.step(real_params, env_states, action)
        succ = (env.success(real_params, env_states) if env.success is not None
                else torch.zeros(action.shape[:-1], dtype=torch.bool, device=env.device))
        return env_states, batch, dict(reward=reward, action=action, value=value, done=done,
                                       success=succ)

    return step_fn


def _stack_states(states, dim: int = 0):
    """T states (dataclasses of tensors, nested dataclasses and host
    values) as one state whose tensors are stacked on a new axis `dim`;
    host values are taken from the first."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states, dim)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack_states([getattr(s, f.name) for s in states], dim)
            for f in dataclasses.fields(first)})
    return first


def _host_values(x) -> list:
    """The values of a state that are not tensors (host integers such as a
    solver's seed or the maze's key), in field order."""
    if isinstance(x, torch.Tensor):
        return []
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) for v in _host_values(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _host_values(item)]
    return [x]


def _eager_episode(step_fn, episode_length: int, real_params, sim_params, env_state,
                   solver_state, time_dim: int = 0):
    """The episode as a host loop; records and states stacked on a new
    axis time_dim (1 for a batched episode: [B, T, ...])."""
    records, states = {k: [] for k in _RECORDS}, []
    for _ in range(episode_length):
        env_state, solver_state, out = step_fn(real_params, sim_params, env_state, solver_state)
        for k, v in out.items():
            records[k].append(v)
        states.append(env_state)
    return ({k: torch.stack(v, time_dim) for k, v in records.items()},
            _stack_states(states, time_dim), solver_state)


def _replayed_episode(step_fn, episode_length: int, real_params, sim_params, env_state,
                      solver_state, name: str, time_dim: int = 0):
    """The episode with steps 1..T-1 replayed from one captured control
    step (the module docstring); records and states written on the axis
    time_dim of their buffers (1 for a batched episode: [B, T, ...])."""
    device = _device(env_state)
    stream = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):   # step 0, eager: builds the kernels and library state
        env_1, solver_1, out = step_fn(real_params, sim_params, env_state, solver_state)
    stream.wait_stream(side)
    torch.cuda.synchronize(device)
    if (_host_values(env_1) != _host_values(env_state)
            or _host_values(solver_1) != _host_values(solver_state)):
        raise RuntimeError(f"{name}: a host value of the env or solver state changes at every "
                           "step, so the control step cannot be captured as a CUDA graph")
    first_state = solvers.tensor_leaves(env_1)

    def buffer(v):
        shape = v.shape[:time_dim] + (episode_length,) + v.shape[time_dim:]
        return torch.empty(shape, dtype=v.dtype, device=device)

    records = {k: buffer(v) for k, v in out.items()}
    states = {k: buffer(v) for k, v in first_state.items()}
    for bufs, vals in ((records, out), (states, first_state)):
        for k, v in vals.items():
            bufs[k].select(time_dim, 0).copy_(v)
    static = solvers.map_tensors(lambda v: v.clone(), (env_1, solver_1))
    inputs = solvers.tensor_leaves(static)
    t_index = torch.ones(1, dtype=torch.int64, device=device)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            env_n, solver_n, out_n = step_fn(real_params, sim_params, *static)
            for bufs, vals in ((records, out_n), (states, solvers.tensor_leaves(env_n))):
                for k, v in vals.items():
                    bufs[k].index_copy_(time_dim, t_index, v.unsqueeze(time_dim))
            new = solvers.tensor_leaves((env_n, solver_n))
            if new.keys() != inputs.keys():
                raise RuntimeError(f"the step changes the state's structure: "
                                   f"{sorted(set(new) ^ set(inputs))}")
            ptrs = {v.data_ptr() for v in inputs.values()}
            # a new value that is another input's storage is read before it is overwritten
            staged = {k: v.clone() if v.data_ptr() in ptrs and v is not inputs[k] else v
                      for k, v in new.items()}
            for k, v in inputs.items():
                if staged[k] is not v:
                    v.copy_(staged[k])
            t_index.add_(1)
    except Exception as e:
        raise RuntimeError(f"{name}: capturing the control step as a CUDA graph failed: "
                           f"{e}") from e
    n = episode_length - 1
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    start.record(stream)
    for _ in range(n):
        graph.replay()   # on the current stream, the events' stream
    end.record(stream)
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    replay_ms = start.elapsed_time(end) / n
    # the events enclose the replays, and the host clock encloses the events
    if not 0.0 < replay_ms <= host_ms:
        raise RuntimeError(f"{name}: a replay's device time {replay_ms} ms is not within "
                           f"(0, {host_ms}] ms, the synchronised host clock's over the same "
                           "replays")
    return records, _with_leaves(env_1, states), static[1], (replay_ms, host_ms)


def _device(state) -> torch.device:
    """The device of a state's tensors."""
    return next(iter(solvers.tensor_leaves(state).values())).device


def _with_leaves(state, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    """state with each tensor replaced by leaves[its dotted path]."""
    if isinstance(state, torch.Tensor):
        return leaves[prefix]
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: _with_leaves(getattr(state, f.name), leaves,
                                 f"{prefix}.{f.name}" if prefix else f.name)
            for f in dataclasses.fields(state)})
    return state


def build_episode_fn(solver, env: Env, episode_length: int, sim_env: Optional[Env] = None,
                     guard: bool = True, fused: Any = "auto", replay: Optional[bool] = None):
    """episode(real_params, sim_params, seed) -> (records, states, final
    solver state): records maps reward, action, value, done and success to
    [T, ...] tensors on the device, states is the env state with every
    tensor stacked on a leading [T] axis (the T post-step states). The env
    starts from env.init(real_params, derive_seed(seed, 0)), the solver
    from init_state(derive_seed(seed, 1)).

    replay: replay a captured control step (the module docstring); None
    (the default) does so on a CUDA device, False runs the eager loop.
    After a replayed episode, episode.replay_ms holds one replay's time on
    the device (CUDA events around the replays) and episode.replay_host_ms
    its time on the host's clock, synchronised before and after them: a
    device time outside (0, host time] raises."""
    step_fn = _build_step_fn(solver, env, sim_env, guard, fused)
    use_graph = (torch.device(env.device).type == "cuda") if replay is None else bool(replay)

    def episode(real_params, sim_params, seed: int):
        env_state = env.init(real_params, rng.derive_seed(seed, 0))
        solver_state = solver.init_state(rng.derive_seed(seed, 1))
        if use_graph and episode_length > 1:
            *out, (episode.replay_ms, episode.replay_host_ms) = _replayed_episode(
                step_fn, episode_length, real_params, sim_params, env_state, solver_state,
                env.name)
            return tuple(out)
        return _eager_episode(step_fn, episode_length, real_params, sim_params, env_state,
                              solver_state)

    episode.replay_ms = episode.replay_host_ms = None
    return episode


def build_batched_episode_fn(solver, env: Env, episode_length: int,
                             sim_env: Optional[Env] = None, guard: bool = True,
                             replay: Optional[bool] = None):
    """B episodes as one batched episode: episode(real_params, sim_params,
    seeds) -> (records, states, final batch): records maps reward, action,
    value, done and success to [B, T, ...] tensors on the device, states is
    a list of B env states, each with its tensors stacked on a leading [T]
    axis (the T post-step states, each episode's own host values), the
    final batch a solvers.GaussianBatch. Episode b starts as
    build_episode_fn's episode of seed seeds[b] does: the env from
    env.init(real_params, derive_seed(seed, 0)), the solver from
    init_state(derive_seed(seed, 1)). The batched step runs the env's step
    on the stacked state, whose host values are the first episode's (no
    batched env reads one in its step).

    replay: the first control step eager, then one batched control step
    captured as a CUDA graph and replayed T - 1 times (the module
    docstring); None (the default) does so on a CUDA device, False runs
    the eager loop. episode.replay_ms and episode.replay_host_ms are
    build_episode_fn's. A solver or planning env the batched solve does
    not cover raises NotImplementedError here, before anything runs."""
    device = torch.device(env.device)
    step_fn = _build_batched_step_fn(solver, env, sim_env, guard)
    use_graph = device.type == "cuda" if replay is None else bool(replay)

    def episode(real_params, sim_params, seeds):
        starts = [env.init(real_params, rng.derive_seed(seed, 0)) for seed in seeds]
        env_states = solvers.stack_states(starts)
        batch = solver.init_batch([rng.derive_seed(seed, 1) for seed in seeds])
        if use_graph and episode_length > 1:
            records, states, final, (episode.replay_ms, episode.replay_host_ms) = (
                _replayed_episode(step_fn, episode_length, real_params, sim_params, env_states,
                                  batch, env.name, time_dim=1))
        else:
            records, states, final = _eager_episode(step_fn, episode_length, real_params,
                                                    sim_params, env_states, batch, time_dim=1)
        per_episode = [solvers.map_tensors(lambda _, t: t[b], start, states)
                       for b, start in enumerate(starts)]
        return records, per_episode, final

    episode.replay_ms = episode.replay_host_ms = None
    return episode


def batch_coverage(solver, plan_env: Env, fused: Any = "auto") -> Optional[str]:
    """None where run_episodes can run its episodes as one batched episode
    (the batched solve covers the solver and the planning env's fused
    rollout, and the planning params keep that rollout: `fused`, as
    _fused_mode gives it), else why not."""
    if fused is False:
        return (f"planning on params that {plan_env.name!r}'s fused rollout does not read "
                f"takes the general rollout, which has no batched entry")
    try:
        solvers.check_batchable(solver, plan_env)
    except NotImplementedError as e:
        return str(e)
    return None


def _fused_mode(plan_env: Env, sim_params):
    """Whether the fused rollout may plan against `sim_params`. A kernel
    bakes the env's build-time model constants, but the params a kernel
    declares in its `dynamic_fields` it reads at call time (through its
    extras): planning against params that differ from the env's own only
    in those fields (pen's contact gains and radius) keeps the fused path
    ("auto"); any other difference (a perturbed model, other drag
    coefficients) takes the general rollout (False). A perturbed env made
    by randomize_dynamics carries kernels built from its own params, so
    planning on it with its params keeps them."""
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


def _to_numpy(state):
    """A stacked env state with its tensors as numpy arrays."""
    if isinstance(state, torch.Tensor):
        return state.cpu().numpy()
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{f.name: _to_numpy(getattr(state, f.name))
                                             for f in dataclasses.fields(state)})
    return state


def summarize(records: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """run_episodes' per-episode rewards and the aggregate metrics the
    reference logs (AverageReward, StdReward, SuccessMetric = % of episodes
    with more than 10 goal-achieved steps) from records [B, T, ...]."""
    ep_rewards = records["reward"].sum(axis=1)
    success_counts = records["success"].sum(axis=1)
    return dict(
        rewards=records["reward"], actions=records["action"], values=records["value"],
        dones=records["done"], successes=records["success"], ep_rewards=ep_rewards,
        average_reward=float(ep_rewards.mean()), reward_std=float(ep_rewards.std()),
        success_metric=100.0 * float((success_counts > 10).mean()))


def run_episodes(solver, env: Env, n_episodes: int, episode_length: int,
                 base_seed: int = 123, sim_params=None, sim_env: Optional[Env] = None,
                 guard: bool = True, batched: Optional[bool] = None) -> Dict[str, Any]:
    """Episodes with the reference's per-episode seeding (episode seed =
    base_seed + i * 12345), on a CUDA device replayed captured control
    steps.

    batched: run the episodes as one batched episode
    (build_batched_episode_fn: one batched control step for all of them,
    the JAX package's jax.vmap over the episode keys); None (the default)
    does so where batch_coverage finds the solver and the planning env
    covered and runs them one after another (build_episode_fn) where not,
    a choice made before anything runs; True raises NotImplementedError
    where they are not covered; False runs them one after another.

    Returns rewards [B, T], actions [B, T, dA], values, dones, success
    flags, per-episode rewards and the aggregate metrics (summarize) as
    numpy, `states` (one env state of [T, ...] arrays per episode),
    `final_solver_states` (one solver state per episode) and `batched`
    (whether they ran batched). sim_env / sim_params redirect planning to
    other dynamics.
    """
    if sim_params is None:
        sim_params = sim_env.params if sim_env is not None else env.params
    plan_env = sim_env if sim_env is not None else env
    fused = _fused_mode(plan_env, sim_params)
    seeds = [base_seed + i * 12345 for i in range(n_episodes)]
    missing = batch_coverage(solver, plan_env, fused)
    if batched and missing is not None:
        raise NotImplementedError(f"run_episodes(batched=True): {missing}")
    batched = missing is None if batched is None else bool(batched)
    if batched:
        episode = build_batched_episode_fn(solver, env, episode_length, sim_env=sim_env,
                                           guard=guard)
        records, ep_states, final = episode(env.params, sim_params, seeds)
        records = {k: v.cpu().numpy() for k, v in records.items()}
        states = [_to_numpy(st) for st in ep_states]
        finals = [solvers.map_tensors(torch.clone, s) for s in final.unstack()]
    else:
        episode = build_episode_fn(solver, env, episode_length, sim_env=sim_env, guard=guard,
                                   fused=fused)
        per_episode, states, finals = [], [], []
        for seed in seeds:
            recs, ep_states, final = episode(env.params, sim_params, seed)
            per_episode.append({k: v.cpu().numpy() for k, v in recs.items()})
            states.append(_to_numpy(ep_states))
            finals.append(final)
        records = {k: np.stack([r[k] for r in per_episode]) for k in _RECORDS}
    return dict(summarize(records), states=states, final_solver_states=finals,
                batched=batched)
