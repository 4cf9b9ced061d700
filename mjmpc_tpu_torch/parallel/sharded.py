"""Sharded MPC solves and episodes over a device mesh.

Counterpart of mjmpc_tpu/parallel/sharded.py, where the reference's
SubprocVecEnv scatter / rollout / gather becomes single-program SPMD under
sharding constraints, and where the JAX package turns its kernels off. Here
the particle axis is split into contiguous shards, one per device of a
mesh row (parallel/mesh.py), and the kernels stay on:

- `shard_env` gives an env whose particle-batched work runs shard by
  shard: each fused rollout kernel is called on each shard's noise on that
  shard's device (its own build of the kernel), and each step, observation
  and success of a batched state (the general rollout) runs likewise; the
  results are gathered on the row's first device, where the solver's
  reductions (softmax sums, top-k, resampling) run over all the particles.
  The env state and the params are replicated;
- `build_sharded_solve_fn`: one solve on the sharded env; PFMPC's
  action_samples stay sharded between solves (a tuple of per-device
  slices);
- `build_sharded_episode_fn` and `build_batch_episode_fn`: episodes on the
  sharded env, each a replayed captured control step on a CUDA device
  (harness/episode.py); a batch of B episodes gives [B, T, ...] records,
  each episode row's contiguous slice of them one batched episode (the
  sharded kernels' `batched` split the particles, axis 1 of the noise,
  over the row), equal to B runs of the single episode with the same
  seeds.

Only a mesh of one card has run on a card; a mesh of several devices runs
on the CPU (every shard a CPU device).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import solvers
from ..envs.base import Env
from ..harness import episode as ep
from .mesh import Mesh, canonical_device, make_mesh, pad_particles, particle_slices

_FUSED = ("fused_rollout", "fused_obs_rollout", "fused_cl_rollout")


def _to(x, device):
    """x with its tensors on `device`; x itself when they are there already
    (rebuilding a ChainModel would copy its masks from the host)."""
    if all(t.device == device for t in solvers.tensor_leaves(x).values()):
        return x
    return solvers.map_tensors(lambda t: t.to(device), x)


def _env_on(env: Env, device: torch.device) -> Env:
    """env with its params (and kernels) on `device`."""
    if canonical_device(env.device) == device:
        return env
    return dataclasses.replace(env.with_params(_to(env.params, device)), device=device,
                               action_lows=env.action_lows.to(device),
                               action_highs=env.action_highs.to(device))


def _gather(parts, device):
    """Per-shard results (tensors, or states / tuples of them) concatenated
    on their leading axis on `device`."""
    return solvers.map_tensors(lambda *xs: torch.cat([x.to(device) for x in xs]), *parts)


def shard_env(env: Env, mesh: Mesh, num_particles: int) -> Env:
    """env with its work on num_particles particles split over the mesh's
    particle axis (the module docstring). Every other call (the real env's
    unbatched step, an observation of the unbatched state) runs as env's."""
    shards = particle_slices(num_particles, mesh)
    first = shards[0][0]
    per_device = {d: _env_on(env, d) for d, _ in shards}
    # a state is batched when its tensors have one more axis than init's
    ref = {k: v.dim() for k, v in solvers.tensor_leaves(env.init(env.params, 0)).items()}

    def batched(state) -> bool:
        return any(v.dim() > ref[k] for k, v in solvers.tensor_leaves(state).items())

    def on(params, d):
        """params on device d (the env's own, moved once)."""
        return per_device[d].params if params is env.params else _to(params, d)

    def split(fn_name, params, state, *rows):
        """fn(params, state shard, *row shards) on every shard, gathered."""
        outs = []
        for d, sl in shards:
            e = per_device[d]
            st = solvers.map_tensors(lambda t: t[sl].to(d), state)
            outs.append(getattr(e, fn_name)(on(params, d), st, *(r[sl].to(d) for r in rows)))
        return _gather(outs, first)

    def step(params, state, action):
        if not batched(state):
            return env.step(params, state, action)
        return split("step", params, state, action)

    def observe(params, state):
        if not batched(state):
            return env.observe(params, state)
        return split("observe", params, state)

    success = None
    if env.success is not None:
        def success(params, state):
            if not batched(state):
                return env.success(params, state)
            return split("success", params, state)

    def sharded_kernel(field):
        kernels = {d: getattr(e, field) for d, e in per_device.items()}
        if any(k is None for k in kernels.values()):
            return None

        def fused(params, state, ctrl, noise):
            outs = [kernels[d](on(params, d), _to(state, d), ctrl.to(d), noise[sl].to(d))
                    for d, sl in shards]
            return _gather(outs, first)

        base = getattr(env, field)
        if hasattr(base, "dynamic_fields"):
            fused.dynamic_fields = base.dynamic_fields
        batched = {d: getattr(k, "batched", None) for d, k in kernels.items()}
        if all(k is not None for k in batched.values()):
            def fused_batch(params, states, means, noises):
                """B states' rollouts, each shard's particles (axis 1 of the
                noise) on its device's batched kernel, gathered on axis 1."""
                outs = [batched[d](on(params, d), _to(states, d), means.to(d),
                                   noises[:, sl].to(d).contiguous())
                        for d, sl in shards]
                return torch.cat([o.to(first) for o in outs], 1)

            fused.batched = fused_batch
        return fused

    return dataclasses.replace(env, step=step, observe=observe, success=success,
                               build_fused=None, **{f: sharded_kernel(f) for f in _FUSED})


def _check_particles(solver, mesh: Mesh) -> int:
    n = solver.num_particles
    if pad_particles(n, mesh) != n:
        raise ValueError(f"num_particles={n} must be a multiple of the particle axis; "
                         f"pad it to {pad_particles(n, mesh)} (pad_particles)")
    return n


def build_sharded_solve_fn(solver, env: Env, mesh: Optional[Mesh] = None, **kwargs):
    """One MPC solve with the particle axis split over the mesh's first row.

    Returns solve(env_params, env_state, solver_state) -> (action, value,
    new state) on the row's first device. The env and solver states are
    replicated, but for PFMPC's action_samples, which the returned state
    keeps sharded (a tuple with one [N / shards, H, dA] slice per device);
    the solve takes them sharded or whole."""
    mesh = mesh or make_mesh()
    n = _check_particles(solver, mesh)
    solve = solvers.make_solve_fn(solver, shard_env(env, mesh, n), **kwargs)
    if not isinstance(solver, solvers.PFMPC):
        return solve
    shards = particle_slices(n, mesh)
    first = shards[0][0]

    def pf_solve(env_params, env_state, state):
        samples = state.action_samples
        if isinstance(samples, tuple):
            samples = torch.cat([s.to(first) for s in samples])
        action, value, new = solve(env_params, env_state,
                                   dataclasses.replace(state, action_samples=samples))
        parts = tuple(new.action_samples[sl].to(d) for d, sl in shards)
        return action, value, dataclasses.replace(new, action_samples=parts)

    return pf_solve


def build_sharded_episode_fn(solver, env: Env, episode_length: int,
                             mesh: Optional[Mesh] = None):
    """One MPC-in-the-loop episode with every solve's particles split over
    the mesh's first row: episode(env_params, seed) -> records {reward,
    action, value, done, success: [T, ...]} on the first device (the real
    env advances unsharded under env_params; the solver plans on them)."""
    mesh = mesh or make_mesh()
    sharded = shard_env(env, mesh, _check_particles(solver, mesh))

    def episode(env_params, seed: int):
        fused = ep._fused_mode(env, env_params)
        run = ep.build_episode_fn(solver, env, episode_length, sim_env=sharded, fused=fused)
        records, _, _ = run(env_params, env_params, seed)
        return records

    return episode


def _batch_rows(n: int, rows: int):
    """The contiguous slices of n episodes over `rows` episode rows, the
    first rows one episode longer where n does not divide."""
    per, extra = divmod(n, rows)
    bounds = [0]
    for e in range(rows):
        bounds.append(bounds[-1] + per + (e < extra))
    return [slice(bounds[e], bounds[e + 1]) for e in range(rows)]


def build_batch_episode_fn(solver, env: Env, episode_length: int,
                           mesh: Optional[Mesh] = None):
    """B independent episodes: batch(env_params, seeds [B]) -> records
    {reward, action, value, done, success: [B, T, ...]} on the mesh's first
    device (the JAX package's jax.vmap over the episode keys, the batch
    split over the mesh's episodes axis). Episode row e takes a contiguous
    slice of the seeds and runs it as one batched episode
    (harness/episode.py build_batched_episode_fn), its solves' particles
    split over the row's devices; where the batched solve does not cover
    the solver and env (episode.batch_coverage) the row runs its single
    episodes one after another, as build_sharded_episode_fn's. Either way
    episode b agrees with the single episode of seed seeds[b] (the batched
    solve's reductions may sum in another order)."""
    mesh = mesh or make_mesh()
    n = _check_particles(solver, mesh)
    row_envs = [_env_on(env, mesh.devices[e][0]) for e in range(mesh.shape["episodes"])]
    sharded = [shard_env(e, mesh.row(i), n) for i, e in enumerate(row_envs)]
    first = mesh.devices[0][0]

    def row_episode(e, env_params, seeds):
        fused = ep._fused_mode(row_envs[e], env_params)
        seeds = [int(s) for s in seeds]
        if ep.batch_coverage(solver, sharded[e], fused) is None:
            run = ep.build_batched_episode_fn(solver, row_envs[e], episode_length,
                                              sim_env=sharded[e])
            return run(env_params, env_params, seeds)[0]
        run = ep.build_episode_fn(solver, row_envs[e], episode_length, sim_env=sharded[e],
                                  fused=fused)
        outs = [run(env_params, env_params, seed)[0] for seed in seeds]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def batch(env_params, seeds):
        outs = []
        for e, sl in enumerate(_batch_rows(len(seeds), len(row_envs))):
            if sl.stop > sl.start:
                outs.append(row_episode(e, _to(env_params, mesh.devices[e][0]), seeds[sl]))
        return {k: torch.cat([o[k].to(first) for o in outs]) for k in outs[0]}

    return batch
