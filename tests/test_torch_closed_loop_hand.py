"""Closed loops of the port against the JAX package's on the hand and arm
configs whose card episodes are not spanned by the JAX package's own CPU
episodes (tools/jax_cpu_episodes.py): door-v0 here, whose JAX episodes
succeed where the port's did not, and the pusher, whose port episodes
score above the JAX ones (test_torch_closed_loop_pusher.py, which uses
the helpers here). K = 3 control steps of solve, clip and env step from
the JAX env's start, every solver iteration on the same injected noise
(never seeds: the packages' streams differ).

The config's mppi block at a reduced size, since the plain rollouts on
the CPU are slow: N = 16 particles, horizon 4 (the configs' N x H are
256 x 48 and 512 x 24); every other field as the config sets it, door-v0's
two optimiser iterations (the second warm-started from the first's mean,
each on its own noise) included. The loop compares the control law, which
does not depend on the size. The port runs its own solve (make_solve_fn:
on the CPU kernel #6's plain version, the rollout the card's episodes run
on the kernel); the JAX side is composed from its general rollout (the
Pallas forest kernel has no fast CPU mode), update, act and shift.

Actions, rewards, the mean and the env state agree at 1e-4 after every
step (measured on the CPU: door-v0 at most 1.8e-7, the pusher 1.7e-6 on
the action and 1.3e-5 on the block's velocity under contact). So the
episode results that differ are the spread of the noise streams in
chaotic closed loops, not a fault of the port. hammer-v0's loop agrees as
well (at most 1e-6 at N = 16, H = 8), but its JAX CPU episodes span the
port's. About 70 s on one core (the JAX door rollout's and step's trace
and compile take most of it).
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.harness import config as jcfg
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout_open_loop
from mjmpc_tpu_torch import convert, envs, solvers
from mjmpc_tpu_torch.harness import config as cfg
from test_torch_closed_loop import _d, _lightly_compiled, _noises

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
K = 3
ATOL = 1e-4
N, H = 16, 4


def _injected(cls):
    """A subclass of the port's solver `cls` whose c-th noise draw is
    noises[c], one a solver iteration."""
    @dataclasses.dataclass(frozen=True)
    class Injected(cls):
        noises: Any = None
        calls: Any = None

        def sample_noise(self, state):
            self.calls.append(int(state.step))
            return torch.as_tensor(self.noises[len(self.calls) - 1]).clone()

    return Injected


def closed_loops(path, to_port):
    """Both packages' loops of K control steps with the config's mppi block
    at N x H, from the JAX env's start on PRNGKey(0); to_port carries the
    JAX env state across (convert.py)."""
    exp = cfg.load_config(path)
    exp["mppi"] = dict(exp["mppi"], num_cpu=1, particles_per_cpu=N, horizon=H)
    jenv, env = jenvs.make(exp["env_name"]), envs.make(exp["env_name"], device=DEVICE)
    jsolver = jcfg.make_solver_for_env(exp, "mppi", jenv)
    params = cfg.solver_params_from_config(exp, "mppi", env)
    iters = jsolver.n_iters
    # one draw a solver iteration, in the order the solve makes them
    draws = [_noises(jsolver, env.d_action, params["init_cov"], seed=5 + i) for i in range(iters)]
    noises = [draws[i][k] for k in range(K) for i in range(iters)]

    @_lightly_compiled
    def jax_iter(p, e, s, noise):
        return jsolver.update(s, jax_rollout_open_loop(jenv, p, e, s.mean, noise))

    @_lightly_compiled
    def jax_finish(p, e, s):
        action = jenv.clip_action(jsolver.act(s))
        s = jsolver.shift(s._replace(step=s.step + 1))
        e, _, reward, _ = jenv.step(p, e, action)
        return action, reward, s, e

    je = jenv.init(jenv.params, jax.random.PRNGKey(0))
    e, s = je, jsolver.init_state(jax.random.PRNGKey(1))
    jax_records = []
    for k in range(K):
        for i in range(iters):
            s = jax_iter(jenv.params, e, s, jnp.asarray(noises[k * iters + i]))
        a, r, s, e = jax_finish(jenv.params, e, s)
        jax_records.append((a, r, s.mean, e.qpos, e.qvel))
    es = to_port(je, device=DEVICE)
    st = convert.gaussian_state_from_reference(jsolver.init_state(jax.random.PRNGKey(1)), 0,
                                               DEVICE)
    solver = _injected(solvers.MPPI)(**params, noises=noises, calls=[])
    solve = solvers.make_solve_fn(solver, env)
    port = []
    for _ in range(K):
        a, _, st = solve(env.params, es, st)
        a = env.clip_action(a)
        es, _, r, _ = env.step(env.params, es, a)
        port.append((a, r, st.mean, es.qpos, es.qvel))
    return dict(jax=jax_records, port=port, calls=list(solver.calls), iters=iters)


def assert_loops_agree(loop):
    """Every record at 1e-4 after each step; one noise draw a solver
    iteration, in order."""
    assert loop["calls"] == [k for k in range(K) for _ in range(loop["iters"])]
    for k in range(K):
        diffs = {f: _d(p, j) for f, p, j in zip(("action", "reward", "mean", "qpos", "qvel"),
                                                  loop["port"][k], loop["jax"][k])}
        assert max(diffs.values()) <= ATOL, (k, diffs)


def test_door_closed_loop_matches_jax():
    assert_loops_agree(closed_loops("configs/hand/door-v0.yml",
                                    convert.hand_door_state_from_reference))
