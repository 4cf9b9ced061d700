"""The port's batched control step (harness/episode.py
_build_batched_step_fn: one batched solve on the plain batched kernels,
the clip and one real env step of the stacked state) against jax.vmap over
B = 2 episodes of K = 3 control steps of the JAX loop (general rollout,
update, act, clip, shift, env step, as in test_torch_closed_loop_hand.py),
every solve on the same injected [B] noise (never seeds: the packages'
streams differ). The configs' mppi block at N = 16, H = 4; actions,
rewards, means and env states agree at 1e-4 after every step. The
pendulum here, with the helper; pen-v0 in test_torch_batched_episode_pen.py
(its JAX loop planning from the port's states) and
test_torch_batched_episode_pen_step.py (its env step): each compile of the
JAX pen step under vmap takes about 30 s on one core.
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.harness import config as jcfg
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout
from mjmpc_tpu_torch import convert, envs, solvers
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import episode
from test_torch_closed_loop import _d, _lightly_compiled, _noises

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
K, B = 3, 2
ATOL = 1e-4
N, H = 16, 4


def _injected_batch(cls):
    """A subclass of the port's solver `cls` whose c-th batched noise draw
    is noises[c] ([B, N, H, dA])."""
    @dataclasses.dataclass(frozen=True)
    class Injected(cls):
        noises: Any = None
        calls: Any = None

        def sample_noise_batch(self, batch):
            self.calls.append(batch.step.tolist())
            return torch.as_tensor(self.noises[len(self.calls) - 1]).clone()

    return Injected


def batched_loops(path, to_port, fields=("qpos", "qvel"), to_jax=None):
    """jax.vmap of the JAX loop's K control steps over B episodes, and the
    port's K batched control steps, from the JAX env's starts on
    PRNGKey(b) and solver states on PRNGKey(10 + b); to_port carries a JAX
    env state across (convert.py). Returns both packages' records after
    each step: (actions, rewards, means, *the env state's `fields`). With
    to_jax (a port env state and the JAX one it replaces -> the port's as
    a JAX state), the JAX loop plans from the port's states and takes no
    env step of its own, and the records are (actions, means)."""
    exp = cfg.load_config(path)
    exp["mppi"] = dict(exp["mppi"], num_cpu=1, particles_per_cpu=N, horizon=H)
    jenv, env = jenvs.make(exp["env_name"]), envs.make(exp["env_name"], device=DEVICE)
    jsolver = jcfg.make_solver_for_env(exp, "mppi", jenv)
    params = cfg.solver_params_from_config(exp, "mppi", env)
    assert jsolver.n_iters == 1
    draws = [_noises(jsolver, env.d_action, params["init_cov"], seed=5 + b) for b in range(B)]
    noises = [np.stack([draws[b][k] for b in range(B)]) for k in range(K)]

    @_lightly_compiled
    def jax_step(p, e, s, noise):
        def one(e, s, noise):
            s = jsolver.update(s, jax_rollout(jenv, p, e, s.mean, noise))
            action = jenv.clip_action(jsolver.act(s))
            s = jsolver.shift(s._replace(step=s.step + 1))
            if to_jax is not None:
                return action, s
            e, _, reward, _ = jenv.step(p, e, action)
            return action, reward, s, e
        return jax.vmap(one)(e, s, noise)

    stack = lambda xs: jax.tree_util.tree_map(lambda *v: jnp.stack(v), *xs)   # noqa: E731
    jes = [jenv.init(jenv.params, jax.random.PRNGKey(b)) for b in range(B)]
    jss = [jsolver.init_state(jax.random.PRNGKey(10 + b)) for b in range(B)]
    e, s = stack(jes), stack(jss)
    solver = _injected_batch(solvers.MPPI)(**params, noises=noises, calls=[])
    step = episode._build_batched_step_fn(solver, env)
    es = solvers.stack_states([to_port(x, device=DEVICE) for x in jes])
    batch = solvers.GaussianBatch.stack([convert.gaussian_state_from_reference(x, b, DEVICE)
                                         for b, x in enumerate(jss)])
    jax_records, port = [], []
    for k in range(K):
        if to_jax is None:
            a, r, s, e = jax_step(jenv.params, e, s, jnp.asarray(noises[k]))
            jax_records.append((a, r, s.mean) + tuple(getattr(e, f) for f in fields))
        else:
            a, s = jax_step(jenv.params, to_jax(es, e), s, jnp.asarray(noises[k]))
            jax_records.append((a, s.mean))
        es, batch, out = step(env.params, env.params, es, batch)
        port.append((out["action"], out["reward"], batch.mean)
                    + tuple(getattr(es, f) for f in fields) if to_jax is None
                    else (out["action"], batch.mean))
    return dict(jax=jax_records, port=port, calls=list(solver.calls))


def assert_loops_agree(loop, names=("action", "reward", "mean", "qpos", "qvel")):
    """Every record at 1e-4 after each step; one batched noise draw a step,
    at every element's step."""
    assert loop["calls"] == [[k] * B for k in range(K)]
    for k in range(K):
        diffs = {f: _d(p, j) for f, p, j in zip(names, loop["port"][k], loop["jax"][k])}
        assert max(diffs.values()) <= ATOL, (k, diffs)
    # the two episodes differ
    assert _d(loop["jax"][-1][0][0], loop["jax"][-1][0][1]) > 10 * ATOL


def test_pendulum_batched_steps_match_vmapped_jax_loop():
    loop = batched_loops("configs/SimplePendulum-v0.yml", convert.pendulum_state_from_reference,
                         fields=("th", "thdot"))
    assert_loops_agree(loop, names=("action", "reward", "mean", "th", "thdot"))
