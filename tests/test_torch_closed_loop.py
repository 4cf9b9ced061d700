"""Closed loops of the port against the JAX package's, on the CPU: K = 3
control steps of solve, clip and env step from the same start, each solve
on the same injected noise (never seeds: the two packages' streams
differ). The port runs its own solve (make_solve_fn, its noise given); the
JAX side is composed from the package's own pieces (rollout, update, act,
shift), jitted once. Actions, rewards, the solver state and the env state
are compared after each step. The helpers here also serve
test_torch_closed_loop_peg.py, run_mpc_cl's Reinforce on the peg CL config.

What the loops show:
- trajopt_reacher-v0 with its config's mppi block (H=32, N=36, 'repeat',
  step size 0.55, filter (0.25, 0.8, 0)): every field agrees to 1e-4 at
  every step (about 1e-7).
- acrobot-v0 mppi (H=32, N=40, lam 0.1): the first two steps agree to
  1e-4. The rollout costs differ by f32 rounding (3e-6 at the first step
  from identical inputs; each package's rollout is as far from the port's
  float64 rollout as from the other's), MPPI's updates on the same
  trajectories agree to 1e-5, and the softmax at lam 0.1 amplifies the
  swinging arm's rounding: by the third step the means differ by about
  1e-3, within the bound that the cost differences and the softmax's
  sensitivity give.
- the peg CL config (test_torch_closed_loop_peg.py): the first rollout
  agrees to 1e-4, the port's update on JAX's trajectory agrees with JAX's
  where the near-singular critic fit leaves it well conditioned, and the
  loops then part by f32 rounding as far as the JAX loop with its
  particles permuted parts from itself.
So the episode results that differ from the JAX records are the spread of
f32 rounding and of the noise streams, not a fault of the port.
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.harness import config as jcfg
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout_open_loop
from mjmpc_tpu_torch import convert, envs, ops, solvers
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.rollout import Trajectories, rollout_open_loop

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
K = 3
ATOL = 1e-4


def _d(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _noises(solver, d_action: int, cov, seed: int):
    """K noise draws [N, H, dA]: N(0, cov) through the solver's AR(2)
    filter, in numpy."""
    rs = np.random.default_rng(seed)
    b0, b1, b2 = solver.filter_coeffs
    out = []
    for _ in range(K):
        eps = rs.normal(size=(solver.num_particles, solver.horizon, d_action)) * np.sqrt(cov)
        for i in range(2, solver.horizon):
            eps[:, i] = b0 * eps[:, i] + b1 * eps[:, i - 1] + b2 * eps[:, i - 2]
        out.append(eps.astype(np.float32))
    return out


def _lightly_compiled(fn):
    """fn jitted, compiled at XLA's backend optimisation level 0 on its
    first call: a third of the compile time for a few calls (the same
    results here; the rollouts called a dozen times keep the default)."""
    compiled = {}

    def call(*args):
        if not compiled:
            compiled["fn"] = jax.jit(fn).lower(*args).compile(
                {"xla_backend_optimization_level": 0})
        return compiled["fn"](*args)

    return call


def _injected(cls):
    """A subclass of the port's solver `cls` whose noise at step k is
    noises[k], and which appends each trajectory's costs to `costs`."""
    @dataclasses.dataclass(frozen=True)
    class Injected(cls):
        noises: Any = None
        costs: Any = None

        def sample_noise(self, state):
            return torch.as_tensor(self.noises[int(state.step)]).clone()

        def update(self, state, traj):
            self.costs.append(traj.costs)
            return super().update(state, traj)

    return Injected


# ---- open-loop MPPI: trajopt_reacher, acrobot ------------------------------

MPPI_LOOPS = {
    "trajopt_reacher-v0": ("configs/trajopt_reacher-v0.yml",
                           convert.trajopt_reacher_state_from_reference, K),
    "acrobot-v0": ("configs/classic_control/acrobot-v0.yml",
                   convert.acrobot_state_from_reference, 2),
}


def _mppi_loops(name):
    """Both packages' loops from the JAX env's start; per step the JAX
    records, the port's, and JAX's trajectory with the port's update on
    it."""
    path, to_port, _ = MPPI_LOOPS[name]
    exp = cfg.load_config(path)
    jenv, env = jenvs.make(exp["env_name"]), envs.make(exp["env_name"], device=DEVICE)
    jsolver = jcfg.make_solver_for_env(exp, "mppi", jenv)
    params = cfg.solver_params_from_config(exp, "mppi", env)
    noises = _noises(jsolver, env.d_action, params["init_cov"], seed=3)
    solver = _injected(solvers.MPPI)(**params, noises=noises, costs=[])

    @_lightly_compiled
    def jax_step(p, e, s, noise):
        traj = jax_rollout_open_loop(jenv, p, e, s.mean, noise)
        s = jsolver.update(s, traj)
        updated = s.mean
        action = jenv.clip_action(jsolver.act(s))
        s = jsolver.shift(s._replace(step=s.step + 1))
        e, _, reward, _ = jenv.step(p, e, action)
        return action, reward, s, e, traj, updated

    je = jenv.init(jenv.params, jax.random.PRNGKey(0))
    js = jsolver.init_state(jax.random.PRNGKey(1))
    es, st = to_port(je, DEVICE), convert.gaussian_state_from_reference(js, 0, DEVICE)
    solve = solvers.make_solve_fn(solver, env)
    steps = []
    for k in range(K):
        prev = convert.gaussian_state_from_reference(js, 0, DEVICE)
        ja, jr, js, je, jtraj, jupdated = jax_step(jenv.params, je, js, jnp.asarray(noises[k]))
        # the port's update on JAX's own trajectory, from JAX's state
        port_traj = Trajectories(*(None if x is None else torch.as_tensor(np.array(x))
                                   for x in jtraj))
        same_input = solvers.MPPI.update(solver, prev, port_traj)
        a, _, st = solve(env.params, es, st)
        a = env.clip_action(a)
        es, _, r, _ = env.step(env.params, es, a)
        steps.append(dict(jax=(ja, jr, js.mean, je.qpos, je.qvel),
                          port=(a, r, st.mean, es.qpos, es.qvel), jax_traj=jtraj,
                          update_on_jax_traj=same_input.mean, jax_update=jupdated))
    return dict(jenv=jenv, env=env, solver=solver, steps=steps, start=(jenv.init(
        jenv.params, jax.random.PRNGKey(0)), noises[0]), lam=params["lam"])


@pytest.fixture(scope="module")
def mppi_loops():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _mppi_loops(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(MPPI_LOOPS))
def test_mppi_closed_loop_matches_jax(mppi_loops, name):
    """Actions, rewards, the mean and the env state at 1e-4 after each
    step for as long as f32 rounding stays below it (trajopt_reacher: every
    step; acrobot: the first two); at every step the port's MPPI update on
    JAX's trajectory equals JAX's to 1e-5; past the agreeing steps the
    means differ by no more than MPPI's softmax lets the two loops' own
    cost-to-go differences move them. With the same noise the actions
    differ by the last mean's difference d0, and sum |dw| <= 2 max|d ctg| /
    lam, so |d mean| <= d0 + step_size (2 max|d ctg| / lam) max|a|."""
    loop = mppi_loops(name)
    agree = MPPI_LOOPS[name][2]
    solver = loop["solver"]
    prev_mean = 0.0
    for k, step in enumerate(loop["steps"]):
        np.testing.assert_allclose(step["update_on_jax_traj"].numpy(),
                                   np.asarray(step["jax_update"]), rtol=0, atol=1e-5)
        diffs = {f: _d(p, j) for f, p, j in zip(("action", "reward", "mean", "qpos", "qvel"),
                                                  step["port"], step["jax"])}
        if k < agree:
            assert max(diffs.values()) <= ATOL, (k, diffs)
        else:
            jtraj = step["jax_traj"]
            d_ctg = _d(solver.costs[k].sum(1), np.asarray(jtraj.costs).sum(1))
            bound = prev_mean + (solver.step_size * 2 * d_ctg / loop["lam"]
                                 * float(np.abs(np.asarray(jtraj.actions)).max()))
            assert diffs["mean"] <= bound, (k, diffs, d_ctg, bound)
            assert all(np.isfinite(np.asarray(x)).all() for x in step["port"])
        prev_mean = diffs["mean"]


def test_acrobot_rollout_rounding_is_alike_in_both_packages(mppi_loops):
    """From the loop's start and first noise, the JAX and the port rollout
    in f32 against the port's rollout in float64 (every model tensor,
    state and noise in double): each f32 rollout's costs are within 3x of
    the other's distance from the float64 costs, and the two differ by no
    more than they each miss float64: rounding, not a model difference."""
    loop = mppi_loops("acrobot-v0")
    env, (je, noise) = loop["env"], loop["start"]
    jtraj = loop["steps"][0]["jax_traj"]
    es = convert.acrobot_state_from_reference(je, DEVICE)
    mean = torch.zeros(noise.shape[1], env.d_action)     # the loop's first mean
    port32 = loop["solver"].costs[0]                      # the loop's first rollout
    double = lambda x: solvers.map_tensors(
        lambda t: t.double() if t.is_floating_point() else t, x)
    env64 = dataclasses.replace(env, params=double(env.params))
    port64 = rollout_open_loop(env64, env64.params, double(es), mean.double(),
                               torch.as_tensor(noise).double()).costs
    err_jax, err_port = _d(jtraj.costs, port64), _d(port32, port64)
    gap = _d(jtraj.costs, port32)
    assert port64.dtype == torch.float64 and 0 < err_port and 0 < err_jax
    assert err_port <= 3 * err_jax and err_jax <= 3 * err_port, (err_jax, err_port)
    assert gap <= max(err_jax, err_port) <= ATOL, (gap, err_jax, err_port)
