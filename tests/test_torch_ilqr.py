"""iLQR in the PyTorch port (solvers/ilqr.py) against the exact
finite-horizon dynamic program and the JAX package's solve.

- On LQR-v0 one iteration is a Newton step on a quadratic, so the plan
  must be the DP's (zero terminal cost): the first action to rtol 1e-3 and
  the plan's cost to rtol 1e-4, the JAX package's own bounds
  (tests/test_ilqr.py).
- The port's solve against the JAX solve, both from the same injected
  initial mean (the streams differ, so the mean is passed in), on LQR and
  on cartpole (H = 32, 5 iterations, the cartpole config's iLQR): action,
  plan cost and the shifted mean to rtol 1e-4 (atol 1e-6 where a value is
  near zero).
- The pendulum's plan cost does not rise with more iterations (the line
  search keeps the nominal plan unless a candidate beats it) and replanning
  from the hotstart holds it.
- The maze, whose state holds an int64 timestep and a host key, plans
  with those fields frozen.
- `step` is a 0-d int64 tensor that a solve and guard_finite advance on
  the device; no solve makes a torch.Generator; guard_finite resets a
  non-finite solve to init_state's mean.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.envs.cartpole import CartpoleState as JaxCartpoleState
from mjmpc_tpu.envs.lqr import LQRState as JaxLQRState
from mjmpc_tpu_torch import convert, envs, rng, solvers
from mjmpc_tpu_torch.envs.lqr import LQRState
from mjmpc_tpu_torch.envs.pendulum import PendulumState

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
X0 = np.array([1.5, -0.8])


def _lqr_dp(env, h):
    """(first optimal action, optimal cost) of the finite-horizon LQR from
    X0 in float64."""
    a_m, b_m, q_m, r_m = (getattr(env.params, k).double().numpy() for k in "ABQR")
    pp, ks = np.zeros((2, 2)), []
    for _ in range(h):
        k = np.linalg.solve(r_m + b_m.T @ pp @ b_m, b_m.T @ pp @ a_m)
        pp = q_m + k.T @ r_m @ k + (a_m - b_m @ k).T @ pp @ (a_m - b_m @ k)
        ks.append(k)
    ks = ks[::-1]
    x, cost = X0.copy(), 0.0
    for t in range(h):
        u = -ks[t] @ x
        cost += x @ q_m @ x + u @ r_m @ u
        x = a_m @ x + b_m @ u
    return float((-ks[0] @ X0)[0]), cost


def test_ilqr_exact_on_lqr():
    env = envs.make("LQR-v0", device=DEVICE)
    h = 30
    u0_opt, cost_opt = _lqr_dp(env, h)
    solver = solvers.ILQR(d_action=1, horizon=h, n_iters=3, mu=1e-6, device=DEVICE)
    solve = solvers.make_solve_fn(solver, env)
    a, plan_cost, s = solve(env.params, LQRState(x=torch.tensor(X0, dtype=torch.float32)),
                            solver.init_state(0))
    np.testing.assert_allclose(float(a[0]), u0_opt, rtol=1e-3)
    np.testing.assert_allclose(float(plan_cost), cost_opt, rtol=1e-4)
    assert int(s.step) == 1 and torch.equal(s.mean[-1], torch.zeros(1))


def _jax_solve(jenv, jsolver, mean, jstate):
    s0 = jsolver.init_state(jax.random.PRNGKey(0))._replace(mean=jnp.asarray(mean))
    return jax.jit(jsolvers.make_solve_fn(jsolver, jenv))(jenv.params, jstate, s0)


CASES = {
    # name: (iLQR fields, JAX env state, the port's from it)
    "LQR-v0": (dict(d_action=1, horizon=12, n_iters=3, mu=1e-3),
               JaxLQRState(x=jnp.asarray(X0, jnp.float32))),
    "cartpole-v0": (dict(d_action=1, horizon=32, n_iters=5),
                    JaxCartpoleState(*(jnp.float32(v) for v in (0.3, -0.2, 2.6, 0.5)))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax_from_the_same_mean(name):
    fields, jstate = CASES[name]
    env, jenv = envs.make(name, device=DEVICE), jenvs.make(name)
    bounds = dict(action_lows=env.action_lows, action_highs=env.action_highs)
    solver = solvers.ILQR(**fields, **bounds, device=DEVICE)
    jsolver = jsolvers.ILQR(**fields, action_lows=jenv.action_lows,
                            action_highs=jenv.action_highs)
    mean = np.random.default_rng(1).normal(0, 0.3, (fields["horizon"], 1)).astype(np.float32)
    if name == "LQR-v0":
        state = convert.lqr_state_from_reference(jstate, DEVICE)
    else:
        state = convert.cartpole_state_from_reference(jstate, DEVICE)
    s0 = dataclasses.replace(solver.init_state(0), mean=torch.as_tensor(mean))
    a, cost, s = solvers.make_solve_fn(solver, env)(env.params, state, s0)
    a_j, cost_j, s_j = _jax_solve(jenv, jsolver, mean, jstate)
    close = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), **close)
    np.testing.assert_allclose(float(cost), float(cost_j), **close)
    np.testing.assert_allclose(s.mean.numpy(), np.asarray(s_j.mean), **close)
    assert int(s.step) == int(s_j.step) == 1
    # the plan moved: iLQR did work
    assert float((s.mean[:-1] - s0.mean[1:]).abs().max()) > 1e-2


def test_pendulum_cost_does_not_rise_over_iterations():
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    state = PendulumState(th=torch.tensor(2.5), thdot=torch.tensor(0.0))
    costs = []
    for n_iters in (1, 2, 4, 8):
        solver = solvers.ILQR(d_action=1, horizon=24, n_iters=n_iters, mu=1e-2,
                              action_lows=env.action_lows, action_highs=env.action_highs,
                              device=DEVICE)
        a, cost, s = solvers.make_solve_fn(solver, env)(env.params, state, solver.init_state(0))
        assert torch.isfinite(a).all() and (a.abs() <= 2.0).all()
        costs.append(float(cost))
    assert all(b <= a * (1 + 1e-6) for a, b in zip(costs, costs[1:])), costs
    assert costs[-1] < costs[0]
    # replanning from the hotstart keeps improving or holds (tests/test_ilqr.py)
    solve = solvers.make_solve_fn(solver, env)
    _, cost2, _ = solve(env.params, state, s)
    assert float(cost2) <= costs[-1] * 1.05


def test_maze_plans_with_its_integer_fields_frozen():
    env = envs.make("continual_maze-v0", device=DEVICE)
    es = dataclasses.replace(env.init(env.params, 2), timestep=rng.step_tensor(45, DEVICE))
    solver = solvers.ILQR(d_action=2, horizon=8, n_iters=2, action_lows=env.action_lows,
                          action_highs=env.action_highs, device=DEVICE)
    a, cost, s = solvers.make_solve_fn(solver, env)(env.params, es, solver.init_state(0))
    assert a.shape == (2,) and torch.isfinite(a).all() and torch.isfinite(cost)
    assert int(es.timestep) == 45


def test_step_advances_on_the_device_and_no_generator_is_made(monkeypatch):
    env = envs.make("cartpole-v0", device=DEVICE)
    solver = solvers.ILQR(d_action=1, horizon=6, n_iters=2, device=DEVICE)
    s0 = solver.init_state(3)
    es = env.init(env.params, 1)

    def boom(*args, **kwargs):
        raise AssertionError("a torch.Generator inside a solve")

    monkeypatch.setattr(torch, "Generator", boom)
    solve = solvers.make_solve_fn(solver, env)
    _, _, s1 = solve(env.params, es, s0)
    _, _, s2 = solvers.guard_finite(solve, solver)(env.params, es, s1)
    assert s0.step.dtype == torch.int64 and s0.step.dim() == 0
    assert (int(s0.step), int(s1.step), int(s2.step)) == (0, 1, 2)
    assert s2.seed == s0.seed == 3
    # init_state draws its mean from the stream (seed, 40) at step 0
    assert torch.equal(solver.init_state(3).mean, s0.mean)
    assert not torch.equal(solver.init_state(4).mean, s0.mean)
    assert float(s0.mean.abs().max()) < 0.1


def test_guard_resets_a_non_finite_solve():
    env = envs.make("LQR-v0", device=DEVICE)
    nan_env = dataclasses.replace(env, step=lambda p, s, u: (
        LQRState(x=s.x * float("nan")), s.x, torch.full(s.x.shape[:-1], float("nan")),
        torch.zeros(s.x.shape[:-1], dtype=torch.bool)))
    solver = solvers.ILQR(d_action=1, horizon=5, n_iters=1, device=DEVICE)
    state = dataclasses.replace(solver.init_state(0), step=rng.step_tensor(3, DEVICE),
                                mean=torch.ones(5, 1))
    guarded = solvers.guard_finite(solvers.make_solve_fn(solver, nan_env), solver)
    a, value, s = guarded(env.params, LQRState(x=torch.tensor(X0, dtype=torch.float32)), state)
    assert float(a[0]) == 0.0 and float(value) == 0.0 and int(s.step) == 4
    assert torch.equal(s.mean, solver.init_state(0).mean)


def test_config_translation_drops_reg_and_keeps_mu():
    from mjmpc_tpu.harness import config as jcfg
    from mjmpc_tpu_torch.harness import config as cfg
    exp = cfg.load_config("configs/classic_control/cartpole-v0.yml")
    env = envs.make("cartpole-v0", device=DEVICE)
    solver = cfg.make_solver_for_env(exp, "ilqr", env)
    jsolver = jcfg.make_solver_for_env(exp, "ilqr", jenvs.make("cartpole-v0"))
    assert isinstance(solver, solvers.ILQR) and solver.mu == jsolver.mu == 1e-3
    for f in ("horizon", "n_iters", "gamma", "init_std", "d_action"):
        assert getattr(solver, f) == getattr(jsolver, f), f
