"""The port's RandomShootingNN (mjmpc_tpu_torch/solvers/random_shooting_nn.py)
against the JAX package's, and the properties of
tests/test_extended_stack.py's random-shooting-NN test.

Tolerances: one solve on the pendulum (N=64, H=32, hidden (64, 64)) from
the same injected noise and MLP weights against the JAX package's
rollout_closed_loop_policy, update, act and shift: the mean and the action
atol 1e-4 (f32 physics over 32 steps under a tanh MLP, summed in other
orders); the noise stream and the converter exactly.
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.rollout.engine import rollout_closed_loop_policy as jax_rollout_policy
from mjmpc_tpu_torch import convert, envs, ops, rng, solvers
from mjmpc_tpu_torch.rollout import Trajectories, rollout_closed_loop_policy

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
CFG = dict(horizon=32, num_particles=64, hidden=(64, 64), init_cov=0.5, step_size=0.8,
           filter_coeffs=(0.25, 0.8, 0.0))


@dataclasses.dataclass(frozen=True)
class InjectedRSNN(solvers.RandomShootingNN):
    """Test-only RandomShootingNN whose noise is given, not drawn."""
    noise: Any = None

    def sample_noise(self, state):
        return self.noise.clone()


@pytest.fixture(scope="module")
def pendulum_pair():
    """The JAX and port pendulum, a JAX solver state with a nonzero mean,
    a start and noise."""
    jenv, env = jenvs.make("SimplePendulum-v0"), envs.make("SimplePendulum-v0", device=DEVICE)
    jsolver = jsolvers.RandomShootingNN(d_obs=3, d_action=1, **CFG)
    rs = np.random.default_rng(21)
    j0 = jsolver.init_state(jax.random.PRNGKey(0))._replace(
        mean=jnp.asarray(0.2 * rs.normal(size=(32, 1)), jnp.float32))
    js = jenv.init(jenv.params, jax.random.PRNGKey(1))._replace(th=jnp.float32(2.9),
                                                               thdot=jnp.float32(-1.0))
    noise = (0.7 * rs.normal(size=(64, 32, 1))).astype(np.float32)
    return jenv, env, jsolver, j0, js, noise


def _jax_solve(jenv, jsolver, j0, js, noise):
    """The JAX package's solve on `noise`: rollout, update, act, shift."""
    policy = jsolver.policy
    traj = jax.jit(lambda p, s, pp, nz: jax_rollout_policy(
        jenv, p, s, lambda o: policy(pp, o), nz))(jenv.params, js, j0.policy_params,
                                                  jnp.asarray(noise))
    s = jsolver.update(j0, traj)
    action = jsolver.act(s)
    s = s._replace(step=s.step + 1, mean=jnp.roll(s.mean, -1, axis=0).at[-1].set(0.0))
    return action, s, traj


def test_rsnn_solve_matches_jax_on_injected_noise(pendulum_pair):
    jenv, env, jsolver, j0, js, noise = pendulum_pair
    jaction, js1, jtraj = _jax_solve(jenv, jsolver, j0, js, noise)
    solver = InjectedRSNN(d_obs=3, d_action=1, device=DEVICE, noise=torch.as_tensor(noise),
                          **CFG)
    s0 = convert.rsnn_state_from_reference(j0, seed=4, device=DEVICE)
    es = convert.pendulum_state_from_reference(js, DEVICE)
    traj = rollout_closed_loop_policy(env, env.params, es,
                                      lambda o: solver.policy(s0.policy_params, o),
                                      torch.as_tensor(noise))
    np.testing.assert_allclose(traj.costs.numpy(), np.asarray(jtraj.costs), rtol=0, atol=1e-4)
    ctg = ops.cost_to_go(traj.costs, solver.discount)[:, 0]
    # the best rollout is clear of its runner-up, so one argmin on both sides
    best2 = torch.topk(-ctg, 2).values
    assert float(best2[0] - best2[1]) > 1e-3
    action, value, s1 = solvers.make_solve_fn(solver, env)(env.params, es, s0)
    np.testing.assert_allclose(s1.mean.numpy(), np.asarray(js1.mean), rtol=0, atol=1e-4)
    np.testing.assert_allclose(action.numpy(), np.asarray(jaction), rtol=0, atol=1e-4)
    assert float(value) == 0.0 and int(s1.step) == 1 and s1.seed == 4
    assert float(s1.mean[-1].abs().max()) == 0.0


def test_rsnn_update_blends_toward_the_best_rollout():
    """From a zero mean with step_size 0.8, the new mean (before the
    shift) is 0.8 times the lowest-cost-to-go rollout's actions
    (tests/test_extended_stack.py), picked on the device."""
    solver = solvers.RandomShootingNN(d_obs=3, d_action=1, horizon=5, num_particles=6,
                                      step_size=0.8, device=DEVICE)
    s0 = solver.init_state(0)
    rs = np.random.default_rng(3)
    acts = torch.as_tensor(rs.normal(size=(6, 5, 1)).astype(np.float32))
    costs = torch.as_tensor(rs.uniform(0, 1, size=(6, 5)).astype(np.float32))
    costs[4] -= 1.0
    traj = Trajectories(None, acts, costs, None, None, None)
    s1 = solver.update(s0, traj)
    torch.testing.assert_close(s1.mean, 0.8 * acts[4], rtol=0, atol=1e-7)
    shifted = solver.shift(s1)
    torch.testing.assert_close(shifted.mean[:-1], s1.mean[1:], rtol=0, atol=0)


def test_rsnn_solve_runs_on_its_noise_stream():
    """A solve through make_solve_fn with the solver's own noise: finite,
    the mean moved; the noise is the plain sampler's (the noise kernel's
    normals, one launch on the card) under (seed, 40) at the step."""
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    solver = solvers.RandomShootingNN(d_obs=3, d_action=1, horizon=10, num_particles=32,
                                      hidden=(16,), init_cov=1.0, step_size=0.8, device=DEVICE)
    s0 = solver.init_state(0)
    es = env.init(env.params, 1)
    solve = solvers.make_solve_fn(solver, env, calc_val=True, hotstart=False, fused=True)
    a, _, s1 = solve(env.params, es, s0)
    assert np.isfinite(a.numpy()).all() and not np.allclose(s1.mean.numpy(), 0.0)
    a2, _, s2 = solve(env.params, es, s1)
    assert np.isfinite(s2.mean.numpy()).all() and int(s2.step) == 2
    want = ops.filtered_noise(rng.stream_key(0, 40), s1.step, torch.eye(1), (32, 10))
    torch.testing.assert_close(solver.sample_noise(s1), want, rtol=0, atol=0)
    assert not torch.equal(solver.sample_noise(s1), solver.sample_noise(s2))
    torch.testing.assert_close(solve(env.params, es, s1)[0], a2, rtol=0, atol=0)


def test_rsnn_guard_resets_its_policy():
    """guard_finite checks the policy's nested layers and resets them to a
    fresh policy drawn on the device at the state's step (reset_state),
    not the seed's initial one."""
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    solver = solvers.RandomShootingNN(d_obs=3, d_action=1, horizon=6, num_particles=8,
                                      hidden=(8,), device=DEVICE)
    s0 = solver.init_state(2)
    assert s0.policy_params[0].weight is solver.init_state(2).policy_params[0].weight
    params = list(s0.policy_params)
    params[1] = params[1]._replace(bias=torch.full_like(params[1].bias, float("inf")))
    guarded = solvers.guard_finite(solvers.make_solve_fn(solver, env), solver)
    a, v, s1 = guarded(env.params, env.init(env.params, 1),
                       dataclasses.replace(s0, policy_params=params))
    assert float(a.abs().max()) == 0.0 and int(s1.step) == 1
    fresh = solver.reset_state(2, rng.step_tensor(0, DEVICE)).policy_params
    for got, want, first in zip(s1.policy_params, fresh, s0.policy_params):
        torch.testing.assert_close(got.weight, want.weight, rtol=0, atol=0)
        torch.testing.assert_close(got.bias, want.bias, rtol=0, atol=0)
        assert not torch.equal(got.weight, first.weight)
    leaves = solvers.tensor_leaves(s1)
    assert "policy_params.1.bias" in leaves and "step" in leaves


def test_rsnn_state_converter_and_config_section():
    jsolver = jsolvers.RandomShootingNN(d_obs=3, d_action=1, horizon=4, num_particles=8,
                                        hidden=(5,))
    js = jsolver.init_state(jax.random.PRNGKey(2))._replace(step=jnp.int32(3))
    s = convert.rsnn_state_from_reference(js, seed=6, device=DEVICE)
    np.testing.assert_array_equal(s.mean.numpy(), np.asarray(js.mean))
    for got, want in zip(s.policy_params, js.policy_params):
        np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
        np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))
    assert int(s.step) == 3 and s.seed == 6
    from mjmpc_tpu_torch.harness import config as cfg
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    exp = {"random_shooting_nn": {"horizon": 8, "num_cpu": 2, "particles_per_cpu": 4,
                                  "hidden": [16, 16], "filter_coeffs": [0.25, 0.8, 0.0]}}
    solver = cfg.make_solver_for_env(exp, "random_shooting_nn", env)
    assert isinstance(solver, solvers.RandomShootingNN) and solver.num_particles == 8
    assert solver.d_obs == 3 and solver.policy.hidden == (16, 16)


@pytest.mark.parametrize("family", ["rsnn", "softq"])
def test_checkpoint_of_the_nested_states_and_the_next_solve(tmp_path, family):
    """harness.checkpoint saves a state with nested parameters (the MLP's
    layer list, the Q's NamedTuple) and restores it into the structure of
    an example; the next solve from the restored state equals, bit for
    bit, the solve that continues without it."""
    from mjmpc_tpu_torch.harness import checkpoint
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    if family == "rsnn":
        solver = solvers.RandomShootingNN(d_obs=3, d_action=1, horizon=6, num_particles=8,
                                          hidden=(8, 8), device=DEVICE)
    else:
        solver = solvers.SoftQMPC(d_obs=3, d_action=1, horizon=6, num_particles=8, lam=0.2,
                                  device=DEVICE)
    solve, es = solvers.make_solve_fn(solver, env), env.init(env.params, 1)
    state = solver.init_state(5)
    for _ in range(2):
        _, _, state = solve(env.params, es, state)
    checkpoint.save_solver_state(str(tmp_path / "ckpt"), state)
    restored = checkpoint.load_solver_state(str(tmp_path / "ckpt"), solver.init_state(6))
    assert type(restored) is type(state) and restored.seed == 5 and int(restored.step) == 2
    cont, rest = solve(env.params, es, state), solve(env.params, es, restored)
    torch.testing.assert_close(rest[0], cont[0], rtol=0, atol=0)
    for k, v in solvers.tensor_leaves(cont[2]).items():
        torch.testing.assert_close(solvers.tensor_leaves(rest[2])[k], v, rtol=0, atol=0)
