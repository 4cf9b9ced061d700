"""The port's reacher env, MPPI update and whole solve against the JAX
package and the NumPy oracle, plus the registry and the no-jax import.

Tolerances:
- env step: atol 1e-5 (f32 physics, different AD systems for the bias);
- MPPI update and value: atol 1e-5 (softmax of f32 cost-to-go, with lam
  large enough that the weights are well conditioned);
- whole solve: action and mean to atol 2e-5, the JAX fused-vs-general
  solve tolerance (tests/test_pallas_chain.py), on the JAX solve's own
  noise injected into the port.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.envs.reacher_7dof import ReacherState as JReacherState
from mjmpc_tpu.oracle import numpy_ref
from mjmpc_tpu.rollout.engine import Trajectories as JTrajectories
from mjmpc_tpu_torch import convert, envs, rng, solvers
from mjmpc_tpu_torch.rollout import Trajectories

SOLVE_ATOL = 2e-5
DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU


@dataclasses.dataclass(frozen=True)
class InjectedMPPI(solvers.MPPI):
    """Test-only MPPI whose noise is given, not sampled."""
    noise: torch.Tensor = None

    def sample_noise(self, state):
        return self.noise.clone()


def _jax_state(seed):
    rng = np.random.default_rng(seed)
    return JReacherState(
        qpos=jnp.asarray(0.3 * rng.normal(size=7), jnp.float32),
        qvel=jnp.asarray(rng.normal(size=7), jnp.float32),
        target=jnp.asarray([0.2, -0.1, 0.15], jnp.float32),
        timestep=jnp.array(3, jnp.int32), key=jax.random.PRNGKey(seed))


def test_env_step_and_observe_match_jax():
    jenv, env = jenvs.make("reacher_7dof-v0"), envs.make("reacher_7dof-v0", device=DEVICE)
    js = _jax_state(0)
    action = np.linspace(-1.5, 1.5, 7).astype(np.float32)   # clipped inside
    jn, jobs, jrew, _ = jax.jit(jenv.step)(jenv.params, js, jnp.asarray(action))
    state = convert.reacher_state_from_reference(js, device=DEVICE)
    ns, obs, rew, done = env.step(env.params, state, torch.as_tensor(action))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=0, atol=1e-5)
    np.testing.assert_allclose(env.observe(env.params, state).numpy(),
                               np.asarray(jenv.observe(jenv.params, js)), rtol=0, atol=1e-5)
    assert ns.timestep == 4 and not bool(done)
    assert bool(env.success(env.params, state)) == bool(jenv.success(jenv.params, js))


def test_continual_reacher_moves_its_target_every_50_steps():
    env = envs.make("continual_reacher-v0", device=DEVICE)
    assert env.fused_rollout is None
    state = env.init(env.params, 0)
    action = torch.zeros(7)
    state = dataclasses.replace(state, timestep=rng.step_tensor(48, DEVICE))
    s49, *_ = env.step(env.params, state, action)
    s50, *_ = env.step(env.params, s49, action)
    torch.testing.assert_close(s49.target, state.target, rtol=0, atol=0)
    assert not torch.equal(s50.target, state.target)
    lo, hi = env.params.target_low, env.params.target_high
    assert bool(((s50.target >= lo) & (s50.target <= hi)).all())


def _update_inputs(seed, n=16, h=6, da=3):
    rng = np.random.default_rng(seed)
    mean = (0.3 * rng.normal(size=(h, da))).astype(np.float32)
    cov = np.diag(rng.uniform(0.3, 1.0, da)).astype(np.float32)
    actions = (mean + 0.5 * rng.normal(size=(n, h, da))).astype(np.float32)
    costs = rng.uniform(0.0, 1.0, size=(n, h)).astype(np.float32)
    return mean, cov, actions, costs


@pytest.mark.parametrize("alpha", [0, 1])
def test_mppi_update_and_value_match_jax_and_oracle(alpha):
    mean, cov, actions, costs = _update_inputs(alpha)
    n, h, da = actions.shape
    cfg = dict(d_action=da, horizon=h, num_particles=n, lam=0.5, gamma=0.95,
               step_size=0.55, alpha=alpha)
    jsolver, solver = jsolvers.MPPI(**cfg), solvers.MPPI(**cfg, device=DEVICE)
    jstate = jsolvers.GaussianState(mean=jnp.asarray(mean), cov=jnp.asarray(cov),
                                    step=jnp.array(0, jnp.int32),
                                    key=jax.random.PRNGKey(0))
    jtraj = JTrajectories(None, jnp.asarray(actions), jnp.asarray(costs), None, None, None)
    state = convert.gaussian_state_from_reference(jstate, device=DEVICE)
    traj = Trajectories(None, torch.as_tensor(actions), torch.as_tensor(costs),
                        None, None, None)

    got = solver.update(state, traj).mean.numpy()
    np.testing.assert_allclose(got, np.asarray(jsolver.update(jstate, jtraj).mean),
                               rtol=0, atol=1e-5)
    want = numpy_ref.mppi_update(mean.astype(np.float64), cov.astype(np.float64),
                                 actions.astype(np.float64), costs.astype(np.float64),
                                 solver.gamma_seq, 0.5, 0.55, alpha)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    value = float(solver.value(state, traj))
    np.testing.assert_allclose(value, float(jsolver.value(jstate, jtraj)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        value, numpy_ref.mppi_calc_val(mean, cov, actions.astype(np.float64),
                                       costs.astype(np.float64), solver.gamma_seq,
                                       0.5, alpha), rtol=0, atol=1e-5)


@pytest.mark.parametrize("base_action,alpha", [("repeat", 0), ("null", 1)])
def test_solve_matches_jax_general_solve(base_action, alpha):
    """One whole solve (fused rollout in the port, general rollout in JAX)
    on the JAX solve's own noise. Two cases cover both base actions and
    both alphas; each case compiles one JAX solve (~5-15 s on the CPU)."""
    jenv, env = jenvs.make("reacher_7dof-v0"), envs.make("reacher_7dof-v0", device=DEVICE)
    cfg = dict(d_action=7, horizon=8, num_particles=32, lam=0.2, init_cov=0.5,
               step_size=0.55, gamma=1.0, alpha=alpha, base_action=base_action,
               filter_coeffs=(0.25, 0.8, 0.0))
    jsolver = jsolvers.MPPI(**cfg)
    s0 = jsolver.init_state(jax.random.PRNGKey(0))
    es = jenv.init(jenv.params, jax.random.PRNGKey(1))
    noise = np.array(jsolver.sample_noise(s0))
    a_j, _, s_j = jax.jit(jsolvers.build_solve_fn(jsolver, jenv, fused=False))(
        jenv.params, es, s0)

    solver = InjectedMPPI(**cfg, noise=torch.as_tensor(noise), device=DEVICE)
    solve = solvers.make_solve_fn(solver, env)
    a, value, s = solve(env.params, convert.reacher_state_from_reference(es, device=DEVICE),
                        convert.gaussian_state_from_reference(s0, device=DEVICE))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=0, atol=SOLVE_ATOL)
    np.testing.assert_allclose(s.mean.numpy(), np.asarray(s_j.mean), rtol=0,
                               atol=SOLVE_ATOL)
    assert s.step == int(s_j.step) == 1
    assert float(value) == 0.0


def test_noise_streams_follow_seed_and_step():
    solver = solvers.MPPI(d_action=7, horizon=5, num_particles=4,
                          filter_coeffs=(0.25, 0.8, 0.0), device=DEVICE)
    s = solver.init_state(3)
    n0 = solver.sample_noise(s)
    torch.testing.assert_close(solver.sample_noise(solver.init_state(3)), n0,
                               rtol=0, atol=0)
    assert not torch.equal(
        solver.sample_noise(dataclasses.replace(s, step=rng.step_tensor(1, DEVICE))), n0)
    assert not torch.equal(solver.sample_noise(solver.init_state(4)), n0)


def test_evaluate_episode_runs_and_is_reproducible():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    solver = solvers.MPPI(d_action=7, horizon=6, num_particles=16, lam=0.01,
                          init_cov=3.0, step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0),
                          base_action="repeat", device=DEVICE)
    episode = solvers.evaluate_episode(solver, env, 3)
    out = episode(env.params, 0)
    assert out["reward"].shape == (3,) and out["action"].shape == (3, 7)
    assert bool(torch.isfinite(out["reward"]).all())
    assert bool((out["action"].abs() <= 1.0).all())
    torch.testing.assert_close(episode(env.params, 0)["reward"], out["reward"],
                               rtol=0, atol=0)


def test_optimal_value_is_finite():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    solver = solvers.MPPI(d_action=7, horizon=4, num_particles=8, lam=0.5,
                          device=DEVICE)
    value = solvers.build_optimal_value_fn(solver, env)(
        env.params, env.init(env.params, 0), 5)
    assert value.shape == () and bool(torch.isfinite(value))


def test_registry():
    with pytest.raises(ValueError):
        envs.make("no_such_env-v0", device=DEVICE)
    assert envs.make("reacher_7dof-v0", device=DEVICE) is envs.make("reacher_7dof-v0", device=DEVICE)
    assert envs.available() == ["HalfCheetah-v0", "LQR-v0", "SimplePendulum-v0", "Swimmer-v0",
                                "acrobot-v0", "cartpole-v0", "continual_maze-v0",
                                "continual_reacher-v0", "door-v0", "hammer-v0", "maze-v0",
                                "mjrl_point_mass-v0", "panda_reacher-v0", "panda_tray_glass-v0",
                                "panda_tray_glass-v1", "panda_tray_glass_fixed-v1", "pen-v0",
                                "point_mass-v0", "pusher-v0", "reacher_7dof-v0", "relocate-v0",
                                "sawyer_door-v0", "sawyer_peg_insertion-v0",
                                "sawyer_peg_insertion-v1", "sawyer_pusher-v0",
                                "sawyer_reacher-v0", "trajopt_reacher-v0"]
    assert envs.NOT_PORTED == ()                # every JAX env is ported
    assert envs.make("cartpole-v0", device=DEVICE).name == "cartpole-v0"
    with pytest.raises(NotImplementedError):
        solvers.make_solve_fn(object(), envs.make("reacher_7dof-v0", device=DEVICE))


def test_import_leaves_jax_out():
    code = ("import sys, mjmpc_tpu_torch, mjmpc_tpu_torch.convert, "
            "mjmpc_tpu_torch.kernels.build, mjmpc_tpu_torch.ops.chain_rollout, "
            "mjmpc_tpu_torch.ops.noise, mjmpc_tpu_torch.policies, mjmpc_tpu_torch.bounds, "
            "mjmpc_tpu_torch.value_functions, mjmpc_tpu_torch.solvers.reinforce, "
            "mjmpc_tpu_torch.envs.sawyer_tasks, mjmpc_tpu_torch.envs.swimmer, "
            "mjmpc_tpu_torch.envs.half_cheetah, mjmpc_tpu_torch.harness.run_mpc, "
            "mjmpc_tpu_torch.utils, mjmpc_tpu_torch.envs.pen, mjmpc_tpu_torch.envs.adroit, "
            "mjmpc_tpu_torch.envs.contact, mjmpc_tpu_torch.ops.forest_rollout, "
            "mjmpc_tpu_torch.envs.pendulum, mjmpc_tpu_torch.ops.pendulum, "
            "mjmpc_tpu_torch.envs.hand_door, mjmpc_tpu_torch.envs.panda_tasks, "
            "mjmpc_tpu_torch.envs.lqr, mjmpc_tpu_torch.envs.point_mass, "
            "mjmpc_tpu_torch.envs.cartpole, mjmpc_tpu_torch.envs.acrobot, "
            "mjmpc_tpu_torch.envs.trajopt_reacher, mjmpc_tpu_torch.envs.maze, "
            "mjmpc_tpu_torch.solvers.ilqr, mjmpc_tpu_torch.harness.checkpoint, "
            "mjmpc_tpu_torch.harness.run_mpc_cl, mjmpc_tpu_torch.harness.jobs, "
            "mjmpc_tpu_torch.utils.helpers, mjmpc_tpu_torch.models, mjmpc_tpu_torch.rl, "
            "mjmpc_tpu_torch.solvers.softq, mjmpc_tpu_torch.solvers.random_shooting_nn, "
            "mjmpc_tpu_torch.harness.sacq_eval, mjmpc_tpu_torch.harness.softq_diag, "
            "mjmpc_tpu_torch.harness.benchmark, mjmpc_tpu_torch.harness.forest_perf; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    subprocess.run([sys.executable, "-c", code], check=True)
