"""The port's Reinforce (mjmpc_tpu_torch/solvers/reinforce.py) against the
JAX package's: the update on injected trajectories with each baseline and
the KL line search's step; the fused solve against the general one; the
peg config's constants in chip_smoke.py against the YAML; the state
converter. Whole solves against JAX's on injected noise are in
tests/test_torch_cl_rollout.py, beside the JAX rollout they share.

Tolerances:
- update with the mean-return baseline, and the line search: atol 1e-5
  (f32 cost-to-go, whitening and a [N H, d_obs + 1]^T product summed in
  other orders);
- update with a value-function baseline: weights atol 1e-4, fit and fit
  error rtol 1e-3 atol 1e-4, the value functions' tolerance
  (tests/test_torch_value_functions.py), carried through the advantages;
- fused against general solve: atol 5e-5, the JAX package's tolerance for
  the same check (tests/test_pallas_cl.py).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.harness import config as jconfig
from mjmpc_tpu.harness.run_mpc_cl import build_cl_solver
from mjmpc_tpu.rollout.engine import Trajectories as JTrajectories
from mjmpc_tpu_torch import convert, envs, ops, solvers
from mjmpc_tpu_torch.rollout import Trajectories

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
ROOT = Path(__file__).resolve().parent.parent
N, H, D_OBS, DA = 16, 6, 5, 3


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _pair(seed, **cfg):
    """The JAX and the port solver, state and trajectories on one input:
    obs, actions and costs from numpy, a nonzero W and cov_diag."""
    rs = np.random.default_rng(seed)
    obs = rs.normal(size=(N, H, D_OBS)).astype(np.float32)
    acts = (0.5 * rs.normal(size=(N, H, DA))).astype(np.float32)
    costs = rs.uniform(0.0, 2.0, size=(N, H)).astype(np.float32)
    w0 = (0.1 * rs.normal(size=(D_OBS + 1, DA))).astype(np.float32)
    cov = rs.uniform(0.3, 1.0, DA).astype(np.float32)
    cfg = dict(d_obs=D_OBS, d_action=DA, horizon=H, num_particles=N, gamma=0.95, **cfg)
    jsolver, solver = jsolvers.Reinforce(**cfg), solvers.Reinforce(**cfg, device=DEVICE)
    jstate = jsolver.init_state(jax.random.PRNGKey(0))._replace(
        mean_weights=jnp.asarray(w0), cov_diag=jnp.asarray(cov))
    state = convert.reinforce_state_from_reference(jstate, device=DEVICE)
    jtraj = JTrajectories(jnp.asarray(obs), jnp.asarray(acts), jnp.asarray(costs),
                          None, None, None)
    traj = Trajectories(torch.as_tensor(obs), torch.as_tensor(acts), torch.as_tensor(costs),
                        None, None, None)
    return (jsolver, jstate, jtraj), (solver, state, traj)


@pytest.mark.parametrize("baseline", [None, "linear", "quadratic"])
def test_update_matches_jax(baseline):
    (jsolver, jstate, jtraj), (solver, state, traj) = _pair(
        0, lr=0.1, baseline_type=baseline, delta_reg=1e-3)
    jnew, new = jsolver.update(jstate, jtraj), solver.update(state, traj)
    _close(new.mean_weights.numpy(), jnew.mean_weights, atol=1e-5 if baseline is None else 1e-4)
    assert not np.allclose(new.mean_weights.numpy(), np.asarray(jstate.mean_weights))
    for f in ("vf_weights", "vf_bias", "fit_error"):
        _close(getattr(new, f).numpy(), getattr(jnew, f), atol=1e-4, rtol=1e-3)
    assert new.step == state.step and new.seed == state.seed


@pytest.mark.parametrize("case", ["off", "halves", "cap"])
def test_kl_linesearch_picks_the_jax_step(case):
    """The KL of step lr is lr^2 K; delta_kl is set halfway (in log) between
    two halvings, away from any rounding, so both sides stop at the same
    one: none, the third, or the cap of max_linesearch_iters = 4."""
    base = dict(lr=1.0, baseline_type=None)
    _, (solver, state, traj) = _pair(1, **base)
    ret = ops.cost_to_go(traj.costs, solver.discount)
    obs_cat, grad = solver.gradient(state, traj, ret - ret.mean(0, keepdim=True))
    step = (obs_cat @ grad).double()
    k_kl = float(torch.mean(0.5 * torch.sum(step ** 2 / state.cov_diag.double(), -1)))
    cfg, want = {"off": (dict(), 1.0),
                 "halves": (dict(delta_kl=2.0 * k_kl / 4 ** 3), 1.0 / 8),
                 "cap": (dict(delta_kl=0.5 * k_kl / 4 ** 10, max_linesearch_iters=4),
                         1.0 / 16)}[case]
    (jsolver, jstate, jtraj), (solver, state, traj) = _pair(1, **base, **cfg)
    assert float(solver.step_size(state, obs_cat, grad)) == want
    jnew, new = jsolver.update(jstate, jtraj), solver.update(state, traj)
    _close(new.mean_weights.numpy(), jnew.mean_weights)
    _close(new.mean_weights.numpy(), (state.mean_weights - want * grad).numpy())


@pytest.mark.parametrize("name", ["reacher_7dof-v0", "sawyer_peg_insertion-v0"])
def test_fused_solve_matches_general(name):
    """The env's closed-loop rollout (plain on the CPU) against the general
    rollout through a whole solve (tests/test_pallas_cl.py's check)."""
    env = envs.make(name, device=DEVICE)
    solver = solvers.Reinforce(d_obs=env.d_obs, d_action=7, horizon=4, num_particles=16,
                               lr=0.05, init_cov=0.5, gamma=0.99, baseline_type=None,
                               device=DEVICE)
    es = env.init(env.params, 1)
    a_f, _, sf = solvers.make_solve_fn(solver, env)(env.params, es, solver.init_state(0))
    a_g, _, sg = solvers.make_solve_fn(solver, env, fused=False)(env.params, es,
                                                                 solver.init_state(0))
    _close(a_f.numpy(), a_g.numpy(), atol=5e-5)
    _close(sf.mean_weights.numpy(), sg.mean_weights.numpy(), atol=5e-5)
    assert not np.allclose(sf.mean_weights.numpy(), 0.0)


def test_auto_gate_and_no_kernel():
    env = envs.make("continual_reacher-v0", device=DEVICE)
    solver = solvers.Reinforce(d_obs=env.d_obs, d_action=7, horizon=3, num_particles=4,
                               device=DEVICE)
    a, _, s = solvers.make_solve_fn(solver, env)(env.params, env.init(env.params, 0),
                                                 solver.init_state(0))
    assert a.shape == (7,) and s.step == 1
    with pytest.raises(ValueError):
        solvers.make_solve_fn(solver, env, fused=True)


def test_act_modes():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    solver = solvers.Reinforce(d_obs=env.d_obs, d_action=7, horizon=3, num_particles=4,
                               init_cov=0.5, device=DEVICE)
    state = dataclasses.replace(solver.init_state(2), mean_weights=torch.full((21, 7), 0.1))
    obs = env.observe(env.params, env.init(env.params, 0))
    torch.testing.assert_close(solver.act(state, obs), torch.cat([obs, torch.ones(1)])
                               @ state.mean_weights)
    sampled = solver.act(state, obs, "sample")
    torch.testing.assert_close(sampled, solver.act(state, obs, "sample"), rtol=0, atol=0)
    assert not torch.allclose(sampled, solver.act(state, obs))
    with pytest.raises(ValueError):
        solver.act(state, obs, "greedy")


def test_peg_config_constants_match_the_yaml():
    """chip_smoke.py holds the closed-loop peg config as constants (the
    card's machine has no YAML reader); they are what the JAX harness
    builds from configs/sawyer/sawyer_peg_insertion-v0_cl.yml."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    exp = jconfig.load_config(str(ROOT / "configs/sawyer/sawyer_peg_insertion-v0_cl.yml"))
    jsolver = build_cl_solver(exp, "reinforce", jenvs.make(exp["env_name"]))
    for key, value in smoke.PEG_CL.items():
        assert getattr(jsolver, key) == pytest.approx(value) if isinstance(value, float) \
            else getattr(jsolver, key) == value, key
    assert exp["env_name"] == "sawyer_peg_insertion-v0"


def test_reinforce_state_converter():
    jsolver = jsolvers.Reinforce(d_obs=4, d_action=2, horizon=5, num_particles=8,
                                 baseline_type="quadratic_time_varying")
    rs = np.random.default_rng(9)
    jstate = jsolver.init_state(jax.random.PRNGKey(0))._replace(
        mean_weights=jnp.asarray(rs.normal(size=(5, 2)), jnp.float32),
        vf_weights=jnp.asarray(rs.normal(size=(5, 14)), jnp.float32),
        fit_error=jnp.float32(0.25), step=jnp.array(7, jnp.int32))
    state = convert.reinforce_state_from_reference(jstate, seed=11, device=DEVICE)
    for f in ("mean_weights", "cov_diag", "vf_weights", "vf_bias", "fit_error"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)))
    assert (state.step, state.seed) == (7, 11)
    fresh = solvers.Reinforce(d_obs=4, d_action=2, horizon=5, num_particles=8,
                              baseline_type="quadratic_time_varying",
                              device=DEVICE).init_state(0)
    for f in ("mean_weights", "cov_diag", "vf_weights", "vf_bias"):
        assert getattr(fresh, f).shape == getattr(state, f).shape
