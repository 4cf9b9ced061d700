"""The port's open-loop solver family (RandomShooting, CEM, DMD, MPPIQ,
PFMPC), guard_finite, the registry and the policies against the JAX
package and the NumPy oracle, on trajectories made with numpy from a seed.

Tolerances:
- update, value and shift against JAX and the oracle: atol 1e-5 (f32
  softmax and cost-to-go with sums in other orders; the temperatures keep
  the weights well conditioned; the MPPI update parity was 2.3e-6);
- fused against general solve for MPPIQ with a Q: atol 1e-5, the JAX
  package's tolerance for the same check (tests/test_pallas_cl.py);
- resampling: exact indices (one comparison per particle, the cumulative
  weights agree to f32 rounding and u is kept away from them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.oracle import numpy_ref
from mjmpc_tpu.rollout.engine import Trajectories as JTrajectories
from mjmpc_tpu_torch import envs, ops, policies, rng, solvers
from mjmpc_tpu_torch.rollout import Trajectories

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
ATOL = 1e-5
N, H, DA, D_OBS = 20, 6, 3, 5


def _inputs(seed, n=N, h=H, da=DA, full_cov=False):
    rs = np.random.default_rng(seed)
    mean = (0.3 * rs.normal(size=(h, da))).astype(np.float32)
    if full_cov:
        a = rs.normal(size=(da, da))
        cov = (a @ a.T / da + 0.4 * np.eye(da)).astype(np.float32)
    else:
        cov = np.diag(rs.uniform(0.3, 1.0, da)).astype(np.float32)
    actions = (mean + 0.5 * rs.normal(size=(n, h, da))).astype(np.float32)
    costs = rs.uniform(0.0, 1.0, size=(n, h)).astype(np.float32)
    obs = rs.normal(size=(n, h, D_OBS)).astype(np.float32)
    return mean, cov, actions, costs, obs


def _pair(jcls, cls, data, **cfg):
    """The JAX and the port solver, state and trajectories on one input."""
    mean, cov, actions, costs, obs = data
    n, h, da = actions.shape
    cfg = dict(d_action=da, horizon=h, num_particles=n, **cfg)
    jsolver, solver = jcls(**cfg), cls(**cfg, device=DEVICE)
    jstate = jsolvers.GaussianState(mean=jnp.asarray(mean), cov=jnp.asarray(cov),
                                    step=jnp.array(0, jnp.int32), key=jax.random.PRNGKey(0))
    state = solvers.GaussianState(mean=torch.as_tensor(mean), cov=torch.as_tensor(cov),
                                  step=rng.step_tensor(0, DEVICE), seed=0)
    jtraj = JTrajectories(jnp.asarray(obs), jnp.asarray(actions), jnp.asarray(costs),
                          None, None, None)
    traj = Trajectories(torch.as_tensor(obs), torch.as_tensor(actions),
                        torch.as_tensor(costs), None, None, None)
    return (jsolver, jstate, jtraj), (solver, state, traj)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _check_update_value_shift(jside, side, fields=("mean", "cov")):
    (jsolver, jstate, jtraj), (solver, state, traj) = jside, side
    new, jnew = solver.update(state, traj), jsolver.update(jstate, jtraj)
    for f in fields:
        _close(getattr(new, f).numpy(), getattr(jnew, f))
    _close(float(solver.value(state, traj)), float(jsolver.value(jstate, jtraj)))
    shifted, jshifted = solver.shift(new), jsolver.shift(jnew)
    for f in fields:
        _close(getattr(shifted, f).numpy(), getattr(jshifted, f))
    return new


@pytest.mark.parametrize("base_action", ["repeat", "null"])
def test_random_shooting_matches_jax_and_oracle(base_action):
    data = _inputs(0)
    jside, side = _pair(jsolvers.RandomShooting, solvers.RandomShooting, data, gamma=0.95,
                        step_size=0.6, base_action=base_action)
    new = _check_update_value_shift(jside, side, fields=("mean",))
    mean, _, actions, costs, _ = data
    want = numpy_ref.random_shooting_update(mean, actions, costs, side[0].gamma_seq, 0.6)
    _close(new.mean.numpy(), want)


@pytest.mark.parametrize("cov_type", ["diagonal", "full"])
def test_cem_matches_jax_and_oracle(cov_type):
    data = _inputs(1, full_cov=cov_type == "full")
    jside, side = _pair(jsolvers.CEM, solvers.CEM, data, gamma=0.9, step_size=0.7,
                        elite_frac=0.25, beta=0.1, init_cov=0.8, cov_type=cov_type,
                        base_action="repeat")
    new = _check_update_value_shift(jside, side)
    mean, cov, actions, costs, _ = data
    want_mean, want_cov = numpy_ref.cem_update(mean, cov, actions, costs, side[0].gamma_seq,
                                               0.25, 0.7, cov_type)
    _close(new.mean.numpy(), want_mean)
    _close(new.cov.numpy(), want_cov)


@pytest.mark.parametrize("update_cov,cov_type", [(True, "diagonal"), (True, "full"),
                                                 (False, "diagonal")])
def test_dmd_matches_jax_and_oracle(update_cov, cov_type):
    data = _inputs(2, full_cov=cov_type == "full")
    jside, side = _pair(jsolvers.DMDMPC, solvers.DMDMPC, data, gamma=0.97, step_size=0.5,
                        lam=0.4, beta=0.05, update_cov=update_cov, cov_type=cov_type)
    new = _check_update_value_shift(jside, side)
    mean, cov, actions, costs, _ = data
    want_mean, want_cov = numpy_ref.dmd_update(mean, cov, actions, costs, side[0].gamma_seq,
                                               0.4, 0.5, update_cov, cov_type)
    _close(new.mean.numpy(), want_mean)
    _close(new.cov.numpy(), want_cov)


@pytest.mark.parametrize("alpha,time_based,horizon", [(0, True, H), (1, False, H),
                                                      (0, True, 1)])
def test_mppiq_without_q_matches_jax_and_oracle(alpha, time_based, horizon):
    data = _inputs(3, h=horizon)
    cfg = dict(gamma=0.95, td_lam=0.8, beta=0.5, step_size=0.6, alpha=alpha,
               time_based_weights=time_based)
    jside, side = _pair(jsolvers.MPPIQ, solvers.MPPIQ, data, **cfg)
    assert not side[0].uses_observations
    new = _check_update_value_shift(jside, side, fields=("mean",))
    mean, cov, actions, costs, _ = data
    want = numpy_ref.mppiq_update(mean, cov, actions.astype(np.float64),
                                  costs.astype(np.float64), 0.95, 0.8, 0.5, 0.6, alpha,
                                  time_based)
    _close(new.mean.numpy(), want)


def _quadratic_q(seed):
    """The same quadratic Q(obs, a) = obs^2 . w_o + a^2 . w_a in both
    frameworks, weights from numpy."""
    rs = np.random.default_rng(seed)
    w_obs = rs.uniform(0.0, 0.1, D_OBS).astype(np.float32)
    w_act = rs.uniform(0.0, 0.2, DA).astype(np.float32)
    jw_obs, jw_act = jnp.asarray(w_obs), jnp.asarray(w_act)
    tw_obs, tw_act = torch.as_tensor(w_obs), torch.as_tensor(w_act)
    return ((lambda o, a: (o * o) @ jw_obs + (a * a) @ jw_act),
            (lambda o, a: (o * o) @ tw_obs + (a * a) @ tw_act))


def test_mppiq_with_q_matches_jax_and_oracle_returns():
    data = _inputs(4)
    jq, q = _quadratic_q(0)
    cfg = dict(gamma=0.95, td_lam=0.8, beta=0.5, step_size=0.6, alpha=0)
    (jsolver, jstate, jtraj), _ = _pair(jsolvers.MPPIQ, solvers.MPPIQ, data, **cfg)
    jside, side = _pair(lambda **c: jsolvers.MPPIQ(**c, q_fn=jq),
                        lambda **c: solvers.MPPIQ(**c, q_fn=q), data, **cfg)
    assert side[0].uses_observations
    _check_update_value_shift(jside, side, fields=("mean",))
    _, _, actions, costs, obs = data
    qvals = q(torch.as_tensor(obs), torch.as_tensor(actions)).numpy()
    want = numpy_ref.mppiq_returns(costs.astype(np.float64), qvals.astype(np.float64),
                                   0.95, 0.8, H)
    got = side[0].calculate_returns(torch.as_tensor(costs), torch.as_tensor(qvals))
    _close(got.numpy(), want)


def _pf_pair(data, **cfg):
    _, _, actions, costs, _ = data
    n, h, da = actions.shape
    cfg = dict(d_action=da, horizon=h, num_particles=n, lam=0.3, gamma=0.95, **cfg)
    return jsolvers.PFMPC(**cfg), solvers.PFMPC(**cfg, device=DEVICE)


def test_pfmpc_systematic_resample_matches_jax_and_oracle():
    _, _, actions, costs, _ = _inputs(5)
    jsolver, solver = _pf_pair(_inputs(5))
    w = np.array(jax.nn.softmax(-costs.sum(1) / 0.3))
    # r in (0, 1/M): at r = 0 the oracle's walk picks index -1 for m = 0
    for r in (0.004, 0.013, 0.049):
        got = solver.systematic_resample(torch.as_tensor(actions), torch.as_tensor(w),
                                         torch.tensor(r)).numpy()
        want = np.asarray(jsolver.systematic_resample(jnp.asarray(actions), jnp.asarray(w),
                                                      jnp.float32(r)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, numpy_ref.pf_systematic_resample(actions, w, r))


def test_pfmpc_update_act_and_shift():
    """update = JAX's weights and resampling with the port's own r (the
    streams differ); act is the particles' mean at t=0; shift rolls the
    particles, adds cov_shift noise and repeats the last step."""
    data = _inputs(6)
    _, _, actions, costs, _ = data
    jsolver, solver = _pf_pair(data, base_action="repeat")
    state = solvers.PFState(action_samples=torch.as_tensor(actions),
                            mean=torch.zeros(H, DA), step=rng.step_tensor(2, DEVICE), seed=9)
    traj = Trajectories(None, torch.as_tensor(actions), torch.as_tensor(costs),
                        None, None, None)
    new = solver.update(state, traj)
    r = ops.uniforms(rng.stream_key(9, 10), state.step, 1)[0] / N
    jw = jax.nn.softmax((-1.0 / 0.3) * np.asarray(
        numpy_ref.cost_to_go(costs.astype(np.float64), solver.gamma_seq))[:, 0])
    want = np.asarray(jsolver.systematic_resample(jnp.asarray(actions), jw, jnp.float32(r)))
    _close(new.action_samples.numpy(), want)
    _close(new.mean.numpy(), want.mean(0))
    _close(solver.act(new).numpy(), want.mean(0)[0])
    shifted = solver.shift(new)
    moved = shifted.action_samples - torch.roll(new.action_samples, -1, 1)
    assert float(moved[:, :-1].std()) == pytest.approx(0.1, rel=0.2)   # sqrt(cov_shift)
    torch.testing.assert_close(shifted.action_samples[:, -1], shifted.action_samples[:, -2],
                               rtol=0, atol=0)


def test_pfmpc_random_base_action_has_scale_sqrt_cov_resample():
    solver = solvers.PFMPC(d_action=2, horizon=3, num_particles=4096, cov_resample=0.5,
                           cov_shift=1e-8, base_action="random", device=DEVICE)
    last = solver.shift(solver.init_state(0)).action_samples[:, -1]
    assert float(last.std()) == pytest.approx(np.sqrt(0.5), rel=0.05)


@pytest.fixture(scope="module")
def env():
    return envs.make("reacher_7dof-v0", device=DEVICE)


def test_mppiq_with_q_fused_solve_matches_general(env):
    """MPPIQ with a plugged Q rides the obs rollout and agrees with the
    general rollout end to end (tests/test_pallas_cl.py's check)."""
    def q_fn(obs, acts):
        return 0.05 * torch.sum(obs ** 2, -1) + 0.1 * torch.sum(acts ** 2, -1)

    solver = solvers.MPPIQ(d_action=7, horizon=4, num_particles=16, beta=0.3, td_lam=0.9,
                           gamma=0.99, init_cov=0.4, step_size=0.8, alpha=1,
                           filter_coeffs=(0.25, 0.8, 0.0), base_action="null", q_fn=q_fn,
                           device=DEVICE)
    es = env.init(env.params, 1)
    a_f, _, sf = solvers.build_solve_fn(solver, env)(env.params, es, solver.init_state(0))
    a_g, _, sg = solvers.build_solve_fn(solver, env, fused=False)(
        env.params, es, solver.init_state(0))
    _close(a_f.numpy(), a_g.numpy())
    _close(sf.mean.numpy(), sg.mean.numpy())


def test_auto_gate_picks_the_rollout_each_solver_reads(env):
    calls = []
    obs_roll, roll = env.fused_obs_rollout, env.fused_rollout
    spy = dataclasses.replace(
        env, fused_rollout=lambda *a: calls.append("costs") or roll(*a),
        fused_obs_rollout=lambda *a: calls.append("obs") or obs_roll(*a))
    cfg = dict(d_action=7, horizon=3, num_particles=4, device=DEVICE)
    for solver, want in ((solvers.MPPIQ(**cfg, q_fn=lambda o, a: o.sum(-1)), "obs"),
                         (solvers.MPPIQ(**cfg), "costs"), (solvers.CEM(**cfg), "costs"),
                         (solvers.PFMPC(**cfg), "costs")):
        calls.clear()
        solvers.make_solve_fn(solver, spy)(spy.params, spy.init(spy.params, 0),
                                           solver.init_state(0))
        assert calls == [want], type(solver).__name__
    no_obs = dataclasses.replace(env, fused_obs_rollout=None)
    with pytest.raises(ValueError):
        solvers.build_solve_fn(solvers.MPPIQ(**cfg, q_fn=lambda o, a: o.sum(-1)), no_obs,
                               fused=True)


def _nan_costs(env, solver, s0):
    """A rollout that returns NaN costs (MPPI's weights and mean go NaN)."""
    return dataclasses.replace(env, fused_rollout=lambda p, s, mean, noise: torch.full(
        noise.shape[:2], float("nan"))), s0


def _nan_particles(env, solver, s0):
    """NaN particles (PFMPC resamples finite particles even from NaN
    weights, so its failure is a state that went bad)."""
    return env, dataclasses.replace(s0, action_samples=torch.full_like(
        s0.action_samples, float("nan")))


@pytest.mark.parametrize("make,poison", [
    (lambda: solvers.MPPI(d_action=7, horizon=4, num_particles=8, lam=0.5, device=DEVICE),
     _nan_costs),
    (lambda: solvers.PFMPC(d_action=7, horizon=4, num_particles=8, device=DEVICE),
     _nan_particles)])
def test_guard_finite_resets_a_solve_that_went_non_finite(env, make, poison):
    solver = make()
    es = env.init(env.params, 1)
    good_s0 = dataclasses.replace(solver.init_state(3), step=rng.step_tensor(4, DEVICE))
    bad_env, s0 = poison(env, solver, good_s0)
    bad = solvers.make_solve_fn(solver, bad_env)(env.params, es, s0)
    assert not bool(torch.isfinite(bad[0]).all())
    action, value, s = solvers.guard_finite(solvers.make_solve_fn(solver, bad_env), solver)(
        env.params, es, s0)
    assert float(value) == 0.0 and s.step == 5 and s.seed == s0.seed
    torch.testing.assert_close(action, torch.zeros(7), rtol=0, atol=0)
    fresh = solver.init_state(3)
    for f in dataclasses.fields(s):     # the reset state, but for the step checked above
        if f.name != "step" and isinstance(getattr(s, f.name), torch.Tensor):
            torch.testing.assert_close(getattr(s, f.name), getattr(fresh, f.name),
                                       rtol=0, atol=0)
    # a finite solve passes through unchanged
    solve = solvers.make_solve_fn(solver, env)
    want = solve(env.params, es, good_s0)
    got = solvers.guard_finite(solve, solver)(env.params, es, good_s0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert got[2].step == want[2].step == 5


def test_registry_dispatch_and_errors(env):
    cfg = dict(d_action=7, horizon=3, num_particles=4, device=DEVICE)
    assert isinstance(solvers.make_solver("cem", **cfg), solvers.CEM)
    assert solvers.make_solver("gaussian_dmd", **cfg) == solvers.make_solver("dmd", **cfg)
    assert sorted(solvers.REGISTRY) == sorted(["mppi", "mppiq", "random_shooting", "cem",
                                               "dmd", "gaussian_dmd", "pfmpc", "reinforce",
                                               "ilqr", "softqmpc", "softq",
                                               "random_shooting_nn"])
    assert solvers.NOT_PORTED == ()
    assert set(jsolvers.REGISTRY) == set(solvers.REGISTRY)
    sq = solvers.make_solver("softqmpc", d_obs=env.d_obs, **cfg)
    assert isinstance(sq, solvers.SoftQMPC) and solvers.REGISTRY["softq"] is solvers.SoftQMPC
    action, value, s = solvers.make_solve_fn(sq, env, calc_val=True, hotstart=True)(
        env.params, env.init(env.params, 0), sq.init_state(0))
    assert action.shape == (7,) and float(value) == 0.0 and s.step == 1
    rf = solvers.make_solver("reinforce", d_obs=env.d_obs, **cfg)
    assert isinstance(rf, solvers.Reinforce)
    action, value, s = solvers.make_solve_fn(rf, env, calc_val=True, hotstart=False)(
        env.params, env.init(env.params, 0), rf.init_state(0))
    assert action.shape == (7,) and float(value) == 0.0 and s.step == 1
    with pytest.raises(ValueError):
        solvers.make_solver("no_such_controller", **cfg)
    pf = solvers.make_solver("pfmpc", **cfg)
    action, value, s = solvers.make_solve_fn(pf, env, calc_val=True)(
        env.params, env.init(env.params, 0), pf.init_state(0))
    assert action.shape == (7,) and float(value) == 0.0 and s.step == 1
    with pytest.raises(NotImplementedError):
        solvers.make_solve_fn(object(), env)


def test_jax_config_fields_are_accepted():
    cfg = dict(d_action=3, horizon=4, num_particles=8, cov_type="full", noise_impl="kernel",
               action_lows=np.full(3, -1.0), action_highs=np.full(3, 1.0), device=DEVICE)
    for cls in (solvers.MPPI, solvers.CEM, solvers.DMDMPC, solvers.RandomShooting,
                solvers.MPPIQ):
        solver = cls(**cfg)
        assert (solver.cov_type, solver.noise_impl) == ("full", "kernel")
    assert solvers.MPPI(d_action=3, horizon=4, num_particles=8).cov_type == "diagonal"


def test_entry_points_default_to_the_card():
    assert solvers.MPPI(d_action=3, horizon=4, num_particles=8).device == "cuda"
    if torch.cuda.is_available():
        assert envs.make("reacher_7dof-v0").device.type == "cuda"
    else:   # no quiet fall-back to the CPU: torch's own error
        with pytest.raises((AssertionError, RuntimeError)):
            envs.make("reacher_7dof-v0")


@pytest.mark.parametrize("controller", ["mppi", "cem", "pfmpc"])
def test_mpc_policy(env, controller):
    policy = policies.MPCPolicy(controller, env, dict(horizon=4, num_particles=8), seed=1)
    es = env.init(env.params, 0)
    action, value = policy.get_action(es)
    assert isinstance(action, np.ndarray) and action.shape == (7,)
    assert np.isfinite(action).all() and isinstance(value, float)
    assert policy.get_action_seq(es, 2).shape == (2, 7)
    policy.reset(1)
    np.testing.assert_array_equal(policy.get_action(es)[0], action)


def test_random_policy(env):
    policy = policies.RandomPolicy(env, seed=3)
    a = policy.get_action()
    seq = policy.get_action_seq(horizon=5)
    assert a.shape == (7,) and seq.shape == (5, 7)
    assert (np.abs(seq) <= 1.0).all() and (np.abs(a) <= 1.0).all()
    policy.reset(3)
    np.testing.assert_array_equal(policy.get_action(), a)
