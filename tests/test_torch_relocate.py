"""relocate-v0 in the port (envs/relocate.py on the engine's free joint,
kernel #6's plain version with the relocate task as its fused rollout)
against the JAX package: the model and the initial layout, one env step
with its observation, reward and success from injected states, the fused
solve against the port's general solve, the generated header, the config
translation of every controller of configs/hand/relocate-v0.yml, run_mpc
at a cut size, _fused_mode's dynamic fields and the auto gate's pick of
kernel #6. No test runs the JAX forest kernel (an interpret-mode Pallas
compile of minutes): the JAX env step is the reference. The relocate
task's CUDA source is built for the host in tests/test_torch_forest.py.

Tolerances: the env step (qpos, qvel, obs, reward) atol 1e-4 (five
substeps of penalty contact with kp = 800 in two AD systems; f32
reordering stays far below it); the fused against the general solve atol
1e-4, the JAX package's own bar (tests/test_pallas_forest.py); the model
and the config translation exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.harness import config as jcfg
from mjmpc_tpu_torch import convert, envs, solvers
from mjmpc_tpu_torch.envs import adroit, relocate
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import episode, run_mpc
from mjmpc_tpu_torch.ops import forest_rollout as fr
from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
STEP_ATOL = 1e-4
CONFIG = "configs/hand/relocate-v0.yml"
CONTROLLERS = ("mppi", "random_shooting", "cem", "dmd", "pfmpc")
# (name, target offset from the ball or None): at rest on the table with the
# target far; lifted in the grasp with the target 3 cm away (both bonuses,
# success); lifted with the target 7 cm away (the 0.10 bonus only, success)
CASES = (("rest", None), ("near", (0.0, 0.03, 0.0)), ("mid", (0.04, -0.04, 0.04)))


def _case_state(js, offset, rs):
    """A JAX RelocateState: the hand's joints perturbed by U(-0.1, 0.1); with
    an offset, the grasp (envs/relocate.py grasp_qpos) around the lifted
    ball and the target at `offset` from the ball."""
    q = torch.as_tensor(np.array(js.qpos))
    if offset is not None:
        q = relocate.grasp_qpos(q)
    q[relocate.N_ARM:relocate.N_ACT] += torch.as_tensor(rs.uniform(-0.1, 0.1, 24),
                                                        dtype=torch.float32)
    target = js.target
    if offset is not None:
        target = jnp.asarray(q[relocate.BALL_Q:relocate.BALL_Q + 3].numpy()
                             + np.asarray(offset, np.float32))
    return js._replace(qpos=jnp.asarray(q.numpy()), target=target)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX env, the injected states of CASES, one action and one jitted
    env.step from each state."""
    jenv = jenvs.make("relocate-v0")
    rs = np.random.default_rng(0)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    action = np.asarray(rs.uniform(-1.2, 1.2, 27), np.float32)   # clipped inside
    step = jax.jit(jenv.step)
    out = {}
    for name, offset in CASES:
        s = _case_state(js, offset, rs)
        out[name] = (s, step(jenv.params, s, jnp.asarray(action)))
    return jenv, action, out


def test_model_and_init_match_jax():
    jenv = jenvs.make("relocate-v0")
    env = envs.make("relocate-v0", device=DEVICE)
    model, jmodel = env.params.model, jenv.params.model
    for name in convert._MODEL_TENSORS:
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(jmodel, name)), err_msg=name)
    assert model.parent == tuple(jmodel.parent) and model.joint_types == jmodel.joint_types
    assert (model.nq, model.nv, env.d_obs, env.d_action) == (34, 33, 69, 27)
    np.testing.assert_array_equal(model.neutral_qpos().numpy(),
                                  np.asarray(jmodel.neutral_qpos()))
    converted = convert.relocate_params_from_reference(jenv.params, device=DEVICE)
    for f in ("kp", "kd", "mu", "ball_r"):
        assert float(getattr(converted, f)) == float(getattr(env.params, f))
    js = jenv.init(jenv.params, jax.random.PRNGKey(3))
    s = env.init(env.params, 3)
    bq = relocate.BALL_Q
    # everything but the ball's drawn xy is the JAX layout: the hand raised,
    # the ball on the table, at rest
    keep = np.r_[0:bq, bq + 2:34]
    np.testing.assert_array_equal(s.qpos.numpy()[keep], np.asarray(js.qpos)[keep])
    np.testing.assert_array_equal(s.qvel.numpy(), np.asarray(js.qvel))
    assert np.abs(s.qpos[bq:bq + 2].numpy()).max() <= 0.10
    lo, hi = np.array([-0.15, -0.15, 0.18]), np.array([0.15, 0.15, 0.32])
    assert (s.target.numpy() >= lo).all() and (s.target.numpy() <= hi).all()
    other = env.init(env.params, 4)
    assert not torch.equal(other.target, s.target)
    assert not torch.equal(other.qpos[bq:bq + 2], s.qpos[bq:bq + 2])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_step_observe_success_match_jax(jax_steps, case):
    jenv, action, out = jax_steps
    js, (jn, jobs, jrew, _) = out[case]
    env = envs.make("relocate-v0", device=DEVICE)
    state = convert.relocate_state_from_reference(js, device=DEVICE)
    ns, obs, rew, done = env.step(env.params, state, torch.as_tensor(action))
    for got, want, name in ((ns.qpos, jn.qpos, "qpos"), (ns.qvel, jn.qvel, "qvel"),
                            (obs, jobs, "obs")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(env.observe(env.params, state).numpy(),
                               np.asarray(jenv.observe(jenv.params, js)), rtol=0, atol=1e-6)
    success = bool(env.success(env.params, ns))
    assert success == bool(jenv.success(jenv.params, jn))
    assert ns.timestep == 1 and not bool(done) and obs.shape == (69,)
    # the cases reach the gates they are named for: the lift and both
    # bonuses, the lift and the 0.10 bonus, none
    lifted = float(ns.qpos[relocate.BALL_Q + 2]) > relocate.LIFT_Z
    assert lifted == (case != "rest") and success == (case != "rest")
    assert {"rest": float(rew) < 1.0, "near": float(rew) > 29.0,
            "mid": 9.0 < float(rew) < 12.0}[case], float(rew)


# The JAX package's fused-against-general solve (tests/test_pallas_forest.py).
SOLVE_CFG = dict(d_action=27, horizon=4, num_particles=16, lam=0.2, init_cov=0.3,
                 step_size=1.0, gamma=1.0, alpha=1, base_action="null",
                 filter_coeffs=(0.25, 0.8, 0.0))


def test_fused_solve_matches_general_solve():
    """build_solve_fn's fused path (kernel #6's plain version) against the
    general rollout (the AD engine through env.step), the same noise, from
    the grasp around the lifted ball, where the rollouts' costs follow the
    hand through contact."""
    env = envs.make("relocate-v0", device=DEVICE)
    solver = solvers.MPPI(**SOLVE_CFG, device=DEVICE)
    s0, es = solver.init_state(0), env.init(env.params, 1)
    es = dataclasses.replace(es, qpos=relocate.grasp_qpos(es.qpos))
    before = ForestRollout.launches
    a_f, _, s_f = solvers.make_solve_fn(solver, env, fused=True)(env.params, es, s0)
    a_g, _, s_g = solvers.make_solve_fn(solver, env, fused=False)(env.params, es, s0)
    assert ForestRollout.launches == before
    torch.testing.assert_close(a_f, a_g, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_f.mean, s_g.mean, rtol=0, atol=1e-4)
    # the solve's rollouts reach the cost through contact: their costs
    # spread over the particles far beyond the tolerance
    costs = env.fused_rollout(env.params, es, s0.mean, solver.sample_noise(s0))
    assert float(costs.max() - costs.min()) > 1e-3


def test_header_bakes_the_relocate_task():
    env = envs.make("relocate-v0", device=DEVICE)
    roll = relocate.build_rollout(env.params.model)
    assert roll.team == 32 and roll.task.joint_torque is not None
    for text in ("#define FOREST_TASK 3", "constexpr int NB = 28;", "constexpr int NQ = 34;",
                 "constexpr int NV = 33;", "constexpr int D_ACT = 27;",
                 "constexpr int N_POINTS = 12;", "constexpr int N_SUBSTEPS = 5;",
                 "constexpr int N_EXTRAS = 7;", "constexpr int BALL_BODY = 27;",
                 "constexpr bool HAS_FREE = true;", "constexpr bool HAS_SLIDE = true;",
                 "constexpr bool HAS_COUPLED = false;"):
        assert text in roll.header, text
    weight = adroit.arm_hand_weight(env.params.model)
    assert f"constexpr float HAND_WEIGHT = {fr._f(weight)};" in roll.header
    assert roll.task.joint_torque(None, None, None, None) == {2: float(weight)}
    # the weight is the arm's and the hand's, under gravity
    mass = float(env.params.model.mass[:relocate.BALL_BODY].sum())
    assert float(weight) == pytest.approx(9.81 * mass, rel=1e-6) and float(weight) > 1.0


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_solver_params_match_jax(controller):
    """The same solver kwargs as the JAX translation (plus the env's
    device), and a solver that builds from them at the config's size."""
    exp = cfg.load_config(CONFIG)
    env = envs.make(exp["env_name"], device=DEVICE)
    got = cfg.solver_params_from_config(exp, controller, env)
    want = jcfg.solver_params_from_config(exp, controller, jenvs.make(exp["env_name"]))
    assert got.pop("device") == env.device
    assert set(got) == set(want)
    for k, v in want.items():
        got_k = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(np.asarray(got_k), np.asarray(v), err_msg=k)
    solver = cfg.make_solver_for_env(exp, controller, env)
    section = exp[controller]
    assert solver.num_particles == section["num_cpu"] * section["particles_per_cpu"]
    assert solver.horizon == section["horizon"]


def test_run_mpc_runs_relocate_controllers(tmp_path):
    """run_mpc on relocate-v0 with a Gaussian and the particle controller
    block (every block builds in test_solver_params_match_jax), each cut
    to horizon 3, 1 particle per cpu, one episode of 2 steps."""
    exp = cfg.load_config(CONFIG)
    exp.update(n_episodes=1, max_ep_length=2)
    for section in exp.values():
        if isinstance(section, dict) and "horizon" in section:
            section.update(horizon=3, particles_per_cpu=1)
    path = tmp_path / "relocate.yml"
    path.write_text(yaml.safe_dump(exp))
    results = run_mpc.main(["--config", str(path), "--controller", "mppi,pfmpc",
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert tuple(results) == ("mppi", "pfmpc")
    for out in results.values():
        assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()


def test_fused_mode_keeps_the_kernel_for_dynamic_fields():
    """relocate's kernel reads kp, kd, mu and the ball radius at call time:
    params that differ only there keep the fused path, and the rollout
    reads the changed gains; a changed model takes the general rollout."""
    env = envs.make("relocate-v0", device=DEVICE)
    assert env.fused_rollout.dynamic_fields == ("kp", "kd", "mu", "ball_r")
    assert episode._fused_mode(env, env.params) == "auto"
    stiffer = dataclasses.replace(env.params, kp=2.0 * env.params.kp,
                                  ball_r=env.params.ball_r + 1e-3)
    assert episode._fused_mode(env, stiffer) == "auto"
    heavier = dataclasses.replace(env.params, model=dataclasses.replace(
        env.params.model, mass=1.1 * env.params.model.mass))
    assert episode._fused_mode(env, heavier) is False
    state = env.init(env.params, 0)
    state = dataclasses.replace(state, qpos=relocate.grasp_qpos(state.qpos))
    mean, noise = torch.zeros(2, 27), 0.3 * torch.ones(2, 2, 27)
    base = env.fused_rollout(env.params, state, mean, noise)
    assert not torch.equal(base, env.fused_rollout(stiffer, state, mean, noise))


def test_make_builds_on_the_card_by_default_and_picks_the_kernel(monkeypatch):
    """envs.make defaults to the card, and make_solve_fn's auto gate takes
    the fused rollout, kernel #6 with the relocate task (on the CPU its
    plain version, which the spy sees once per solve)."""
    import inspect
    assert inspect.signature(envs.make).parameters["device"].default == "cuda"
    assert inspect.signature(relocate.make).parameters["device"].default == "cuda"
    assert "relocate-v0" not in envs.NOT_PORTED and "relocate-v0" in envs.available()
    calls = []
    plain = fr.rollout_forest_plain

    def spy(model, n_substeps, act_bodies, task, *args, **kwargs):
        calls.append(task.name)
        return plain(model, n_substeps, act_bodies, task, *args, **kwargs)

    monkeypatch.setattr(fr, "rollout_forest_plain", spy)
    env = envs.make("relocate-v0", device=DEVICE)
    solver = solvers.MPPI(**dict(SOLVE_CFG, num_particles=4, horizon=2), device=DEVICE)
    action, _, _ = solvers.make_solve_fn(solver, env)(env.params, env.init(env.params, 0),
                                                      solver.init_state(0))
    assert calls == ["relocate"] and action.shape == (27,)
