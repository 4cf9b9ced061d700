"""hammer-v0 in the port (envs/hammer.py on the engine's free joint and a
nail slide, kernel #6's plain version with the hammer task as its fused
rollout) against the JAX package: the model and the initial layout, one
env step with its observation, reward and success from injected states,
the fused solve against the port's general solve from a strike and the
fused rollout against the general one with the hammer spinning (the
coupled 6x6 free-body solve), the generated header, the config
translation of every controller of configs/hand/hammer-v0.yml, run_mpc at
a cut size, _fused_mode's dynamic fields and the auto gate's pick of
kernel #6. No test runs the JAX forest kernel (an interpret-mode Pallas
compile of minutes): the JAX env step is the reference. The hammer task's
CUDA source is built for the host in tests/test_torch_forest.py (and once
more with the decoupled branch, which must fail).

Tolerances: the env step (qpos, qvel, obs, reward) atol 1e-4 (five
substeps of penalty contact with kp = 800 in two AD systems; f32
reordering stays far below it); the fused against the general solve and
rollout atol 1e-4, the JAX package's own bar (tests/test_pallas_forest.py);
the model and the config translation exact.
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
from mjmpc_tpu_torch.envs import adroit, hammer
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import episode, run_mpc
from mjmpc_tpu_torch.ops import forest_rollout as fr
from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout
from mjmpc_tpu_torch.solvers.base import open_loop_rollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
STEP_ATOL = 1e-4
CONFIG = "configs/hand/hammer-v0.yml"
CONTROLLERS = ("mppi", "pfmpc", "random_shooting", "cem", "dmd")
# (name, nail qpos or None, a strike in progress): the JAX start; the held
# hammer striking the nail (the strike and the nail's dry friction act);
# the nail past half its travel (+25); past 95% (+25 +75, success)
CASES = (("rest", None, False), ("strike", 0.0, True), ("half", -0.03, False),
         ("full", -0.049, False))


def _case_state(js, nail, strike, rs):
    """A JAX HammerState: the hand's joints perturbed by U(-0.1, 0.1); with a
    nail qpos, the held hammer (envs/hammer.py held_qpos) and the nail
    there, moving down with the hand at 0.3 m/s for a strike."""
    q = torch.as_tensor(np.array(js.qpos))
    qd = torch.as_tensor(np.array(js.qvel))
    if nail is not None:
        q = hammer.held_qpos(q)
        q[hammer.NAIL_Q] = nail
    if strike:
        qd = hammer.strike_qvel(qd)
    q[hammer.N_ARM:hammer.N_ACT] += torch.as_tensor(rs.uniform(-0.1, 0.1, 24),
                                                    dtype=torch.float32)
    return js._replace(qpos=jnp.asarray(q.numpy()), qvel=jnp.asarray(qd.numpy()))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX env, the injected states of CASES, one action and one jitted
    env.step from each state."""
    jenv = jenvs.make("hammer-v0")
    rs = np.random.default_rng(0)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    action = np.asarray(rs.uniform(-1.2, 1.2, 27), np.float32)   # clipped inside
    step = jax.jit(jenv.step)
    out = {}
    for name, nail, strike in CASES:
        s = _case_state(js, nail, strike, rs)
        out[name] = (s, step(jenv.params, s, jnp.asarray(action)))
    return jenv, action, out


def test_model_and_init_match_jax():
    jenv = jenvs.make("hammer-v0")
    env = envs.make("hammer-v0", device=DEVICE)
    model, jmodel = env.params.model, jenv.params.model
    for name in convert._MODEL_TENSORS:
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(jmodel, name)), err_msg=name)
    assert model.parent == tuple(jmodel.parent) and model.joint_types == jmodel.joint_types
    assert (model.nq, model.nv, env.d_obs, env.d_action) == (35, 34, 73, 27)
    np.testing.assert_array_equal(model.neutral_qpos().numpy(),
                                  np.asarray(jmodel.neutral_qpos()))
    # the head puts the hammer's com off its joint origin, along the handle
    com = model.com[hammer.HAMMER_BODY].numpy()
    assert com[0] > 0.02 and com[1] == 0.0 and com[2] == 0.0
    converted = convert.hammer_params_from_reference(jenv.params, device=DEVICE)
    for f in ("kp", "kd", "mu"):
        assert float(getattr(converted, f)) == float(getattr(env.params, f))
    js = jenv.init(jenv.params, jax.random.PRNGKey(3))
    s = env.init(env.params, 3)
    hy = hammer.HAMMER_Q + 1
    # everything but the hammer's drawn y is the JAX layout: the hand
    # raised, the hammer flat on the table, the nail up, at rest
    keep = np.r_[0:hy, hy + 1:35]
    np.testing.assert_array_equal(s.qpos.numpy()[keep], np.asarray(js.qpos)[keep])
    np.testing.assert_array_equal(s.qvel.numpy(), np.asarray(js.qvel))
    assert abs(float(s.qpos[hy])) <= 0.06
    assert float(env.init(env.params, 4).qpos[hy]) != float(s.qpos[hy])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_step_observe_success_match_jax(jax_steps, case):
    jenv, action, out = jax_steps
    js, (jn, jobs, jrew, _) = out[case]
    env = envs.make("hammer-v0", device=DEVICE)
    state = convert.hammer_state_from_reference(js, device=DEVICE)
    ns, obs, rew, done = env.step(env.params, state, torch.as_tensor(action))
    for got, want, name in ((ns.qpos, jn.qpos, "qpos"), (ns.qvel, jn.qvel, "qvel"),
                            (obs, jobs, "obs")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(env.observe(env.params, state).numpy(),
                               np.asarray(jenv.observe(jenv.params, js)), rtol=0, atol=1e-6)
    success = bool(env.success(env.params, ns))
    assert success == bool(jenv.success(jenv.params, jn)) == (case == "full")
    assert ns.timestep == 1 and not bool(done) and obs.shape == (73,)
    # the cases reach the gates they are named for; the strike drives the
    # nail against its dry friction
    assert {"rest": float(rew) < 1.0, "strike": float(rew) < 1.0,
            "half": 25.0 < float(rew) < 28.0, "full": float(rew) > 100.0}[case], float(rew)
    if case == "strike":
        assert float(ns.qvel[hammer.NAIL_V]) < -0.01 and float(ns.qpos[hammer.NAIL_Q]) < 0.0


# The JAX package's fused-against-general solve (tests/test_pallas_forest.py).
SOLVE_CFG = dict(d_action=27, horizon=4, num_particles=16, lam=0.2, init_cov=0.3,
                 step_size=1.0, gamma=1.0, alpha=1, base_action="null",
                 filter_coeffs=(0.25, 0.8, 0.0))


def _strike_state(env, seed):
    st = env.init(env.params, seed)
    return dataclasses.replace(st, qpos=hammer.held_qpos(st.qpos),
                               qvel=hammer.strike_qvel(st.qvel))


def test_fused_solve_matches_general_solve():
    """build_solve_fn's fused path (kernel #6's plain version) against the
    general rollout (the AD engine through env.step), the same noise, from
    a strike: the hand's actions reach the hammer, the nail and the cost
    through contact."""
    env = envs.make("hammer-v0", device=DEVICE)
    solver = solvers.MPPI(**SOLVE_CFG, device=DEVICE)
    s0, es = solver.init_state(0), _strike_state(env, 1)
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


def test_fused_rollout_matches_general_rollout_while_the_hammer_spins():
    """The fused rollout's plain version against the general rollout with
    the hammer spinning in the air (envs/hammer.py spin_state): its offset
    com couples the free body's linear and angular equations, which the
    plain version solves as the kernel does (the coupled 6x6 branch) and
    the engine by its full mass matrix."""
    env = envs.make("hammer-v0", device=DEVICE)
    rs = np.random.default_rng(2)
    st = env.init(env.params, 2)
    q0, qd0 = hammer.spin_state(st.qpos, st.qvel)
    st = dataclasses.replace(st, qpos=q0, qvel=qd0)
    mean = torch.as_tensor(np.asarray(rs.normal(size=(2, 27)) * 0.2, np.float32))
    noise = torch.as_tensor(np.asarray(rs.normal(size=(3, 2, 27)) * 0.3, np.float32))
    got = env.fused_rollout(env.params, st, mean, noise)
    want = open_loop_rollout(env, False, False)(env.params, st, mean, noise).costs
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    c = fr.forest_consts(env.params.model)
    assert c["free"] == [hammer.HAMMER_BODY] and c["free_consts"][hammer.HAMMER_BODY]["coupled"]


def test_header_bakes_the_hammer_task():
    env = envs.make("hammer-v0", device=DEVICE)
    roll = hammer.build_rollout(env.params.model)
    weight = adroit.arm_hand_weight(env.params.model)
    assert roll.team == 32 and roll.task.joint_torque is not None
    for text in ("#define FOREST_TASK 4", "constexpr int NB = 29;", "constexpr int NQ = 35;",
                 "constexpr int NV = 34;", "constexpr int D_ACT = 27;",
                 "constexpr int N_POINTS = 15;", "constexpr int N_SUBSTEPS = 5;",
                 "constexpr int N_EXTRAS = 3;", "constexpr int HAMMER_BODY = 27;",
                 "constexpr int NAIL_BODY = 28;", "constexpr bool HAS_FREE = true;",
                 "constexpr bool HAS_SLIDE = true;",
                 "constexpr bool HAS_COUPLED = true;",
                 f"constexpr float HAND_WEIGHT = {fr._f(weight)};"):
        assert text in roll.header, text
    coupled = [ln for ln in roll.header.splitlines() if ln.startswith("constexpr int h_coupled")]
    assert coupled == ["constexpr int h_coupled[29] = {" + ", ".join(
        "1" if b == hammer.HAMMER_BODY else "0" for b in range(29)) + "};"]
    # the hook: the hand's weight on the z slide, the nail's friction
    # against its velocity
    qd = torch.zeros(2, 34)
    qd[:, hammer.NAIL_V] = torch.tensor([0.1, -0.1])
    torque = roll.task.joint_torque(None, qd, None, None)
    assert set(torque) == {2, hammer.NAIL_BODY}
    assert torque[2] == float(weight)
    np.testing.assert_allclose(torque[hammer.NAIL_BODY].numpy(), [-9.9991, 9.9991], atol=1e-4)


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


def test_run_mpc_runs_the_hammer_config(tmp_path):
    """run_mpc on hammer-v0 with its mppi block (every block builds in
    test_solver_params_match_jax; relocate's test runs a particle
    controller too), cut to horizon 3, 1 particle per cpu, one episode of
    2 steps."""
    exp = cfg.load_config(CONFIG)
    exp.update(n_episodes=1, max_ep_length=2)
    for section in exp.values():
        if isinstance(section, dict) and "horizon" in section:
            section.update(horizon=3, particles_per_cpu=1)
    path = tmp_path / "hammer.yml"
    path.write_text(yaml.safe_dump(exp))
    results = run_mpc.main(["--config", str(path), "--controller", "mppi",
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert tuple(results) == ("mppi",)
    for out in results.values():
        assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()


def test_fused_mode_keeps_the_kernel_for_dynamic_fields():
    """hammer's kernel reads kp, kd and mu at call time: params that differ
    only there keep the fused path, and the rollout reads the changed
    gains; a changed model takes the general rollout."""
    env = envs.make("hammer-v0", device=DEVICE)
    assert env.fused_rollout.dynamic_fields == ("kp", "kd", "mu")
    assert episode._fused_mode(env, env.params) == "auto"
    stiffer = dataclasses.replace(env.params, kp=2.0 * env.params.kp, mu=0.5 * env.params.mu)
    assert episode._fused_mode(env, stiffer) == "auto"
    heavier = dataclasses.replace(env.params, model=dataclasses.replace(
        env.params.model, mass=1.1 * env.params.model.mass))
    assert episode._fused_mode(env, heavier) is False
    state = _strike_state(env, 0)
    mean, noise = torch.zeros(2, 27), 0.3 * torch.ones(2, 2, 27)
    base = env.fused_rollout(env.params, state, mean, noise)
    assert not torch.equal(base, env.fused_rollout(stiffer, state, mean, noise))


def test_make_builds_on_the_card_by_default_and_picks_the_kernel(monkeypatch):
    """envs.make defaults to the card, and make_solve_fn's auto gate takes
    the fused rollout, kernel #6 with the hammer task (on the CPU its plain
    version, which the spy sees once per solve)."""
    import inspect
    assert inspect.signature(hammer.make).parameters["device"].default == "cuda"
    assert "hammer-v0" not in envs.NOT_PORTED and "hammer-v0" in envs.available()
    calls = []
    plain = fr.rollout_forest_plain

    def spy(model, n_substeps, act_bodies, task, *args, **kwargs):
        calls.append(task.name)
        return plain(model, n_substeps, act_bodies, task, *args, **kwargs)

    monkeypatch.setattr(fr, "rollout_forest_plain", spy)
    env = envs.make("hammer-v0", device=DEVICE)
    solver = solvers.MPPI(**dict(SOLVE_CFG, num_particles=4, horizon=2), device=DEVICE)
    action, _, _ = solvers.make_solve_fn(solver, env)(env.params, env.init(env.params, 0),
                                                      solver.init_state(0))
    assert calls == ["hammer"] and action.shape == (27,)
