"""pen-v0 in the port (envs/pen.py on the engine's free joint, kernel #6's
plain version as its fused rollout) and the hand-suite path through the
config runner, against the JAX package: the model and the initial state,
one env step with its observation, reward and success from injected
desired axes, the fused solve against the port's general solve, the
config translation of every controller of configs/hand/pen-v0.yml and of
configs/sawyer/sawyer_peg_insertion-v0.yml, run_mpc on pen at a cut size,
and _fused_mode's dynamic fields.

Tolerances: the env step (qpos, qvel, obs, reward) atol 1e-4 (five
substeps of penalty contact with kp = 800 in two AD systems; f32
reordering stays far below it); the fused against the general solve atol
1e-4, the JAX package's own bar (tests/test_pallas_forest.py); the config
translation is exact.
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
from mjmpc_tpu_torch.envs import pen
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import episode, run_mpc
from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
STEP_ATOL = 1e-4
PEN_CONTROLLERS = ("mppi", "mppiq", "pfmpc", "random_shooting", "cem", "dmd")


@pytest.fixture(scope="module")
def jax_steps():
    """JAX pen states (the hand perturbed; the desired axis injected: one
    far from the pen's axis, one along it, so that the staged bonuses
    and success show) and one jitted env.step from each."""
    jenv = jenvs.make("pen-v0")
    rs = np.random.default_rng(0)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    js = js._replace(qpos=js.qpos.at[:24].add(jnp.asarray(rs.uniform(-0.2, 0.2, 24),
                                                          jnp.float32)))
    action = np.asarray(rs.uniform(-1.2, 1.2, 24), np.float32)   # clipped inside
    step = jax.jit(jenv.step)
    out = []
    for desired in (np.array([0.0, 0.6, -0.8], np.float32), np.array([1.0, 0.0, 0.0],
                                                                       np.float32)):
        s = js._replace(desired=jnp.asarray(desired))
        out.append((s, step(jenv.params, s, jnp.asarray(action))))
    return jenv, action, out


def test_model_and_init_match_jax():
    jenv = jenvs.make("pen-v0")
    env = envs.make("pen-v0", device=DEVICE)
    model, jmodel = env.params.model, jenv.params.model
    for name in convert._MODEL_TENSORS:
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(jmodel, name)), err_msg=name)
    assert model.parent == tuple(jmodel.parent) and model.joint_types == jmodel.joint_types
    assert (model.nq, model.nv, env.d_obs, env.d_action) == (31, 30, 69, 24)
    converted = convert.pen_params_from_reference(jenv.params, device=DEVICE)
    for f in ("kp", "kd", "mu", "pen_r"):
        assert float(getattr(converted, f)) == float(getattr(env.params, f))
    js = jenv.init(jenv.params, jax.random.PRNGKey(3))
    s = env.init(env.params, 3)
    np.testing.assert_array_equal(s.qpos.numpy(), np.asarray(js.qpos))   # rest on the cradle
    np.testing.assert_array_equal(s.qvel.numpy(), np.asarray(js.qvel))
    d = s.desired.numpy()
    assert abs(np.linalg.norm(d) - 1.0) < 1e-6
    pitch, yaw = -np.arcsin(d[2]), np.arctan2(d[1], d[0])
    assert abs(pitch) <= 1.0 + 1e-6 and abs(yaw) <= 1.0 + 1e-6   # the +-1 rad envelope
    assert not torch.equal(env.init(env.params, 4).desired, s.desired)


@pytest.mark.parametrize("case", [0, 1])
def test_step_observe_success_match_jax(jax_steps, case):
    jenv, action, out = jax_steps
    js, (jn, jobs, jrew, _) = out[case]
    env = envs.make("pen-v0", device=DEVICE)
    state = convert.pen_state_from_reference(js, device=DEVICE)
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
    # the desired axis along the pen earns both bonuses; the other none
    assert (float(rew) > 50.0) == (case == 1) and success == (case == 1)


# The JAX package's fused-against-general pen solve (tests/test_pallas_forest.py).
SOLVE_CFG = dict(d_action=24, horizon=4, num_particles=16, lam=0.2, init_cov=0.3,
                 step_size=1.0, gamma=1.0, alpha=1, base_action="null",
                 filter_coeffs=(0.25, 0.8, 0.0))


def test_fused_solve_matches_general_solve():
    """build_solve_fn's fused path (kernel #6's plain version) against the
    general rollout (the AD engine through env.step), the same noise, from
    the pinch (every fingertip pressing on the pen), where the rollouts'
    costs follow the hand through contact."""
    env = envs.make("pen-v0", device=DEVICE)
    solver = solvers.MPPI(**SOLVE_CFG, device=DEVICE)
    s0, es = solver.init_state(0), env.init(env.params, 1)
    es = dataclasses.replace(es, qpos=pen.pinch_qpos(es.qpos))
    before = ForestRollout.launches
    a_f, _, s_f = solvers.make_solve_fn(solver, env, fused=True)(env.params, es, s0)
    a_g, _, s_g = solvers.make_solve_fn(solver, env, fused=False)(env.params, es, s0)
    assert ForestRollout.launches == before
    torch.testing.assert_close(a_f, a_g, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_f.mean, s_g.mean, rtol=0, atol=1e-4)


CONFIGS = [("configs/hand/pen-v0.yml", c) for c in PEN_CONTROLLERS] + [
    ("configs/sawyer/sawyer_peg_insertion-v0.yml", "mppi")]


@pytest.mark.parametrize("path,controller", CONFIGS)
def test_solver_params_match_jax(path, controller):
    """The same solver kwargs as the JAX translation (plus the env's
    device), and a solver that builds from them at the config's size."""
    exp = cfg.load_config(path)
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


def test_run_mpc_runs_every_pen_controller_and_the_peg(tmp_path):
    """run_mpc on pen-v0 with every controller block, and on the sawyer peg,
    each cut to horizon 3, 1 particle per cpu, one episode of 2 steps."""
    paths = {}
    for src in ("configs/hand/pen-v0.yml", "configs/sawyer/sawyer_peg_insertion-v0.yml"):
        exp = cfg.load_config(src)
        exp.update(n_episodes=1, max_ep_length=2)
        for section in exp.values():
            if isinstance(section, dict) and "horizon" in section:
                section.update(horizon=3, particles_per_cpu=1)
        paths[src] = tmp_path / src.rsplit("/", 1)[1]
        paths[src].write_text(yaml.safe_dump(exp))
    results = run_mpc.main(["--config", str(paths["configs/hand/pen-v0.yml"]), "--controller",
                            ",".join(PEN_CONTROLLERS), "--device", DEVICE,
                            "--save_dir", str(tmp_path)])
    results_peg = run_mpc.main(["--config", str(paths["configs/sawyer/sawyer_peg_insertion-v0.yml"]),
                                "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert tuple(results) == PEN_CONTROLLERS and tuple(results_peg) == ("mppi",)
    for out in (*results.values(), *results_peg.values()):
        assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()


def test_fused_mode_keeps_the_kernel_for_dynamic_fields():
    """pen's kernel reads kp, kd, mu and the pen radius at call time:
    params that differ only there keep the fused path; a changed model
    takes the general rollout; the peg's kernel declares no dynamic
    fields."""
    env = envs.make("pen-v0", device=DEVICE)
    assert env.fused_rollout.dynamic_fields == ("kp", "kd", "mu", "pen_r")
    assert episode._fused_mode(env, env.params) == "auto"
    stiffer = dataclasses.replace(env.params, kp=2.0 * env.params.kp, pen_r=env.params.pen_r + 1e-3)
    assert episode._fused_mode(env, stiffer) == "auto"
    heavier = dataclasses.replace(env.params, model=dataclasses.replace(
        env.params.model, mass=1.1 * env.params.model.mass))
    assert episode._fused_mode(env, heavier) is False
    assert episode._fused_mode(env, dataclasses.replace(heavier, kp=stiffer.kp)) is False
    peg = envs.make("sawyer_peg_insertion-v0", device=DEVICE)
    other = dataclasses.replace(peg.params, hole_depth=2.0 * peg.params.hole_depth)
    assert episode._fused_mode(peg, other) is False
    # the fused rollout does read the changed gains at call time
    state = env.init(env.params, 0)
    mean, noise = torch.zeros(2, 24), 0.3 * torch.ones(2, 2, 24)
    state = dataclasses.replace(state, qpos=state.qpos.clone())
    state.qpos[pen.PEN_Q + 2] -= 0.01            # the pen pressed into the cradle
    base = env.fused_rollout(env.params, state, mean, noise)
    assert not torch.equal(base, env.fused_rollout(stiffer, state, mean, noise))
