"""sawyer_pusher-v0 (and its alias pusher-v0) and sawyer_door-v0 in the port
(envs/sawyer_tasks.py, kernel #6's plain version with the pusher and the
sawyer door tasks as their fused rollouts) against the JAX package: the
models and the initial layouts, one env step with its observation, reward
and success from injected states, the fused rollout against the port's
general rollout, the fused solve against the general solve, the generated
headers, the config translation of every controller of
configs/sawyer/sawyer_pusher-v0.yml and sawyer_door-v0.yml, run_mpc at a cut
size and the auto gate's pick of kernel #6. No test runs the JAX forest
kernel: the JAX env step is the reference. The tasks' CUDA source is built
for the host in tests/test_torch_forest.py.

Tolerances: the env step (qpos, qvel, obs, reward) atol 1e-4 (two substeps
of a penalty or a spring force in two AD systems; they agree to 2e-6); the
fused against the general rollout and solve atol 1e-4, the JAX package's
own bar (tests/test_pallas_forest.py); the model and the config
translation exact.
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
from mjmpc_tpu_torch.envs import sawyer_tasks as st
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import run_mpc
from mjmpc_tpu_torch.ops import forest_rollout as fr
from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout
from mjmpc_tpu_torch.solvers.base import open_loop_rollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
STEP_ATOL = 1e-4
CONFIGS = {"sawyer_pusher-v0": "configs/sawyer/sawyer_pusher-v0.yml",
           "sawyer_door-v0": "configs/sawyer/sawyer_door-v0.yml"}
CONTROLLERS = [("sawyer_pusher-v0", "mppi"), ("sawyer_pusher-v0", "cem"),
               ("sawyer_door-v0", "mppi")]
# (env, case): the start with the arm perturbed; the block against the
# hand (the contact force acts); the door open 0.3 rad with the grab
# radius widened (the spring acts)
CASES = (("sawyer_pusher-v0", "start"), ("sawyer_pusher-v0", "contact"),
         ("sawyer_door-v0", "start"), ("sawyer_door-v0", "grab"))


def _case(env, jenv, case, rs):
    """(port params, port state, JAX params, JAX state) of a case; the arm's
    joints perturbed by U(-0.1, 0.1), the port's target (the pusher's) in
    the JAX state."""
    s = env.init(env.params, 0)
    q = s.qpos.clone()
    q[:7] += torch.as_tensor(rs.uniform(-0.1, 0.1, 7), dtype=torch.float32)
    params, jparams = env.params, jenv.params
    if case == "contact":
        q = st.pusher_contact_qpos(env.params.model, q)
    elif case == "grab":
        params, q = st.door_grab_state(env.params, q)
        jparams = jparams._replace(grab_radius=jnp.float32(float(params.grab_radius)))
    s = dataclasses.replace(s, qpos=q)
    js = jenv.init(jparams, jax.random.PRNGKey(0))._replace(qpos=jnp.asarray(q.numpy()))
    if hasattr(s, "target"):
        js = js._replace(target=jnp.asarray(s.target.numpy()))
    return params, s, jparams, js


@pytest.fixture(scope="module")
def jax_steps():
    """Each case's states and one jitted JAX env step from it."""
    rs = np.random.default_rng(0)
    action = np.asarray(rs.uniform(-1.2, 1.2, 7), np.float32)   # clipped inside
    out = {}
    for name, case in CASES:
        env, jenv = envs.make(name, device=DEVICE), jenvs.make(name)
        params, s, jparams, js = _case(env, jenv, case, rs)
        out[(name, case)] = (params, s, jparams, js, jax.jit(jenv.step)(jparams, js,
                                                                         jnp.asarray(action)))
    return action, out


@pytest.mark.parametrize("name", ["sawyer_pusher-v0", "pusher-v0", "sawyer_door-v0"])
def test_model_and_init_match_jax(name):
    jenv = jenvs.make(name)
    env = envs.make(name, device=DEVICE)
    model, jmodel = env.params.model, jenv.params.model
    for f in convert._MODEL_TENSORS:
        np.testing.assert_array_equal(getattr(model, f).numpy(),
                                      np.asarray(getattr(jmodel, f)), err_msg=f)
    assert model.parent == tuple(jmodel.parent) and model.joint_types == jmodel.joint_types
    assert (env.name, env.d_obs, env.d_action, env.max_episode_steps) == (
        jenv.name, jenv.d_obs, jenv.d_action, jenv.max_episode_steps)
    js, s = jenv.init(jenv.params, jax.random.PRNGKey(3)), env.init(env.params, 3)
    np.testing.assert_array_equal(s.qpos.numpy(), np.asarray(js.qpos))
    np.testing.assert_array_equal(s.qvel.numpy(), np.asarray(js.qvel))
    if env.name == "sawyer_pusher-v0":
        # the planar target is drawn from the JAX package's box
        target = s.target.numpy()
        assert ((target >= [-0.25, -0.35]) & (target <= [0.25, 0.15])).all()
        assert not np.array_equal(env.init(env.params, 4).target.numpy(), target)
        converted = convert.pusher_params_from_reference(jenv.params, device=DEVICE)
        assert float(converted.k_contact) == float(env.params.k_contact) == 500.0
        assert (model.nq, env.d_obs) == (9, 26)
    else:
        converted = convert.sawyer_door_params_from_reference(jenv.params, device=DEVICE)
        for f in ("k_grab", "grab_radius", "target_angle"):
            assert float(getattr(converted, f)) == float(getattr(env.params, f))
        assert (model.nq, env.d_obs) == (8, 20)


@pytest.mark.parametrize("name,case", CASES, ids=[f"{n}:{c}" for n, c in CASES])
def test_step_observe_success_match_jax(jax_steps, name, case):
    action, out = jax_steps
    params, s, jparams, js, (jn, jobs, jrew, _) = out[(name, case)]
    env, jenv = envs.make(name, device=DEVICE), jenvs.make(name)
    to_port = (convert.pusher_state_from_reference if name == "sawyer_pusher-v0"
               else convert.sawyer_door_state_from_reference)
    state = to_port(js, device=DEVICE)
    ns, obs, rew, done = env.step(params, state, torch.as_tensor(action))
    for got, want, what in ((ns.qpos, jn.qpos, "qpos"), (ns.qvel, jn.qvel, "qvel"),
                            (obs, jobs, "obs")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL,
                                   err_msg=what)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(env.observe(params, state).numpy(),
                               np.asarray(jenv.observe(jparams, js)), rtol=0, atol=1e-6)
    assert bool(env.success(params, ns)) == bool(jenv.success(jparams, jn))
    assert ns.timestep == 1 and not bool(done) and obs.shape == (env.d_obs,)
    if case == "contact":       # the hand pushes the block along x
        assert float(ns.qvel[7]) > 0.1
    if case == "grab":          # the spring pulls the door shut
        assert float(ns.qvel[st.DOOR_BODY]) < -1.0


def _rollout_case(name, case, seed, n=6, h=3):
    rs = np.random.default_rng(seed)
    env = envs.make(name, device=DEVICE)
    params, s, _, _ = _case(env, jenvs.make(name), case, rs)
    mean = torch.as_tensor(np.asarray(rs.normal(size=(h, 7)) * 0.2, np.float32))
    noise = torch.as_tensor(np.asarray(rs.normal(size=(n, h, 7)) * 0.3, np.float32))
    return env, params, s, mean, noise


@pytest.mark.parametrize("name,case", [("sawyer_pusher-v0", "contact"),
                                       ("sawyer_door-v0", "grab")])
def test_fused_rollout_matches_general_rollout(name, case):
    """The fused rollout's plain version (kernel #6's task) against the
    general rollout (the AD engine through env.step) from a state where
    the force law acts; zeroed actions move the costs far beyond the
    tolerance, so the check follows the arm."""
    env, params, s, mean, noise = _rollout_case(name, case, 1)
    got = env.fused_rollout(params, s, mean, noise)
    want = open_loop_rollout(env, False, False)(params, s, mean, noise).costs
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    zeroed = env.fused_rollout(params, s, torch.zeros_like(mean), torch.zeros_like(noise))
    assert float((zeroed - want).abs().max()) > 1e-3


# The JAX package's fused-against-general solve on the pusher
# (tests/test_pallas_sawyer.py test_fused_solve_matches_general_solve).
SOLVE_CFG = dict(d_action=7, horizon=3, num_particles=8, lam=0.2, init_cov=0.3, step_size=1.0,
                 gamma=1.0, alpha=1, base_action="null", filter_coeffs=(0.25, 0.8, 0.0))


@pytest.mark.parametrize("name,case", [("sawyer_pusher-v0", "contact"),
                                       ("sawyer_door-v0", "grab")])
def test_fused_solve_matches_general_solve(name, case):
    env, params, s, _, _ = _rollout_case(name, case, 2)
    solver = solvers.MPPI(**SOLVE_CFG, device=DEVICE)
    s0 = solver.init_state(0)
    before = ForestRollout.launches
    a_f, _, s_f = solvers.make_solve_fn(solver, env, fused=True)(params, s, s0)
    a_g, _, s_g = solvers.make_solve_fn(solver, env, fused=False)(params, s, s0)
    assert ForestRollout.launches == before
    torch.testing.assert_close(a_f, a_g, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_f.mean, s_g.mean, rtol=0, atol=1e-4)


def test_headers_bake_the_tasks():
    pusher = st.build_pusher_rollout(envs.make("sawyer_pusher-v0", device=DEVICE).params.model)
    door = st.build_door_rollout(envs.make("sawyer_door-v0", device=DEVICE).params.model)
    assert pusher.task.name == "pusher" and door.task.name == "sawyer_door"
    for text in ("#define FOREST_TASK 6", "constexpr int NB = 9;", "constexpr int NQ = 9;",
                 "constexpr int D_ACT = 7;", "constexpr int N_POINTS = 2;",
                 "constexpr int N_SUBSTEPS = 2;", "constexpr int N_EXTRAS = 3;",
                 "constexpr bool HAS_SLIDE = true;", "constexpr int BLOCK_BODY = 8;",
                 f"constexpr float CONTACT_R = {fr._f(0.13)};"):
        assert text in pusher.header, text
    for text in ("#define FOREST_TASK 5", "constexpr int NB = 8;", "constexpr int N_POINTS = 2;",
                 "constexpr bool HAS_SLIDE = false;", "constexpr int DOOR_BODY = 7;"):
        assert text in door.header, text
    # two scalar trees: the arm, and the block's slides (the door's hinge)
    assert pusher.consts["trees"] == [list(range(7)), [7, 8]] and not pusher.consts["free"]
    assert door.consts["trees"] == [list(range(7)), [7]]
    # the hand's force is -f of the block's, and the door's hand gets none
    pos = torch.tensor([[[0.0, 0.0, 0.0], [0.1, 0.0, 0.0]]])
    f = pusher.task.forces(pos, None, torch.tensor([0.0, 0.0, 500.0]))
    torch.testing.assert_close(f[0, 0], -f[0, 1])
    torch.testing.assert_close(f[0, 1], torch.tensor([15.0, 0.0, 0.0]), rtol=0, atol=1e-4)
    g = door.task.forces(pos, None, torch.tensor([60.0, 0.12, 1.2]))
    assert float(g[0, 0].abs().max()) == 0.0
    torch.testing.assert_close(g[0, 1], torch.tensor([-6.0, 0.0, 0.0]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,controller", CONTROLLERS)
def test_solver_params_match_jax(name, controller):
    """The same solver kwargs as the JAX translation (plus the env's
    device), and a solver that builds from them at the config's size."""
    exp = cfg.load_config(CONFIGS[name])
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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_mpc_runs_the_config(tmp_path, name):
    """run_mpc on each config's controllers, cut to horizon 3, 2 particles
    per cpu, one episode of 2 steps."""
    exp = cfg.load_config(CONFIGS[name])
    exp.update(n_episodes=1, max_ep_length=2)
    controllers = [c for n, c in CONTROLLERS if n == name]
    for c in controllers:
        exp[c].update(horizon=3, particles_per_cpu=2)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(exp))
    results = run_mpc.main(["--config", str(path), "--controller", ",".join(controllers),
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert tuple(results) == tuple(controllers)
    for out in results.values():
        assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()


@pytest.mark.parametrize("name,task", [("sawyer_pusher-v0", "pusher"), ("pusher-v0", "pusher"),
                                       ("sawyer_door-v0", "sawyer_door")])
def test_make_builds_on_the_card_by_default_and_picks_the_kernel(monkeypatch, name, task):
    """envs.make defaults to the card, and make_solve_fn's auto gate takes
    the fused rollout, kernel #6 with the env's task (on the CPU its plain
    version, which the spy sees once per solve)."""
    import inspect
    factory = envs._REGISTRY[name]
    assert inspect.signature(factory).parameters["device"].default == "cuda"
    assert name not in envs.NOT_PORTED and name in envs.available()
    calls = []
    plain = fr.rollout_forest_plain

    def spy(model, n_substeps, act_bodies, task_, *args, **kwargs):
        calls.append(task_.name)
        return plain(model, n_substeps, act_bodies, task_, *args, **kwargs)

    monkeypatch.setattr(fr, "rollout_forest_plain", spy)
    env = envs.make(name, device=DEVICE)
    solver = solvers.MPPI(**dict(SOLVE_CFG, num_particles=4, horizon=2), device=DEVICE)
    action, _, _ = solvers.make_solve_fn(solver, env)(env.params, env.init(env.params, 0),
                                                      solver.init_state(0))
    assert calls == [task] and action.shape == (7,)
