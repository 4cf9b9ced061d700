"""door-v0 in the port (envs/hand_door.py: the arm-mounted hand, the door and
its latch, kernel #6's plain version with the door task as its fused
rollout) against the JAX package: the model and the initial layout, one
env step with its observation, reward and success from injected states
(the hand hooking the handle with the latch near its threshold, the door
past each bonus angle), the fused rollout and solve against the port's
general ones, the generated header, the config translation of every
controller of configs/hand/door-v0.yml, run_mpc at a cut size, _fused_mode's
dynamic fields and the auto gate's pick of kernel #6. No test runs the JAX
forest kernel (an interpret-mode Pallas compile of minutes): the JAX env
step is the reference. The door task's CUDA source is built for the host
in tests/test_torch_forest.py.

Tolerances: the env step (qpos, qvel, obs, reward) atol 1e-4 (five
substeps of penalty contact with kp = 800 in two AD systems; they agree to
2e-6); the fused against the general rollout and solve atol 1e-4, the JAX
package's own bar (tests/test_pallas_forest.py), entries off by a bonus
step of the gated door cost counted by gated_cost_agreement; the model and
the config translation exact.
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
from mjmpc_tpu_torch.envs import adroit
from mjmpc_tpu_torch.envs import hand_door as hd
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import episode, run_mpc
from mjmpc_tpu_torch.ops import forest_rollout as fr
from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout
from mjmpc_tpu_torch.solvers.base import open_loop_rollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
STEP_ATOL = 1e-4
CONFIG = "configs/hand/door-v0.yml"
CONTROLLERS = ("mppi", "cem", "random_shooting", "dmd", "pfmpc")
# (name, latch, door, hooked): the JAX start; the hand hooking the handle,
# the latch near its threshold (the strike plate's gate half open); the
# door opened past 0.2 rad (+2); past 1.0 (+2 +8); past 1.35 (+20, success)
CASES = (("rest", None, None, False), ("hook", 0.5, 0.0, True), ("open", 0.6, 0.3, True),
         ("wide", 0.8, 1.1, False), ("success", 0.8, 1.4, False))


def _case_state(model, js, latch, door, hooked, rs):
    """A JAX DoorState: the hand's joints perturbed by U(-0.03, 0.03); the
    latch and the door at the given angles, the hand hooking the handle
    (envs/hand_door.py hook_qpos) where `hooked`."""
    q = torch.as_tensor(np.array(js.qpos))
    if hooked:
        q = hd.hook_qpos(model, q, latch, door)
    elif latch is not None:
        q[hd.DOOR_BODY], q[hd.LATCH_BODY] = door, latch
    q[hd.N_ARM:hd.N_ACT] += torch.as_tensor(rs.uniform(-0.03, 0.03, 24), dtype=torch.float32)
    return js._replace(qpos=jnp.asarray(q.numpy()))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX env, the injected states of CASES, one action and one jitted
    env.step from each state."""
    jenv = jenvs.make("door-v0")
    model = envs.make("door-v0", device=DEVICE).params.model
    rs = np.random.default_rng(0)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    action = np.asarray(rs.uniform(-1.2, 1.2, 27), np.float32)   # clipped inside
    step = jax.jit(jenv.step)
    out = {}
    for name, latch, door, hooked in CASES:
        s = _case_state(model, js, latch, door, hooked, rs)
        out[name] = (s, step(jenv.params, s, jnp.asarray(action)))
    return jenv, action, out


def test_model_and_init_match_jax():
    jenv = jenvs.make("door-v0")
    env = envs.make("door-v0", device=DEVICE)
    model, jmodel = env.params.model, jenv.params.model
    for name in convert._MODEL_TENSORS:
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(jmodel, name)), err_msg=name)
    assert model.parent == tuple(jmodel.parent) and model.joint_types == jmodel.joint_types
    assert (model.nq, model.nv, env.d_obs, env.d_action) == (29, 29, 64, 27)
    assert (env.max_episode_steps, env.name) == (jenv.max_episode_steps, jenv.name)
    converted = convert.hand_door_params_from_reference(jenv.params, device=DEVICE)
    for f in ("kp", "kd", "mu"):
        assert float(getattr(converted, f)) == float(getattr(env.params, f))
    js = jenv.init(jenv.params, jax.random.PRNGKey(3))
    s = env.init(env.params, 3)
    # everything but the hand's drawn y is the JAX layout: the hand raised
    # to 0.10, the door and the latch closed, at rest
    keep = np.r_[0:1, 2:29]
    np.testing.assert_array_equal(s.qpos.numpy()[keep], np.asarray(js.qpos)[keep])
    np.testing.assert_array_equal(s.qvel.numpy(), np.asarray(js.qvel))
    assert abs(float(s.qpos[1])) <= 0.05
    assert float(env.init(env.params, 4).qpos[1]) != float(s.qpos[1])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_step_observe_success_match_jax(jax_steps, case):
    jenv, action, out = jax_steps
    js, (jn, jobs, jrew, _) = out[case]
    env = envs.make("door-v0", device=DEVICE)
    state = convert.hand_door_state_from_reference(js, device=DEVICE)
    ns, obs, rew, done = env.step(env.params, state, torch.as_tensor(action))
    for got, want, name in ((ns.qpos, jn.qpos, "qpos"), (ns.qvel, jn.qvel, "qvel"),
                            (obs, jobs, "obs")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(env.observe(env.params, state).numpy(),
                               np.asarray(jenv.observe(jenv.params, js)), rtol=0, atol=1e-6)
    success = bool(env.success(env.params, ns))
    assert success == bool(jenv.success(jenv.params, jn)) == (case == "success")
    assert ns.timestep == 1 and not bool(done) and obs.shape == (64,)
    # the cases reach the gates they are named for
    r = float(rew)
    assert {"rest": abs(r) < 0.1, "hook": 0.1 < r < 0.5, "open": 2.5 < r < 4.0,
            "wide": 12.0 < r < 13.0, "success": 23.0 < r < 24.0}[case], r
    if case == "hook":
        # the hooked fingers press the handle: the contact turns the latch
        # and the door within one step
        assert float(ns.qvel[hd.LATCH_BODY].abs()) > 0.01
        assert float(ns.qvel[hd.DOOR_BODY].abs()) > 0.01


def _rollout_inputs(env, case, seed, n, h):
    rs = np.random.default_rng(seed)
    _, latch, door, hooked = dict((c[0], c) for c in CASES)[case]
    st = env.init(env.params, seed)
    q = hd.hook_qpos(env.params.model, st.qpos, latch, door)
    q[hd.N_ARM:hd.N_ACT] += torch.as_tensor(rs.uniform(-0.03, 0.03, 24), dtype=torch.float32)
    st = dataclasses.replace(st, qpos=q)
    mean = torch.as_tensor(np.asarray(rs.normal(size=(h, 27)) * 0.2, np.float32))
    noise = torch.as_tensor(np.asarray(rs.normal(size=(n, h, 27)) * 0.3, np.float32))
    return st, mean, noise


@pytest.mark.parametrize("case", ["hook", "open"])
def test_fused_rollout_matches_general_rollout(case):
    """The fused rollout's plain version (the door task: the handle's
    contact split onto its ends, the hook's springs and strike plate)
    against the general rollout (the AD engine through env.step); zeroed
    actions move the costs far beyond the tolerance."""
    env = envs.make("door-v0", device=DEVICE)
    st, mean, noise = _rollout_inputs(env, case, 1, 4, 3)
    got = env.fused_rollout(env.params, st, mean, noise)
    want = open_loop_rollout(env, False, False)(env.params, st, mean, noise).costs
    agree = fr.gated_cost_agreement(got, want, 1e-4, fr.DOOR_BONUS_STEPS)
    assert agree["other"] == 0 and agree["share_within"] >= 0.9, agree
    zeroed = env.fused_rollout(env.params, st, torch.zeros_like(mean), torch.zeros_like(noise))
    assert float((zeroed - want).abs().max()) > 1e-3


# The JAX package's fused-against-general solve (tests/test_pallas_forest.py),
# cut to 8 particles and 3 steps (the general rollout is the eager AD engine).
SOLVE_CFG = dict(d_action=27, horizon=3, num_particles=8, lam=0.2, init_cov=0.3,
                 step_size=1.0, gamma=1.0, alpha=1, base_action="null",
                 filter_coeffs=(0.25, 0.8, 0.0))


def test_fused_solve_matches_general_solve():
    """build_solve_fn's fused path (kernel #6's plain version) against the
    general rollout, the same noise, from the hand hooking the handle."""
    env = envs.make("door-v0", device=DEVICE)
    solver = solvers.MPPI(**SOLVE_CFG, device=DEVICE)
    s0 = solver.init_state(0)
    es, _, _ = _rollout_inputs(env, "hook", 2, 1, 1)
    before = ForestRollout.launches
    a_f, _, s_f = solvers.make_solve_fn(solver, env, fused=True)(env.params, es, s0)
    a_g, _, s_g = solvers.make_solve_fn(solver, env, fused=False)(env.params, es, s0)
    assert ForestRollout.launches == before
    torch.testing.assert_close(a_f, a_g, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_f.mean, s_g.mean, rtol=0, atol=1e-4)


def test_header_bakes_the_door_task():
    env = envs.make("door-v0", device=DEVICE)
    roll = hd.build_rollout(env.params.model)
    weight = adroit.arm_hand_weight(env.params.model)
    assert roll.team == 32 and roll.task.joint_torque is not None
    for text in ("#define FOREST_TASK 8", "constexpr int NB = 29;", "constexpr int NQ = 29;",
                 "constexpr int NV = 29;", "constexpr int D_ACT = 27;",
                 "constexpr int N_POINTS = 13;", "constexpr int N_SUBSTEPS = 5;",
                 "constexpr int N_EXTRAS = 3;", "constexpr int DOOR_BODY = 27;",
                 "constexpr int LATCH_BODY = 28;", "constexpr bool HAS_FREE = false;",
                 "constexpr bool HAS_SLIDE = true;",
                 f"constexpr float HAND_WEIGHT = {fr._f(weight)};",
                 f"constexpr float LATCH_THRESH = {fr._f(0.55)};"):
        assert text in roll.header, text
    # two scalar trees: the arm and hand, the door and its latch
    assert roll.consts["trees"] == [list(range(27)), [27, 28]]
    # the hook: the hand's weight, the latch's spring, and the strike plate
    # that holds the closed door while the latch is down and lets go of it
    # once the latch turns past its threshold
    q = torch.zeros(3, 29)
    q[:, hd.DOOR_BODY] = 0.05
    q[:, hd.LATCH_BODY] = torch.tensor([0.0, 0.55, 1.0])
    torque = roll.task.joint_torque(q, None, None, None)
    assert set(torque) == {2, hd.DOOR_BODY, hd.LATCH_BODY} and torque[2] == float(weight)
    door = torque[hd.DOOR_BODY].numpy()
    assert door[0] < -3.0 and -2.5 < door[1] < -1.0 and -0.1 < door[2] < 0.0
    np.testing.assert_allclose(torque[hd.LATCH_BODY].numpy(), [0.0, -0.165, -0.3], atol=1e-6)


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


def test_run_mpc_runs_the_door_config(tmp_path):
    """run_mpc on door-v0 with its mppi block (every block builds in
    test_solver_params_match_jax), cut to horizon 3, 1 particle per cpu,
    one episode of 2 steps."""
    exp = cfg.load_config(CONFIG)
    exp.update(n_episodes=1, max_ep_length=2)
    exp["mppi"].update(horizon=3, particles_per_cpu=1)
    path = tmp_path / "door.yml"
    path.write_text(yaml.safe_dump(exp))
    results = run_mpc.main(["--config", str(path), "--controller", "mppi",
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert tuple(results) == ("mppi",)
    out = results["mppi"]
    assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()


def test_fused_mode_keeps_the_kernel_for_dynamic_fields():
    """door's kernel reads kp, kd and mu at call time: params that differ
    only there keep the fused path, and the rollout reads the changed
    gains; a changed model takes the general rollout."""
    env = envs.make("door-v0", device=DEVICE)
    assert env.fused_rollout.dynamic_fields == ("kp", "kd", "mu")
    assert episode._fused_mode(env, env.params) == "auto"
    stiffer = dataclasses.replace(env.params, kp=2.0 * env.params.kp, mu=0.5 * env.params.mu)
    assert episode._fused_mode(env, stiffer) == "auto"
    heavier = dataclasses.replace(env.params, model=dataclasses.replace(
        env.params.model, mass=1.1 * env.params.model.mass))
    assert episode._fused_mode(env, heavier) is False
    st, mean, noise = _rollout_inputs(env, "hook", 0, 2, 2)
    base = env.fused_rollout(env.params, st, mean, noise)
    assert not torch.equal(base, env.fused_rollout(stiffer, st, mean, noise))


def test_make_builds_on_the_card_by_default_and_picks_the_kernel(monkeypatch):
    """envs.make defaults to the card, and make_solve_fn's auto gate takes
    the fused rollout, kernel #6 with the door task (on the CPU its plain
    version, which the spy sees once per solve)."""
    import inspect
    assert inspect.signature(hd.make).parameters["device"].default == "cuda"
    assert "door-v0" not in envs.NOT_PORTED and "door-v0" in envs.available()
    calls = []
    plain = fr.rollout_forest_plain

    def spy(model, n_substeps, act_bodies, task, *args, **kwargs):
        calls.append(task.name)
        return plain(model, n_substeps, act_bodies, task, *args, **kwargs)

    monkeypatch.setattr(fr, "rollout_forest_plain", spy)
    env = envs.make("door-v0", device=DEVICE)
    solver = solvers.MPPI(**dict(SOLVE_CFG, num_particles=4, horizon=2), device=DEVICE)
    action, _, _ = solvers.make_solve_fn(solver, env)(env.params, env.init(env.params, 0),
                                                      solver.init_state(0))
    assert calls == ["door"] and action.shape == (27,)
