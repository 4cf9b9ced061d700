"""The tray-glass family in the port (envs/panda_tasks.py: panda_tray_glass-v0,
-v1 and -fixed-v1, kernel #6's plain version with the tray task as their
fused rollout) against the JAX package: the models and the initial
layouts, the potential energy and the arm's gravity feed-forward against
JAX's grad, one env step with its observation, reward and success from
injected states, the fused rollout against the port's general rollout, the
generated headers, the config translation of the panda configs, run_mpc at
a cut size (the biased-model config planning on fixed-v1's own kernel) and
the auto gate's pick of kernel #6. No test runs the JAX forest kernel: the
JAX env step is the reference. The tray task's CUDA source is built for the
host in tests/test_torch_forest.py.

Tolerances: the potential energy and its gradient atol 1e-5 (sums of a few
terms of order 1 in f32); the env step (qpos, qvel, obs, reward) atol 1e-4
(they agree to 2e-6); the fused against the general rollout atol 1e-4, the
JAX package's own bar, entries off by the fall penalty's step (a gate that
an f32 ulp can flip) counted by gated_cost_agreement; the model and the
config translation exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.engine import chain as jrb
from mjmpc_tpu.harness import config as jcfg
from mjmpc_tpu_torch import convert, envs, solvers
from mjmpc_tpu_torch.engine import chain as rb
from mjmpc_tpu_torch.envs import panda_tasks as pt
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import episode, run_mpc
from mjmpc_tpu_torch.ops import forest_rollout as fr
from mjmpc_tpu_torch.solvers.base import open_loop_rollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
STEP_ATOL = 1e-4
VARIANTS = ("panda_tray_glass-v0", "panda_tray_glass-v1", "panda_tray_glass_fixed-v1")
CONFIGS = ("configs/panda/tray_glass-v0.yml", "configs/panda/tray_glass-v1.yml",
           "configs/panda/tray_glass_fixed-v1.yml",
           "configs/panda/tray_glass-v1_biased_model.yml")
BIASED = "configs/panda/tray_glass-v1_biased_model.yml"
# (case): the start with the arm perturbed; the glass past the tray's edge
# (the fall penalty live); the tray at its target (success)
CASES = ("start", "fallen", "at_target")


def _case(env, jenv, case, rs):
    """(port state, JAX state) of a case; the arm's joints perturbed by
    U(-0.2, 0.2), the port's target in the JAX state."""
    s = env.init(env.params, 0)
    q = s.qpos.clone()
    q[:7] += torch.as_tensor(rs.uniform(-0.2, 0.2, 7), dtype=torch.float32)
    target = s.target
    if case == "fallen":
        q = pt.fallen_qpos(q)
    elif case == "at_target":
        q[pt.GLASS_Q:] = 0.0
        target = pt._tray_and_glass(env.params.model, q)[0] + torch.tensor([0.01, -0.01, 0.0])
    s = dataclasses.replace(s, qpos=q, target=target)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))._replace(
        qpos=jnp.asarray(q.numpy()), target=jnp.asarray(target.numpy()))
    return s, js


@pytest.fixture(scope="module")
def jax_steps():
    """Each variant's and case's states and one jitted JAX env step."""
    rs = np.random.default_rng(0)
    action = np.asarray(rs.uniform(-1.2, 1.2, 7), np.float32)   # clipped inside
    out = {}
    for name in VARIANTS:
        env, jenv = envs.make(name, device=DEVICE), jenvs.make(name)
        step = jax.jit(jenv.step)
        for case in CASES:
            s, js = _case(env, jenv, case, rs)
            out[(name, case)] = (js, step(jenv.params, js, jnp.asarray(action)))
    return action, out


@pytest.mark.parametrize("name", VARIANTS)
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
    # v1 halves the glass's damping, fixed-v1 also clamps its slides
    want = np.float32(0.6) * (1.0 if name.endswith("-v0") else np.float32(0.5))
    np.testing.assert_array_equal(model.damping[7:].numpy(), [want, want])
    assert (model.qpos_high[7:].tolist() == [0.0, 0.0]) == ("fixed" in name)
    converted = convert.tray_params_from_reference(jenv.params, device=DEVICE)
    assert float(converted.fall_penalty) == float(env.params.fall_penalty) == 5.0
    js, s = jenv.init(jenv.params, jax.random.PRNGKey(3)), env.init(env.params, 3)
    np.testing.assert_array_equal(s.qpos[:7].numpy(), np.asarray(js.qpos)[:7])
    np.testing.assert_array_equal(s.qvel.numpy(), np.asarray(js.qvel))
    target = s.target.numpy()
    assert ((target >= [0.3, -0.85, -0.1]) & (target <= [0.8, -0.35, 0.3])).all()
    glass = s.qpos[7:].numpy()
    if name.endswith("-v0"):
        assert (glass == 0.0).all()
    else:           # v1 starts with the glass displaced by U(-0.05, 0.05)
        assert (np.abs(glass) <= 0.05).all() and (glass != 0.0).all()
    assert not torch.equal(env.init(env.params, 4).target, s.target)


@pytest.mark.parametrize("name", ["panda_tray_glass-v0", "panda_tray_glass_fixed-v1"])
def test_potential_energy_and_feed_forward_match_jax_grad(name):
    """engine.chain.potential_energy against the JAX package's, and the
    arm-masked feed-forward of the env step against JAX's grad of it, from
    random states (a batch of them: each row's own gradient)."""
    env, jenv = envs.make(name, device=DEVICE), jenvs.make(name)
    rs = np.random.default_rng(1)
    q = np.asarray(rs.uniform(-0.8, 0.8, (5, 9)), np.float32)
    want_v = np.asarray(jax.vmap(lambda x: jrb.potential_energy(jenv.params.model, x))(q))
    got_v = rb.potential_energy(env.params.model, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5)
    grad = np.asarray(jax.vmap(jax.grad(lambda x: jrb.potential_energy(jenv.params.model, x)))(
        q))
    got = pt.gravity_compensation(env.params.model, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got[:, :7], grad[:, :7], rtol=0, atol=1e-5)
    assert (got[:, 7:] == 0.0).all() and np.abs(grad[:, :7]).max() > 1.0
    # the tray task's hook computes the same feed-forward from the FK's frames
    roll = pt.build_rollout(env.params.model)
    rots, poss, axes = fr._fk(roll.consts, torch.as_tensor(q))
    hook = roll.task.joint_torque(None, None, None, (rots, poss, axes))
    assert sorted(hook) == list(range(7))
    np.testing.assert_allclose(torch.stack([hook[d] for d in range(7)], -1).numpy(),
                               grad[:, :7], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,case", [(n, c) for n in VARIANTS for c in CASES])
def test_step_observe_success_match_jax(jax_steps, name, case):
    action, out = jax_steps
    js, (jn, jobs, jrew, _) = out[(name, case)]
    env, jenv = envs.make(name, device=DEVICE), jenvs.make(name)
    state = convert.tray_state_from_reference(js, device=DEVICE)
    ns, obs, rew, done = env.step(env.params, state, torch.as_tensor(action))
    for got, want, what in ((ns.qpos, jn.qpos, "qpos"), (ns.qvel, jn.qvel, "qvel"),
                            (obs, jobs, "obs")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL,
                                   err_msg=what)
    np.testing.assert_allclose(float(rew), float(jrew), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(env.observe(env.params, state).numpy(),
                               np.asarray(jenv.observe(jenv.params, js)), rtol=0, atol=1e-6)
    success = bool(env.success(env.params, ns))
    assert success == bool(jenv.success(jenv.params, jn))
    assert ns.timestep == 1 and not bool(done) and obs.shape == (24,)
    # the fall penalty is live once the glass is off the tray (fixed-v1's
    # clamp puts it back at once); the tray reaches its target
    fallen = case == "fallen" and "fixed" not in name
    assert (float(rew) < -5.0) == fallen, float(rew)
    assert success == (case == "at_target"), float(rew)


@pytest.mark.parametrize("name,case", [(n, c) for n in VARIANTS for c in ("start", "fallen")])
def test_fused_rollout_matches_general_rollout(name, case):
    """The fused rollout's plain version (the tray task: its hook's
    feed-forward from the FK's frames) against the general rollout (the
    engine's grad of the potential energy through env.step); zeroed
    actions move the costs far beyond the tolerance."""
    rs = np.random.default_rng(2)
    env = envs.make(name, device=DEVICE)
    s, _ = _case(env, jenvs.make(name), case, rs)
    mean = torch.as_tensor(np.asarray(rs.normal(size=(3, 7)) * 0.2, np.float32))
    noise = torch.as_tensor(np.asarray(rs.normal(size=(8, 3, 7)) * 0.3, np.float32))
    got = env.fused_rollout(env.params, s, mean, noise)
    want = open_loop_rollout(env, False, False)(env.params, s, mean, noise).costs
    agree = fr.gated_cost_agreement(got, want, 1e-4, fr.TRAY_FALL_STEPS)
    assert agree["other"] == 0 and agree["share_within"] >= 0.95, agree
    if case == "fallen" and "fixed" not in name:
        assert float(want.max()) > 5.0          # the penalty is live
    zeroed = env.fused_rollout(env.params, s, torch.zeros_like(mean), torch.zeros_like(noise))
    assert float((zeroed - want).abs().max()) > 1e-3


def test_headers_bake_each_variants_model():
    headers = {n: pt.build_rollout(envs.make(n, device=DEVICE).params.model).header
               for n in VARIANTS}
    for n, h in headers.items():
        for text in ("#define FOREST_TASK 7", "constexpr int NB = 9;", "constexpr int NQ = 9;",
                     "constexpr int D_ACT = 7;", "constexpr int N_POINTS = 0;",
                     "constexpr int N_EXTRAS = 4;", "constexpr int N_ARM = 7;",
                     "constexpr int GLASS_Q = 7;", f"constexpr float TRAY_R = {fr._f(0.12)};"):
            assert text in h, (n, text)
    # three kernels: the damping, then the slides' range, differ
    assert len(set(headers.values())) == 3
    reg = lambda h: [ln for ln in h.splitlines() if ln.startswith("constexpr float h_qhigh")]
    assert reg(headers["panda_tray_glass-v1"]) != reg(headers["panda_tray_glass_fixed-v1"])


@pytest.mark.parametrize("path", CONFIGS)
def test_solver_params_match_jax(path):
    """The same mppi kwargs as the JAX translation (plus the env's device),
    and a solver that builds from them at the config's size."""
    exp = cfg.load_config(path)
    env = envs.make(exp["env_name"], device=DEVICE)
    got = cfg.solver_params_from_config(exp, "mppi", env)
    want = jcfg.solver_params_from_config(exp, "mppi", jenvs.make(exp["env_name"]))
    assert got.pop("device") == env.device
    assert set(got) == set(want)
    for k, v in want.items():
        got_k = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(np.asarray(got_k), np.asarray(v), err_msg=k)
    solver = cfg.make_solver_for_env(exp, "mppi", env)
    assert solver.num_particles == exp["mppi"]["num_cpu"] * exp["mppi"]["particles_per_cpu"]
    assert solver.horizon == exp["mppi"]["horizon"]


def _cut_config(tmp_path, path):
    exp = cfg.load_config(path)
    exp.update(n_episodes=1, max_ep_length=2)
    exp["mppi"].update(horizon=3, particles_per_cpu=2)
    out = tmp_path / "config.yml"
    out.write_text(yaml.safe_dump(exp))
    return str(out)


def test_run_mpc_runs_the_v0_config(tmp_path):
    """run_mpc on tray_glass-v0's mppi, cut to horizon 3, 2 particles per
    cpu, one episode of 2 steps."""
    results = run_mpc.main(["--config", _cut_config(tmp_path, CONFIGS[0]), "--controller", "mppi",
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    out = results["mppi"]
    assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()


def test_biased_model_config_plans_on_fixed_v1s_own_kernel(tmp_path, monkeypatch):
    """tray_glass-v1_biased_model.yml: the real env is v1 and the planner's
    model fixed-v1 (the glass welded). run_mpc hands fixed-v1 over as the
    sim env, whose own params _fused_mode keeps on the fused path: every
    solve runs kernel #6 with the tray task on fixed-v1's model (its glass
    slides clamped to [0, 0]), never v1's model nor the general rollout."""
    fixed = envs.make("panda_tray_glass_fixed-v1", device=DEVICE)
    assert episode._fused_mode(fixed, fixed.params) == "auto"
    seen = []
    plain = fr.rollout_forest_plain

    def spy(model, n_substeps, act_bodies, task, *args, **kwargs):
        seen.append((task.name, model.qpos_high[7:].tolist()))
        return plain(model, n_substeps, act_bodies, task, *args, **kwargs)

    monkeypatch.setattr(fr, "rollout_forest_plain", spy)
    results = run_mpc.main(["--config", _cut_config(tmp_path, BIASED), "--controller", "mppi",
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert results["mppi"]["rewards"].shape == (1, 2)
    assert seen == [("tray", [0.0, 0.0])] * 2


@pytest.mark.parametrize("name", VARIANTS)
def test_make_builds_on_the_card_by_default_and_picks_the_kernel(monkeypatch, name):
    """envs.make defaults to the card, and make_solve_fn's auto gate takes
    the fused rollout, kernel #6 with the tray task (on the CPU its plain
    version, which the spy sees once per solve)."""
    import inspect
    factory = envs._REGISTRY[name]
    assert inspect.signature(factory).parameters["device"].default == "cuda"
    assert name not in envs.NOT_PORTED and name in envs.available()
    calls = []
    plain = fr.rollout_forest_plain

    def spy(model, n_substeps, act_bodies, task, *args, **kwargs):
        calls.append(task.name)
        return plain(model, n_substeps, act_bodies, task, *args, **kwargs)

    monkeypatch.setattr(fr, "rollout_forest_plain", spy)
    env = envs.make(name, device=DEVICE)
    solver = solvers.MPPI(d_action=7, horizon=2, num_particles=4, lam=0.2, init_cov=0.3,
                          step_size=1.0, gamma=1.0, alpha=1, base_action="null",
                          filter_coeffs=(0.25, 0.8, 0.0), device=DEVICE)
    action, _, _ = solvers.make_solve_fn(solver, env)(env.params, env.init(env.params, 0),
                                                      solver.init_state(0))
    assert calls == ["tray"] and action.shape == (7,)
