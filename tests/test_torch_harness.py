"""The port's config runner (harness/config.py, episode.py, run_mpc.py and
utils/) against the JAX package's, and the whole locomotion slice: a
swimmer MPPI solve through kernel #5's plain version against the JAX
package's solve on the same injected noise, and against the port's own
general solve.

Tolerances: the config translation is exact (the same dict); episodes run
by hand and by run_episodes are identical (the same seeds, rtol 0 atol 0);
whole solves, action and mean to atol 5e-4, the JAX package's tolerance
for its fused against its general swimmer solve
(tests/test_pallas_loco.py).
"""
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.harness import config as jcfg
from mjmpc_tpu_torch import convert, envs, rng, solvers
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.envs import randomize
from mjmpc_tpu_torch.harness import episode, run_mpc
from mjmpc_tpu_torch.ops.chain_rollout import ChainExtRollout
from mjmpc_tpu_torch.render import gif
from mjmpc_tpu_torch.utils import TimeIt, get_logger

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
SOLVE_ATOL = 5e-4
CONFIGS = [
    ("configs/Swimmer-v0.yml", "mppi"),
    ("configs/HalfCheetah-v0.yml", "mppi"),
    *[("configs/reacher_7dof-v0.yml", c)
      for c in ("mppi", "random_shooting", "cem", "dmd", "pfmpc")],
    ("configs/sawyer/sawyer_peg_insertion-v0_cl.yml", "reinforce"),
]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v) if isinstance(v, (list, np.ndarray)) else v


@pytest.mark.parametrize("path,controller", CONFIGS)
def test_solver_params_match_jax(path, controller):
    """The same solver kwargs as the JAX translation, plus the env's
    device, and a solver that builds from them."""
    exp = cfg.load_config(path)
    env = envs.make(exp["env_name"], device=DEVICE)
    got = cfg.solver_params_from_config(exp, controller, env)
    want = jcfg.solver_params_from_config(exp, controller, jenvs.make(exp["env_name"]))
    assert got.pop("device") == env.device
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_host(got[k]), _host(v), err_msg=k)
    solver = cfg.make_solver_for_env(exp, controller, env)
    assert solver.num_particles == got["num_particles"] and solver.device == env.device


def test_config_helpers_match_jax():
    cases = [("horizon", [16, 32]), ("filter_coeffs", [0.25, 0.8, 0.0]), ("step_size", "1.]"),
             ("cov_type", "full"), ("env", "v1"), ("init_cov", [0.5, 0.7]), ("lam", 0.01)]
    for key, v in cases:
        assert cfg._scalarize(key, v) == jcfg._scalarize(key, v)
    assert cfg._denoise("1.]") == 1.0 and cfg._denoise("[3]") == 3


def test_unported_and_unknown_controllers_raise():
    """An unknown controller or a missing section raises ValueError; the
    learned-model controllers (ported now) build their solvers from a
    section, d_obs injected."""
    env = envs.make("Swimmer-v0", device=DEVICE)
    exp = {"softqmpc": {"horizon": 8, "num_particles": 16},
           "softq": {"horizon": 8, "n_rollouts": 16, "lam": 0.2},
           "random_shooting_nn": {"horizon": 8, "num_cpu": 2, "particles_per_cpu": 4},
           "mppi": {"horizon": 8}}
    for name, cls in (("softqmpc", solvers.SoftQMPC), ("softq", solvers.SoftQMPC),
                      ("random_shooting_nn", solvers.RandomShootingNN)):
        solver = cfg.make_solver_for_env(exp, name, env)
        assert isinstance(solver, cls) and solver.d_obs == env.d_obs
        assert solver.num_particles == (16 if cls is solvers.SoftQMPC else 8)
        assert solver.device == env.device and callable(solvers.make_solve_fn(solver, env))
    with pytest.raises(ValueError):
        cfg.solver_params_from_config(exp, "no_such_controller", env)
    with pytest.raises(ValueError):
        cfg.solver_params_from_config(exp, "cem", env)     # no section


def _swimmer_solver(env, **kw):
    cfg_kw = dict(d_action=4, horizon=4, num_particles=16, lam=0.01, init_cov=3.0,
                  step_size=0.55, alpha=1, filter_coeffs=(0.25, 0.8, 0.0),
                  base_action="repeat", device=DEVICE)
    cfg_kw.update(kw)
    return solvers.MPPI(**cfg_kw)


def test_run_episodes_matches_a_hand_loop():
    """run_episodes' episodes one after another (batched=False; the batched
    episode is held to this loop in test_torch_batched_episode.py) at N=16,
    H=4, 3 steps, 2 episodes give the rewards of guarded solves and env
    steps run by hand from the same seeds."""
    env = envs.make("Swimmer-v0", device=DEVICE)
    solver = _swimmer_solver(env)
    out = episode.run_episodes(solver, env, n_episodes=2, episode_length=3, base_seed=7,
                               batched=False)
    solve = solvers.guard_finite(solvers.make_solve_fn(solver, env), solver)
    for i in range(2):
        seed = 7 + i * 12345
        es = env.init(env.params, rng.derive_seed(seed, 0))
        ss = solver.init_state(rng.derive_seed(seed, 1))
        for t in range(3):
            action, value, ss = solve(env.params, es, ss)
            action = env.clip_action(action)
            es, _, reward, _ = env.step(env.params, es, action)
            assert out["rewards"][i, t] == float(reward)
            np.testing.assert_array_equal(out["actions"][i, t], action.numpy())
        np.testing.assert_array_equal(out["states"][i].qpos[-1], es.qpos.numpy())
        torch.testing.assert_close(out["final_solver_states"][i].mean, ss.mean, rtol=0, atol=0)
    assert out["rewards"].shape == (2, 3) and out["actions"].shape == (2, 3, 4)
    assert out["ep_rewards"] == pytest.approx(out["rewards"].sum(1))
    assert out["average_reward"] == pytest.approx(float(out["ep_rewards"].mean()))
    assert out["success_metric"] == 0.0 and out["states"][0].qpos.shape == (3, 7)


def test_fused_mode_follows_the_planning_params():
    env = envs.make("Swimmer-v0", device=DEVICE)
    assert episode._fused_mode(env, env.params) == "auto"
    other = dataclasses.replace(env.params, drag_perp=2.0 * env.params.drag_perp)
    assert episode._fused_mode(env, other) is False


def _small_config(tmp_path, src, **sizes):
    """A copy of a config with every controller section cut to `sizes`."""
    exp = cfg.load_config(src)
    exp.update(n_episodes=1, max_ep_length=2)
    for section in exp.values():
        if isinstance(section, dict) and "horizon" in section:
            section.update(sizes)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(exp))
    return str(path)


def test_run_mpc_writes_its_log_and_returns_finite_rewards(tmp_path):
    path = _small_config(tmp_path, "configs/Swimmer-v0.yml", horizon=4, particles_per_cpu=2)
    results = run_mpc.main(["--config", path, "--controller", "mppi", "--device", DEVICE,
                            "--save_dir", str(tmp_path), "--save_trajectories",
                            "--chunk_size", "5"])
    out = results["mppi"]
    assert out["rewards"].shape == (1, 2) and np.isfinite(out["ep_rewards"]).all()
    log_dir = out["log_dir"]
    with open(f"{log_dir}/mppi_Swimmer-v0.csv") as f:
        header = f.readline().strip().split(",")
    assert "AverageReward" in header and "NumParticles" in header
    assert "Avg. reward" in open(f"{log_dir}/mppi_Swimmer-v0.log").read()
    assert np.load(f"{log_dir}/trajectories.npz")["rewards"].shape == (1, 2)


def test_run_mpc_runs_every_reacher_controller(tmp_path):
    path = _small_config(tmp_path, "configs/reacher_7dof-v0.yml", horizon=4,
                         particles_per_cpu=2)
    controllers = ("mppi", "random_shooting", "cem", "dmd", "pfmpc")
    results = run_mpc.main(["--config", path, "--controller", ",".join(controllers),
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert tuple(results) == controllers
    for out in results.values():
        assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()


@pytest.mark.parametrize("flag", [["--dump_vids"], ["--checkpoint", "--dump_vids"]])
def test_run_mpc_flags_not_ported_raise(flag, tmp_path):
    """--dump_vids, once the flag still to port (it raised
    NotImplementedError), alone and beside --checkpoint, on the swimmer
    config cut to 2 episodes x 3 steps at N=8, H=4: one GIF per episode
    (3 frames each) in the controller's log dir, the checkpoint beside it,
    and the episodes' records equal to a run without the flag, bit for bit
    (rendering reads the states the episodes already read to the host)."""
    with open("configs/Swimmer-v0.yml") as f:
        exp = yaml.safe_load(f)
    exp.update(n_episodes=2, max_ep_length=3)
    exp["mppi"].update(horizon=4, num_cpu=1, particles_per_cpu=8)
    cfg_path = tmp_path / "swimmer.yml"
    cfg_path.write_text(yaml.safe_dump(exp))
    runs = {}
    for key, extra in (("with", flag), ("without", [])):
        save = tmp_path / key
        runs[key] = run_mpc.main(["--config", str(cfg_path), "--device", DEVICE,
                                  "--save_dir", str(save), *extra])["mppi"]
    log_dir = runs["with"]["log_dir"]
    gifs = sorted(f for f in os.listdir(log_dir) if f.endswith(".gif"))
    assert gifs == ["vid_traj_0.gif", "vid_traj_1.gif"]
    for name in gifs:
        assert len(gif.read_gif(os.path.join(log_dir, name))["delays"]) == 3
    has_checkpoint = os.path.exists(os.path.join(log_dir, "solver_state.npz"))
    assert has_checkpoint == ("--checkpoint" in flag)
    assert not [f for f in os.listdir(runs["without"]["log_dir"]) if f.endswith(".gif")]
    for k in ("rewards", "actions", "values", "dones", "successes"):
        np.testing.assert_array_equal(runs["with"][k], runs["without"][k])


def test_run_mpc_dyn_randomize_perturbs_only_the_sim_params(tmp_path):
    """run_mpc --dyn_randomize_config on the reacher spec at a tiny size:
    the planner's params are the spec's draw from the config's seed, the
    real env's are nominal, and both are logged."""
    cfg_path = tmp_path / "reacher.yml"
    with open("configs/reacher_7dof-v0.yml") as f:
        exp = yaml.safe_load(f)
    exp.update(n_episodes=1, max_ep_length=2)
    exp["mppi"].update(num_particles=8, horizon=4)
    cfg_path.write_text(yaml.safe_dump(exp))
    spec_path = "configs/dyn_randomize/reacher_7dof.yml"
    nominal = envs.make("reacher_7dof-v0", device=DEVICE)
    out = run_mpc.main(["--config", str(cfg_path), "--controller", "mppi", "--device", DEVICE,
                        "--dyn_randomize_config", spec_path,
                        "--save_dir", str(tmp_path)])["mppi"]
    with open(spec_path) as f:
        spec = yaml.safe_load(f)
    want, _, _ = randomize.perturbed_params(nominal, spec, base_seed=exp["seed"])
    sim = out["sim_params"]
    for f in ("mass", "inertia", "damping"):
        np.testing.assert_array_equal(getattr(sim.model, f).numpy(),
                                      getattr(want.model, f).numpy())
    assert not torch.equal(sim.model.mass, nominal.params.model.mass)
    # the real env that run_mpc stepped is nominal ...
    real = solvers.tensor_leaves(out["real_params"])
    for k, v in solvers.tensor_leaves(nominal.params).items():
        assert torch.equal(real[k], v), k
    # ... and its episode is the one of a nominal real env planned on the
    # perturbed sim env from the same seed
    exp_run = cfg.load_config(str(cfg_path))
    sim_env = randomize.randomize_dynamics(nominal, spec, base_seed=exp["seed"])[0]
    ref = episode.run_episodes(cfg.make_solver_for_env(exp_run, "mppi", nominal), nominal,
                               n_episodes=1, episode_length=2, base_seed=exp["seed"],
                               sim_env=sim_env)
    np.testing.assert_array_equal(out["rewards"], ref["rewards"])
    assert np.isfinite(out["rewards"]).all() and out["rewards"].shape == (1, 2)
    log = "".join(p.read_text() for p in tmp_path.rglob("*.log"))
    assert "Default params" in log and "Randomized params" in log


def test_logger_tabular_round_trip_and_timer(tmp_path):
    lg = get_logger("run", str(tmp_path))
    lg.record_tabular("a", 1.0)
    with pytest.raises(ValueError):
        lg.record_tabular("a", 2.0)
    lg.dump_tabular()
    lg.record_tabular("b", 3.0)
    lg.dump_tabular()
    resumed = get_logger("run", str(tmp_path))
    assert resumed._tabular["b"][1] == 3.0 and math.isnan(resumed._tabular["b"][0])
    assert resumed._num_dump_tabular_calls == 2
    timer = TimeIt()
    timer.start("x")
    assert timer.stop("x") >= 0.0 and "x:" in timer.report()
    with pytest.raises(KeyError):
        timer.stop("x")


@dataclasses.dataclass(frozen=True)
class InjectedMPPI(solvers.MPPI):
    """Test-only MPPI whose noise is given, not sampled."""
    noise: torch.Tensor = None

    def sample_noise(self, state):
        return self.noise.clone()


# The JAX package's fused-vs-general swimmer solve (tests/test_pallas_loco.py).
SOLVE_CFG = dict(d_action=4, horizon=6, num_particles=24, lam=0.2, init_cov=0.3,
                 step_size=1.0, gamma=1.0, alpha=1, base_action="null",
                 filter_coeffs=(1.0, 0.0, 0.0))


def test_swimmer_solve_matches_jax_solve():
    """One whole MPPI solve on the swimmer: the port through kernel #5's
    plain version, JAX through its general rollout, on the JAX solve's own
    noise."""
    jenv = jenvs.make("Swimmer-v0")
    jsolver = jsolvers.MPPI(**SOLVE_CFG)
    s0 = jsolver.init_state(jax.random.PRNGKey(0))
    es = jenv.init(jenv.params, jax.random.PRNGKey(1))
    noise = np.array(jsolver.sample_noise(s0))
    a_j, _, s_j = jax.jit(jsolvers.build_solve_fn(jsolver, jenv, fused=False))(
        jenv.params, es, s0)
    env = envs.make("Swimmer-v0", device=DEVICE)
    solver = InjectedMPPI(**SOLVE_CFG, noise=torch.as_tensor(noise), device=DEVICE)
    solve = solvers.make_solve_fn(solver, env)
    a, _, s = solve(env.params, convert.loco_state_from_reference(es, device=DEVICE),
                    convert.gaussian_state_from_reference(s0, device=DEVICE))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=0, atol=SOLVE_ATOL)
    np.testing.assert_allclose(s.mean.numpy(), np.asarray(s_j.mean), rtol=0, atol=SOLVE_ATOL)
    assert s.step == int(s_j.step) == 1


def test_swimmer_fused_solve_matches_general_solve():
    env = envs.make("Swimmer-v0", device=DEVICE)
    solver = solvers.MPPI(**SOLVE_CFG, device=DEVICE)
    s0, es = solver.init_state(0), env.init(env.params, 1)
    before = ChainExtRollout.launches
    a_f, _, s_f = solvers.make_solve_fn(solver, env, fused=True)(env.params, es, s0)
    a_g, _, s_g = solvers.make_solve_fn(solver, env, fused=False)(env.params, es, s0)
    assert ChainExtRollout.launches == before
    torch.testing.assert_close(a_f, a_g, rtol=0, atol=SOLVE_ATOL)
    torch.testing.assert_close(s_f.mean, s_g.mean, rtol=0, atol=SOLVE_ATOL)
