"""Every experiment config under configs/ in the port's config driver
(harness/config.py, run_mpc.py), after tests/test_reference_configs.py:
each controller section builds its solver, cut to N = 8, H = 4, and its
solve, or raises NotImplementedError because the port lacks the env
(envs.NOT_PORTED) or the controller (solvers.NOT_PORTED); both lists are
empty since the learned-model family landed, so every section builds. A
ValueError (an unknown env or controller) fails. The configs' controllers
also run through run_mpc, cut to one step; SimplePendulum-v0's five
controllers among them, the analytic configs' (cartpole's iLQR and softq
among them) and the sawyer reacher's softq.

The port's env names and its not-ported list together are the JAX
package's registry, so the two cannot drift apart.
"""
import dataclasses
import glob

import numpy as np
import pytest
import yaml

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu_torch import envs, solvers
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import run_mpc

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
CUT = dict(num_particles=8, horizon=4)


def _experiments():
    """(path, controller) for every controller section of every experiment
    config (one with an env_name; the dyn_randomize specs have none)."""
    pairs = []
    for path in sorted(glob.glob("configs/**/*.yml", recursive=True)):
        exp = cfg.load_config(path)
        if "env_name" not in exp:
            continue
        pairs += [(path, k) for k, v in exp.items() if isinstance(v, dict)
                  and (k in solvers.REGISTRY or k in solvers.NOT_PORTED)]
    return pairs


EXPERIMENTS = _experiments()
# The configs whose env and every controller are ported: all of them since
# the learned-model family (softq) landed.
LOADING = sorted(p for p in glob.glob("configs/**/*.yml", recursive=True)
                 if "env_name" in cfg.load_config(p))


def _not_ported(exp, controller):
    return exp["env_name"] in envs.NOT_PORTED or controller in solvers.NOT_PORTED


def test_every_experiment_config_is_enumerated():
    paths = {p for p, _ in EXPERIMENTS}
    assert len(paths) == 29 and len(EXPERIMENTS) == 70
    loading = sorted(p for p in paths if not any(
        _not_ported(cfg.load_config(p), c) for q, c in EXPERIMENTS if q == p))
    assert loading == LOADING and len(LOADING) == 29
    assert solvers.NOT_PORTED == () and envs.NOT_PORTED == ()


@pytest.mark.parametrize("path,controller", EXPERIMENTS,
                         ids=[f"{p[8:-4]}:{c}" for p, c in EXPERIMENTS])
def test_config_controller_builds_or_is_not_ported(path, controller):
    exp = cfg.load_config(path)
    if _not_ported(exp, controller):
        with pytest.raises(NotImplementedError):
            cfg.make_solver_for_env(exp, controller, envs.make(exp["env_name"], device=DEVICE))
        return
    env = envs.make(exp["env_name"], device=DEVICE)
    solver = cfg.make_solver_for_env(exp, controller, env)
    small = dataclasses.replace(solver, **{k: v for k, v in CUT.items() if hasattr(solver, k)})
    assert small.horizon == CUT["horizon"] and small.device == env.device
    assert callable(solvers.make_solve_fn(small, env))


def _one_step_config(tmp_path, src):
    exp = cfg.load_config(src)
    exp.update(n_episodes=1, max_ep_length=1)
    for section in exp.values():
        if isinstance(section, dict) and "horizon" in section:
            section.update(horizon=CUT["horizon"], num_cpu=1,
                           particles_per_cpu=CUT["num_particles"])
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(exp))
    return str(path)


@pytest.mark.parametrize("src,controllers", [
    ("configs/SimplePendulum-v0.yml", ("mppi", "random_shooting", "cem", "dmd", "pfmpc")),
    ("configs/sawyer/sawyer_reacher-v0.yml", ("mppi",)),
    ("configs/panda/reacher-v0.yml", ("mppi", "mppiq")),
    ("configs/point_mass-v0.yml", ("random_shooting", "mppi", "cem")),
    ("configs/trajopt_reacher-v0.yml", ("mppi", "random_shooting", "cem")),
    ("configs/classic_control/acrobot-v0.yml", ("random_shooting", "mppi")),
    ("configs/classic_control/cartpole-v0.yml", ("ilqr", "mppi", "reinforce", "softq")),
])
def test_run_mpc_runs_a_step_of_each_controller(tmp_path, src, controllers):
    path = _one_step_config(tmp_path, src)
    results = run_mpc.main(["--config", path, "--controller", ",".join(controllers),
                            "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert tuple(results) == controllers
    for out in results.values():
        assert out["rewards"].shape == (1, 1) and np.isfinite(out["rewards"]).all()


@pytest.mark.parametrize("controllers", ["ilqr,softq", "softq"], ids=["ilqr", "softq"])
def test_run_mpc_raises_for_the_sawyer_reacher_controllers_not_ported(tmp_path, controllers):
    """softq is ported: run_mpc builds and runs the sawyer reacher's softq
    section (after ilqr when both are asked for), cut to N = 8, H = 4 and
    one step, with finite rewards; its solver is a SoftQMPC with the
    section's 8 gradient steps and clip. (The name is the test's from
    before softq was ported, when these cases had to raise.)"""
    path = _one_step_config(tmp_path, "configs/sawyer/sawyer_reacher-v0.yml")
    results = run_mpc.main(["--config", path, "--controller", controllers, "--device", DEVICE,
                            "--save_dir", str(tmp_path)])
    assert tuple(results) == tuple(controllers.split(","))
    for out in results.values():
        assert out["rewards"].shape == (1, 1) and np.isfinite(out["rewards"]).all()
    exp = cfg.load_config("configs/sawyer/sawyer_reacher-v0.yml")
    solver = cfg.make_solver_for_env(exp, "softq", envs.make(exp["env_name"], device=DEVICE))
    assert isinstance(solver, solvers.SoftQMPC)
    assert (solver.n_grad_steps, solver.grad_clip, solver.num_particles) == (8, 10.0, 64)


def test_env_names_are_the_jax_registry():
    ported, missing = set(envs.available()), set(envs.NOT_PORTED)
    assert not ported & missing and len(missing) == len(envs.NOT_PORTED)
    assert ported | missing == set(jenvs.available())


def test_register_adds_and_replaces_an_env():
    calls = []

    def factory(device="cuda"):
        calls.append(device)
        return envs.make("SimplePendulum-v0", device=device, max_episode_steps=7)

    envs.register("pendulum_short-v0", factory)
    try:
        env = envs.make("pendulum_short-v0", device=DEVICE)
        assert env.max_episode_steps == 7 and env is envs.make("pendulum_short-v0",
                                                                device=DEVICE)
        envs.register("pendulum_short-v0", lambda device="cuda": envs.make(
            "SimplePendulum-v0", device=device, max_episode_steps=9))
        assert envs.make("pendulum_short-v0", device=DEVICE).max_episode_steps == 9
        assert calls == [DEVICE]
    finally:
        envs._REGISTRY.pop("pendulum_short-v0")
        envs._CACHE.pop(("pendulum_short-v0", DEVICE), None)
