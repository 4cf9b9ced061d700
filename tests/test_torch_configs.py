"""Every experiment config under configs/ in the port's config driver
(harness/config.py, run_mpc.py), after tests/test_reference_configs.py:
each controller section builds its solver, cut to N = 8, H = 4, and its
solve, or raises NotImplementedError because the port lacks the env
(envs.NOT_PORTED) or the controller (solvers.NOT_PORTED). A ValueError
(an unknown env or controller) fails. The configs whose every part is
ported also run through run_mpc, cut to one step; SimplePendulum-v0's
five controllers among them, and the analytic configs' (cartpole's iLQR
among them).

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
# The configs whose env and every controller are ported.
LOADING = ["configs/HalfCheetah-v0.yml", "configs/SimplePendulum-v0.yml",
           "configs/Swimmer-v0.yml", "configs/cartpole-v0_cl.yml",
           "configs/classic_control/acrobot-v0.yml", "configs/hand/door-v0.yml",
           "configs/hand/hammer-v0.yml", "configs/hand/pen-v0.yml",
           "configs/hand/relocate-v0.yml", "configs/panda/reacher-v0.yml",
           "configs/panda/tray_glass-v0.yml", "configs/panda/tray_glass-v1.yml",
           "configs/panda/tray_glass-v1_biased_model.yml",
           "configs/panda/tray_glass_fixed-v1.yml", "configs/point_mass-v0.yml",
           "configs/reacher_7dof-v0.yml", "configs/sawyer/sawyer_door-v0.yml",
           "configs/sawyer/sawyer_peg_insertion-v0.yml",
           "configs/sawyer/sawyer_peg_insertion-v0_cl.yml",
           "configs/sawyer/sawyer_peg_insertion-v1.yml", "configs/sawyer/sawyer_pusher-v0.yml",
           "configs/trajopt_reacher-v0.yml", "configs/tune/door-v0.yml",
           "configs/tune/door-v0_grid3.yml", "configs/tune/hammer-v0.yml",
           "configs/tune/relocate-v0.yml", "configs/tune/tray_glass-v0.yml"]


def _not_ported(exp, controller):
    return exp["env_name"] in envs.NOT_PORTED or controller in solvers.NOT_PORTED


def test_every_experiment_config_is_enumerated():
    paths = {p for p, _ in EXPERIMENTS}
    assert len(paths) == 29 and len(EXPERIMENTS) == 70
    loading = sorted(p for p in paths if not any(
        _not_ported(cfg.load_config(p), c) for q, c in EXPERIMENTS if q == p))
    assert loading == LOADING


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
    ("configs/classic_control/cartpole-v0.yml", ("ilqr", "mppi", "reinforce")),
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
    """softq is not ported: run_mpc raises, and builds every controller's
    solver before it runs any, so with ilqr (ported since) first in the
    list it raises before an iLQR episode starts."""
    with pytest.raises(NotImplementedError, match="softq"):
        run_mpc.main(["--config", "configs/sawyer/sawyer_reacher-v0.yml", "--controller",
                      controllers, "--device", DEVICE, "--save_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())     # no log directory: nothing ran


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
