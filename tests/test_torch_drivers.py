"""The port's experiment drivers and their helpers, on the CPU:
utils/helpers.py against the JAX helpers; harness/checkpoint.py (a round
trip restores every field, the seed and the step, and the next solve after
a save and a load equals, bit for bit, the solve that continues without
them) and run_mpc --checkpoint; harness/run_mpc_cl.py (build_cl_solver
against the JAX package's on both closed-loop configs, its ValueError, and
main on both configs cut to 2 control steps, with a finite fit error);
harness/jobs.py (its grid axes against the JAX package's on every config,
the tune rules and the sweep's pairing, and main in tune and in sweep
mode on the pendulum config cut to 2 cells x 1 episode x 2 steps).
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.harness import jobs as jjobs
from mjmpc_tpu.harness import run_mpc_cl as jrun_mpc_cl
from mjmpc_tpu.utils import helpers as jhelpers
from mjmpc_tpu_torch import envs, solvers
from mjmpc_tpu_torch.harness import checkpoint, jobs, run_mpc, run_mpc_cl
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.utils import helpers

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
CL_CONFIGS = ("configs/cartpole-v0_cl.yml", "configs/sawyer/sawyer_peg_insertion-v0_cl.yml")
PENDULUM = "configs/SimplePendulum-v0.yml"


# ---- helpers -----------------------------------------------------------------

def test_helpers_match_jax():
    r = np.random.default_rng(0)
    dicts = [dict(a=r.normal(size=3), b=dict(c=r.normal(size=(2, 2)), d=float(i)))
             for i in range(4)]
    want = jhelpers.stack_tensor_dict_list(dicts)
    got = helpers.stack_tensor_dict_list(dicts)
    np.testing.assert_array_equal(got["a"], want["a"])
    np.testing.assert_array_equal(got["b"]["c"], want["b"]["c"])
    np.testing.assert_array_equal(got["b"]["d"], want["b"]["d"])
    tensors = [dict(x=torch.as_tensor(d["a"])) for d in dicts]
    stacked = helpers.stack_tensor_dict_list(tensors)["x"]
    assert isinstance(stacked, torch.Tensor) and stacked.shape == (4, 3)
    np.testing.assert_array_equal(stacked.numpy(), want["a"])
    np.testing.assert_array_equal(helpers.stack_tensor_list([1.0, 2.0]),
                                  jhelpers.stack_tensor_list([1.0, 2.0]))


# ---- checkpoint --------------------------------------------------------------

def _pendulum_mppi():
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    exp = cfg.load_config(PENDULUM)
    return env, cfg.make_solver_for_env(exp, "mppi", env)


def _assert_identical(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("family", ["mppi", "ilqr", "reinforce"])
def test_checkpoint_round_trip_and_the_next_solve_bit_for_bit(tmp_path, family):
    if family == "mppi":
        env, solver = _pendulum_mppi()
    elif family == "ilqr":
        env = envs.make("cartpole-v0", device=DEVICE)
        solver = solvers.ILQR(d_action=1, horizon=8, n_iters=2, device=DEVICE)
    else:
        env = envs.make("cartpole-v0", device=DEVICE)
        solver = run_mpc_cl.build_cl_solver(dict(
            cfg.load_config(CL_CONFIGS[0]), reinforce=dict(
                cfg.load_config(CL_CONFIGS[0])["reinforce"], horizon=6, num_cpu=1,
                particles_per_cpu=8, n_iters=2)), "reinforce", env)
    solve = solvers.make_solve_fn(solver, env)
    es = env.init(env.params, 1)
    state = solver.init_state(11)
    for _ in range(3):
        _, _, state = solve(env.params, es, state)
    path = str(tmp_path / "ckpt" / "solver_state")
    checkpoint.save_solver_state(path, state, metadata=dict(controller=family))
    assert os.path.exists(path + ".npz") and os.path.exists(path + ".manifest.json")
    like = solver.init_state(0)
    restored = checkpoint.load_solver_state(path, like)
    _assert_identical(restored, state)
    assert restored.seed == 11 and int(restored.step) == 3 and like.seed == 0
    a_cont, v_cont, s_cont = solve(env.params, es, state)
    a_rest, v_rest, s_rest = solve(env.params, es, restored)
    assert torch.equal(a_cont, a_rest) and torch.equal(v_cont, v_rest)
    _assert_identical(s_rest, s_cont)
    manifest = json.load(open(path + ".manifest.json"))
    assert manifest["metadata"] == dict(controller=family)


def test_checkpoint_of_a_list_and_a_mismatched_example(tmp_path):
    env, solver = _pendulum_mppi()
    states = [solver.init_state(s) for s in (1, 2)]
    path = str(tmp_path / "states.npz")
    checkpoint.save_solver_state(path, states)
    back = checkpoint.load_solver_state(path, [solver.init_state(0)] * 2)
    assert [s.seed for s in back] == [1, 2]
    for a, b in zip(back, states):
        _assert_identical(a, b)
    with pytest.raises(ValueError):
        checkpoint.load_solver_state(path, [solver.init_state(0)] * 3)
    ilqr = solvers.ILQR(d_action=1, horizon=4, device=DEVICE)
    with pytest.raises(ValueError):
        checkpoint.load_solver_state(path, [ilqr.init_state(0)] * 2)


def _cut(tmp_path, src, steps=2, cells=None, **section):
    """src's config cut to one episode of `steps` steps, its controller
    sections updated with `section`, written to tmp_path."""
    exp = cfg.load_config(src)
    exp.update(n_episodes=1, max_ep_length=steps)
    for k, v in exp.items():
        if isinstance(v, dict) and "horizon" in v:
            v.update(section)
    path = tmp_path / os.path.basename(src)
    path.write_text(yaml.safe_dump(exp))
    return str(path)


def test_run_mpc_checkpoint_writes_both_files(tmp_path):
    path = _cut(tmp_path, PENDULUM, horizon=4, num_cpu=1, particles_per_cpu=6)
    out = run_mpc.main(["--config", path, "--controller", "mppi,pfmpc", "--checkpoint",
                        "--device", DEVICE, "--save_dir", str(tmp_path)])
    for name, res in out.items():
        base = os.path.join(res["log_dir"], "solver_state")
        assert os.path.exists(base + ".npz") and os.path.exists(base + ".manifest.json")
        solver = cfg.make_solver_for_env(cfg.load_config(path), name,
                                         envs.make("SimplePendulum-v0", device=DEVICE))
        back = checkpoint.load_solver_state(base, [solver.init_state(0)])
        _assert_identical(back[0], res["final_solver_states"][0])
        assert int(back[0].step) == 2
        assert json.load(open(base + ".manifest.json"))["metadata"]["controller"] == name


# ---- run_mpc_cl -------------------------------------------------------------------

@pytest.mark.parametrize("src", CL_CONFIGS)
def test_build_cl_solver_matches_jax(src):
    exp = cfg.load_config(src)
    solver = run_mpc_cl.build_cl_solver(exp, "reinforce", envs.make(exp["env_name"],
                                                                    device=DEVICE))
    jsolver = jrun_mpc_cl.build_cl_solver(exp, "reinforce", jenvs.make(exp["env_name"]))
    assert isinstance(solver, solvers.Reinforce) and solver.baseline_type == "quadratic"
    assert solver.init_cov == jsolver.init_cov == 1.0
    for f in ("d_obs", "d_action", "horizon", "num_particles", "lr", "beta", "gamma",
              "n_iters", "init_cov", "baseline_type", "delta_kl", "max_linesearch_iters",
              "delta_reg", "filter_coeffs", "sample_mode"):
        assert getattr(solver, f) == getattr(jsolver, f), f
    # init_cov = exp(2 init_log_std) as a default
    exp["actor_params"] = dict(exp["actor_params"], init_log_std=-0.5)
    solver = run_mpc_cl.build_cl_solver(exp, "reinforce", envs.make(exp["env_name"],
                                                                    device=DEVICE))
    assert solver.init_cov == pytest.approx(np.exp(-1.0))


def test_build_cl_solver_rejects_other_actors():
    exp = cfg.load_config(CL_CONFIGS[0])
    exp["actor_params"] = dict(exp["actor_params"], actor_type="mlp")
    with pytest.raises(ValueError, match="linear_gaussian"):
        run_mpc_cl.build_cl_solver(exp, "reinforce", envs.make("cartpole-v0", device=DEVICE))


@pytest.mark.parametrize("src", CL_CONFIGS)
def test_run_mpc_cl_main_runs_two_steps(tmp_path, src):
    path = _cut(tmp_path, src, horizon=6, num_cpu=1, particles_per_cpu=8)
    out = run_mpc_cl.main(["--config", path, "--device", DEVICE, "--save_dir", str(tmp_path)])
    res = out["reinforce"]
    assert res["ep_rewards"].shape == (1,) and np.isfinite(res["ep_rewards"]).all()
    assert np.isfinite(res["fit_errors"]).all() and (res["fit_errors"] > 0).all()
    name = cfg.load_config(src)["env_name"]
    with open(os.path.join(res["log_dir"], f"reinforce_cl_{name}.csv")) as f:
        assert "AvgBaselineFitError" in f.readline()


# ---- jobs -------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob("configs/**/*.yml", recursive=True)))
def test_grid_axes_match_jax(path):
    exp = cfg.load_config(path)
    for k, v in exp.items():
        if isinstance(v, dict) and "horizon" in v:
            for tune_keys in (None, v.get("tune_keys"), ["horizon"]):
                assert jobs._list_keys(v, tune_keys) == jjobs._list_keys(v, tune_keys)


def _fake_cells(monkeypatch, successes):
    """run_cell replaced by a record of its overrides; the i-th cell scores
    -i and the success given."""
    seen = []

    def run_cell(exp_params, controller_name, env, overrides, sim_params=None):
        seen.append(overrides)
        i = len(seen) - 1
        return dict(average_reward=float(-abs(i - 1)), reward_std=0.0,
                    success_metric=successes[i])

    monkeypatch.setattr(jobs, "run_cell", run_cell)
    return seen


def test_tune_grid_best_and_early_stop(tmp_path, monkeypatch):
    exp = cfg.load_config("configs/tune/tray_glass-v0.yml")
    seen = _fake_cells(monkeypatch, [0.0] * 16)
    best, history = jobs.tune(exp, "mppi", None, str(tmp_path))
    assert len(seen) == 16 and seen[0] == dict(horizon=20, n_iters=1, lam=0.02,
                                                particles_per_cpu=64)
    assert best["params"] == seen[1] and best["reward"] == 0.0
    assert json.load(open(tmp_path / "best_params.json"))["best"]["params"] == seen[1]
    seen = _fake_cells(monkeypatch, [0.0, 96.0] + [0.0] * 14)
    _, history = jobs.tune(exp, "mppi", None, str(tmp_path))
    assert len(history) == 2        # stopped above 95% success


def test_sweep_pairs_the_ith_entries(tmp_path, monkeypatch):
    exp = cfg.load_config(PENDULUM)
    exp["mppi"] = dict(exp["mppi"], horizon=[8, 16, 32], lam=[0.1, 0.01, 0.001])
    seen = _fake_cells(monkeypatch, [0.0] * 3)
    rows = jobs.sweep(exp, "mppi", None, str(tmp_path))
    assert seen == [dict(horizon=8, lam=0.1), dict(horizon=16, lam=0.01),
                    dict(horizon=32, lam=0.001)]
    assert len(rows) == 3 and len(json.load(open(tmp_path / "sweep_results.json"))) == 3
    exp["mppi"]["lam"] = [0.1, 0.01]
    with pytest.raises(ValueError, match="equal length"):
        jobs.sweep(exp, "mppi", None, str(tmp_path))


@pytest.mark.parametrize("mode", ["tune", "sweep"])
def test_jobs_main_on_the_pendulum_config(tmp_path, mode):
    path = _cut(tmp_path, PENDULUM, horizon=4, num_cpu=1, particles_per_cpu=6,
                lam=[0.01, 0.1])
    out = jobs.main(["--config", path, "--controller", "mppi", "--job_mode", mode,
                     "--device", DEVICE, "--save_dir", str(tmp_path)])
    rows = out["mppi"][1] if mode == "tune" else out["mppi"]
    assert [r["params"] for r in rows] == [dict(lam=0.01), dict(lam=0.1)]
    assert all(np.isfinite(r["average_reward"]) for r in rows)
    if mode == "tune":
        best = out["mppi"][0]
        assert best["reward"] == max(r["average_reward"] for r in rows)
    with pytest.raises(ValueError, match="job_mode"):
        jobs.main(["--config", path, "--job_mode", "grid", "--device", DEVICE])
