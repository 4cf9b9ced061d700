"""B episodes as one batched episode (harness/episode.py
build_batched_episode_fn, run_episodes(batched=...), parallel's
build_batch_episode_fn) on the CPU, where the batched control step is the
card's: one batched solve on the plain batched kernels (its update through
torch.func.vmap) and one real env step of the stacked state.

- run_episodes(batched=True) against batched=False on the reacher, Swimmer
  and the pendulum at K = 3 steps: the same keys, formats and shapes,
  `batched` telling which ran, every record, state and final solver state
  within 2.3e-6 (the MPPI update's tolerance: vmapped reductions may sum
  in another order). The swimmer's first step is held there too; its
  engine step of the stacked state rounds otherwise than the single step
  (7e-7 on qvel), which its chaotic loop at the config's lam 0.01 grows to
  1.8e-5 on the second action, so its K = 3 records are held to 1e-4 and
  its states (velocities up to 20) to 1e-4 plus 1e-4 relative;
- in each of K = 3 batched control steps every element's solve against its
  single solve from the same states, within 2.3e-6, and the new states
  those of the env's step of the stacked state, on all three envs;
- guard_finite over a batch: a rollout that gives NaN for one element
  resets that element alone;
- NotImplementedError from batched=True for PFMPC, MPPIQ with a Q and
  Reinforce (batched=None runs their loop);
- run_mpc.main on a reduced config with n_episodes 2; parallel's
  build_batch_episode_fn on CPU meshes, each episode row a contiguous
  slice of the episodes, particles split over a row's two devices.
"""
import dataclasses

import numpy as np
import pytest
import torch
import yaml

from mjmpc_tpu_torch import envs, parallel, rng, solvers
from mjmpc_tpu_torch.harness import episode, run_mpc

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
K = 3
UPDATE_ATOL = 2.3e-6
SWIMMER_ATOL = 1e-4   # the swimmer's K = 3 records; its states 1e-4 + 1e-4 relative
RECORDS = ("rewards", "actions", "values", "dones", "successes")
SEEDS = [7, 7 + 12345, 7 + 2 * 12345]


def _mppi(env, **kw):
    cfg = dict(d_action=env.d_action, horizon=4, num_particles=16, lam=0.01, init_cov=3.0,
               step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat",
               device=DEVICE)
    cfg.update(kw)
    return solvers.MPPI(**cfg)


ENVS = ("reacher_7dof-v0", "Swimmer-v0", "SimplePendulum-v0")


def _close(got, want, atol, what, rtol=0.0):
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", ENVS)
def test_batched_run_episodes_equals_the_loop(name):
    env = envs.make(name, device=DEVICE)
    solver = _mppi(env)
    atol, rtol = (SWIMMER_ATOL, SWIMMER_ATOL) if name == "Swimmer-v0" else (UPDATE_ATOL, 0.0)
    loop = episode.run_episodes(solver, env, 3, K, base_seed=7, batched=False)
    batch = episode.run_episodes(solver, env, 3, K, base_seed=7, batched=True)
    default = episode.run_episodes(solver, env, 3, K, base_seed=7)
    assert batch.keys() == loop.keys() == default.keys()
    assert (loop["batched"], batch["batched"], default["batched"]) == (False, True, True)
    for k in RECORDS + ("ep_rewards",):
        assert batch[k].shape == loop[k].shape and batch[k].dtype == loop[k].dtype, k
        np.testing.assert_array_equal(default[k], batch[k], err_msg=k)
        if k == "ep_rewards":
            _close(batch[k], loop[k], K * atol, k)
            continue
        _close(batch[k][:, :1], loop[k][:, :1], UPDATE_ATOL, k)     # the first step
        _close(batch[k], loop[k], atol, k)
    assert batch["rewards"].shape == (3, K) and batch["actions"].shape == (3, K, env.d_action)
    for k in ("average_reward", "reward_std", "success_metric"):
        assert abs(batch[k] - loop[k]) <= 2 * K * atol, k
    for got, want in zip(batch["states"], loop["states"]):   # one env state an episode
        assert type(got) is type(want)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.shape == b.shape and a.dtype == b.dtype, f.name
                _close(a, b, atol, f.name, rtol)
            else:
                assert a == b, f.name          # each episode's own host values
    for got, want in zip(batch["final_solver_states"], loop["final_solver_states"]):
        assert isinstance(got, solvers.GaussianState) and got.seed == want.seed
        assert torch.equal(got.step, want.step)
        for f in ("mean", "cov"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ENVS)
def test_vectorised_batched_step_matches_single_steps(name):
    """K = 3 batched control steps of the card's path, each from the last
    one's states: each element's action, value and new mean against its
    single guarded solve from the same states (2.3e-6), and the new states,
    rewards and dones those of the env's step of the stacked state under
    the batch's clipped actions, bit for bit."""
    env = envs.make(name, device=DEVICE)
    solver = _mppi(env)
    batched = episode._build_batched_step_fn(solver, env)
    single = solvers.guard_finite(solvers.make_solve_fn(solver, env), solver)
    es = solvers.stack_states([env.init(env.params, rng.derive_seed(s, 0)) for s in SEEDS])
    batch = solver.init_batch([rng.derive_seed(s, 1) for s in SEEDS])
    for _ in range(K):
        want = [single(env.params, solvers.map_tensors(lambda t: t[i], es), s)
                for i, s in enumerate(batch.unstack())]
        before = es
        es, batch, out = batched(env.params, env.params, es, batch)
        stepped = env.step(env.params, before, out["action"])
        for i, (action, value, state) in enumerate(want):
            torch.testing.assert_close(out["action"][i], env.clip_action(action), rtol=0,
                                       atol=UPDATE_ATOL)
            torch.testing.assert_close(out["value"][i], value, rtol=0, atol=UPDATE_ATOL)
            torch.testing.assert_close(batch.mean[i], state.mean, rtol=0, atol=UPDATE_ATOL)
            assert torch.equal(batch.step[i], state.step)
        assert solvers.tensor_leaves(es).keys() == solvers.tensor_leaves(stepped[0]).keys()
        for k, v in solvers.tensor_leaves(stepped[0]).items():
            assert torch.equal(solvers.tensor_leaves(es)[k], v), k
        assert torch.equal(out["reward"], stepped[2]) and torch.equal(out["done"], stepped[3])
    assert batch.step.tolist() == [K] * 3


def _nan_for(element, env):
    """env whose batched fused rollout gives NaN costs for one element."""
    base = env.fused_rollout

    def fused(p, state, mean, noise):
        return base(p, state, mean, noise)

    def batched(p, states, means, noises):
        costs = base.batched(p, states, means, noises).clone()
        costs[element] = float("nan")
        return costs

    fused.batched = batched
    return dataclasses.replace(env, fused_rollout=fused)


def test_guard_resets_only_the_element_that_failed():
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    bad = _nan_for(1, env)
    solver = _mppi(env)
    start = solver.init_batch([1, 2, 3])
    start = dataclasses.replace(start, mean=torch.full_like(start.mean, 0.5),
                                cov=2.0 * start.cov, step=torch.tensor([4, 5, 6]))
    es = solvers.stack_states([env.init(env.params, s) for s in (1, 2, 3)])
    solve = solvers.build_batched_solve_fn(solver, bad).vectorised
    guarded = solvers.guard_finite(solve, solver)
    raw_action, raw_value, raw = solve(env.params, es, start)
    assert not bool(torch.isfinite(raw_action[1]).all())
    action, value, new = guarded(env.params, es, start)
    fresh = solver.init_state(0)
    assert torch.equal(action[1], torch.zeros(1)) and float(value[1]) == 0.0
    assert torch.equal(new.mean[1], fresh.mean) and torch.equal(new.cov[1], fresh.cov)
    for i in (0, 2):     # the others keep their solve's results
        assert torch.equal(action[i], raw_action[i]) and torch.equal(value[i], raw_value[i])
        assert torch.equal(new.mean[i], raw.mean[i]) and torch.equal(new.cov[i], raw.cov[i])
    assert new.step.tolist() == [5, 6, 7] and new.seeds == start.seeds
    assert torch.equal(new.keys, start.keys)
    # a guarded batched episode plays the zero action for that element alone
    run = episode.build_batched_episode_fn(solver, bad, 2)
    records = run(env.params, env.params, [1, 2, 3])[0]
    assert torch.equal(records["action"][1], torch.zeros(2, 1))
    assert bool((records["action"][0] != 0).all()) and bool((records["action"][2] != 0).all())


def test_batched_true_raises_for_solvers_without_a_batched_update():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    cfg = dict(d_action=7, horizon=3, num_particles=8, device=DEVICE)
    q_fn = lambda obs, actions: torch.zeros(obs.shape[:-1])   # noqa: E731
    for solver in (solvers.PFMPC(**cfg),
                   solvers.MPPIQ(**cfg, q_fn=q_fn),
                   solvers.Reinforce(d_obs=env.d_obs, **cfg)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
            episode.run_episodes(solver, env, 2, 2, batched=True)
        assert episode.batch_coverage(solver, env) is not None
    pf = episode.run_episodes(solvers.PFMPC(**cfg), env, 2, 2)
    assert pf["batched"] is False and pf["rewards"].shape == (2, 2)
    # planning on params the kernel does not read takes the general rollout
    swim = envs.make("Swimmer-v0", device=DEVICE)
    other = dataclasses.replace(swim.params, drag_perp=2.0 * swim.params.drag_perp)
    with pytest.raises(NotImplementedError, match="general rollout"):
        episode.run_episodes(_mppi(swim), swim, 2, 2, sim_params=other, batched=True)
    with pytest.raises(NotImplementedError):     # an env without a fused rollout
        episode.build_batched_episode_fn(_mppi(envs.make("point_mass-v0", device=DEVICE)),
                                         envs.make("point_mass-v0", device=DEVICE), 2)


def test_run_mpc_runs_its_episodes_batched(tmp_path):
    with open("configs/SimplePendulum-v0.yml") as f:
        exp = yaml.safe_load(f)
    exp.update(n_episodes=2, max_ep_length=3)
    exp["mppi"].update(horizon=4)
    path = tmp_path / "pendulum.yml"
    path.write_text(yaml.safe_dump(exp))
    out = run_mpc.main(["--config", str(path), "--controller", "mppi,pfmpc", "--device", DEVICE,
                        "--save_dir", str(tmp_path)])
    assert out["mppi"]["batched"] is True and out["pfmpc"]["batched"] is False
    for name, res in out.items():
        assert res["rewards"].shape == (2, 3) and np.isfinite(res["rewards"]).all()
        log = open(f"{res['log_dir']}/{name}_SimplePendulum-v0.log").read()
        assert ("as one batched episode" in log) == (name == "mppi")
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    from mjmpc_tpu_torch.harness import config as cfg
    solver = cfg.make_solver_for_env(cfg.load_config(str(path)), "mppi", env)
    loop = episode.run_episodes(solver, env, 2, 3, base_seed=exp["seed"], batched=False)
    np.testing.assert_allclose(out["mppi"]["rewards"], loop["rewards"], rtol=0, atol=UPDATE_ATOL)


def test_batch_episode_rows_take_contiguous_slices():
    """Two episode rows of one device each take seeds [0:2] and [2:3]; a row
    of two devices splits each solve's particles; both equal the unsharded
    batched episodes of the same seeds bit for bit, and each episode the
    single sharded episode of its seed within 2.3e-6."""
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    solver = solvers.MPPI(d_action=7, horizon=4, num_particles=8, lam=0.1, device=DEVICE)
    seeds = [3, 8, 21]
    rows = parallel.make_mesh(episodes=2, devices=["cpu", "cpu"])
    assert [(s.start, s.stop) for s in parallel.sharded._batch_rows(3, 2)] == [(0, 2), (2, 3)]
    wide = parallel.make_mesh(devices=["cpu", "cpu"])
    unsharded = episode.build_batched_episode_fn(solver, env, 3)
    whole = unsharded(env.params, env.params, seeds)[0]
    parts = [unsharded(env.params, env.params, part)[0] for part in (seeds[:2], seeds[2:])]
    for mesh, want_batch in ((rows, {k: torch.cat([p[k] for p in parts]) for k in whole}),
                             (wide, whole)):
        batch = parallel.build_batch_episode_fn(solver, env, 3, mesh)(env.params, seeds)
        assert batch.keys() == want_batch.keys()
        for k, v in want_batch.items():
            assert batch[k].shape[:2] == (3, 3) and torch.equal(batch[k], v), k
        single = parallel.build_sharded_episode_fn(solver, env, 3, mesh.row(0))
        for b, seed in enumerate(seeds):
            for k, v in single(env.params, seed).items():
                _close(batch[k][b].numpy(), v.numpy(), UPDATE_ATOL, (k, b))
    # the sharded batched hook splits the particles (axis 1 of the noise)
    sharded = parallel.shard_env(env, wide, 8)
    es = solvers.stack_states([env.init(env.params, s) for s in seeds])
    means = torch.randn(3, 4, 7, generator=torch.Generator().manual_seed(0)) * 0.3
    noise = torch.randn(3, 8, 4, 7, generator=torch.Generator().manual_seed(1)) * 0.3
    assert torch.equal(sharded.fused_rollout.batched(env.params, es, means, noise),
                       env.fused_rollout.batched(env.params, es, means, noise))
