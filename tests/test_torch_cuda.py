"""The CUDA kernels on the card (chain rollout, chain rollout with
observations, closed-loop chain rollout for the reacher and peg tasks,
filtered noise, the locomotion rollout for the swimmer and the half
cheetah, the forest rollout for pen-v0 and the sawyer peg, the pendulum
rollout and the one-kernel pendulum MPPI solve): each against its plain
PyTorch version, their launch counts on sync-free solves, and the
wrappers' checks.

Needs a CUDA card and skips without one (the kernel has no CPU mode). This
file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: atol 5e-5 at (N=37, H=5), the JAX kernel's own tolerance; 1e-3
at the main path's (N=4096, H=32), where the longer horizon accumulates
f32 reordering on costs of order 1-10. Noise: atol 1e-4 (identical
uniforms; libm ulps and the order of sums differ, scaled by the filter's
gain of about 1.25 and by sqrt(3) for cov 3 I). Locomotion: the swimmer
atol 5e-5 at (37, 5) and 1e-3 at its config's (512, 32); the cheetah, whose
stiff contact (kp 6000, 25 substeps per step) amplifies f32 reordering,
5e-4 and 1e-2 of max(1, |cost|) at (37, 5) and its config's (512, 16).
Forest: the peg 5e-5 at (37, 5) and 1e-3 at its config's (256, 16); pen,
from a pinch in which every fingertip presses on the pen (so that the
costs follow the hand's dynamics through contact), 1e-4 at (37, 5); at its
config's (256, 16), 80 substeps of contact, at least 99% of the costs
within 1e-3 and every other one off by a bonus step of the gated pen cost
(a signed sum of 5, 10 and 50) to within 1e-3. Pendulum rollout: atol
1e-5 from a start that crosses -pi (th0 = -3.0, thdot0 = -8), at (37, 5)
and (4096, 32). One-kernel MPPI solve: atol 1e-5 on the new mean at N =
1024 and 2048, H = 32, lam 0.01 and 1.0 (the same Philox normals and the
same rollout operations; only the order of the particle sums differs).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mjmpc_tpu_torch import envs, solvers
from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
from mjmpc_tpu_torch.envs import half_cheetah, pen, sawyer_tasks, swimmer
from mjmpc_tpu_torch.ops.chain_rollout import (ChainClRollout, ChainExtRollout, ChainObsRollout,
                                               ChainRollout, build_chain_cl_rollout,
                                               build_chain_obs_rollout, build_chain_rollout)
from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout, gated_cost_agreement
from mjmpc_tpu_torch.ops.noise import FilteredNoise
from mjmpc_tpu_torch.ops.pendulum import (MppiPendulumSolve, PendulumRollout,
                                          mppi_pendulum_solve, pendulum_rollout)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(n, h, seed, device):
    rng = np.random.default_rng(seed)
    mean = np.asarray(rng.normal(size=(h, 7)) * 0.3, np.float32)
    noise = np.asarray(rng.normal(size=(n, h, 7)) * 0.5, np.float32)
    q0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    qd0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    target = np.array([0.2, -0.1, 0.15], np.float32)
    return [torch.as_tensor(a, device=device) for a in (q0, qd0, target, mean, noise)]


@pytest.mark.parametrize("n,h,tol", [(37, 5, 5e-5), (4096, 32, 1e-3)])
def test_kernel_matches_plain(device, n, h, tol):
    roll = build_chain_rollout(envs.make("reacher_7dof-v0", device=device).params.model,
                               n_substeps=2)
    args = _inputs(n, h, 0, device)
    before = ChainRollout.launches
    got = roll(*args)
    assert ChainRollout.launches == before + 1
    torch.testing.assert_close(got, roll.plain(*args), rtol=0, atol=tol)


def test_wrapper_rejects_non_contiguous_noise(device):
    roll = build_chain_rollout(envs.make("reacher_7dof-v0", device=device).params.model,
                               n_substeps=2)
    q0, qd0, target, mean, noise = _inputs(8, 4, 1, device)
    noise = noise.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        roll(q0, qd0, target, mean, noise)


def test_solves_launch_the_kernel_without_host_syncs(device):
    env = envs.make("reacher_7dof-v0", device=device)
    solver = solvers.MPPI(d_action=7, horizon=8, num_particles=256, lam=0.01,
                          init_cov=3.0, step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0),
                          base_action="repeat", device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state = env.init(env.params, 1)
    state = solver.init_state(0)
    before = ChainRollout.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, state = solve(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ChainRollout.launches == before + 3
    assert bool(torch.isfinite(action).all())


@pytest.mark.parametrize("n,h,tol", [(37, 5, 5e-5), (4096, 32, 1e-3)])
def test_obs_kernel_matches_plain(device, n, h, tol):
    roll = build_chain_obs_rollout(envs.make("reacher_7dof-v0", device=device).params.model,
                                   n_substeps=2)
    args = _inputs(n, h, 2, device)
    before = ChainObsRollout.launches
    obs, costs = roll(*args)
    assert ChainObsRollout.launches == before + 1
    want_obs, want_costs = roll.plain(*args)
    torch.testing.assert_close(obs, want_obs, rtol=0, atol=tol)
    torch.testing.assert_close(costs, want_costs, rtol=0, atol=tol)


@pytest.mark.parametrize("n,h", [(37, 5), (4096, 32)])
def test_noise_kernel_matches_plain(device, n, h):
    sampler = FilteredNoise()
    cov = 3.0 * torch.eye(7, device=device)
    before = FilteredNoise.launches
    got = sampler(12345, cov, (n, h), (0.25, 0.8, 0.0))
    assert FilteredNoise.launches == before + 1
    torch.testing.assert_close(got, sampler.plain(12345, cov, (n, h), (0.25, 0.8, 0.0)),
                               rtol=0, atol=1e-4)


def test_kernel_noise_solves_without_host_syncs(device):
    env = envs.make("reacher_7dof-v0", device=device)
    solver = solvers.MPPI(d_action=7, horizon=8, num_particles=256, lam=0.01,
                          init_cov=3.0, step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0),
                          base_action="repeat", noise_impl="kernel", device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state = env.init(env.params, 1)
    state = solver.init_state(0)
    solver.noise_sampler.library()
    before = (ChainRollout.launches, FilteredNoise.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, state = solve(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ChainRollout.launches, FilteredNoise.launches) == (before[0] + 3, before[1] + 3)
    assert bool(torch.isfinite(action).all())


@pytest.mark.parametrize("name,n,h,tol", [("reacher_7dof-v0", 37, 5, 5e-5),
                                          ("reacher_7dof-v0", 4096, 32, 1e-3),
                                          ("sawyer_peg_insertion-v0", 37, 5, 5e-5),
                                          ("sawyer_peg_insertion-v0", 64, 32, 1e-3)])
def test_cl_kernel_matches_plain(device, name, n, h, tol):
    env = envs.make(name, device=device)
    peg = name.startswith("sawyer_peg")
    roll = build_chain_cl_rollout(env.params.model, n_substeps=2,
                                  task="peg" if peg else "reacher")
    rng = np.random.default_rng(3)
    q0, qd0, target, _, _ = _inputs(1, 1, 4, device)
    extras = peg_extras(env.params) if peg else target
    w = torch.as_tensor(np.asarray(rng.normal(size=(roll.d_obs + 1, 7)) * 0.05, np.float32),
                        device=device)
    noise = torch.as_tensor(np.asarray(rng.normal(size=(n, h, 7)) * 0.3, np.float32),
                            device=device)
    before = ChainClRollout.launches
    got = roll(q0, qd0, extras, w, noise)
    assert ChainClRollout.launches == before + 1
    for x, y in zip(got, roll.plain(q0, qd0, extras, w, noise)):
        torch.testing.assert_close(x, y, rtol=0, atol=tol)


@pytest.mark.parametrize("name,baseline", [("reacher_7dof-v0", "quadratic"),
                                           ("sawyer_peg_insertion-v0", "linear")])
def test_reinforce_solves_launch_the_cl_kernel_without_host_syncs(device, name, baseline):
    env = envs.make(name, device=device)
    solver = solvers.Reinforce(d_obs=env.d_obs, d_action=7, horizon=8, num_particles=256,
                               lr=0.5, n_iters=2, baseline_type=baseline, delta_reg=1e-3,
                               delta_kl=1e-3, filter_coeffs=(0.25, 0.8, 0.0), device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state = env.init(env.params, 1)
    state = solver.init_state(0)
    before = (ChainClRollout.launches, ChainRollout.launches, ChainObsRollout.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, state = solve(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = (ChainClRollout.launches, ChainRollout.launches, ChainObsRollout.launches)
    assert after == (before[0] + 6, before[1], before[2])
    assert bool(torch.isfinite(action).all()) and bool(torch.isfinite(state.fit_error))


_LOCO = {"Swimmer-v0": swimmer, "HalfCheetah-v0": half_cheetah}


def _loco_inputs(nv, n, h, seed, device):
    """q0, qd0 * 0.1, mean * 0.3 and noise * 0.5 with the three unactuated
    base dofs zero, as the envs' fused rollouts pad them."""
    rng = np.random.default_rng(seed)
    q0, qd0 = (np.asarray(rng.normal(size=nv) * 0.1, np.float32) for _ in range(2))
    mean = np.asarray(rng.normal(size=(h, nv)) * 0.3, np.float32)
    noise = np.asarray(rng.normal(size=(n, h, nv)) * 0.5, np.float32)
    mean[:, :3], noise[..., :3] = 0.0, 0.0
    return [torch.as_tensor(a, device=device) for a in (q0, qd0, mean, noise)]


@pytest.mark.parametrize("name,n,h,tol", [("Swimmer-v0", 37, 5, 5e-5),
                                          ("Swimmer-v0", 512, 32, 1e-3),
                                          ("HalfCheetah-v0", 37, 5, 5e-4),
                                          ("HalfCheetah-v0", 512, 16, 1e-2)])
def test_ext_kernel_matches_plain(device, name, n, h, tol):
    env = envs.make(name, device=device)
    roll = _LOCO[name].build_rollout(env.params)
    args = _loco_inputs(env.params.model.nv, n, h, 5, device)
    before = ChainExtRollout.launches
    got = roll(*args)
    assert ChainExtRollout.launches == before + 1
    want = roll.plain(*args)
    scale = torch.clamp(want.abs(), min=1.0) if name == "HalfCheetah-v0" else 1.0
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("name", sorted(_LOCO))
def test_loco_solves_launch_the_ext_kernel_without_host_syncs(device, name):
    env = envs.make(name, device=device)
    solver = solvers.MPPI(d_action=env.d_action, horizon=8, num_particles=256, lam=0.01,
                          init_cov=0.5, step_size=0.55, alpha=1,
                          filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat", device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state = env.init(env.params, 1)
    state = solver.init_state(0)
    before = (ChainExtRollout.launches, ChainRollout.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, state = solve(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ChainExtRollout.launches, ChainRollout.launches) == (before[0] + 3, before[1])
    assert bool(torch.isfinite(action).all())


def _forest_case(name, n, h, seed, device):
    """Kernel #6's wrapper for pen-v0 (the pinch, the hand perturbed by
    U(-0.05, 0.05)) or the peg, and its inputs: mean * 0.2, noise * 0.3 as
    tests/test_pallas_forest.py draws them."""
    rng = np.random.default_rng(seed)
    env = envs.make(name, device=device)
    if name == "pen-v0":
        roll, st = pen.build_rollout(env.params.model), env.init(env.params, seed)
        q0 = pen.pinch_qpos(st.qpos)
        q0[:24] += torch.as_tensor(rng.uniform(-0.05, 0.05, 24), dtype=torch.float32,
                                   device=device)
        head = [q0, st.qvel, pen.pen_extras(env.params, st)]
    else:
        roll = sawyer_tasks.build_rollout(env.params.model)
        head = [torch.as_tensor(np.asarray(rng.normal(size=7) * 0.1, np.float32), device=device)
                for _ in range(2)] + [sawyer_tasks.peg_extras(env.params)]
    d = len(roll.act_bodies)
    tail = [torch.as_tensor(np.asarray(rng.normal(size=shape) * s, np.float32), device=device)
            for shape, s in (((h, d), 0.2), ((n, h, d), 0.3))]
    return roll, head + tail


@pytest.mark.parametrize("name,n,h,tol", [("sawyer_peg_insertion-v0", 37, 5, 5e-5),
                                          ("sawyer_peg_insertion-v0", 256, 16, 1e-3),
                                          ("pen-v0", 37, 5, 1e-4)])
def test_forest_kernel_matches_plain(device, name, n, h, tol):
    roll, args = _forest_case(name, n, h, 6, device)
    before = ForestRollout.launches
    got = roll(*args)
    assert ForestRollout.launches == before + 1
    torch.testing.assert_close(got, roll.plain(*args), rtol=0, atol=tol)


def test_forest_kernel_pen_config_size_agrees_up_to_bonus_steps(device):
    roll, args = _forest_case("pen-v0", 256, 16, 7, device)
    got, want = roll(*args), roll.plain(*args)
    assert bool(torch.isfinite(got).all())
    agree = gated_cost_agreement(got, want)
    assert agree["share_within"] >= 0.99 and agree["other"] == 0, agree


@pytest.mark.parametrize("name", ["pen-v0", "sawyer_peg_insertion-v0"])
def test_forest_solves_launch_the_kernel_without_host_syncs(device, name):
    env = envs.make(name, device=device)
    solver = solvers.MPPI(d_action=env.d_action, horizon=8, num_particles=64, lam=0.05,
                          init_cov=0.5, step_size=0.7, alpha=1, filter_coeffs=(0.25, 0.8, 0.0),
                          base_action="repeat", device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state = env.init(env.params, 1)
    state = solver.init_state(0)
    before = (ForestRollout.launches, ChainRollout.launches, ChainObsRollout.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, state = solve(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = (ForestRollout.launches, ChainRollout.launches, ChainObsRollout.launches)
    assert after == (before[0] + 3, before[1], before[2])
    assert bool(torch.isfinite(action).all())


def _pendulum_case(n, h, seed, device):
    """The pendulum env, the start that crosses -pi, mean * 0.3 and noise."""
    env = envs.make("SimplePendulum-v0", device=device)
    state = dataclasses.replace(env.init(env.params, 0), th=torch.tensor(-3.0, device=device),
                                thdot=torch.tensor(-8.0, device=device))
    rng = np.random.default_rng(seed)
    mean = torch.as_tensor(np.asarray(rng.normal(size=(h, 1)) * 0.3, np.float32), device=device)
    noise = torch.as_tensor(np.asarray(rng.normal(size=(n, h, 1)), np.float32), device=device)
    return env, state, mean, noise


@pytest.mark.parametrize("n,h", [(37, 5), (4096, 32)])
def test_pendulum_kernel_matches_plain(device, n, h):
    env, state, mean, noise = _pendulum_case(n, h, 8, device)
    before = PendulumRollout.launches
    got = pendulum_rollout(env.params, state, mean, noise)
    assert PendulumRollout.launches == before + 1
    want = pendulum_rollout.plain(env.params, state, mean, noise)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    zeroed = pendulum_rollout.plain(env.params, state, mean, torch.zeros_like(noise))
    assert float((zeroed - got).abs().max()) > 1e-4


@pytest.mark.parametrize("n,lam", [(1024, 0.01), (1024, 1.0), (2048, 0.01), (2048, 1.0)])
def test_one_kernel_solve_matches_plain(device, n, lam):
    env, state, mean, _ = _pendulum_case(1, 32, 9, device)
    args = (env.params, state, mean, 77, n, (0.25, 0.8, 0.0), float(np.sqrt(3.5)), lam, 0.55,
            1.0)
    before = MppiPendulumSolve.launches
    got = mppi_pendulum_solve(*args)
    assert MppiPendulumSolve.launches == before + 1
    torch.testing.assert_close(got, mppi_pendulum_solve.plain(*args), rtol=0, atol=1e-5)
    other = mppi_pendulum_solve.plain(*args[:3], 78, *args[4:])
    assert float((other - got).abs().max()) > 1e-4


def test_pendulum_solves_launch_the_kernels_without_host_syncs(device):
    env = envs.make("SimplePendulum-v0", device=device)
    solver = solvers.MPPI(d_action=1, horizon=32, num_particles=24, lam=0.01, init_cov=3.5,
                          step_size=0.55, alpha=1, filter_coeffs=(0.25, 0.8, 0.0),
                          base_action="repeat", device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state, state = env.init(env.params, 1), solver.init_state(0)
    mean = torch.zeros(32, 1, device=device)
    before = (PendulumRollout.launches, MppiPendulumSolve.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(3):
            action, _, state = solve(env.params, env_state, state)
            mean = mppi_pendulum_solve(env.params, env_state, mean, 1000 + t, 1024,
                                       (0.25, 0.8, 0.0), float(np.sqrt(3.5)), 0.01, 0.55, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (PendulumRollout.launches, MppiPendulumSolve.launches) == (before[0] + 3,
                                                                      before[1] + 3)
    assert bool(torch.isfinite(action).all()) and bool(torch.isfinite(mean).all())
