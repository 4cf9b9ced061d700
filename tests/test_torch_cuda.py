"""The CUDA kernels on the card (chain rollout, chain rollout with
observations, closed-loop chain rollout for the reacher and peg tasks,
filtered noise, the locomotion rollout for the swimmer and the half
cheetah (#1, #3, #4 and #5 a team of lanes per particle: ragged N, two
launches bit for bit, zeroed actions failing the check, their phase
clocks; #1 and #3 at every team size bit for bit), the
forest rollout for pen-v0, the sawyer peg, relocate-v0, hammer-v0 (its
coupled free-body branch), the sawyer door, the pusher, the three
tray-glass models and door-v0, the pendulum rollout (every particles-a-block
size bit for bit) and the one-kernel pendulum MPPI solve, a thread-block
cluster), and the batched entries of #1, #2, #5, #6 and #7 (B elements in
one launch, equal to B single launches bit for bit; a strided argument
raising), and a batched episode replayed against its eager loop:
each against its plain PyTorch version, their launch counts on sync-free
solves (the batched MPPI solve against single solves too), and the
wrappers' checks; and one solve of each family captured as
a CUDA graph and replayed against eager solves (chip_smoke.py graph_check),
two replays drawing different noise; iLQR on LQR against the dynamic
program (rtol 1e-3 on the action, 1e-4 on the cost), iLQR on cartpole and
MPPI on the continual maze replayed as CUDA graphs, and their checkpoints
restoring the next solve bit for bit; an episode replayed from one captured
control step against the eager episode bit for bit (the main path, and pen
planning on a perturbed model's own kernel), guard_finite's reset of the
learned solvers replayed in a graph, kernels built from perturbed models
against their plain versions, and parallel/ on a mesh of one card.

Needs a CUDA card and skips without one (the kernel has no CPU mode). This
file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: atol 5e-5 at (N=37, H=5), the JAX kernel's own tolerance; 1e-3
at the main path's (N=4096, H=32), where the longer horizon accumulates
f32 reordering on costs of order 1-10. Noise: atol 1e-4 (identical
uniforms; libm ulps and the order of sums differ, scaled by the filter's
gain of about 1.25 and by sqrt(3) for cov 3 I), two launches bit for bit;
uniforms bit for bit. Locomotion: the swimmer
atol 5e-5 at (37, 5) and 1e-3 at its config's (512, 32); the cheetah, whose
stiff contact (kp 6000, 25 substeps per step) amplifies f32 reordering,
5e-4 and 1e-2 of max(1, |cost|) at (37, 5) and its config's (512, 16).
Forest: the peg 5e-5 at (37, 5), at N=1 and 37 (H=4) and 1e-3 at its
config's (256, 16); pen 1e-4 at N=1 and 37 (H=4); two launches on the
same inputs agree bit for bit, and so do the phase-clock build's; the
peg with a repeated act body 5e-5 at (37, 4); pen,
from a pinch in which every fingertip presses on the pen (so that the
costs follow the hand's dynamics through contact), 1e-4 at (37, 5); at its
config's (256, 16), 80 substeps of contact, at least 99% of the costs
within 1e-3 and every other one off by a bonus step of the gated pen cost
(a signed sum of 5, 10 and 50) to within 1e-3. relocate-v0 from the grasp
and hammer-v0 with the hammer held on the nail or spinning (chip_smoke.py
forest_inputs): 1e-4 at (37, 4) and N=1, the configs' (512, 32) and
(512, 20) by the gated rule with their bonuses, two launches bit for bit,
the plain version with the actions zeroed, or with the hammer's coupled
solve replaced by the decoupled one, off by more than 10x. The sawyer door
from its grab, the pusher from contact, the tray's glass past its edge
(fixed-v1 from its start) and door-v0 hooking the handle or opened past 0.2
rad (chip_smoke.py forest_inputs) likewise at (37, 4) and N=1; door-v0 and
tray-glass v0 at their configs' (256, 48) and (1024, 20) by the gated rule
(the door's bonuses, the tray's fall penalty). Pendulum
rollout: atol 1e-5 from a start that crosses -pi (th0 = -3.0, thdot0 =
-8), at (37, 5) and (4096, 32); every particles-a-block size and two
launches bit for bit. One-kernel MPPI solve: atol 1e-5 on the new mean at N =
128, 1024, 2048 and 8192, H = 32, lam 0.01 and 1.0, and at every cluster
size (the same Philox normals and the same rollout operations; only the
order of the particle sums differs), two launches bit for bit. Graph
replays: bit for bit against eager solves.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mjmpc_tpu_torch import bounds, envs, ops, rng, solvers
from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
from mjmpc_tpu_torch.envs import half_cheetah, hammer, pen, sawyer_tasks, swimmer
from mjmpc_tpu_torch.ops.chain_rollout import (TEAM_SIZES, ChainClRollout, ChainExtRollout,
                                               ChainObsRollout, ChainRollout,
                                               build_chain_cl_rollout, build_chain_obs_rollout,
                                               build_chain_rollout)
from mjmpc_tpu_torch.ops.forest_rollout import (ForestRollout, build_forest_rollout,
                                                gated_cost_agreement)
from mjmpc_tpu_torch.ops.noise import FilteredNoise
from mjmpc_tpu_torch.ops.pendulum import (CLUSTER_SIZES, ROLLOUT_PER_BLOCK, MppiPendulumSolve,
                                          PendulumRollout, max_active_clusters,
                                          mppi_pendulum_solve, pendulum_rollout,
                                          rollout_per_block, sampled_particles, solve_cluster,
                                          solve_shape)

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


@pytest.mark.parametrize("b", [1, 3])
def test_batched_kernels_equal_single_launches(device, b):
    """The batched entries of #1 and #2 (one launch for B elements) equal B
    single launches bit for bit and their plain versions within 5e-5."""
    roll = build_chain_rollout(envs.make("reacher_7dof-v0", device=device).params.model,
                               n_substeps=2)
    rows = [_inputs(37, 5, seed, device) for seed in range(b)]
    args = [torch.stack(xs).contiguous() for xs in zip(*rows)]
    before = ChainRollout.batch_launches
    got = roll.batch(*args)
    assert ChainRollout.batch_launches == before + 1
    assert torch.equal(got, torch.stack([roll(*row) for row in rows]))
    torch.testing.assert_close(got, roll.batch_plain(*args), rtol=0, atol=5e-5)
    sampler = FilteredNoise()
    keys = ops.key_tensor([rng.stream_key(7, i) for i in range(b)], device)
    steps = torch.arange(3, 3 + b, device=device)
    white = sampler.white_batch(keys, steps, 37, 5, 7, (0.25, 0.8, 0.0))
    assert torch.equal(white, torch.stack([
        sampler.white(rng.stream_key(7, i), steps[i], 37, 5, 7, (0.25, 0.8, 0.0))
        for i in range(b)]))
    torch.testing.assert_close(white, sampler.white_batch_plain(
        keys, steps, 37, 5, 7, (0.25, 0.8, 0.0)), rtol=0, atol=5e-5)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name", ["Swimmer-v0", "pen-v0", "SimplePendulum-v0"])
def test_new_batched_entries_equal_single_launches(device, name, b):
    """The batched entries of #5, #6 and #7 (chip_smoke.py's inputs of
    phase 30) equal B single launches bit for bit and their plain versions
    within the single checks' tolerances, one batched launch each."""
    smoke = _chip_smoke()
    env = envs.make(name, device=device)
    roll = getattr(env.fused_rollout, "kernel", env.fused_rollout)
    n, h, tol = smoke.BATCH_ENTRY_CHECKS[name]
    args = smoke._batched_entry_inputs(name, env, roll, n, h, b, device)
    before = type(roll).batch_launches
    got = roll.batch(*args)
    assert type(roll).batch_launches == before + 1
    if name == "SimplePendulum-v0":
        st = args[1]
        singles = [roll(args[0], type(st)(th=st.th[i], thdot=st.thdot[i]), args[2][i],
                        args[3][i]) for i in range(b)]
    else:
        singles = [roll(*(x[i] for x in args)) for i in range(b)]
    assert torch.equal(got, torch.stack(singles))
    torch.testing.assert_close(got, roll.batch_plain(*args), rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["Swimmer-v0", "pen-v0", "SimplePendulum-v0"])
def test_new_batched_entries_raise_on_non_contiguous_inputs(device, name):
    smoke = _chip_smoke()
    env = envs.make(name, device=device)
    roll = getattr(env.fused_rollout, "kernel", env.fused_rollout)
    n, h, _ = smoke.BATCH_ENTRY_CHECKS[name]
    args = smoke._batched_entry_inputs(name, env, roll, n, h, 2, device)
    args[-1] = args[-1].transpose(0, 1).contiguous().transpose(0, 1)   # noise, strided
    with pytest.raises(ValueError, match="contiguous"):
        roll.batch(*args)


def test_batched_episode_replays_the_eager_loop(device):
    """Two pendulum episodes as one batched episode, replayed, equal the
    batched eager loop bit for bit and launch #7's batched entry alone."""
    from mjmpc_tpu_torch.harness.episode import build_batched_episode_fn
    smoke = _chip_smoke()
    env = envs.make("SimplePendulum-v0", device=device)
    solver = solvers.MPPI(d_action=1, horizon=16, num_particles=64, lam=0.01, init_cov=3.5,
                          step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0), device=device)
    before = (PendulumRollout.launches, PendulumRollout.batch_launches)
    replayed = build_batched_episode_fn(solver, env, 6)(env.params, env.params, [1, 2])
    assert (PendulumRollout.launches, PendulumRollout.batch_launches) == (before[0],
                                                                          before[1] + 2)
    eager = build_batched_episode_fn(solver, env, 6, replay=False)(env.params, env.params,
                                                                   [1, 2])
    assert smoke.tensors_equal(replayed[0], eager[0]) and smoke.tensors_equal(replayed[2],
                                                                               eager[2])


def test_batched_solve_matches_single_solves_without_host_syncs(device):
    """build_batched_solve_fn at B=3 against three single solves (2.3e-6,
    the MPPI update's tolerance), one launch of each batched entry a
    solve and no host sync."""
    env = envs.make("reacher_7dof-v0", device=device)
    solver = solvers.MPPI(d_action=7, horizon=8, num_particles=256, lam=0.01, init_cov=3.0,
                          step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat",
                          noise_impl="kernel", device=device)
    states = [solver.init_state(seed) for seed in (1, 2, 3)]
    env_states = [env.init(env.params, seed) for seed in (4, 5, 6)]
    es = solvers.stack_states(env_states)
    bsolve = solvers.build_batched_solve_fn(solver, env)
    action, _, new = bsolve(env.params, es, solvers.GaussianBatch.stack(states))
    single = solvers.make_solve_fn(solver, env)
    for i, (s, e) in enumerate(zip(states, env_states)):
        a, _, s = single(env.params, e, s)
        torch.testing.assert_close(action[i], a, rtol=0, atol=2.3e-6)
        torch.testing.assert_close(new.mean[i], s.mean, rtol=0, atol=2.3e-6)
    before = (ChainRollout.batch_launches, FilteredNoise.batch_launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, new = bsolve(env.params, es, new)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ChainRollout.batch_launches, FilteredNoise.batch_launches) == (before[0] + 3,
                                                                           before[1] + 3)
    assert bool(torch.isfinite(action).all()) and new.step.tolist() == [4, 4, 4]


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


def _open_loop_case(kind, n, h, seed, device):
    """Kernel #1 ("costs") or #3 ("obs", "peg_obs") and its inputs, drawn
    as _inputs draws them (the peg's extras for "peg_obs")."""
    name = "sawyer_peg_insertion-v0" if kind == "peg_obs" else "reacher_7dof-v0"
    env = envs.make(name, device=device)
    build = build_chain_rollout if kind == "costs" else build_chain_obs_rollout
    roll = build(env.params.model, n_substeps=2, task="peg" if kind == "peg_obs" else "reacher")
    args = _inputs(n, h, seed, device)
    if kind == "peg_obs":
        args[2] = peg_extras(env.params)
    return roll, args


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("kind,n", [("costs", 1), ("costs", 5), ("obs", 1), ("obs", 5),
                                    ("peg_obs", 1), ("peg_obs", 5)])
def test_open_loop_kernels_ragged_sizes_two_launches_and_team_sizes(device, kind, n):
    """N=1 and N=5 (ragged for any team narrower than a warp): the costs
    and obs kernels match their plain versions, and two launches and every
    team size agree bit for bit (no sum split between lanes)."""
    roll, args = _open_loop_case(kind, n, 5, 18, device)
    first, second = _tuple(roll(*args)), _tuple(roll(*args))
    for team in TEAM_SIZES:
        for x, y in zip(first, _tuple(roll(*args, team=team))):
            assert torch.equal(x, y), team
    for x, y, z in zip(first, second, _tuple(roll.plain(*args))):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=0, atol=5e-5)


@pytest.mark.parametrize("kind", ["costs", "obs", "peg_obs"])
def test_open_loop_check_fails_for_zeroed_actions(device, kind):
    """The plain version with the mean and the noise zeroed misses the
    kernel's outputs by more than 10x the tolerance."""
    roll, args = _open_loop_case(kind, 37, 5, 19, device)
    zeroed = _tuple(roll.plain(*args[:3], torch.zeros_like(args[3]), torch.zeros_like(args[4])))
    got = _tuple(roll(*args))
    assert max(float((x - y).abs().max()) for x, y in zip(got, zeroed)) > 5e-4


@pytest.mark.parametrize("n,h,d_action", [(37, 5, 7), (4096, 32, 7), (512, 32, 30)])
def test_noise_kernel_matches_plain(device, n, h, d_action):
    sampler = FilteredNoise()
    cov = 3.0 * torch.eye(d_action, device=device)
    step = rng.step_tensor(5, device)
    before = FilteredNoise.launches
    got = sampler(12345, step, cov, (n, h), (0.25, 0.8, 0.0))
    assert FilteredNoise.launches == before + 1
    want = sampler.plain(12345, step, cov, (n, h), (0.25, 0.8, 0.0))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(sampler(12345, step, cov, (n, h), (0.25, 0.8, 0.0)), got)
    other = sampler.plain(12345, step + 1, cov, (n, h), (0.25, 0.8, 0.0))
    assert float((other - got).abs().max()) > 1e-3


@pytest.mark.parametrize("n", [1, 7, 4096])
def test_uniforms_kernel_matches_plain(device, n):
    step = rng.step_tensor(3, device)
    before = ops.PhiloxUniforms.launches
    got = ops.uniforms(9, step, n)
    assert ops.PhiloxUniforms.launches == before + 1
    assert torch.equal(got, ops.uniforms.plain(9, step, n))


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


def _cl_case(name, n, h, seed, device):
    """Kernel #4's wrapper for the reacher or the peg and its inputs: W *
    0.05 and noise * 0.3 as tests/test_pallas_cl.py draws them."""
    env = envs.make(name, device=device)
    peg = name.startswith("sawyer_peg")
    roll = build_chain_cl_rollout(env.params.model, n_substeps=2,
                                  task="peg" if peg else "reacher")
    rng = np.random.default_rng(seed)
    q0, qd0, target, _, _ = _inputs(1, 1, seed, device)
    extras = peg_extras(env.params) if peg else target
    w = torch.as_tensor(np.asarray(rng.normal(size=(roll.d_obs + 1, 7)) * 0.05, np.float32),
                        device=device)
    noise = torch.as_tensor(np.asarray(rng.normal(size=(n, h, 7)) * 0.3, np.float32),
                            device=device)
    return roll, [q0, qd0, extras, w, noise]


@pytest.mark.parametrize("name,n", [("reacher_7dof-v0", 1), ("reacher_7dof-v0", 5),
                                    ("sawyer_peg_insertion-v0", 1),
                                    ("sawyer_peg_insertion-v0", 5)])
def test_cl_kernel_ragged_sizes_and_two_launches(device, name, n):
    """N=1 and N=5 (ragged for any team narrower than a warp): the kernel
    matches its plain version, and two launches agree bit for bit (no
    atomics, a fixed order of every sum)."""
    roll, args = _cl_case(name, n, 5, 13, device)
    first, second = roll(*args), roll(*args)
    for x, y, z in zip(first, second, roll.plain(*args)):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=0, atol=5e-5)


@pytest.mark.parametrize("name", ["reacher_7dof-v0", "sawyer_peg_insertion-v0"])
def test_cl_check_fails_for_zeroed_actions(device, name):
    """The check's power: the plain version with W and the noise zeroed
    (a rollout that ignores the actions) misses the kernel's observations
    and costs by more than 10x the tolerance."""
    roll, args = _cl_case(name, 37, 5, 14, device)
    obs, _, costs = roll(*args)
    z_obs, _, z_costs = roll.plain(*args[:3], torch.zeros_like(args[3]),
                                   torch.zeros_like(args[4]))
    assert max(float((obs - z_obs).abs().max()), float((costs - z_costs).abs().max())) > 5e-4


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


@pytest.mark.parametrize("name,n", [("Swimmer-v0", 1), ("Swimmer-v0", 5),
                                    ("HalfCheetah-v0", 1), ("HalfCheetah-v0", 5)])
def test_ext_kernel_ragged_sizes_and_two_launches(device, name, n):
    """As for the closed loop: N=1 and N=5 match the plain version (the
    cheetah's to 5e-4 of max(1, |cost|)) and two launches agree bit for
    bit."""
    env = envs.make(name, device=device)
    roll = _LOCO[name].build_rollout(env.params)
    args = _loco_inputs(env.params.model.nv, n, 5, 15, device)
    first, second, want = roll(*args), roll(*args), roll.plain(*args)
    assert torch.equal(first, second)
    cheetah = name == "HalfCheetah-v0"
    scale = torch.clamp(want.abs(), min=1.0) if cheetah else 1.0
    torch.testing.assert_close(first / scale, want / scale, rtol=0,
                               atol=5e-4 if cheetah else 5e-5)


@pytest.mark.parametrize("name", sorted(_LOCO))
def test_ext_check_fails_for_zeroed_actions(device, name):
    """The plain version with the mean and the noise zeroed misses the
    kernel's costs by more than 10x the tolerance."""
    env = envs.make(name, device=device)
    roll = _LOCO[name].build_rollout(env.params)
    args = _loco_inputs(env.params.model.nv, 37, 5, 16, device)
    zeroed = roll.plain(*args[:2], torch.zeros_like(args[2]), torch.zeros_like(args[3]))
    tol = 5e-4 if name == "HalfCheetah-v0" else 5e-5
    assert float((roll(*args) - zeroed).abs().max()) > 10 * tol


def test_chain_phase_clocks_count_and_change_no_output(device):
    """The chain team kernel's phase-clock build (tools/kernel_ab.py
    clocked) counts cycles in every kind of phase and gives the same
    outputs, bit for bit, for the peg's closed loop and the cheetah."""
    kernel_ab = _kernel_ab()
    cases = [_cl_case("sawyer_peg_insertion-v0", 37, 5, 17, device)]
    env = envs.make("HalfCheetah-v0", device=device)
    cases.append((half_cheetah.build_rollout(env.params),
                  _loco_inputs(env.params.model.nv, 37, 5, 17, device)))
    for roll, args in cases:
        clocked, read = kernel_ab.clocked(roll, "chain")
        clocked(*args)
        torch.cuda.synchronize()
        read()                                   # zeroes the counts
        got = clocked(*args)
        cycles = read()
        want = roll(*args)
        for x, y in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(x, y)
        assert all(cycles[k] > 0 for k in kernel_ab.PHASE_KINDS["chain"]), cycles


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


@pytest.mark.parametrize("name,n", [("pen-v0", 1), ("pen-v0", 37),
                                    ("sawyer_peg_insertion-v0", 1),
                                    ("sawyer_peg_insertion-v0", 37)])
def test_forest_kernel_ragged_sizes_match_plain(device, name, n):
    """N=1 and N=37 leave teams and blocks ragged (a block holds 32 / team
    particles: the peg's 4, pen's 1)."""
    roll, args = _forest_case(name, n, 4, 8, device)
    tol = 1e-4 if name == "pen-v0" else 5e-5
    torch.testing.assert_close(roll(*args), roll.plain(*args), rtol=0, atol=tol)


def test_forest_kernel_repeated_act_body_takes_its_last_action(device):
    """A body listed twice in act_bodies takes the later action, as in the
    plain version: the peg with its fourth joint listed again at the end
    (two lanes of a team hold actions of that body)."""
    roll, args = _forest_case("sawyer_peg_insertion-v0", 37, 4, 11, device)
    twice = build_forest_rollout(roll.model, roll.n_substeps,
                                 list(roll.act_bodies) + [roll.act_bodies[3]], roll.task,
                                 roll.ulow, roll.uhigh)
    rng = np.random.default_rng(12)
    extra = [torch.as_tensor(np.asarray(rng.normal(size=shape) * 0.3, np.float32),
                             device=device) for shape in ((4, 1), (37, 4, 1))]
    args = args[:3] + [torch.cat([a, x], -1) for a, x in zip(args[3:], extra)]
    torch.testing.assert_close(twice(*args), twice.plain(*args), rtol=0, atol=5e-5)


def _kernel_ab():
    """tools/kernel_ab.py as a module."""
    path = Path(__file__).resolve().parent.parent / "tools" / "kernel_ab.py"
    spec = importlib.util.spec_from_file_location("kernel_ab", path)
    kernel_ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kernel_ab)
    return kernel_ab


def test_forest_phase_clocks_count_and_change_no_cost(device):
    """The phase-clock build (tools/kernel_ab.py clocked) counts cycles in
    every kind of phase pen runs and gives the same costs, bit for bit."""
    roll, args = _forest_case("pen-v0", 37, 5, 10, device)
    clocked, read = _kernel_ab().clocked(roll, "forest")
    clocked(*args)
    torch.cuda.synchronize()
    read()                                       # zeroes the counts
    got = clocked(*args)
    cycles = read()
    assert torch.equal(got, roll(*args))
    assert all(cycles[k] > 0 for k in ("init", "fk", "points", "forces", "sums", "mass",
                                       "chol", "forward", "back", "cost")), cycles


@pytest.mark.parametrize("name", ["pen-v0", "sawyer_peg_insertion-v0"])
def test_forest_kernel_launches_agree_bit_for_bit(device, name):
    """No atomics and a fixed order of every sum: two launches on the same
    inputs give the same costs, bit for bit."""
    roll, args = _forest_case(name, 256, 16, 9, device)
    first, second = roll(*args), roll(*args)
    assert torch.equal(first, second)


@pytest.mark.parametrize("name", ["pen-v0", "sawyer_peg_insertion-v0", "relocate-v0",
                                  "hammer-v0", "sawyer_door-v0", "sawyer_pusher-v0",
                                  "panda_tray_glass-v0", "panda_tray_glass-v1",
                                  "panda_tray_glass_fixed-v1", "door-v0"])
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


@pytest.mark.parametrize("n", [24, 64, 2048])
def test_pendulum_kernel_every_per_block_size_agrees(device, n):
    """A block owns per_block whole particles; every size the sweep times
    gives the default's costs bit for bit (each particle's arithmetic is
    the same in every partition), and so does a second launch."""
    env, state, mean, noise = _pendulum_case(n, 32, 11, device)
    got = pendulum_rollout(env.params, state, mean, noise)
    torch.testing.assert_close(got, pendulum_rollout.plain(env.params, state, mean, noise),
                               rtol=0, atol=1e-5)
    assert torch.equal(pendulum_rollout(env.params, state, mean, noise), got)
    for per_block in ROLLOUT_PER_BLOCK:
        assert torch.equal(pendulum_rollout(env.params, state, mean, noise, per_block=per_block),
                           got), per_block
    assert rollout_per_block(n, 32) == 4         # 4 a block up to 8 blocks an SM


@pytest.mark.parametrize("n", [128, 1024, 2048, 8192])
@pytest.mark.parametrize("lam", [0.01, 1.0])
def test_one_kernel_solve_matches_plain(device, n, lam):
    env, state, mean, _ = _pendulum_case(1, 32, 9, device)
    step = rng.step_tensor(3, device)
    args = (env.params, state, mean, 77, step, n, (0.25, 0.8, 0.0), float(np.sqrt(3.5)), lam,
            0.55, 1.0)
    before = MppiPendulumSolve.launches
    got = mppi_pendulum_solve(*args)
    assert MppiPendulumSolve.launches == before + 1
    torch.testing.assert_close(got, mppi_pendulum_solve.plain(*args), rtol=0, atol=1e-5)
    assert torch.equal(mppi_pendulum_solve(*args), got)
    other = mppi_pendulum_solve.plain(*args[:4], step + 1, *args[5:])
    assert float((other - got).abs().max()) > 1e-4


@pytest.mark.parametrize("n", [128, 2048, 8192])
def test_one_kernel_solve_every_cluster_size_agrees(device, n):
    """Every cluster size the card holds gives the plain version's mean to
    1e-5 (only the order of the sums over the particles moves); a shape
    that does not fit raises."""
    env, state, mean, _ = _pendulum_case(1, 32, 10, device)
    args = (env.params, state, mean, 5, rng.step_tensor(0, device), n, (0.25, 0.8, 0.0), 1.5,
            0.01, 0.55, 1.0)
    want = mppi_pendulum_solve.plain(*args)
    sampled, ran = sampled_particles(n), []
    for ctas in CLUSTER_SIZES:
        try:
            solve_shape(sampled, 32, ctas)
        except ValueError:
            with pytest.raises(ValueError):
                mppi_pendulum_solve(*args, ctas=ctas)
            continue
        if max_active_clusters(sampled, 32, ctas) < 1:
            continue
        torch.testing.assert_close(mppi_pendulum_solve(*args, ctas=ctas), want, rtol=0,
                                   atol=1e-5)
        ran.append(ctas)
    assert solve_cluster(sampled) in ran


def test_pendulum_solves_launch_the_kernels_without_host_syncs(device):
    env = envs.make("SimplePendulum-v0", device=device)
    solver = solvers.MPPI(d_action=1, horizon=32, num_particles=24, lam=0.01, init_cov=3.5,
                          step_size=0.55, alpha=1, filter_coeffs=(0.25, 0.8, 0.0),
                          base_action="repeat", device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state, state = env.init(env.params, 1), solver.init_state(0)
    mean, step = torch.zeros(32, 1, device=device), rng.step_tensor(0, device)
    mppi_pendulum_solve(env.params, env_state, mean, 1000, step, 1024)    # builds the kernel
    before = (PendulumRollout.launches, MppiPendulumSolve.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, state = solve(env.params, env_state, state)
            mean = mppi_pendulum_solve(env.params, env_state, mean, 1000, step, 1024,
                                       (0.25, 0.8, 0.0), float(np.sqrt(3.5)), 0.01, 0.55, 1.0)
            step = step + 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (PendulumRollout.launches, MppiPendulumSolve.launches) == (before[0] + 3,
                                                                      before[1] + 3)
    assert bool(torch.isfinite(action).all()) and bool(torch.isfinite(mean).all())


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library, numpy and the port's timers)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _hand_case(name, start, n, h, seed, device):
    """Kernel #6's wrapper for one of HAND_CASES' envs and chip_smoke.py's
    inputs for it (the grasp; the hammer held on the nail or spinning; the
    sawyer door's grab, the pusher's contact, the tray's glass off its edge;
    door-v0 hooking the handle or opened)."""
    env = envs.make(name, device=device)
    roll = bounds.forest_builder(name)(env.params.model)
    return roll, _chip_smoke().forest_inputs(env, roll, n, h, seed, device, start)


HAND_CASES = [("relocate-v0", "grasp"), ("hammer-v0", "held"), ("hammer-v0", "spin"),
              ("sawyer_door-v0", "grab"), ("sawyer_pusher-v0", "contact"),
              ("panda_tray_glass-v0", "fallen"), ("panda_tray_glass-v1", "fallen"),
              ("panda_tray_glass_fixed-v1", "arm"), ("door-v0", "hook"), ("door-v0", "open")]


@pytest.mark.parametrize("name,start", HAND_CASES)
@pytest.mark.parametrize("n", [1, 37])
def test_hand_forest_kernel_matches_plain(device, name, start, n):
    """Each task of HAND_CASES at (N, 4) to 1e-4, two launches bit for bit;
    at N=37 the plain version with the actions zeroed (not for the spin,
    which no hand touches) misses by more than 10x."""
    roll, args = _hand_case(name, start, n, 4, 12, device)
    before = ForestRollout.launches
    got = roll(*args)
    assert ForestRollout.launches == before + 1
    want = roll.plain(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(roll(*args), got)
    if n == 37 and start != "spin":
        zeroed = roll.plain(*args[:3], torch.zeros_like(args[3]), torch.zeros_like(args[4]))
        assert float((zeroed - want).abs().max()) > 10 * 1e-4


def test_hammer_kernel_runs_the_coupled_free_body_solve(device):
    """hammer's header turns the coupled 6x6 branch on for the hammer, and
    with the hammer spinning the kernel agrees with the plain version while
    the plain version with the decoupled branch in its place misses by more
    than 10x the tolerance."""
    import copy
    from mjmpc_tpu_torch.ops.forest_rollout import rollout_forest_plain
    roll, args = _hand_case("hammer-v0", "spin", 37, 4, 13, device)
    assert "constexpr bool HAS_COUPLED = true;" in roll.header
    got = roll(*args)
    torch.testing.assert_close(got, roll.plain(*args), rtol=0, atol=1e-4)
    consts = copy.deepcopy(roll.consts)
    consts["free_consts"][hammer.HAMMER_BODY]["coupled"] = False
    decoupled = rollout_forest_plain(roll.model, roll.n_substeps, roll.act_bodies, roll.task,
                                     roll.ulow, roll.uhigh, *args, consts=consts)
    assert float((decoupled - got).abs().max()) > 10 * 1e-4


@pytest.mark.parametrize("name,start,n,h", [("relocate-v0", "grasp", 512, 32),
                                            ("hammer-v0", "held", 512, 20),
                                            ("panda_tray_glass-v0", "fallen", 1024, 20),
                                            ("door-v0", "hook", 256, 48)])
def test_hand_forest_kernel_config_size_agrees_up_to_bonus_steps(device, name, start, n, h):
    """At the configs' sizes: at least 99% of the costs within 1e-3 and
    every other one off by a bonus step of the gated cost (the tray's: its
    fall penalty); two launches bit for bit."""
    from mjmpc_tpu_torch.ops import forest_rollout as fr
    roll, args = _hand_case(name, start, n, h, 14, device)
    got, want = roll(*args), roll.plain(*args)
    assert bool(torch.isfinite(got).all()) and torch.equal(roll(*args), got)
    steps = {"relocate-v0": fr.RELOCATE_BONUS_STEPS, "hammer-v0": fr.HAMMER_BONUS_STEPS,
             "panda_tray_glass-v0": fr.TRAY_FALL_STEPS, "door-v0": fr.DOOR_BONUS_STEPS}[name]
    agree = gated_cost_agreement(got, want, 1e-3, steps)
    assert agree["share_within"] >= 0.99 and agree["other"] == 0, agree


def _graph_family(name, device):
    """(solve, env, env state, solver state) of one family at a small size."""
    reacher = envs.make("reacher_7dof-v0", device=device)
    cfg = dict(d_action=7, horizon=8, num_particles=256, filter_coeffs=(0.25, 0.8, 0.0),
               device=device)
    if name in ("mppi_kernel_noise_guarded", "mppi_plain_noise"):
        solver = solvers.MPPI(**cfg, lam=0.01, init_cov=3.0, step_size=0.55,
                              base_action="repeat",
                              noise_impl="kernel" if "kernel" in name else "plain")
        solve = solvers.make_solve_fn(solver, reacher)
        if "guarded" in name:
            solve = solvers.guard_finite(solve, solver)
        return solve, reacher, reacher.init(reacher.params, 1), solver.init_state(0)
    if name == "pfmpc":
        solver = solvers.PFMPC(**cfg, lam=0.01, cov_shift=0.05, base_action="random",
                               noise_impl="kernel")
        return (solvers.make_solve_fn(solver, reacher), reacher,
                reacher.init(reacher.params, 1), solver.init_state(0))
    if name == "reinforce_peg_cl":
        peg = envs.make("sawyer_peg_insertion-v0", device=device)
        smoke = _chip_smoke()
        solver = solvers.make_solver("reinforce", d_obs=peg.d_obs, d_action=7, device=device,
                                     **smoke.PEG_CL)
        return (solvers.make_solve_fn(solver, peg), peg, peg.init(peg.params, 1),
                solver.init_state(0))
    smoke = _chip_smoke()
    pend = envs.make("SimplePendulum-v0", device=device)
    return (smoke.one_kernel_solve_fn(1024), pend, pend.init(pend.params, 1),
            smoke.one_kernel_start(device))


@pytest.mark.parametrize("name", ["mppi_kernel_noise_guarded", "mppi_plain_noise", "pfmpc",
                                  "reinforce_peg_cl", "one_kernel_n1024"])
def test_solve_replays_as_a_cuda_graph(device, name):
    """5 replays equal 5 eager solves bit for bit; two replays at successive
    steps from the same start draw different noise (chip_smoke.graph_check
    raises otherwise)."""
    solve, env, es, state = _graph_family(name, device)
    fields = _chip_smoke().graph_check(name, solve, env, es, state)
    assert fields["identical"] and fields["steps"] == [1, 2, 3, 4, 5]
    assert fields["max_abs_diff_next_step"] > 0.0


def test_ilqr_on_lqr_matches_the_dynamic_program_without_host_syncs(device):
    """iLQR (H=30, 3 iterations) on LQR-v0: the first action within rtol
    1e-3 and the plan's cost within rtol 1e-4 of the finite-horizon dynamic
    program's, sync-free, no kernel launched."""
    from mjmpc_tpu_torch.envs.lqr import LQRState
    smoke = _chip_smoke()
    env = envs.make("LQR-v0", device=device)
    u0_opt, cost_opt = smoke.lqr_dp(env.params, smoke.LQR_H, smoke.LQR_X0)
    solver = solvers.ILQR(d_action=1, horizon=smoke.LQR_H, n_iters=3, mu=1e-6, device=device)
    solve = solvers.make_solve_fn(solver, env)
    state = solver.init_state(0)
    x0 = LQRState(x=torch.tensor(smoke.LQR_X0, dtype=torch.float32, device=device))
    before = FilteredNoise.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, cost, state = solve(env.params, x0, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert FilteredNoise.launches == before and int(state.step) == 1
    np.testing.assert_allclose(float(action[0]), u0_opt, rtol=1e-3)
    np.testing.assert_allclose(float(cost), cost_opt, rtol=1e-4)


def _analytic_family(name, device):
    smoke = _chip_smoke()
    if name == "ilqr_cartpole":
        env = envs.make("cartpole-v0", device=device)
        solver = solvers.ILQR(d_action=1, horizon=32, n_iters=5, action_lows=env.action_lows,
                              action_highs=env.action_highs, device=device)
        return solvers.make_solve_fn(solver, env), env, env.init(env.params, 1), solver
    env = envs.make("continual_maze-v0", device=device)
    es = dataclasses.replace(env.init(env.params, 1),
                             timestep=rng.step_tensor(smoke.MAZE_START, device))
    solver = solvers.MPPI(d_action=2, device=device, **smoke.MAZE_MPPI)
    return solvers.make_solve_fn(solver, env), env, es, solver


@pytest.mark.parametrize("name", ["ilqr_cartpole", "mppi_continual_maze"])
def test_analytic_solve_replays_as_a_cuda_graph(device, name):
    """iLQR on cartpole and MPPI on the continual maze across its goal's
    switch: 5 replays equal 5 eager solves bit for bit; iLQR draws no noise,
    so two replays from one start agree, the maze's differ."""
    solve, env, es, solver = _analytic_family(name, device)
    ilqr = name.startswith("ilqr")
    fields = _chip_smoke().graph_check(name, solve, env, es, solver.init_state(0),
                                       draws_noise=not ilqr)
    assert fields["identical"] and fields["steps"] == [1, 2, 3, 4, 5]
    assert (fields["max_abs_diff_next_step"] == 0.0) == ilqr


@pytest.mark.parametrize("name", ["ilqr_cartpole", "mppi_continual_maze"])
def test_checkpoint_restores_the_next_solve_bit_for_bit(device, name, tmp_path):
    from mjmpc_tpu_torch.harness import checkpoint
    solve, env, es, solver = _analytic_family(name, device)
    state = solver.init_state(3)
    for _ in range(2):
        _, _, state = solve(env.params, es, state)
    checkpoint.save_solver_state(str(tmp_path / "state"), state)
    restored = checkpoint.load_solver_state(str(tmp_path / "state"), solver.init_state(0))
    assert restored.seed == 3 and restored.step.device.type == "cuda"
    cont, rest = solve(env.params, es, state), solve(env.params, es, restored)
    for a, b in zip(cont[:2], rest[:2]):
        assert torch.equal(a, b)
    assert torch.equal(cont[2].mean, rest[2].mean) and torch.equal(cont[2].step, rest[2].step)


def _learned_family(name, device):
    """(solve, env, env state, solver state) of the learned-model family at
    the sizes chip_smoke.py runs them: SoftQMPC with the cartpole config's
    softq block, RandomShootingNN on the pendulum, SACMPC's MPPIQ solve with
    its SAC Q on the reacher (kernel #3)."""
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.rl import SACMPC
    smoke = _chip_smoke()
    if name == "softq_cartpole-v0":
        exp = hconfig.load_config(smoke.SOFTQ_CONFIGS["cartpole-v0"])
        env = envs.make("cartpole-v0", device=device)
        solver = hconfig.make_solver_for_env(exp, "softq", env)
        return solvers.make_solve_fn(solver, env), env, env.init(env.params, 1), solver
    if name == "rsnn_SimplePendulum-v0":
        env = envs.make("SimplePendulum-v0", device=device)
        solver = solvers.RandomShootingNN(d_obs=3, d_action=1, device=device, **smoke.RSNN)
        return solvers.make_solve_fn(solver, env), env, env.init(env.params, 1), solver
    env = envs.make("reacher_7dof-v0", device=device)
    m = SACMPC(env, seed=0)

    def solve(params, es, state):
        return m.solve_with_q(params, es, state, m.sac_params.q)

    return solve, env, env.init(env.params, 1), m.solver


LEARNED = {"softq_cartpole-v0": dict(noise=3), "rsnn_SimplePendulum-v0": dict(noise=3),
           "sac_mpc_reacher_7dof-v0": dict(noise=3, obs=3)}


@pytest.mark.parametrize("name", sorted(LEARNED))
def test_learned_solves_launch_their_kernels_without_host_syncs(device, name):
    """3 solves after a warm-up, under set_sync_debug_mode("error"): the
    noise kernel (#2) once a solve; SACMPC's MPPIQ with the SAC Q also the
    obs rollout (#3) once a solve and no costs-only rollout."""
    solve, env, es, solver = _learned_family(name, device)
    state = solver.init_state(0)
    solve(env.params, es, state)
    before = (FilteredNoise.launches, ChainObsRollout.launches, ChainRollout.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            action, _, state = solve(env.params, es, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = dict(noise=FilteredNoise.launches - before[0], obs=ChainObsRollout.launches - before[1],
               chain=ChainRollout.launches - before[2])
    assert got == dict(dict(noise=0, obs=0, chain=0), **LEARNED[name])
    assert bool(torch.isfinite(action).all()) and int(state.step) == 3


def test_sacmpc_solve_replays_as_a_cuda_graph_with_the_q_of_each_call(device):
    """SACMPC's solve_with_q captured as a CUDA graph with static Q params:
    replays from the same start, with the static Q set to the SAC Q and
    then to a shifted one, equal the eager solves with those Qs bit for bit
    and differ from each other (the planner never reads a stale Q)."""
    from mjmpc_tpu_torch.rl import SACMPC
    smoke = _chip_smoke()
    env = envs.make("reacher_7dof-v0", device=device)
    m = SACMPC(env, seed=0)
    es, start = env.init(env.params, 1), m.solver.init_state(0)
    q = m.sac_params.q
    shifted = solvers.map_tensors(lambda x: x + 0.05, q)
    static_q = solvers.map_tensors(torch.clone, q)
    graph, out, feed = smoke.capture(
        lambda p, e, st: m.solve_with_q(p, e, st, static_q), env, es, start)
    actions = []
    for q_now in (q, shifted):
        solvers.map_tensors(lambda buf, x: buf.copy_(x), static_q, q_now)
        solvers.map_tensors(lambda buf, x: buf.copy_(x), feed.static, start)
        graph.replay()
        eager = m.solve_with_q(env.params, es, solvers.map_tensors(torch.clone, start), q_now)
        assert torch.equal(out[0], eager[0]) and torch.equal(out[2].mean, eager[2].mean)
        actions.append(out[0].clone())
    assert not torch.equal(actions[0], actions[1])


@pytest.mark.parametrize("name", ["softq_cartpole-v0", "rsnn_SimplePendulum-v0"])
def test_learned_solve_replays_as_a_cuda_graph(device, name):
    """5 replays equal 5 eager solves bit for bit (the Q's and the MLP's
    nested parameters fed back with the rest of the state); two replays at
    successive steps draw different noise."""
    solve, env, es, solver = _learned_family(name, device)
    fields = _chip_smoke().graph_check(name, solve, env, es, solver.init_state(0))
    assert fields["identical"] and fields["steps"] == [1, 2, 3, 4, 5]
    assert fields["max_abs_diff_next_step"] > 0.0


def _main_path_mppi(device, n=4096):
    return solvers.MPPI(d_action=7, horizon=32, num_particles=n, lam=0.01, init_cov=3.0,
                        step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat",
                        device=device)


@pytest.mark.parametrize("name", ["reacher_7dof-v0", "pen-v0_perturbed"])
def test_replayed_episode_equals_the_eager_episode(device, name):
    """build_episode_fn replayed (one control step captured as a CUDA graph)
    against the eager loop: the records, the stacked env states and the
    final solver state bit for bit; the main path, and pen-v0's mppi
    planning on the perturbed pen's own kernel #6 (hand_pen.yml)."""
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness.episode import build_episode_fn
    smoke = _chip_smoke()
    if name == "reacher_7dof-v0":
        env, sim, steps = envs.make(name, device=device), None, 6
        solver = _main_path_mppi(device)
    else:
        env, sim, steps = envs.make("pen-v0", device=device), smoke.dyn_envs(device)["pen-v0"], 3
        solver = hconfig.make_solver_for_env(hconfig.load_config("configs/hand/pen-v0.yml"),
                                             "mppi", env)
    sim_params = (sim or env).params
    outs = [build_episode_fn(solver, env, steps, sim_env=sim, replay=replay)(
        env.params, sim_params, 5) for replay in (False, True)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert smoke.tensors_equal(a, b)
    assert outs[1][0]["reward"].shape == (steps,)


@pytest.mark.parametrize("name", ["softqmpc", "random_shooting_nn"])
def test_replayed_guard_reset_draws_fresh_parameters(device, name):
    """guard_finite around a diverging solve, captured as a CUDA graph: two
    replays at different steps reset to different, finite parameters, each
    equal to the eager reset at its step (drawn on the device, nothing
    copied from the host)."""
    env = envs.make("SimplePendulum-v0", device=device)
    if name == "softqmpc":
        solver = solvers.SoftQMPC(d_obs=3, d_action=1, horizon=8, num_particles=16, device=device)
        field = "q_params"
    else:
        solver = solvers.RandomShootingNN(d_obs=3, d_action=1, horizon=8, num_particles=16,
                                          hidden=(16,), device=device)
        field = "policy_params"
    diverged = lambda p, es, s: (torch.full((1,), float("nan"), device=device),
                                 torch.zeros((), device=device), s)
    guarded = solvers.guard_finite(diverged, solver)
    es = env.init(env.params, 0)
    graph, out, feed = _chip_smoke().capture(guarded, env, es, solver.init_state(0))
    resets = []
    for _ in range(2):
        step = int(feed.static.step)
        graph.replay()
        got = solvers.map_tensors(torch.clone, getattr(out[2], field))
        want = getattr(solver.reset_state(0, rng.step_tensor(step, device)), field)
        assert all(torch.equal(a, b) for a, b in zip(solvers.tensor_leaves(got).values(),
                                                     solvers.tensor_leaves(want).values()))
        resets.append(got)
        feed()
    a, b = (list(solvers.tensor_leaves(r).values()) for r in resets)
    assert all(bool(torch.isfinite(x).all()) for x in a + b)
    assert any(not torch.equal(x, y) for x, y in zip(a, b))


def test_perturbed_models_kernels_match_their_plain_versions(device):
    """Kernels built from perturbed models (chip_smoke.py dyn_envs): #1 for
    the reacher at (37, 5) to 5e-5, #6 for pen and hammer at (37, 3) to
    1e-4, their headers not the nominal models'."""
    smoke = _chip_smoke()
    dyn = smoke.dyn_envs(device)
    for name, start in [(smoke.DYN_REACHER[0], None)] + [(k, v[1]) for k, v in
                                                          smoke.DYN_FOREST.items()]:
        e, r = dyn[name], dyn[name].fused_rollout.kernel
        if name == smoke.DYN_REACHER[0]:
            args, tol = smoke.reacher_inputs(37, 5, 3, device), 5e-5
        else:
            args, tol = smoke.forest_inputs(e, r, 37, 3, 3, device, start), 1e-4
        torch.testing.assert_close(r(*args), r.plain(*args), rtol=0, atol=tol)
        assert r.header != envs.make(name, device=device).fused_rollout.kernel.header


def test_sharded_solve_and_batch_episode_on_a_mesh_of_one_card(device):
    """parallel/ on the card alone: the sharded main-path solve equals the
    plain solve bit for bit, #1 once a solve; the batch of episodes (one
    batched episode on the row) equals the unsharded env's batched
    episode, and each episode agrees with the single episode of its seed
    on the first steps (chip_smoke's rule: 1e-4, rewards of
    max(1, |reward|))."""
    from mjmpc_tpu_torch import parallel
    from mjmpc_tpu_torch.harness.episode import build_batched_episode_fn
    smoke = _chip_smoke()
    env = envs.make("reacher_7dof-v0", device=device)
    solver = _main_path_mppi(device, 1024)
    mesh = parallel.make_mesh()
    es, state = env.init(env.params, 1), solver.init_state(0)
    before = ChainRollout.launches
    sharded = parallel.build_sharded_solve_fn(solver, env, mesh)(env.params, es, state)
    assert ChainRollout.launches == before + 1
    assert smoke.tensors_equal(sharded, solvers.make_solve_fn(solver, env)(env.params, es, state))
    small = _main_path_mppi(device, 128)
    batch = parallel.build_batch_episode_fn(small, env, 3, mesh)(env.params, [4, 9])
    records = build_batched_episode_fn(small, env, 3)(env.params, env.params, [4, 9])[0]
    assert all(torch.equal(batch[k], records[k]) for k in records)
    diffs = smoke.single_episode_diffs(small, env, batch, [4, 9])[0]
    assert max(diffs.values()) <= smoke.BATCH_AGREE_ATOL, diffs
