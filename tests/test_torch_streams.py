"""The port's solver streams are keyed on a device-side step (CPU).

Every solver state's `step` is a 0-d int64 tensor on the solver's device
that a solve (and guard_finite) advances by a device add; every random
stream of a solve is Philox under rng.stream_key(seed, tag) with that step
as its last counter word, so the same (seed, step) draws the same numbers
and another seed or step draws others; and no solve creates or seeds a
torch.Generator (which a solve captured as a CUDA graph would replay with
the same numbers). The replay itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py's `graph` phase).

Small sizes (N <= 16, H <= 6) on the reacher; each test well under a
second.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mjmpc_tpu_torch import envs, rng, solvers
from mjmpc_tpu_torch.rollout import Trajectories

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
H, N, DA = 5, 8, 7
FILTER = (0.25, 0.8, 0.0)


@pytest.fixture(scope="module")
def env():
    return envs.make("reacher_7dof-v0", device=DEVICE)


def _open_loop(cls, **more):
    return lambda: cls(d_action=DA, horizon=H, num_particles=N, filter_coeffs=FILTER,
                       device=DEVICE, **more)


SOLVERS = {
    "mppi": _open_loop(solvers.MPPI, lam=0.1, base_action="repeat"),
    "mppi_kernel_noise": _open_loop(solvers.MPPI, lam=0.1, noise_impl="kernel"),
    "random_shooting": _open_loop(solvers.RandomShooting, base_action="random"),
    "cem": _open_loop(solvers.CEM, elite_frac=0.25, cov_type="full"),
    "dmd": _open_loop(solvers.DMDMPC, lam=0.1, update_cov=True),
    "mppiq": _open_loop(solvers.MPPIQ, beta=0.1, td_lam=0.9, gamma=0.99),
    "pfmpc": _open_loop(solvers.PFMPC, base_action="random"),
    "reinforce": lambda: solvers.Reinforce(d_obs=envs.make("reacher_7dof-v0", device=DEVICE)
                                           .d_obs, d_action=DA, horizon=H, num_particles=N,
                                           filter_coeffs=FILTER, baseline_type=None,
                                           device=DEVICE),
    "softqmpc": lambda: solvers.SoftQMPC(d_obs=20, d_action=DA, horizon=H, num_particles=N,
                                         lam=0.1, device=DEVICE),
    "random_shooting_nn": lambda: solvers.RandomShootingNN(
        d_obs=20, d_action=DA, horizon=H, num_particles=N, hidden=(8,),
        filter_coeffs=FILTER, device=DEVICE),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
@pytest.mark.parametrize("guarded", [False, True])
def test_step_is_a_device_tensor_that_a_solve_advances(env, name, guarded):
    solver = SOLVERS[name]()
    solve = solvers.make_solve_fn(solver, env)
    if guarded:
        solve = solvers.guard_finite(solve, solver)
    state = solver.init_state(3)
    assert state.step.dtype == torch.int64 and state.step.dim() == 0
    assert state.step.device.type == DEVICE and int(state.step) == 0
    es = env.init(env.params, 1)
    _, _, s1 = solve(env.params, es, state)
    _, _, s2 = solve(env.params, es, s1)
    assert isinstance(s2.step, torch.Tensor) and s2.step.dtype == torch.int64
    assert (int(state.step), int(s1.step), int(s2.step)) == (0, 1, 2)   # not advanced in place
    assert s2.seed == state.seed == 3


def _mppi_state(solver, seed, step):
    return dataclasses.replace(solver.init_state(seed), step=rng.step_tensor(step, DEVICE))


def _pf_traj():
    costs = torch.as_tensor(np.random.default_rng(0).uniform(size=(N, H)), dtype=torch.float32)
    return Trajectories(None, None, costs, None, None, None)


def _draw_mppi(impl):
    solver = _open_loop(solvers.MPPI, noise_impl=impl)()
    return lambda seed, step: solver.sample_noise(_mppi_state(solver, seed, step))


def _draw_act():
    solver = _open_loop(solvers.MPPI, sample_mode="sample")()
    return lambda seed, step: solver.act(_mppi_state(solver, seed, step))


def _draw_shift_random():
    solver = _open_loop(solvers.MPPI, base_action="random")()
    return lambda seed, step: solver.shift(_mppi_state(solver, seed, step)).mean[-1]


@dataclasses.dataclass(frozen=True)
class _OffsetProbe(solvers.PFMPC):
    """PFMPC whose resampling returns its offset r as the particles."""

    def systematic_resample(self, samples, weights, r):
        return r.reshape(1, 1, 1)


def _draw_pf(what):
    cls = _OffsetProbe if what == "resample" else solvers.PFMPC
    solver = _open_loop(cls, base_action="random" if what == "random" else "null")()

    def draw(seed, step):
        state = _mppi_state(solver, 0, step)       # the same particles for every seed
        state = dataclasses.replace(state, seed=seed)
        if what == "resample":
            return solver.update(state, _pf_traj()).action_samples
        shifted = solver.shift(state).action_samples
        return shifted[:, -1] if what == "random" else shifted[:, :-1]

    return draw


def _draw_reinforce(what):
    solver = SOLVERS["reinforce"]()
    obs = torch.full((solver.d_obs,), 0.1)

    def draw(seed, step):
        state = _mppi_state(solver, seed, step)
        return solver.sample_noise(state) if what == "noise" else solver.act(state, obs, "sample")

    return draw


def _draw_learned(what):
    solver = SOLVERS["random_shooting_nn" if what == "rsnn" else "softqmpc"]()
    obs = torch.full((20,), 0.1)

    def draw(seed, step):
        state = _mppi_state(solver, seed, step)
        if what == "rsnn":
            return solver.sample_noise(state)
        return solver.white_noise(state) if what == "white" else solver.act(state, obs, "sample")

    return draw


STREAMS = {
    "mppi_plain_noise": lambda: _draw_mppi("plain"),
    "mppi_kernel_noise": lambda: _draw_mppi("kernel"),
    "act_sample": _draw_act,
    "shift_random_base_action": _draw_shift_random,
    "pfmpc_resample_offset": lambda: _draw_pf("resample"),
    "pfmpc_shift_noise": lambda: _draw_pf("shift"),
    "pfmpc_random_base_action": lambda: _draw_pf("random"),
    "reinforce_noise": lambda: _draw_reinforce("noise"),
    "reinforce_act_sample": lambda: _draw_reinforce("act"),
    "softq_white_noise": lambda: _draw_learned("white"),
    "softq_act_sample": lambda: _draw_learned("act"),
    "rsnn_noise": lambda: _draw_learned("rsnn"),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_every_stream_follows_seed_and_step(name):
    draw = STREAMS[name]()
    base = draw(3, 5)
    assert bool(torch.isfinite(base).all())
    torch.testing.assert_close(draw(3, 5), base, rtol=0, atol=0)
    assert not torch.equal(draw(3, 6), base)
    assert not torch.equal(draw(4, 5), base)


def test_pfmpc_initial_particles_follow_the_seed():
    solver = _open_loop(solvers.PFMPC)()
    a = solver.init_state(3).action_samples
    torch.testing.assert_close(solver.init_state(3).action_samples, a, rtol=0, atol=0)
    assert not torch.equal(solver.init_state(4).action_samples, a)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_no_solve_creates_a_generator(env, name, monkeypatch):
    """A solve of every family, guarded, with torch.Generator made to raise:
    every stream is Philox at the device-side step."""
    solver = SOLVERS[name]()
    if hasattr(solver, "sample_mode"):
        solver = dataclasses.replace(solver, sample_mode="sample")
    solve = solvers.guard_finite(solvers.make_solve_fn(solver, env), solver)
    state, es = solver.init_state(0), env.init(env.params, 1)

    def refuse(*args, **kwargs):
        raise AssertionError("a solve created a torch.Generator")

    monkeypatch.setattr(torch, "Generator", refuse)
    action, _, state = solve(env.params, es, state)
    assert bool(torch.isfinite(action).all()) and int(state.step) == 1


@pytest.mark.parametrize("name", ["softqmpc", "random_shooting_nn"])
def test_guard_resets_draw_fresh_parameters_at_each_step(env, name):
    """guard_finite's reset of a learned-model solver draws its parameters
    on the device from Philox at the state's step (reset_state), as the JAX
    guard's init_state(fold_in(key, step)) draws a fresh Q or MLP: resets
    at different steps give different, finite parameters, neither the
    seed's initial ones, and a reset is a function of (seed, step)."""
    solver = SOLVERS[name]()
    diverged = lambda p, es, s: (torch.full((DA,), float("nan")), torch.zeros(()), s)
    guarded = solvers.guard_finite(diverged, solver)
    es = env.init(env.params, 0)
    start = solver.init_state(6)

    def reset_at(step):
        s = dataclasses.replace(start, step=rng.step_tensor(step, DEVICE))
        action, value, out = guarded(env.params, es, s)
        assert float(action.abs().max()) == 0.0 and float(value) == 0.0 and int(out.step) == step + 1
        return out

    field = "q_params" if name == "softqmpc" else "policy_params"
    leaves = lambda s: solvers.tensor_leaves(getattr(s, field))
    a, b, again = reset_at(3), reset_at(7), reset_at(3)
    initial = leaves(start)
    assert leaves(a).keys() == leaves(b).keys() == initial.keys()
    for k in initial:
        if not initial[k].abs().max() > 0:   # zero biases and c stay zero
            continue
        assert bool(torch.isfinite(leaves(a)[k]).all()) and bool(torch.isfinite(leaves(b)[k]).all())
        assert not torch.equal(leaves(a)[k], leaves(b)[k]), k
        assert not torch.equal(leaves(a)[k], initial[k]), k
        torch.testing.assert_close(leaves(again)[k], leaves(a)[k], rtol=0, atol=0)
    # the first draw is init_state's, kept for the seed
    assert all(torch.equal(v, leaves(solver.init_state(6))[k]) for k, v in initial.items())
