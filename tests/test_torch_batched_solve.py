"""The batched solve (solvers.build_batched_solve_fn) and the batched
entries of kernels #1 and #2 against single solves and the JAX package.

- on the CPU the batched solve is the single solve of each element: B=3
  equals three single solves bit for bit, over two chained solves;
- its vectorised path (the card's: one batched draw and one batched
  rollout an iteration, the update, value and shift through
  torch.func.vmap), run here on CPU tensors, equals the single solves to
  2.3e-6, the MPPI update's tolerance (vmapped reductions may sum in
  another order);
- on injected noise both equal the JAX package's jax.vmap of the general
  solve (in_axes=(None, 0, 0)) to 2e-5, the fused-against-general solve
  tolerance;
- the batched kernels' CPU paths are the single calls per element, and a
  solver or env without a batched path raises NotImplementedError.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu_torch import convert, envs, ops, rng, solvers
from mjmpc_tpu_torch.ops.chain_rollout import ChainObsRollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
B = 3
SOLVE_ATOL = 2e-5
UPDATE_ATOL = 2.3e-6
FILTER = (0.25, 0.8, 0.0)
BASE = dict(d_action=7, horizon=4, num_particles=16, gamma=1.0, filter_coeffs=FILTER,
            device=DEVICE)
CONFIGS = {
    "mppi": ("mppi", dict(lam=0.01, init_cov=3.0, step_size=0.55, base_action="repeat")),
    "mppi_kernel_sampled_random": ("mppi", dict(lam=0.1, init_cov=3.0, step_size=0.55,
                                                base_action="random", sample_mode="sample",
                                                noise_impl="kernel")),
    "cem_full": ("cem", dict(elite_frac=0.2, beta=0.3, step_size=0.9, cov_type="full")),
    "random_shooting": ("random_shooting", {}),
    "dmd_update_cov": ("dmd", dict(lam=0.5, update_cov=True, beta=0.1,
                                   use_zero_control_seq=True)),
}


@pytest.fixture(scope="module")
def env():
    return envs.make("reacher_7dof-v0", device=DEVICE)


def _batch(env, solver):
    states = [solver.init_state(rng.derive_seed(0, i)) for i in range(B)]
    env_states = [env.init(env.params, rng.derive_seed(1, i)) for i in range(B)]
    return states, env_states, solvers.GaussianBatch.stack(states), solvers.stack_states(env_states)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_batched_solve_equals_single_solves(env, case):
    name, kw = CONFIGS[case]
    solver = solvers.make_solver(name, **BASE, **kw)
    states, env_states, batch, es = _batch(env, solver)
    bsolve = solvers.build_batched_solve_fn(solver, env)
    single = solvers.make_solve_fn(solver, env)
    a1, v1, b1 = bsolve(env.params, es, batch)
    a2, v2, b2 = bsolve(env.params, es, b1)
    va1, _, vb1 = bsolve.vectorised(env.params, es, batch)
    va2, _, vb2 = bsolve.vectorised(env.params, es, vb1)
    assert a1.shape == (B, 7) and v1.shape == (B,) and b2.step.tolist() == [2] * B
    assert vb2.step.tolist() == [2] * B and torch.equal(b2.keys, batch.keys)
    for i, (s, e) in enumerate(zip(states, env_states)):
        sa1, sv1, s1 = single(env.params, e, s)
        sa2, sv2, s2 = single(env.params, e, s1)
        for got, want in ((a1[i], sa1), (v1[i], sv1), (b1.mean[i], s1.mean), (b1.cov[i], s1.cov),
                          (a2[i], sa2), (v2[i], sv2), (b2.mean[i], s2.mean),
                          (b2.cov[i], s2.cov), (b2.step[i], s2.step)):
            assert torch.equal(got, want)
        for got, want in ((va1[i], sa1), (vb1.mean[i], s1.mean), (vb1.cov[i], s1.cov),
                          (va2[i], sa2), (vb2.mean[i], s2.mean), (vb2.cov[i], s2.cov)):
            torch.testing.assert_close(got, want, rtol=0, atol=UPDATE_ATOL)


@dataclasses.dataclass(frozen=True)
class InjectedMPPI(solvers.MPPI):
    """Test-only MPPI whose noise is given per seed, not sampled."""
    noise_of: dict = None

    def sample_noise(self, state):
        return self.noise_of[state.seed].clone()

    def sample_noise_batch(self, batch):
        return torch.stack([self.noise_of[seed] for seed in batch.seeds])


@pytest.fixture(scope="module")
def jax_batch():
    """B states of the JAX package's reacher and MPPI, their noise, and the
    vmapped general solve's action, value and states."""
    cfg = dict(d_action=7, horizon=4, num_particles=16, lam=0.2, init_cov=0.5,
               step_size=0.55, gamma=1.0, base_action="repeat", filter_coeffs=FILTER)
    jenv, jsolver = jenvs.make("reacher_7dof-v0"), jsolvers.MPPI(**cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = [jsolver.init_state(k) for k in keys]
    env_states = [jenv.init(jenv.params, k) for k in jax.random.split(jax.random.PRNGKey(1), B)]
    noise = [np.array(jsolver.sample_noise(s)) for s in states]
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    vsolve = jax.jit(jax.vmap(jsolvers.build_solve_fn(jsolver, jenv, fused=False),
                              in_axes=(None, 0, 0)))
    out = vsolve(jenv.params, stack(env_states), stack(states))
    return cfg, states, env_states, noise, jax.tree_util.tree_map(np.asarray, out)


def test_batched_solve_matches_jax_vmap(env, jax_batch):
    cfg, jstates, jenv_states, noise, (ja, jv, js) = jax_batch
    solver = InjectedMPPI(**cfg, device=DEVICE,
                          noise_of={i: torch.as_tensor(n) for i, n in enumerate(noise)})
    states = [convert.gaussian_state_from_reference(s, seed=i, device=DEVICE)
              for i, s in enumerate(jstates)]
    es = solvers.stack_states([convert.reacher_state_from_reference(s, device=DEVICE)
                               for s in jenv_states])
    bsolve = solvers.build_batched_solve_fn(solver, env)
    for solve in (bsolve, bsolve.vectorised):
        a, v, b = solve(env.params, es, solvers.GaussianBatch.stack(states))
        np.testing.assert_allclose(a.numpy(), ja, rtol=0, atol=SOLVE_ATOL)
        np.testing.assert_allclose(b.mean.numpy(), js.mean, rtol=0, atol=SOLVE_ATOL)
        assert b.step.tolist() == np.asarray(js.step).tolist() == [1] * B
        assert v.tolist() == [0.0] * B


def test_batched_kernels_on_the_cpu_are_the_single_calls(env):
    roll = env.fused_rollout.kernel
    rs = np.random.default_rng(0)
    q0, qd0 = (torch.as_tensor(np.asarray(rs.normal(size=(2, 7)) * 0.1, np.float32))
               for _ in range(2))
    target = torch.as_tensor(np.asarray(rs.normal(size=(2, 3)) * 0.2, np.float32))
    mean = torch.as_tensor(np.asarray(rs.normal(size=(2, 3, 7)) * 0.3, np.float32))
    noise = torch.as_tensor(np.asarray(rs.normal(size=(2, 5, 3, 7)) * 0.5, np.float32))
    costs = roll.batch(q0, qd0, target, mean, noise)
    assert costs.shape == (2, 5, 3)
    for i in range(2):
        assert torch.equal(costs[i], roll(q0[i], qd0[i], target[i], mean[i], noise[i]))
    assert torch.equal(env.fused_rollout.batched(env.params, solvers.stack_states(
        [env.init(env.params, 0)] * 2), mean, noise)[0],
        roll(torch.zeros(7), torch.zeros(7), env.init(env.params, 0).target, mean[0], noise[0]))
    with pytest.raises(ValueError):
        roll.batch(q0, qd0, target, mean[:1], noise)
    with pytest.raises(NotImplementedError):
        ChainObsRollout(roll.model, 2).batch(q0, qd0, target, mean, noise)

    sampler = ops.FilteredNoise()
    keys = ops.key_tensor([rng.stream_key(3, 0), 2 ** 64 - 5], DEVICE)
    steps = torch.tensor([4, 9])
    white = sampler.white_batch(keys, steps, 6, 5, 7, FILTER)
    assert white.shape == (2, 6, 5, 7)
    for i, key in enumerate((rng.stream_key(3, 0), 2 ** 64 - 5)):
        assert torch.equal(white[i], sampler.white(key, steps[i], 6, 5, 7, FILTER))
    cov = torch.stack([3.0 * torch.eye(7), torch.diag(torch.arange(1.0, 8.0))])
    coloured = ops.filtered_noise_batch(keys, steps, cov, (6, 5), FILTER)
    for i, key in enumerate((rng.stream_key(3, 0), 2 ** 64 - 5)):
        torch.testing.assert_close(coloured[i], ops.filtered_noise(key, steps[i], cov[i], (6, 5),
                                                                   FILTER), rtol=0, atol=1e-6)
    with pytest.raises(TypeError):
        sampler.white_batch(keys, steps.to(torch.int32), 6, 5, 7, FILTER)
    with pytest.raises(ValueError):
        sampler.white_batch(keys, steps[:1], 6, 5, 7, FILTER)


def test_batched_solve_raises_without_a_batched_path(env):
    cfg = dict(BASE, num_particles=8)
    for solver in (solvers.PFMPC(d_action=7, horizon=4, num_particles=8, device=DEVICE),
                   solvers.Reinforce(d_action=7, d_obs=env.d_obs, horizon=4, num_particles=8,
                                     device=DEVICE),
                   solvers.MPPIQ(**cfg)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
            solvers.build_batched_solve_fn(solver, env)
    for name in ("point_mass-v0", "continual_reacher-v0"):
        other = envs.make(name, device=DEVICE)
        solver = solvers.MPPI(**dict(cfg, d_action=other.d_action))
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
            solvers.build_batched_solve_fn(solver, other)
