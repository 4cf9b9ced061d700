"""parallel/ in the port: meshes of torch devices, the sharded solve, the
sharded and the batched episode, against the unsharded port and the JAX
package's names.

Two shards run here as two CPU shards (each shard the plain version of its
kernel, or the env step on its slice of the particles): a two-shard solve
equals the unsharded solve on the same noise (the same solver state draws
the same Philox noise; atol 1e-6, where float reassociation could show; in
practice bit for bit) with the fused kernel (the reacher, #1's plain
version), with the general rollout (cartpole) and for PFMPC, whose
action_samples stay sharded between solves. A batch of episodes equals
the per-seed single episodes bit for bit, on one row and on two. Only a
mesh of one card runs on a card (tests/test_torch_cuda.py,
chip_smoke.py). initialize_multihost makes a world of one process on
gloo here (NCCL on the card, chip_smoke.py).
"""
import inspect
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mjmpc_tpu.parallel as jparallel
from mjmpc_tpu_torch import envs, parallel, solvers
from mjmpc_tpu_torch.harness import episode

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
TWO = parallel.make_mesh(devices=["cpu", "cpu"])
ONE = parallel.make_mesh(devices=["cpu"])


def test_exports_the_jax_names_but_initialize_multihost():
    """Every name of the JAX package's parallel/, initialize_multihost
    (once the one left out) among them, with the JAX signature."""
    assert set(jparallel.__all__) <= set(parallel.__all__)
    assert (inspect.signature(parallel.initialize_multihost).parameters.keys()
            == inspect.signature(jparallel.initialize_multihost).parameters.keys())


def test_initialize_multihost_on_gloo_at_world_size_one():
    """A world of one process on gloo (this host has no card) at a free
    tcp://127.0.0.1 port; a second call is a no-op; one all_reduce."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert not dist.is_initialized()
    parallel.initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        group = dist.group.WORLD
        parallel.initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0)
        assert dist.group.WORLD is group
        x = torch.arange(3.0)
        dist.all_reduce(x)
        torch.testing.assert_close(x, torch.arange(3.0), rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_mesh_layout_padding_and_shardings():
    mesh = parallel.make_mesh(episodes=2, devices=["cpu"] * 4)
    assert mesh.shape == {parallel.EPISODES_AXIS: 2, parallel.PARTICLES_AXIS: 2}
    assert parallel.pad_particles(37, mesh) == 38 and parallel.pad_particles(38, mesh) == 38
    with pytest.raises(ValueError):
        parallel.make_mesh(episodes=3, devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(6, 2, 2)
    parts = parallel.particle_sharding(mesh)(x)
    assert [p.shape[0] for p in parts] == [3, 3]
    torch.testing.assert_close(torch.cat(parts), x, rtol=0, atol=0)
    with pytest.raises(ValueError):
        parallel.particle_sharding(mesh)(x[0])
    assert len(parallel.replicated(mesh)(x)) == 4
    seeds = torch.arange(4)
    assert [p.tolist() for p in parallel.episode_sharding(mesh)(seeds)] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError):
        parallel.particle_slices(7, mesh)
    # the card alone by default, when there is one
    if torch.cuda.is_available():
        assert parallel.make_mesh().devices[0][0].type == "cuda"


def _compare(a, b):
    for x, y in zip(a[:2], b[:2]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    la, lb = solvers.tensor_leaves(a[2]), solvers.tensor_leaves(b[2])
    assert la.keys() == lb.keys()
    for k in la:
        torch.testing.assert_close(la[k], lb[k], rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("name,controller", [("reacher_7dof-v0", "mppi"),
                                             ("cartpole-v0", "mppi"),
                                             ("reacher_7dof-v0", "cem")])
def test_two_shard_solve_equals_the_unsharded_solve(name, controller):
    env = envs.make(name, device=DEVICE)
    cls = solvers.solver_class(controller)
    kw = dict(lam=0.1) if controller == "mppi" else dict(elite_frac=0.25)
    solver = cls(d_action=env.d_action, horizon=5, num_particles=12, device=DEVICE, **kw)
    es = env.init(env.params, 3)
    state = solver.init_state(4)
    plain = solvers.make_solve_fn(solver, env)
    sharded = parallel.build_sharded_solve_fn(solver, env, TWO)
    a, b = state, state
    for _ in range(2):   # the second solve starts from each one's own first
        out_a, out_b = plain(env.params, es, a), sharded(env.params, es, b)
        _compare(out_a, out_b)
        a, b = out_a[2], out_b[2]
    if name == "reacher_7dof-v0":   # the fused path: each shard calls the kernel
        assert parallel.shard_env(env, TWO, 12).fused_rollout is not None


def test_two_shard_pfmpc_keeps_its_samples_sharded():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    solver = solvers.PFMPC(d_action=7, horizon=5, num_particles=12, device=DEVICE)
    es = env.init(env.params, 1)
    plain = solvers.make_solve_fn(solver, env)
    sharded = parallel.build_sharded_solve_fn(solver, env, TWO)
    a = plain(env.params, es, solver.init_state(2))
    b = sharded(env.params, es, solver.init_state(2))
    samples = b[2].action_samples
    assert isinstance(samples, tuple) and [s.shape[0] for s in samples] == [6, 6]
    torch.testing.assert_close(torch.cat(samples), a[2].action_samples, rtol=0, atol=1e-6)
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=1e-6)
    # the next solve takes the sharded samples
    a2, b2 = plain(env.params, es, a[2]), sharded(env.params, es, b[2])
    torch.testing.assert_close(b2[0], a2[0], rtol=0, atol=1e-6)


def test_particles_must_split_over_the_shards():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    solver = solvers.MPPI(d_action=7, horizon=5, num_particles=13, device=DEVICE)
    with pytest.raises(ValueError, match="pad_particles"):
        parallel.build_sharded_solve_fn(solver, env, TWO)


def _single(solver, env, seeds, steps):
    run = episode.build_episode_fn(solver, env, steps)
    return [run(env.params, env.params, s)[0] for s in seeds]


@pytest.mark.parametrize("mesh", [ONE, parallel.make_mesh(episodes=2, devices=["cpu", "cpu"])],
                         ids=["one_row", "two_rows"])
def test_batch_episode_equals_per_seed_single_episodes(mesh):
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    solver = solvers.MPPI(d_action=1, horizon=6, num_particles=16, lam=0.1, device=DEVICE)
    seeds = [3, 8, 21]
    batch = parallel.build_batch_episode_fn(solver, env, 4, mesh)(env.params, seeds)
    singles = _single(solver, env, seeds, 4)
    for k, v in batch.items():
        assert v.shape[:2] == (3, 4)
        for b in range(3):
            torch.testing.assert_close(v[b], singles[b][k], rtol=0, atol=0)


def test_two_shard_episode_equals_the_unsharded_episode():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    solver = solvers.MPPI(d_action=7, horizon=4, num_particles=8, lam=0.1, device=DEVICE)
    got = parallel.build_sharded_episode_fn(solver, env, 3, TWO)(env.params, 5)
    want = _single(solver, env, [5], 3)[0]
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)
