"""Env wrappers in the port (envs/wrappers.py) against the JAX package's.

normalize_obs (observations, rewards with norm_reward, the running
statistics) and frame_stack (the stacked observations) on the same
observation streams: both packages' pendulums driven by the same actions
from the same state (atol 1e-5; the single-sample update is the JAX
formula operation for operation). Chan's merge of batches of different
sizes against JAX's rms_update folded over the same samples one by one
(rtol 1e-5). A wrapped env composes with the rollouts and a solve: its
costs-only fused rollout is the inner env's kernel, and a batched
rollout's statistics are each particle's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.envs import wrappers as jwrappers
from mjmpc_tpu_torch import envs, solvers
from mjmpc_tpu_torch.envs import wrappers
from mjmpc_tpu_torch.envs.pendulum import PendulumState
from mjmpc_tpu_torch.rollout.engine import rollout_open_loop

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
T = 40


_JAX_PEND = jenvs.make("SimplePendulum-v0")
_PORT_PEND = envs.make("SimplePendulum-v0", device=DEVICE)


def _start(jwrapped, wrapped, th, thdot):
    """Both wrapped states at the pendulum state (th, thdot), the frame
    buffer (if any) holding its observation."""
    js = jwrapped.init(jwrapped.params, jax.random.PRNGKey(0))
    s = wrapped.init(wrapped.params, 0)
    jinner = js.inner._replace(th=jnp.float32(th), thdot=jnp.float32(thdot))
    inner = PendulumState(th=torch.tensor(th), thdot=torch.tensor(thdot))
    js, s = js._replace(inner=jinner), dataclasses.replace(s, inner=inner)
    if hasattr(js, "frames"):
        jo = _JAX_PEND.observe(_JAX_PEND.params, jinner)
        js = js._replace(frames=jnp.zeros_like(js.frames).at[-1].set(jo))
        o = _PORT_PEND.observe(_PORT_PEND.params, inner)
        s = dataclasses.replace(s, frames=torch.cat([torch.zeros_like(s.frames[:-1]), o[None]]))
    return js, s


def _streams(jwrapped, wrapped, seed):
    """Both wrapped pendulums from the same start under the same actions:
    (JAX obs, port obs, JAX rewards, port rewards, JAX state, port state)."""
    rs = np.random.default_rng(seed)
    actions = np.asarray(rs.uniform(-2.5, 2.5, (T, 1)), np.float32)
    js, s = _start(jwrapped, wrapped, np.float32(rs.uniform(-np.pi, np.pi)),
                   np.float32(rs.uniform(-1, 1)))
    jstep, out = jax.jit(jwrapped.step), ([], [], [], [])
    for a in actions:
        js, jo, jr, _ = jstep(jwrapped.params, js, jnp.asarray(a))
        s, o, r, _ = wrapped.step(wrapped.params, s, torch.as_tensor(a))
        for lst, v in zip(out, (np.asarray(jo), o.numpy(), float(jr), float(r))):
            lst.append(v)
    return [np.asarray(x) for x in out] + [js, s]


@pytest.mark.parametrize("norm_reward", [False, True])
def test_normalize_obs_matches_jax(norm_reward):
    jenv = jwrappers.normalize_obs(_JAX_PEND, clip_obs=5.0,
                                   norm_reward=norm_reward)
    env = wrappers.normalize_obs(_PORT_PEND, clip_obs=5.0, norm_reward=norm_reward)
    assert env.name == jenv.name and env.d_obs == jenv.d_obs
    jo, o, jr, r, js, s = _streams(jenv, env, 3)
    np.testing.assert_allclose(o, jo, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-5)
    assert np.abs(o).max() <= 5.0 and float(s.rms.count) == pytest.approx(T + 1e-4)
    for f in ("mean", "var"):
        np.testing.assert_allclose(getattr(s.rms, f).numpy(), np.asarray(getattr(js.rms, f)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(s.ret_rms.var), float(js.ret_rms.var), rtol=1e-5)
    if norm_reward:
        assert env.fused_rollout is None
    else:   # the reward is the inner env's: its kernel still plans
        assert env.fused_rollout is not None


@pytest.mark.parametrize("k", [2, 4])
def test_frame_stack_matches_jax(k):
    jenv = jwrappers.frame_stack(_JAX_PEND, k=k)
    env = wrappers.frame_stack(_PORT_PEND, k=k)
    assert env.d_obs == jenv.d_obs == 3 * k
    jo, o, jr, r, js, s = _streams(jenv, env, 5)
    np.testing.assert_allclose(o, jo, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.frames.numpy(), np.asarray(js.frames), rtol=0, atol=1e-5)
    # the oldest frame first: the last frame is the newest observation
    np.testing.assert_allclose(o[-1][-3:], o[-1].reshape(k, 3)[-1], rtol=0, atol=0)


@pytest.mark.parametrize("sizes", [(1, 7, 3, 12), (5, 5, 1, 20, 2)])
def test_chan_merge_of_batches_matches_jax_sample_by_sample(sizes):
    rs = np.random.default_rng(len(sizes))
    xs = np.asarray(rs.normal(size=(sum(sizes), 4)) * [1.0, 3.0, 0.1, 10.0] + [0, 2, -1, 5],
                    np.float32)
    jr = jwrappers.rms_init((4,))
    upd = jax.jit(jwrappers.rms_update)
    for x in xs:
        jr = upd(jr, jnp.asarray(x))
    r, off = wrappers.rms_init((4,), device=DEVICE), 0
    for b in sizes:
        r = wrappers.rms_update(r, torch.as_tensor(xs[off:off + b]), batch=True)
        off += b
    np.testing.assert_allclose(r.mean.numpy(), np.asarray(jr.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r.var.numpy(), np.asarray(jr.var), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(r.count), float(jr.count), rtol=1e-6)
    # a single sample's merge is JAX's rms_update exactly
    one = wrappers.rms_update(wrappers.rms_init((4,), device=DEVICE), torch.as_tensor(xs[0]))
    jone = jwrappers.rms_update(jwrappers.rms_init((4,)), jnp.asarray(xs[0]))
    np.testing.assert_array_equal(one.mean.numpy(), np.asarray(jone.mean))
    np.testing.assert_array_equal(one.var.numpy(), np.asarray(jone.var))


def test_wrapped_env_composes_with_rollouts_and_solves():
    env = wrappers.frame_stack(wrappers.normalize_obs(_PORT_PEND), k=3)
    state = env.init(env.params, 2)
    rs = np.random.default_rng(0)
    mean = torch.as_tensor(np.asarray(rs.normal(size=(5, 1)), np.float32))
    noise = torch.as_tensor(np.asarray(rs.normal(size=(6, 5, 1)), np.float32))
    traj = rollout_open_loop(env, env.params, state, mean, noise)
    assert traj.observations.shape == (6, 5, 9)
    # the costs are the inner env's: the wrapped fused rollout (kernel #7's
    # plain version on the inner state) gives the general rollout's
    fused = env.fused_rollout(env.params, state, mean, noise)
    torch.testing.assert_close(fused, traj.costs, rtol=0, atol=1e-5)
    # each particle's statistics are its own: particle 0 alone gives its row
    one = rollout_open_loop(env, env.params, state, mean, noise[:1])
    torch.testing.assert_close(one.observations[0], traj.observations[0], rtol=0, atol=0)
    solver = solvers.MPPI(d_action=1, horizon=5, num_particles=6, lam=0.1, device=DEVICE)
    solve = solvers.guard_finite(solvers.make_solve_fn(solver, env), solver)
    action, _, s = solve(env.params, state, solver.init_state(0))
    assert action.shape == (1,) and bool(torch.isfinite(action).all()) and int(s.step) == 1
    # with_params rebinds the inner env's params and keeps the kernel
    assert env.with_params(env.params).fused_rollout is not None
