"""The batched entries of kernels #5, #6 and #7 (ChainExtRollout.batch,
ForestRollout.batch, PendulumRollout.batch: B rollouts in one launch) on
the CPU, where each runs its plain version, and against the JAX package.

- batch_plain at B = 1 and 3 equals the single plain call of each element
  bit for bit (#5 for the swimmer and the cheetah, #6 for pen from a
  pinch, the sawyer peg and relocate from the grasp, #7), and `.batch` on
  CPU tensors is batch_plain;
- shape and dtype errors raise (a non-contiguous argument raises on the
  card, where the kernel launches: tests/test_torch_cuda.py);
- every env with a fused rollout has its batched hook
  (`fused_rollout.batched`), and Env.with_params keeps it;
- #7 against jax.vmap(pendulum_rollout_pallas) in interpret mode (the
  Pallas batching rule itself) to atol 1e-5. #5 and #6 are held against
  jax.vmap of the JAX general rollout in test_torch_batched_rollouts.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.ops import pallas_kernels as pk
from mjmpc_tpu_torch import envs, solvers
from mjmpc_tpu_torch.envs import pen, relocate
from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
from mjmpc_tpu_torch.envs.swimmer import pad_base
from mjmpc_tpu_torch.ops import pendulum as P

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
N, H = 8, 3
NB, HB = 4, 2    # the per-element checks' size: the plain forest rollouts are slow on the CPU
# every env whose fused rollout has a batched entry (#1, #5, #6, #7)
BATCHED_ENVS = ("reacher_7dof-v0", "Swimmer-v0", "HalfCheetah-v0", "pen-v0", "relocate-v0",
                "hammer-v0", "door-v0", "sawyer_peg_insertion-v0", "sawyer_pusher-v0",
                "sawyer_door-v0", "panda_tray_glass-v0", "panda_tray_glass-v1",
                "panda_tray_glass_fixed-v1", "SimplePendulum-v0")


def _draws(b, n, h, d, seed, scale=0.3):
    """means [B, H, d] * scale and noise [B, N, H, d] * scale."""
    rs = np.random.default_rng(seed)
    return (torch.as_tensor(np.asarray(rs.normal(size=(b, h, d)) * scale, np.float32)),
            torch.as_tensor(np.asarray(rs.normal(size=(b, n, h, d)) * scale, np.float32)))


def _starts(name, env, b):
    """B env states: pen from a pinch, relocate from the grasp (the ball
    lifted), the others from their inits."""
    states = []
    for seed in range(b):
        st = env.init(env.params, seed)
        if name == "pen-v0":
            st = dataclasses.replace(st, qpos=pen.pinch_qpos(st.qpos))
        elif name == "relocate-v0":
            st = dataclasses.replace(st, qpos=relocate.grasp_qpos(st.qpos))
        states.append(st)
    return states


def _loco_args(env, states, means, noise):
    """#5's arguments: the states and the actions with the three unactuated
    base dofs padded in (the envs' control layout)."""
    st = solvers.stack_states(states)
    return st.qpos, st.qvel, pad_base(means), pad_base(noise)


def _forest_args(name, env, states):
    """#6's q0 [B, nq], qd0 [B, nv] and extras [B, n_extras]."""
    st = solvers.stack_states(states)
    extras = {"pen-v0": lambda: pen.pen_extras(env.params, st),
              "relocate-v0": lambda: relocate.relocate_extras(env.params, st),
              "sawyer_peg_insertion-v0": lambda: peg_extras(env.params).expand(
                  st.qpos.shape[:1] + (-1,)).contiguous()}[name]()
    return st.qpos, st.qvel, extras


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name", ["Swimmer-v0", "HalfCheetah-v0", "pen-v0",
                                  "sawyer_peg_insertion-v0", "relocate-v0",
                                  "SimplePendulum-v0"])
def test_batch_plain_is_the_single_plain_call_per_element(name, b):
    env = envs.make(name, device=DEVICE)
    states = _starts(name, env, b)
    means, noise = _draws(b, NB, HB, env.d_action, seed=b)
    roll = getattr(env.fused_rollout, "kernel", env.fused_rollout)
    if name == "SimplePendulum-v0":
        st = solvers.stack_states(states)
        got, again = roll.batch_plain(env.params, st, means, noise), roll.batch(
            env.params, st, means, noise)
        singles = [roll.plain(env.params, s, means[i], noise[i]) for i, s in enumerate(states)]
    else:
        head = (_loco_args(env, states, means, noise) if name in ("Swimmer-v0", "HalfCheetah-v0")
                else _forest_args(name, env, states) + (means, noise))
        got, again = roll.batch_plain(*head), roll.batch(*head)
        singles = [roll.plain(*(x[i] for x in head)) for i in range(b)]
    assert got.shape == (b, NB, HB) and bool(torch.isfinite(got).all())
    assert torch.equal(got, torch.stack(singles)) and torch.equal(again, got)
    # the elements differ: each reads its own rows
    if b > 1:
        assert not torch.equal(got[0], got[1])
    # the env's hook is the same batched call
    hooked = env.fused_rollout.batched(env.params, solvers.stack_states(states), means, noise)
    assert torch.equal(hooked, got)


def test_batched_entries_raise_on_bad_shapes_and_dtypes():
    swim = envs.make("Swimmer-v0", device=DEVICE)
    ext = swim.fused_rollout.kernel
    args = _loco_args(swim, _starts("Swimmer-v0", swim, 2), *_draws(2, N, H, 4, seed=0))
    with pytest.raises(ValueError):
        ext.batch(args[0][:1], *args[1:])             # q0 of one element for two
    with pytest.raises(ValueError):
        ext.batch(*args[:3], args[3][0])              # noise without its batch axis
    with pytest.raises(TypeError):
        ext.batch(args[0].double(), *args[1:])
    peg = envs.make("sawyer_peg_insertion-v0", device=DEVICE)
    forest = peg.fused_rollout.kernel
    head = _forest_args("sawyer_peg_insertion-v0", peg, _starts("sawyer_peg_insertion-v0",
                                                                 peg, 2))
    means, noise = _draws(2, N, H, 7, seed=1)
    with pytest.raises(ValueError):
        forest.batch(*head[:2], head[2][0], means, noise)     # extras without the batch
    with pytest.raises(ValueError):
        forest.batch(*head, means[:, :2], noise)             # a mean two steps long for three
    with pytest.raises(TypeError):
        forest.batch(*head, means, noise.double())
    pend = envs.make("SimplePendulum-v0", device=DEVICE)
    st = solvers.stack_states(_starts("SimplePendulum-v0", pend, 2))
    means, noise = _draws(2, N, H, 1, seed=2)
    with pytest.raises(ValueError):
        P.pendulum_rollout.batch(pend.params, st, means[:1], noise)
    with pytest.raises(ValueError):
        P.pendulum_rollout.batch(pend.params, st, means, noise[0])
    with pytest.raises(ValueError):   # a param with a batch axis of another length
        P.pendulum_rollout.batch(dataclasses.replace(pend.params, g=pend.params.g.expand(3)),
                                 st, means, noise)
    with pytest.raises(TypeError):
        P.pendulum_rollout.batch(pend.params, st, means.double(), noise)


def test_pendulum_batch_takes_params_per_element():
    """Each param 0-d (shared) or [B] (one model an element): element b is
    the single rollout on element b's params."""
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    states = _starts("SimplePendulum-v0", env, 2)
    params = dataclasses.replace(env.params, g=torch.tensor([10.0, 9.0]),
                                 max_torque=torch.tensor([2.0, 1.0]))
    means, noise = _draws(2, N, H, 1, seed=3, scale=1.0)
    got = P.pendulum_rollout.batch(params, solvers.stack_states(states), means, noise)
    for i, s in enumerate(states):
        p_i = dataclasses.replace(env.params, g=params.g[i], max_torque=params.max_torque[i])
        assert torch.equal(got[i], P.pendulum_rollout(p_i, s, means[i], noise[i]))
    assert not torch.equal(got[1], P.pendulum_rollout(env.params, states[1], means[1], noise[1]))


@pytest.mark.parametrize("name", BATCHED_ENVS)
def test_every_fused_env_has_a_batched_hook_that_with_params_keeps(name):
    env = envs.make(name, device=DEVICE)
    assert callable(env.fused_rollout.batched)
    rebuilt = env.with_params(env.params)
    assert rebuilt.fused_rollout is not None and callable(rebuilt.fused_rollout.batched)
    assert solvers.check_batchable(solvers.MPPI(d_action=env.d_action, horizon=H,
                                                num_particles=N, device=DEVICE),
                                   rebuilt) == rebuilt.fused_rollout.batched


def test_pendulum_batch_matches_vmapped_pallas_kernel():
    """#7's batch against jax.vmap(pendulum_rollout_pallas) in interpret
    mode over B = 3 starts, one of them crossing -pi (the batching rule
    lifts the batch into the Pallas grid): atol 1e-5."""
    jenv, env = jenvs.make("SimplePendulum-v0"), envs.make("SimplePendulum-v0", device=DEVICE)
    th0 = np.array([-3.0, 0.5, 2.9], np.float32)
    thdot0 = np.array([-8.0, 0.3, 4.0], np.float32)
    means, noise = _draws(3, 16, 8, 1, seed=4, scale=1.0)
    want = np.asarray(jax.vmap(lambda a, b, m, z: pk.pendulum_rollout_pallas(
        jenv.params, a, b, m, z))(jnp.asarray(th0), jnp.asarray(thdot0),
                                  jnp.asarray(means.numpy()), jnp.asarray(noise.numpy())))
    states = type(env.init(env.params, 0))(th=torch.as_tensor(th0), thdot=torch.as_tensor(thdot0))
    got = P.pendulum_rollout.batch(env.params, states, means, noise).numpy()
    assert got.shape == want.shape == (3, 16, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert float(np.abs(want[0] - want[1]).max()) > 1e-2
