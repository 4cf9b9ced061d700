"""The batched entries of kernels #5 and #6 (the envs' batched hooks,
fused_rollout.batched, on the CPU their plain versions per element)
against jax.vmap of the JAX package's general rollout
(mjmpc_tpu.rollout.engine.rollout_open_loop) over B = 2 starts, the
counterpart of the JAX kernels under jax.vmap: the swimmer (#5) and the
sawyer peg (#6) to atol 5e-5, the kernel-against-engine tolerance, and
pen-v0 from a pinch (every fingertip pressing on the pen, so that the
costs follow the hand's dynamics through contact) to 1e-4, the pen
checks' tolerance. Never the JAX forest kernel in interpret mode (minutes
a compile). N = 8 particles, H = 3 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout
from mjmpc_tpu_torch import convert, envs, solvers
from mjmpc_tpu_torch.envs import pen

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
N, H, B = 8, 3, 2
# env: (converter of a JAX state, mean and noise scale, atol)
CASES = {"Swimmer-v0": (convert.loco_state_from_reference, 0.5, 5e-5),
         "sawyer_peg_insertion-v0": (convert.peg_state_from_reference, 0.3, 5e-5),
         "pen-v0": (convert.pen_state_from_reference, 0.3, 1e-4)}
HERE = ("Swimmer-v0", "sawyer_peg_insertion-v0")


def _jax_start(name, jenv, seed):
    """The JAX env's start: pen's with the pinch, its hand's joints
    perturbed by U(-0.05, 0.05); the peg's arm perturbed by N(0, 0.1)."""
    js = jenv.init(jenv.params, jax.random.PRNGKey(seed))
    rs = np.random.default_rng(seed)
    if name == "pen-v0":
        q = pen.pinch_qpos(torch.as_tensor(np.array(js.qpos)))
        q[:24] += torch.as_tensor(rs.uniform(-0.05, 0.05, 24), dtype=torch.float32)
        js = js._replace(qpos=jnp.asarray(q.numpy()))
    elif name == "sawyer_peg_insertion-v0":
        js = js._replace(qpos=js.qpos + jnp.asarray(rs.normal(size=7) * 0.1, jnp.float32))
    return js


def check_against_vmapped_jax(name):
    """The env's batched hook against jax.vmap of the JAX general rollout
    from B starts, at CASES[name]'s tolerance."""
    to_port, scale, atol = CASES[name]
    jenv, env = jenvs.make(name), envs.make(name, device=DEVICE)
    jstates = [_jax_start(name, jenv, seed) for seed in range(B)]
    rs = np.random.default_rng(7)
    means = np.asarray(rs.normal(size=(B, H, env.d_action)) * scale, np.float32)
    noise = np.asarray(rs.normal(size=(B, N, H, env.d_action)) * scale, np.float32)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    want = np.asarray(jax.jit(jax.vmap(lambda s, m, z: jax_rollout(
        jenv, jenv.params, s, m, z).costs))(stacked, jnp.asarray(means), jnp.asarray(noise)))
    states = solvers.stack_states([to_port(s, device=DEVICE) for s in jstates])
    got = env.fused_rollout.batched(env.params, states, torch.as_tensor(means),
                                    torch.as_tensor(noise)).numpy()
    assert got.shape == want.shape == (B, N, H)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the two elements' starts and means lead to different costs
    assert float(np.abs(want[0] - want[1]).max()) > 10 * atol


@pytest.mark.parametrize("name", HERE)
def test_batched_hook_matches_vmapped_jax_general_rollout(name):
    check_against_vmapped_jax(name)
