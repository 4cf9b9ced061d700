"""pen-v0's batched control step (kernel #6's batched entry, its plain
version on the CPU, and one real pen step of the stacked state) against
jax.vmap over B = 2 episodes of K = 3 control steps of the JAX loop on
injected noise, at the config's mppi block cut to N = 16, H = 4: the JAX
loop (general rollout, update, act, clip, shift) plans from the port's
env states, and the actions and means agree at 1e-4 after every step
(test_torch_batched_episode_jax.py has the helper). The JAX pen step under
vmap, held to the port's step of the stacked state, is in
test_torch_batched_episode_pen_step.py: each compile of it takes about
30 s on one core.
"""
import jax.numpy as jnp

from mjmpc_tpu_torch import convert
from test_torch_batched_episode_jax import assert_loops_agree, batched_loops


def _pen_to_jax(port, like):
    """The port's stacked PenState as the JAX one (the same layout, the
    pen's quaternion wxyz; the timestep in `like`'s dtype)."""
    return like._replace(qpos=jnp.asarray(port.qpos.numpy()), qvel=jnp.asarray(port.qvel.numpy()),
                         desired=jnp.asarray(port.desired.numpy()),
                         timestep=jnp.asarray(port.timestep.numpy(), like.timestep.dtype))


def test_pen_batched_steps_match_vmapped_jax_loop():
    assert_loops_agree(batched_loops("configs/hand/pen-v0.yml", convert.pen_state_from_reference,
                                     to_jax=_pen_to_jax),
                       names=("action", "mean"))
