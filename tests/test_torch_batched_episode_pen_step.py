"""pen-v0's env step of B = 2 stacked states (the real step of the batched
control step, harness/episode.py _build_batched_step_fn) against
jax.vmap of the JAX pen step, over K = 3 chained steps from the JAX env's
starts on PRNGKey(b) under seeded actions in the action bounds: qpos, qvel
and rewards at 1e-4 after every step. The JAX step under vmap compiles for
about 30 s on one core; the JAX loop's plan is in
test_torch_batched_episode_pen.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu_torch import convert, envs, solvers
from test_torch_batched_episode_jax import ATOL, B, DEVICE, K
from test_torch_closed_loop import _d, _lightly_compiled


def test_pen_batched_env_step_matches_vmapped_jax_step():
    jenv, env = jenvs.make("pen-v0"), envs.make("pen-v0", device=DEVICE)
    rs = np.random.default_rng(3)
    low, high = env.action_lows.numpy(), env.action_highs.numpy()
    actions = rs.uniform(low, high, size=(K, B, env.d_action)).astype(np.float32)

    @_lightly_compiled
    def jax_step(p, e, a):
        return jax.vmap(lambda e, a: jenv.step(p, e, a))(e, a)

    jes = [jenv.init(jenv.params, jax.random.PRNGKey(b)) for b in range(B)]
    e = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *jes)
    es = solvers.stack_states([convert.pen_state_from_reference(x, device=DEVICE) for x in jes])
    for k in range(K):
        e, _, jreward, _ = jax_step(jenv.params, e, jnp.asarray(actions[k]))
        es, _, reward, _ = env.step(env.params, es, torch.as_tensor(actions[k]))
        diffs = dict(qpos=_d(es.qpos, e.qpos), qvel=_d(es.qvel, e.qvel),
                     reward=_d(reward, jreward))
        assert max(diffs.values()) <= ATOL, (k, diffs)
        assert reward.shape == (B,) and es.timestep.tolist() == [k + 1] * B
    # the two episodes differ
    assert _d(e.qpos[0], e.qpos[1]) > 10 * ATOL
