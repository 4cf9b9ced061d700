"""Kernel #6 built from the perturbed pen (Env.with_params through
envs.randomize_dynamics, configs/dyn_randomize/hand_pen.yml) against the
JAX package's general rollout on the perturbed params, from the pinch: its
plain version holds to atol 5e-5, the kernel-against-engine tolerance,
and the nominal model's kernel misses by more than 10x that (the
perturbation shows). The JAX forest kernel is never compiled here (an
interpret-mode compile of minutes). The reacher's #1:
tests/test_torch_randomize.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout
from mjmpc_tpu_torch import convert, envs
from mjmpc_tpu_torch.envs import pen

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
KERNEL_ATOL = 5e-5
_DIR = os.path.join(os.path.dirname(__file__), "..", "configs", "dyn_randomize")


def _spec(name):
    with open(os.path.join(_DIR, name)) as f:
        return yaml.safe_load(f)


def test_perturbed_pen_kernel_twin_matches_jax_general_rollout():
    spec = _spec("hand_pen.yml")
    jenv, env = jenvs.make("pen-v0"), envs.make("pen-v0", device=DEVICE)
    jrand, _, _ = jenvs.randomize_dynamics(jenv, spec, base_seed=4)
    rand, _, _ = envs.randomize_dynamics(env, spec, base_seed=4)
    assert rand.params.model.mass[pen.PEN_BODY] != env.params.model.mass[pen.PEN_BODY]
    rs = np.random.default_rng(1)
    n, h = 4, 3
    mean = np.asarray(rs.normal(size=(h, 24)) * 0.2, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, 24)) * 0.3, np.float32)
    js = jenv.init(jenv.params, jax.random.PRNGKey(1))
    q = pen.pinch_qpos(torch.as_tensor(np.array(js.qpos)))
    q[:24] += torch.as_tensor(rs.uniform(-0.05, 0.05, 24), dtype=torch.float32)
    js = js._replace(qpos=jnp.asarray(q.numpy()))
    want = np.asarray(jax_rollout(jrand, jrand.params, js, jnp.asarray(mean),
                                  jnp.asarray(noise)).costs)
    state = convert.pen_state_from_reference(js, device=DEVICE)
    got = rand.fused_rollout(rand.params, state, torch.as_tensor(mean),
                             torch.as_tensor(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)
    nominal = env.fused_rollout(env.params, state, torch.as_tensor(mean),
                                torch.as_tensor(noise)).numpy()
    assert np.abs(nominal - want).max() > 10 * KERNEL_ATOL
