"""Dynamics randomization in the port (envs/randomize.py, Env.with_params,
run_mpc --dyn_randomize_config) against the JAX package.

For each of the nine specs of configs/dyn_randomize/ with its env: the
defaults and the randomized values equal the JAX package's exactly (the
same np.random.RandomState draws in the same order), and so does every
perturbed params leaf; repeated calls do not drift; randomize_batch equals
JAX's stacked leaves. An unknown field raises; a [0, 0] name that no table
maps is tolerated (cartpole's spec).

The perturbed env keeps its kernels, built anew from its model
(Env.with_params): the plain version of the reacher's #1 built from the
perturbed model holds to atol 5e-5 (the kernel-against-engine tolerance)
against the JAX package's general rollout on the perturbed params, and
the nominal model's kernel misses by more (the perturbation shows); pen's
#6: tests/test_torch_randomize_kernels.py; run_mpc
--dyn_randomize_config: tests/test_torch_harness.py and
tests/test_torch_randomize_run_mpc.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.envs import randomize as jrandomize
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout
from mjmpc_tpu_torch import convert, envs
from mjmpc_tpu_torch.envs import randomize

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
KERNEL_ATOL = 5e-5
_DIR = os.path.join(os.path.dirname(__file__), "..", "configs", "dyn_randomize")

# each spec of configs/dyn_randomize/ and the env it parameterizes
SPECS = {
    "cartpole.yml": "cartpole-v0",
    "hand_hammer.yml": "hammer-v0",
    "hand_pen.yml": "pen-v0",
    "panda_tray_glass-v1.yml": "panda_tray_glass-v1",
    "panda_tray_glass.yml": "panda_tray_glass-v0",
    "reacher_7dof.yml": "reacher_7dof-v0",
    "sawyer_peg_insertion-v0.yml": "sawyer_peg_insertion-v0",
    "sawyer_peg_insertion-v1.yml": "sawyer_peg_insertion-v1",
    "sawyer_pusher.yml": "sawyer_pusher-v0",
}


def _spec(name):
    with open(os.path.join(_DIR, name)) as f:
        return yaml.safe_load(f)


def _assert_values_equal(got, want):
    assert got.keys() == want.keys()
    for field in want:
        assert got[field].keys() == want[field].keys()
        for name, w in want[field].items():
            g = got[field][name]
            if w is None:
                assert g is None, (field, name)
            else:
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{field}/{name}")


def _paths(jenv, spec):
    """(field, name, params path, index) of every mapped entry of the spec."""
    out = []
    for field, names in spec.items():
        for name, dist in names.items():
            try:
                path, idx = jrandomize._resolve(jenv, field, name)
            except ValueError:
                continue
            out.append((field, name, path, idx))
    return out


def _leaf(params, path):
    for part in path.split("."):
        params = getattr(params, part)
    return params.numpy() if isinstance(params, torch.Tensor) else np.asarray(params)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_values_and_params_equal_jax_for_each_spec(spec_name):
    name, spec = SPECS[spec_name], _spec(spec_name)
    jenv, env = jenvs.make(name), envs.make(name, device=DEVICE)
    jnew, jdef, jrnd = jenvs.randomize_dynamics(jenv, spec, base_seed=17)
    params, dflt, rnd = randomize.perturbed_params(env, spec, base_seed=17)
    _assert_values_equal(dflt, jdef)
    _assert_values_equal(rnd, jrnd)
    mapped = _paths(jenv, spec)
    assert mapped, "the spec maps no entry"
    for field, key, path, _ in mapped:
        np.testing.assert_array_equal(_leaf(params, path), np.asarray(_leaf(jnew.params, path)),
                                      err_msg=f"{field}/{key} -> {path}")
        # the env's own params are untouched
        np.testing.assert_array_equal(_leaf(env.params, path),
                                      np.asarray(_leaf(jenv.params, path)))
    # repeated calls do not drift: the defaults come from the env's own params
    again, dflt2, rnd2 = randomize.perturbed_params(env, spec, base_seed=17)
    _assert_values_equal(dflt2, jdef)
    _assert_values_equal(rnd2, jrnd)


@pytest.mark.parametrize("spec_name", ["reacher_7dof.yml", "panda_tray_glass.yml",
                                       "sawyer_pusher.yml"])
def test_randomize_batch_equals_jax_stacked_leaves(spec_name):
    name, spec = SPECS[spec_name], _spec(spec_name)
    jenv, env = jenvs.make(name), envs.make(name, device=DEVICE)
    jbatch = jenvs.randomize_batch(jenv, spec, base_seed=5, n=3)
    batch = randomize.randomize_batch(env, spec, base_seed=5, n=3)
    for field, key, path, _ in _paths(jenv, spec):
        got, want = _leaf(batch, path), np.asarray(_leaf(jbatch, path))
        assert got.shape[0] == 3
        np.testing.assert_array_equal(got, want, err_msg=f"{field}/{key}")
    assert batch.model.joint_types == env.params.model.joint_types


def test_unknown_field_raises_and_zeroed_unmapped_name_is_tolerated():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    with pytest.raises(ValueError, match="unknown dynamics field"):
        randomize.perturbed_params(env, {"body_colour": {"r_wrist_roll_link": [0.1, 0.0]}})
    with pytest.raises(ValueError, match="no name table entry"):
        randomize.perturbed_params(env, {"body_mass": {"no_such_link": [0.1, 0.0]}})
    params, dflt, rnd = randomize.perturbed_params(
        env, {"body_mass": {"no_such_link": [0.0, 0.0]}})
    assert dflt["body_mass"]["no_such_link"] is None and rnd["body_mass"]["no_such_link"] is None
    np.testing.assert_array_equal(params.model.mass.numpy(), env.params.model.mass.numpy())
    # cartpole's spec: inertia and damping are [0, 0] on names the analytic env lacks
    cart = envs.make("cartpole-v0", device=DEVICE)
    _, dflt, rnd = randomize.perturbed_params(cart, _spec("cartpole.yml"), base_seed=3)
    assert dflt["body_inertia"]["cart"] is None and rnd["dof_damping"]["hinge"] is None
    assert float(rnd["body_mass"]["cart"]) == pytest.approx(0.5 * float(dflt["body_mass"]["cart"]))


def test_with_params_rebuilds_the_kernels_and_keeps_the_rest():
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    rand, _, _ = envs.randomize_dynamics(env, _spec("reacher_7dof.yml"), base_seed=2)
    assert rand.name == env.name and rand.init is env.init and rand.step is env.step
    for f in ("fused_rollout", "fused_obs_rollout", "fused_cl_rollout"):
        assert getattr(rand, f) is not None and getattr(rand, f) is not getattr(env, f)
    # an env without build_fused drops its kernels rather than keep stale ones
    bare = dataclasses.replace(env, build_fused=None)
    assert bare.with_params(rand.params).fused_rollout is None


def _reacher_inputs(n, h, seed):
    rs = np.random.default_rng(seed)
    q = np.asarray(rs.normal(size=7) * 0.3, np.float32)
    qd = np.asarray(rs.normal(size=7) * 0.5, np.float32)
    target = np.asarray([0.2, -0.1, 0.15], np.float32)
    mean = np.asarray(rs.normal(size=(h, 7)) * 0.3, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, 7)) * 0.5, np.float32)
    return q, qd, target, mean, noise


def test_perturbed_reacher_kernel_twin_matches_jax_general_rollout():
    spec = _spec("reacher_7dof.yml")
    jenv, env = jenvs.make("reacher_7dof-v0"), envs.make("reacher_7dof-v0", device=DEVICE)
    jrand, _, _ = jenvs.randomize_dynamics(jenv, spec, base_seed=11)
    rand, _, _ = envs.randomize_dynamics(env, spec, base_seed=11)
    q, qd, target, mean, noise = _reacher_inputs(16, 6, 0)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))._replace(
        qpos=jnp.asarray(q), qvel=jnp.asarray(qd), target=jnp.asarray(target))
    want = np.asarray(jax_rollout(jrand, jrand.params, js, jnp.asarray(mean),
                                  jnp.asarray(noise)).costs)
    state = convert.reacher_state_from_reference(js, device=DEVICE)
    got = rand.fused_rollout(rand.params, state, torch.as_tensor(mean),
                             torch.as_tensor(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)
    nominal = env.fused_rollout(env.params, state, torch.as_tensor(mean),
                                torch.as_tensor(noise)).numpy()
    assert np.abs(nominal - want).max() > 10 * KERNEL_ATOL
