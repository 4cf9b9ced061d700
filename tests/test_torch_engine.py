"""The port's chain engine on the reacher model against the JAX engine and
the f64 C++ oracle (cpp_oracle.chain_mass_matrix, chain_bias, chain_step).

Tolerance: atol 1e-5. The port and the JAX engine compute in f32 (sums in
different orders, the bias by different AD systems); the oracle in f64.
Mass-matrix entries and bias forces are O(1), where f32 round-off
through FK, the Jacobians and the solve stays below 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.engine import chain as jrb
from mjmpc_tpu.oracle import cpp_oracle
from mjmpc_tpu_torch import convert, envs
from mjmpc_tpu_torch.convert import _MODEL_TENSORS
from mjmpc_tpu_torch.engine import chain as rb

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jmodel = jenvs.make("reacher_7dof-v0").params.model
    return jmodel, convert.chain_model_from_reference(jmodel, device=DEVICE)


def _states(n, seed):
    rng = np.random.default_rng(seed)
    q = (0.4 * rng.normal(size=(n, 7))).astype(np.float32)
    qd = rng.normal(size=(n, 7)).astype(np.float32)
    return q, qd


def test_reacher_body_table_equals_the_jax_model(models):
    """The port carries the sawyer body table over as-is: its model is the
    JAX model, field for field."""
    _, converted = models
    own = envs.make("reacher_7dof-v0", device=DEVICE).params.model
    for name in _MODEL_TENSORS:
        torch.testing.assert_close(getattr(own, name), getattr(converted, name),
                                   rtol=0, atol=0)
    for name in ("parent", "joint_types", "dt", "site_body"):
        assert getattr(own, name) == getattr(converted, name)


def test_site_position_matches_jax_and_oracle(models):
    jmodel, model = models
    q, _ = _states(4, 0)
    got = rb.site_position(model, torch.as_tensor(q)).numpy()
    for i in range(len(q)):
        np.testing.assert_allclose(got[i], cpp_oracle.chain_site(jmodel, q[i]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            got[i], np.asarray(jrb.site_position(jmodel, jnp.asarray(q[i]))),
            rtol=0, atol=ATOL)


def test_mass_matrix_and_bias_match_jax_and_oracle(models):
    jmodel, model = models
    q, qd = _states(3, 1)
    m = rb.mass_matrix(model, torch.as_tensor(q)).numpy()
    bias = rb.bias_forces(model, torch.as_tensor(q), torch.as_tensor(qd)).numpy()
    jbias = jax.jit(jax.vmap(lambda a, b: jrb.bias_forces(jmodel, a, b)))(q, qd)
    jm = jax.jit(jax.vmap(lambda a: jrb.mass_matrix(jmodel, a)))(q)
    for i in range(len(q)):
        np.testing.assert_allclose(m[i], cpp_oracle.chain_mass_matrix(jmodel, q[i]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(bias[i], cpp_oracle.chain_bias(jmodel, q[i], qd[i]),
                                   rtol=0, atol=ATOL)
    np.testing.assert_allclose(m, np.asarray(jm), rtol=0, atol=ATOL)
    np.testing.assert_allclose(bias, np.asarray(jbias), rtol=0, atol=ATOL)


def test_step_matches_oracle_batched_and_single(models):
    """Two substeps from states near and beyond the joint limits (the
    clamp and the zeroed velocity included), batched and unbatched."""
    jmodel, model = models
    q, qd = _states(4, 2)
    q[0] = np.asarray(jmodel.qpos_high) - 1e-3      # pushes into the limits
    qd[0] = 5.0
    ctrl = np.random.default_rng(3).uniform(-1, 1, size=(4, 7)).astype(np.float32)
    qn, qdn = rb.step(model, torch.as_tensor(q), torch.as_tensor(qd),
                      torch.as_tensor(ctrl), n_substeps=2)
    for i in range(len(q)):
        qo, qdo = cpp_oracle.chain_step(jmodel, q[i], qd[i], ctrl[i], n_substeps=2)
        np.testing.assert_allclose(qn[i].numpy(), qo, rtol=0, atol=ATOL)
        np.testing.assert_allclose(qdn[i].numpy(), qdo, rtol=0, atol=ATOL)
    q1, qd1 = rb.step(model, torch.as_tensor(q[1]), torch.as_tensor(qd[1]),
                      torch.as_tensor(ctrl[1]), n_substeps=2)
    np.testing.assert_allclose(q1.numpy(), qn[1].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(qd1.numpy(), qdn[1].numpy(), rtol=0, atol=1e-6)
    assert (qdn[0].numpy()[np.isclose(qn[0].numpy(), np.asarray(jmodel.qpos_high))]
            == 0).all()


# The name is older than the ball and free joints' port and is kept so that
# the test keeps its identity; it now checks that both joints are ported.
def test_ball_and_free_joints_are_not_ported():
    """Ball and free joints were the part of the engine left unported; they
    now build with the JAX layout (nq, nv, offsets, limits, neutral
    qpos), the converter carries a JAX ball model over field for field,
    and a joint type neither package knows raises."""
    body = dict(pos=(0, 0, 0), geoms=[rb.sphere_geom(0.1)], range=(-1, 1))
    for jt in ("ball", "free"):
        model = rb.build_chain([dict(body, type=jt)], dt=0.01, site_body=0,
                               site_pos=(0, 0, 0), device=DEVICE)
        jmodel = jrb.build_chain([dict(body, type=jt)], dt=0.01, site_body=0,
                                 site_pos=(0, 0, 0))
        assert (model.nq, model.nv) == (jmodel.nq, jmodel.nv)
        assert (model.q_offsets, model.v_offsets) == (jmodel.q_offsets, jmodel.v_offsets)
        np.testing.assert_array_equal(model.neutral_qpos().numpy(),
                                      np.asarray(jmodel.neutral_qpos()))
        converted = convert.chain_model_from_reference(jmodel, device=DEVICE)
        for name in _MODEL_TENSORS:
            torch.testing.assert_close(getattr(model, name), getattr(converted, name),
                                       rtol=0, atol=0)
    with pytest.raises(ValueError):
        rb.build_chain([dict(body, type="screw")], dt=0.01, site_body=0,
                       site_pos=(0, 0, 0), device=DEVICE)
