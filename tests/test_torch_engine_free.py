"""The port's ball and free joints (engine/chain.py) against the JAX engine,
analytic rigid-body physics and the f64 C++ oracle (cpp_oracle
chain_mass_matrix, chain_bias, chain_step), on the cases of
tests/test_engine_free.py:

1. a free body's mass matrix is block-diagonal (m I, I_body), and the
   tangent-space Lagrangian bias is Euler's w x I w for a free body and a
   ball joint;
2. a torque-free tumbling body conserves world angular momentum and
   kinetic energy;
3. free fall matches g t under semi-implicit Euler;
4. the mass matrix and bias of a mixed hinge/ball/free tree match the JAX
   engine and the oracle, and the tree conserves energy;
5. a point force on a free body maps to the analytic wrench;
6. quaternions stay unit-norm through a long rollout;
(the eager AD engine takes about 25 ms per substep on one CPU core, so the
long rollouts run 250-1000 substeps where the JAX tests' jitted ones run
500-2000);
plus the hand-and-pen model's mass matrix and bias against the oracle,
points_frame and integrate_qpos against the JAX engine, and free-body
steps against the oracle's serial integrator.

Tolerances are the JAX engine's own tests' (tests/test_engine_free.py,
tests/test_cpp_oracle.py); the port against the JAX engine on one input:
atol 1e-5 (f32, sums in other orders, the bias by another AD system).
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
from mjmpc_tpu_torch.engine import chain as rb

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
ATOL = 1e-5


def _free_body(half_extents=(0.05, 0.08, 0.12), gravity=(0.0, 0.0, 0.0), dt=1e-3):
    bodies = [dict(pos=(0, 0, 0), type="free", damping=0.0, armature=0.0, gear=1.0,
                   geoms=[rb.box_geom(half_extents)])]
    return rb.build_chain(bodies, dt=dt, site_body=0, site_pos=(0, 0, 0), gravity=gravity,
                          device=DEVICE)


def _quat(seed):
    q = np.random.default_rng(seed).normal(size=4)
    return torch.as_tensor(q / np.linalg.norm(q), dtype=torch.float32)


def _t(*xs):
    return torch.as_tensor(np.asarray(xs, np.float32))


def test_free_body_mass_matrix_block_diagonal():
    """COM at the frame origin: M = diag(m, m, m) ++ I_body whatever the
    orientation (linear DOFs in the parent frame, angular in the body
    frame)."""
    model = _free_body()
    q = torch.cat([_t(0.3, -0.2, 0.5), _quat(0)])
    m = rb.mass_matrix(model, q).numpy()
    mass = float(model.mass[0])
    np.testing.assert_allclose(m[:3, :3], mass * np.eye(3), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m[3:, 3:], model.inertia[0].numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(m[:3, 3:], 0.0, atol=1e-6)


def test_free_body_bias_is_eulers_gyroscopic_term():
    model = _free_body()
    q = torch.cat([torch.zeros(3), _quat(1)])
    omega = _t(2.0, -3.0, 1.5)
    qd = torch.cat([_t(0.4, 0.1, -0.2), omega])
    bias = rb.bias_forces(model, q, qd).numpy()
    inertia = model.inertia[0].numpy()
    expected = np.cross(omega.numpy(), inertia @ omega.numpy())
    np.testing.assert_allclose(bias[:3], 0.0, atol=1e-5)
    np.testing.assert_allclose(bias[3:], expected, rtol=1e-4, atol=1e-6)


def test_ball_joint_bias_is_eulers_gyroscopic_term():
    bodies = [dict(pos=(0, 0, 0), type="ball", damping=0.0, armature=0.0, gear=1.0,
                   geoms=[rb.box_geom((0.05, 0.08, 0.12))])]
    model = rb.build_chain(bodies, dt=1e-3, site_body=0, site_pos=(0, 0, 0), device=DEVICE)
    omega = _t(-1.0, 2.5, 0.7)
    bias = rb.bias_forces(model, _quat(2), omega).numpy()
    inertia = model.inertia[0].numpy()
    np.testing.assert_allclose(bias, np.cross(omega.numpy(), inertia @ omega.numpy()),
                               rtol=1e-4, atol=1e-6)


def test_torque_free_tumble_conserves_momentum_and_energy():
    """An asymmetric body spun near its unstable middle axis: world angular
    momentum R I w and kinetic energy are conserved through the flip."""
    model = _free_body(half_extents=(0.03, 0.09, 0.15))
    q = torch.cat([torch.zeros(3), _t(1.0, 0.0, 0.0, 0.0)])
    qd = torch.cat([torch.zeros(3), _t(0.02, 6.0, 0.03)])
    inertia = model.inertia[0]

    def momentum(q, qd):
        return (rb._quat_to_mat(q[3:7]) @ (inertia @ qd[3:6])).numpy()

    l0, e0 = momentum(q, qd), float(rb.kinetic_energy(model, q, qd))
    q, qd = rb.step(model, q, qd, torch.zeros(6), n_substeps=1000)    # 1.0 s at dt=1e-3
    np.testing.assert_allclose(momentum(q, qd), l0, rtol=2e-3, atol=2e-4)
    e1 = float(rb.kinetic_energy(model, q, qd))
    assert abs(e1 - e0) / e0 < 2e-3, (e0, e1)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(q[3:7])), 1.0, rtol=1e-5)


def test_free_fall_matches_gravity():
    g = -9.81
    model = _free_body(gravity=(0.0, 0.0, g), dt=1e-3)
    q = torch.cat([torch.zeros(3), _t(1.0, 0.0, 0.0, 0.0)])
    q, qd = rb.step(model, q, torch.zeros(6), torch.zeros(6), n_substeps=100)
    np.testing.assert_allclose(float(qd[2]), g * 0.1, rtol=1e-4)
    # semi-implicit Euler: z = sum_{k=1..n} dt * (g k dt)
    np.testing.assert_allclose(float(q[2]), g * 1e-6 * (100 * 101) / 2.0, rtol=1e-4)
    np.testing.assert_allclose(qd[3:].numpy(), 0.0, atol=1e-6)


def _mixed_tree(module, **kw):
    """hinge -> ball -> free (a finger pushing a free object)."""
    rb_ = module
    bodies = [
        dict(pos=(0, 0, 0), axis=(0, 0, 1), range=(-3, 3), damping=0.0, armature=0.0, gear=1.0,
             geoms=[rb_.capsule_geom(0.03, (0, 0, 0, 0.25, 0, 0))]),
        dict(pos=(0.25, 0, 0), type="ball", damping=0.0, armature=0.0, gear=1.0,
             geoms=[rb_.capsule_geom(0.025, (0, 0, 0, 0.2, 0, 0))]),
        dict(pos=(0.1, 0.1, 0), type="free", parent=-1, damping=0.0, armature=0.0, gear=1.0,
             geoms=[rb_.box_geom((0.04, 0.05, 0.06))]),
    ]
    return rb_.build_chain(bodies, dt=1e-3, site_body=1, site_pos=(0.2, 0, 0), **kw)


def _mixed_state(seed):
    rs = np.random.default_rng(seed)
    q = np.concatenate([[0.4], _quat(seed).numpy(), [0.1, -0.2, 0.3],
                        _quat(seed + 1).numpy()]).astype(np.float32)
    return q, np.asarray(rs.normal(size=10) * 0.5, np.float32)


def test_mixed_tree_mass_and_bias_match_jax_and_oracle():
    """The Jacobian-composed mass matrix and the tangent-Lagrangian bias of
    a hinge/ball/free tree against the JAX engine and the oracle's
    floating-base RNEA (whose layout converts field for field)."""
    jmodel = _mixed_tree(jrb)
    model = convert.chain_model_from_reference(jmodel, device=DEVICE)
    own = _mixed_tree(rb, device=DEVICE)
    for name in convert._MODEL_TENSORS:
        torch.testing.assert_close(getattr(own, name), getattr(model, name), rtol=0, atol=0)
    for seed in (3, 4):
        q, qd = _mixed_state(seed)
        m = rb.mass_matrix(model, torch.as_tensor(q)).numpy()
        bias = rb.bias_forces(model, torch.as_tensor(q), torch.as_tensor(qd)).numpy()
        np.testing.assert_allclose(m, np.asarray(jrb.mass_matrix(jmodel, jnp.asarray(q))),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(bias, np.asarray(jrb.bias_forces(
            jmodel, jnp.asarray(q), jnp.asarray(qd))), rtol=0, atol=ATOL)
        np.testing.assert_allclose(m, cpp_oracle.chain_mass_matrix(jmodel, q),
                                   rtol=3e-4, atol=2e-6)
        np.testing.assert_allclose(bias, cpp_oracle.chain_bias(jmodel, q, qd),
                                   rtol=3e-3, atol=3e-4)
        assert np.all(np.linalg.eigvalsh(m) > 0)


def test_mixed_tree_energy_conservation():
    model = _mixed_tree(rb, device=DEVICE)
    q, qd = (torch.as_tensor(a) for a in _mixed_state(5))
    e0 = float(rb.kinetic_energy(model, q, qd))
    q, qd = rb.step(model, q, qd, torch.zeros(model.nv), n_substeps=250)
    e1 = float(rb.kinetic_energy(model, q, qd))
    assert abs(e1 - e0) / e0 < 5e-3, (e0, e1)


def test_point_force_on_free_body_analytic_wrench():
    """A world force f at body point p: linear block f, angular block
    R^T ((R p) x f) (body-frame DOFs)."""
    model = _free_body()
    quat = _quat(8)
    q = torch.cat([_t(0.2, -0.1, 0.4), quat])
    p_local, f_world = _t(0.05, -0.02, 0.07), _t(1.0, 2.0, -0.5)
    tau = rb.point_force_to_generalized(model, q, 0, p_local, f_world).numpy()
    r = rb._quat_to_mat(quat).numpy()
    np.testing.assert_allclose(tau[:3], f_world.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tau[3:], r.T @ np.cross(r @ p_local.numpy(), f_world.numpy()),
                               rtol=1e-4, atol=1e-6)


def test_quaternion_norm_preserved_long_rollout():
    model = _free_body(gravity=(0, 0, -9.81))
    q = torch.cat([torch.zeros(3), _quat(9)])
    qd = torch.cat([_t(0.1, 0.0, 0.5), _t(3.0, -2.0, 4.0)])
    q, qd = rb.step(model, q, qd, torch.zeros(6), n_substeps=500)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(q[3:7])), 1.0, rtol=1e-5)
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(qd).all())


def test_free_body_steps_match_the_oracle():
    """Tumbling free fall with damping: 50 steps against the serial f64
    integrator (quaternion retraction included), batched and single."""
    bodies = [dict(pos=(0, 0, 0), type="free", damping=0.01, armature=0.0, gear=1.0,
                   geoms=[jrb.box_geom((0.03, 0.06, 0.09))])]
    jmodel = jrb.build_chain(bodies, dt=1e-3, site_body=0, site_pos=(0, 0, 0),
                             gravity=(0, 0, -9.81))
    model = convert.chain_model_from_reference(jmodel, device=DEVICE)
    rs = np.random.default_rng(42)
    q0 = np.asarray(jmodel.neutral_qpos(), np.float64)
    qd0 = np.concatenate([rs.uniform(-0.5, 0.5, 3), rs.uniform(-4, 4, 3)])
    q = torch.as_tensor(np.stack([q0, q0]), dtype=torch.float32)
    qd = torch.as_tensor(np.stack([qd0, 0.5 * qd0]), dtype=torch.float32)
    q, qd = rb.step(model, q, qd, torch.zeros(2, 6), n_substeps=50)
    for i, scale in enumerate((1.0, 0.5)):
        qo, qdo = cpp_oracle.chain_step(jmodel, q0, scale * qd0, np.zeros(6), n_substeps=50)
        np.testing.assert_allclose(q[i].numpy(), qo, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(qd[i].numpy(), qdo, rtol=5e-3, atol=3e-3)


@pytest.fixture(scope="module")
def pen_models():
    jmodel = jenvs.make("pen-v0").params.model
    return jmodel, envs.make("pen-v0", device=DEVICE).params.model


def test_pen_model_mass_and_bias_match_the_oracle(pen_models):
    """The hand-and-free-pen model (24 hinges + a free joint, gravity),
    batched over 4 random states: the port's model equals the JAX one and
    its mass matrix and bias match the oracle's floating-base RNEA."""
    jmodel, model = pen_models
    assert (model.nq, model.nv) == (31, 30) and model.joint_types == tuple(jmodel.joint_types)
    for name in convert._MODEL_TENSORS:
        np.testing.assert_allclose(getattr(model, name).numpy(),
                                   np.asarray(getattr(jmodel, name)), rtol=0, atol=0)
    rs = np.random.default_rng(42)
    q = np.tile(np.asarray(jmodel.neutral_qpos(), np.float64), (4, 1))
    q[:, :24] += rs.uniform(-0.6, 0.6, (4, 24))
    q[:, 24:27] += rs.uniform(-0.05, 0.05, (4, 3))
    quat = rs.normal(size=(4, 4))
    q[:, 27:31] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qd = rs.uniform(-1.5, 1.5, (4, 30))
    tq, tqd = torch.as_tensor(q, dtype=torch.float32), torch.as_tensor(qd, dtype=torch.float32)
    m, bias = rb.mass_matrix(model, tq).numpy(), rb.bias_forces(model, tq, tqd).numpy()
    for i in range(4):
        np.testing.assert_allclose(bias[i], cpp_oracle.chain_bias(jmodel, q[i], qd[i]),
                                   rtol=3e-3, atol=3e-4)
        np.testing.assert_allclose(m[i], cpp_oracle.chain_mass_matrix(jmodel, q[i]),
                                   rtol=3e-4, atol=2e-6)


def test_points_frame_and_integrate_qpos_match_jax(pen_models):
    """points_frame (positions, velocities and the force scatter) at the
    pen's contact points, and the quaternion retraction, against the JAX
    engine's."""
    from mjmpc_tpu_torch.envs import pen
    jmodel, model = pen_models
    rs = np.random.default_rng(7)
    q = np.asarray(jmodel.neutral_qpos(), np.float32).copy()
    q[:24] += rs.uniform(-0.3, 0.3, 24).astype(np.float32)
    q[24:27] = (0.01, -0.02, 0.07)
    quat = rs.normal(size=4)
    q[27:31] = quat / np.linalg.norm(quat)
    qd = np.asarray(rs.normal(size=30), np.float32)
    forces = np.asarray(rs.normal(size=(len(pen.C_BODIES), 3)), np.float32)
    pts = torch.as_tensor(pen.C_POINTS)
    pos, vel, apply = rb.points_frame(model, torch.as_tensor(q), torch.as_tensor(qd),
                                      pen.C_BODIES, pts)
    jpos, jvel, japply = jrb.points_frame(jmodel, jnp.asarray(q), jnp.asarray(qd),
                                          pen.C_BODIES, jnp.asarray(pen.C_POINTS))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=0, atol=ATOL)
    np.testing.assert_allclose(apply(torch.as_tensor(forces)).numpy(),
                               np.asarray(japply(jnp.asarray(forces))), rtol=0, atol=ATOL)
    got = rb.integrate_qpos(model, torch.as_tensor(q), torch.as_tensor(qd), 0.01).numpy()
    want = np.asarray(jrb.integrate_qpos(jmodel, jnp.asarray(q), jnp.asarray(qd), 0.01))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got[27:31]), 1.0, rtol=1e-6)
