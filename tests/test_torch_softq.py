"""The port's learned models (mjmpc_tpu_torch/models/), its closed-loop
policy rollout and SoftQMPC (solvers/softq.py) against the JAX package's,
on inputs made with numpy, and the properties of tests/test_softq.py.

Tolerances:
- QuadraticQFunc (p_matrix, values, loss and its gradient, act_mean_sigma,
  grow_cov), MLPPolicy and EnsembleMLP: atol 1e-5 (rtol 1e-5 where values
  grow past 1), f32 products summed in other orders;
- rollout_closed_loop_policy on the pendulum and cartpole under an MLP
  policy with injected noise: atol 1e-5;
- one SoftQMPC solve on cartpole from the same white noise, against the
  JAX package's _policy, _scan_rollout, update and act: the new Q
  parameters and the action to 1e-4, with the gradient clip binding and
  with it not binding.
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.models import EnsembleMLP as JEnsembleMLP
from mjmpc_tpu.models import MLPPolicy as JMLPPolicy
from mjmpc_tpu.models import QuadraticQFunc as JQuadraticQFunc
from mjmpc_tpu.models import QuadraticQParams as JQParams
from mjmpc_tpu.models.ensemble import EnsembleLayerParams as JEnsembleLayer
from mjmpc_tpu.models.mlp import MLPLayerParams as JMLPLayer
from mjmpc_tpu.rollout.engine import _scan_rollout as jax_scan_rollout
from mjmpc_tpu.rollout.engine import rollout_closed_loop_policy as jax_rollout_policy
from mjmpc_tpu_torch import convert, envs, ops, rng, solvers
from mjmpc_tpu_torch.models import EnsembleMLP, MLPPolicy, QuadraticQFunc, init_ensemble
from mjmpc_tpu_torch.rollout import (Trajectories, make_rollout_fn, rollout_closed_loop_linear,
                                     rollout_closed_loop_policy, rollout_open_loop)

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
D_OBS, D_ACT = 4, 2


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _q_params(seed, d_obs=D_OBS, d_act=D_ACT):
    """JAX QuadraticQParams from numpy: L with a diagonal kept away from 0
    (a well-conditioned P, so that grow_cov's three factorisations hold
    1e-5), J and c."""
    rs = np.random.default_rng(seed)
    d = d_obs + d_act
    lmat = np.tril(0.3 * rs.normal(size=(d, d))) + np.diag(rs.uniform(0.8, 1.5, d))
    rows, cols = np.tril_indices(d)
    return JQParams(l_packed=jnp.asarray(lmat[rows, cols], jnp.float32),
                    j=jnp.asarray(rs.normal(size=d), jnp.float32),
                    c=jnp.float32(rs.normal()))


def _batch(seed, b=32, d_obs=D_OBS, d_act=D_ACT):
    rs = np.random.default_rng(seed)
    return (rs.normal(size=(b, d_obs)).astype(np.float32),
            rs.normal(size=(b, d_act)).astype(np.float32),
            rs.normal(size=b).astype(np.float32) * 3.0)


# ---- QuadraticQFunc ---------------------------------------------------------

def test_quadratic_q_matches_jax():
    jmodel, model = JQuadraticQFunc(D_OBS, D_ACT), QuadraticQFunc(D_OBS, D_ACT)
    jp = _q_params(0)
    p = convert.quadratic_q_params_from_reference(jp, DEVICE)
    obs, act, tgt = _batch(1)
    _close(model.p_matrix(p), jmodel.p_matrix(jp), rtol=1e-5)
    _close(model(p, torch.as_tensor(obs), torch.as_tensor(act)),
           jmodel(jp, jnp.asarray(obs), jnp.asarray(act)), rtol=1e-5)
    args = (torch.as_tensor(obs), torch.as_tensor(act), torch.as_tensor(tgt), 0.3)
    jargs = (jnp.asarray(obs), jnp.asarray(act), jnp.asarray(tgt), 0.3)
    _close(model.loss(p, *args), jmodel.loss(jp, *jargs), rtol=1e-5)
    for got, want in zip(torch.func.grad(model.loss)(p, *args), jax.grad(jmodel.loss)(jp, *jargs)):
        _close(got, want, rtol=1e-5)
    mu, sigma = model.act_mean_sigma(p, torch.as_tensor(obs[0]), 0.4)
    jmu, jsigma = jmodel.act_mean_sigma(jp, jnp.asarray(obs[0]), 0.4)
    _close(mu, jmu)
    _close(sigma, jsigma)
    grown = model.grow_cov(p, 0.7, 0.3)
    _close(grown.l_packed, jmodel.grow_cov(jp, 0.7, 0.3).l_packed)
    assert grown.j is p.j and grown.c is p.c


def test_act_mean_batches_every_observation_in_one_solve():
    """mu for a batch [B, dO] and for a [2, B, dO] batch equals the single
    observation's mu row by row (JAX vmaps act_mean_sigma)."""
    jmodel, model = JQuadraticQFunc(D_OBS, D_ACT), QuadraticQFunc(D_OBS, D_ACT)
    jp = _q_params(2)
    p = convert.quadratic_q_params_from_reference(jp, DEVICE)
    obs = _batch(3, b=12)[0]
    mu, _ = model.act_mean_sigma(p, torch.as_tensor(obs), 0.2)
    want = jax.vmap(lambda o: jmodel.act_mean_sigma(jp, o, 0.2)[0])(jnp.asarray(obs))
    _close(mu, want)
    mu2, _ = model.act_mean_sigma(p, torch.as_tensor(obs).reshape(2, 6, D_OBS), 0.2)
    _close(mu2.reshape(12, D_ACT), want)


def test_quadratic_q_conditional_minimizer():
    """mu(s) is the argmin of Q(s, .), and Sigma = lam Paa^-1 is symmetric
    PD (tests/test_softq.py)."""
    model = QuadraticQFunc(3, 2)
    params = model.init_params(torch.Generator().manual_seed(0), DEVICE)
    rs = np.random.RandomState(42)
    obs = torch.as_tensor(rs.randn(3).astype(np.float32))
    mu, sigma = model.act_mean_sigma(params, obs, lam=0.5)
    q_mu = float(model(params, obs, mu))
    for _ in range(20):
        a = mu + torch.as_tensor(0.1 * rs.randn(2).astype(np.float32))
        assert float(model(params, obs, a)) >= q_mu - 1e-4
    s = sigma.numpy()
    np.testing.assert_allclose(s, s.T, atol=1e-6)
    assert np.all(np.linalg.eigvalsh(s) > 0)


def test_quadratic_q_regression_fit():
    """SGD on the quadratic model fits quadratic targets (reference
    simple_quadratic_model_regression_test.py, tests/test_softq.py)."""
    model = QuadraticQFunc(d_obs=2, d_action=1)
    rs = np.random.RandomState(42)
    a_true = rs.randn(3, 3).astype(np.float32)
    p_true = a_true @ a_true.T + 0.5 * np.eye(3, dtype=np.float32)
    j_true = rs.randn(3).astype(np.float32)
    z = rs.randn(512, 3).astype(np.float32)
    targets = torch.as_tensor(0.5 * np.einsum("bi,ij,bj->b", z, p_true, z) + z @ j_true)
    obs, act = torch.as_tensor(z[:, :2]), torch.as_tensor(z[:, 2:])
    params = model.init_params(torch.Generator().manual_seed(1), DEVICE)
    loss_grad = torch.func.grad_and_value(lambda p: model.loss(p, obs, act, targets))
    losses = []
    for _ in range(500):
        g, loss = loss_grad(params)
        losses.append(float(loss))
        params = type(params)(*(w - 0.01 * gw for w, gw in zip(params, g)))
    assert losses[-1] < 0.05 * losses[0]


def test_quadratic_q_grow_cov_moment_space():
    """P_new = lam (lam P^-1 + beta I)^-1 (tests/test_softq.py)."""
    model = QuadraticQFunc(d_obs=2, d_action=2)
    params = model.init_params(torch.Generator().manual_seed(2), DEVICE)
    lam, beta = 0.3, 0.7
    p0 = model.p_matrix(params).double().numpy()
    p1 = model.p_matrix(model.grow_cov(params, beta, lam)).numpy()
    sigma_new = lam * np.linalg.inv(p0 + 1e-6 * np.eye(4)) + beta * np.eye(4)
    np.testing.assert_allclose(p1, lam * np.linalg.inv(sigma_new), rtol=1e-3, atol=1e-4)
    # beta = 0: the round trip is the identity
    np.testing.assert_allclose(model.p_matrix(model.grow_cov(params, 0.0, lam)).numpy(), p0,
                               rtol=1e-3, atol=1e-3)


# ---- MLPs -------------------------------------------------------------------

def _mlp_layers(seed, sizes, ensemble=None):
    rs = np.random.default_rng(seed)
    layers = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        lead = () if ensemble is None else (ensemble,)
        w = (rs.normal(size=lead + (n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)
        b = (0.1 * rs.normal(size=lead + ((1, n_out) if ensemble else (n_out,)))).astype(
            np.float32)
        layers.append((w, b))
    return layers


@pytest.mark.parametrize("activation,squash", [("tanh", True), ("relu", False),
                                               ("swish", True), ("leaky_relu", False)])
def test_mlp_policy_matches_jax(activation, squash):
    layers = _mlp_layers(4, [5, 16, 16, 3])
    jparams = [JMLPLayer(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    params = convert.mlp_params_from_reference(jparams, DEVICE)
    obs = np.random.default_rng(5).normal(size=(7, 5)).astype(np.float32)
    jpol = JMLPPolicy(5, 3, (16, 16), activation=activation, squash=squash)
    pol = MLPPolicy(5, 3, (16, 16), activation=activation, squash=squash)
    _close(pol(params, torch.as_tensor(obs)), jpol(jparams, jnp.asarray(obs)))


@pytest.mark.parametrize("non_linearity", ["leaky_relu", "swish", "tanh", "relu"])
def test_ensemble_mlp_matches_jax(non_linearity):
    layers = _mlp_layers(6, [3, 8, 8, 2], ensemble=4)
    jparams = [JEnsembleLayer(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    params = convert.ensemble_params_from_reference(jparams, DEVICE)
    x = np.random.default_rng(7).normal(size=(4, 5, 3)).astype(np.float32)
    jmodel = JEnsembleMLP(3, 2, 8, 2, 4, non_linearity)
    model = EnsembleMLP(3, 2, 8, 2, 4, non_linearity)
    _close(model(params, torch.as_tensor(x)), jmodel(jparams, jnp.asarray(x)))


def test_ensemble_mlp_matches_per_member_loop():
    """tests/test_softq.py's per-member dense loop oracle, on the port's
    own initialisation."""
    model, params = init_ensemble(torch.Generator().manual_seed(0), 3, 2, 8, 2, 4,
                                  "leaky_relu", DEVICE)
    x = torch.as_tensor(np.random.RandomState(42).randn(4, 5, 3).astype(np.float32))
    out = model(params, x)
    assert out.shape == (4, 5, 2)
    for e in range(4):
        h = x[e].numpy()
        for li, lyr in enumerate(params):
            h = h @ lyr.weight[e].numpy() + lyr.bias[e].numpy()
            if li < len(params) - 1:
                h = np.where(h > 0, h, 0.01 * h)
        np.testing.assert_allclose(out[e].numpy(), h, rtol=1e-4, atol=1e-5)


def test_ensemble_rejects_shallow_and_unknown_activations():
    with pytest.raises(ValueError):
        EnsembleMLP(d_in=3, d_out=2, n_hidden=8, n_layers=1, ensemble_size=2)
    with pytest.raises(ValueError):
        MLPPolicy(2, 1, (4,), activation="gelu")(
            MLPPolicy(2, 1, (4,)).init_params(torch.Generator(), DEVICE), torch.zeros(2))


def test_init_params_shapes_and_scales():
    g = torch.Generator().manual_seed(3)
    pol = MLPPolicy(5, 3, (64, 32))
    params = pol.init_params(g, DEVICE)
    assert [tuple(p.weight.shape) for p in params] == [(5, 64), (64, 32), (32, 3)]
    assert all(float(p.weight.abs().max()) <= np.sqrt(6.0 / sum(p.weight.shape)) for p in params)
    assert all(float(p.bias.abs().max()) == 0.0 for p in params)
    q = QuadraticQFunc(3, 2).init_params(g, DEVICE)
    assert q.l_packed.shape == (15,) and q.j.shape == (5,) and float(q.c) == 0.0


# ---- closed-loop policy rollouts -------------------------------------------

@pytest.mark.parametrize("name", ["SimplePendulum-v0", "cartpole-v0"])
def test_rollout_closed_loop_policy_matches_jax(name):
    jenv, env = jenvs.make(name), envs.make(name, device=DEVICE)
    layers = _mlp_layers(8, [env.d_obs, 16, 16, env.d_action])
    jparams = [JMLPLayer(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    params = convert.mlp_params_from_reference(jparams, DEVICE)
    jpol, pol = JMLPPolicy(env.d_obs, env.d_action, (16, 16)), MLPPolicy(env.d_obs, env.d_action,
                                                                         (16, 16))
    noise = (0.3 * np.random.default_rng(9).normal(size=(12, 10, env.d_action))).astype(
        np.float32)
    js = jenv.init(jenv.params, jax.random.PRNGKey(3))
    to_port = (convert.pendulum_state_from_reference if name == "SimplePendulum-v0"
               else convert.cartpole_state_from_reference)
    want = jax.jit(lambda p, s, nz: jax_rollout_policy(jenv, p, s, lambda o: jpol(jparams, o),
                                                       nz))(jenv.params, js, jnp.asarray(noise))
    got = rollout_closed_loop_policy(env, env.params, to_port(js, DEVICE),
                                     lambda o: pol(params, o), torch.as_tensor(noise))
    for field in ("observations", "actions", "costs", "next_observations"):
        _close(getattr(got, field), getattr(want, field))
    # the loop closes: the actions are not the noise plus a constant
    assert float((got.actions - torch.as_tensor(noise)).std(0).max()) > 1e-3


def test_make_rollout_fn_binds_each_mode():
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    es = env.init(env.params, 1)
    noise = 0.2 * torch.ones(3, 4, 1)
    weights = torch.full((env.d_obs + 1, 1), 0.1)
    cases = {"open_loop": (torch.zeros(4, 1), rollout_open_loop),
             "closed_loop_linear": (weights, rollout_closed_loop_linear),
             "closed_loop_policy": (lambda o: o[:, :1], rollout_closed_loop_policy)}
    for mode, (arg, rollout) in cases.items():
        got = make_rollout_fn(env, mode)(env.params, es, arg, noise)
        want = rollout(env, env.params, es, arg, noise)
        torch.testing.assert_close(got.costs, want.costs, rtol=0, atol=0)
    with pytest.raises(ValueError):
        make_rollout_fn(env, "sideways")


# ---- SoftQMPC ---------------------------------------------------------------

SOFTQ_CARTPOLE = dict(horizon=16, num_particles=64, lam=0.2, gamma=0.99, lr=0.01)


@dataclasses.dataclass(frozen=True)
class InjectedSoftQ(solvers.SoftQMPC):
    """Test-only SoftQMPC whose white noise is given, not drawn."""
    white: Any = None

    def white_noise(self, state):
        return self.white.clone()


def _cartpole_start(jenv):
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    return js._replace(theta=jnp.float32(2.6), theta_dot=jnp.float32(-0.8), x_dot=jnp.float32(0.3))


@pytest.fixture(scope="module")
def cartpole_softq():
    """(JAX env, port env, JAX start, white noise, a JAX Q, the JAX
    package's one solve composed from _policy, _scan_rollout, update and
    act): the config's softq block with grad_clip as the argument."""
    jenv, env = jenvs.make("cartpole-v0"), envs.make("cartpole-v0", device=DEVICE)
    js = _cartpole_start(jenv)
    white = np.random.default_rng(11).normal(size=(64, 16, 1)).astype(np.float32)
    jq = _q_params(12, d_obs=4, d_act=1)
    scan = jax.jit(lambda p, s, nz, q, solver: jax_scan_rollout(
        jenv, p, s, nz, lambda t, o: solver._policy(q)[0](o)), static_argnums=4)

    def jax_solve(grad_clip, n_grad_steps=1):
        solver = jsolvers.SoftQMPC(d_obs=4, d_action=1, grad_clip=grad_clip,
                                   n_grad_steps=n_grad_steps, **SOFTQ_CARTPOLE)
        state = solver.init_state(jax.random.PRNGKey(0))._replace(q_params=jq)
        _, chol, entropy = solver._policy(jq)
        traj = scan(jenv.params, js, jnp.asarray(white) @ chol.T, jq, solver)
        new = solver.update(state, traj, entropy)
        action = solver.act(new, jenv.observe(jenv.params, js))
        grads = jax.grad(solver.model.loss)(
            jq, traj.observations[:, :-1].reshape(-1, 4), traj.actions[:, :-1].reshape(-1, 1),
            _jax_targets(solver, jq, traj, entropy)[:, :-1].reshape(-1))
        gnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in grads)))
        return new, action, gnorm, traj

    return jenv, env, js, white, jq, jax_solve


def _jax_targets(solver, q, traj, entropy):
    from mjmpc_tpu import ops as jops
    term_q = solver.model(q, traj.observations[:, -1], traj.actions[:, -1])
    costs = traj.costs.at[:, -1].set(term_q)
    ent = jnp.full_like(costs, entropy)
    return jops.cost_to_go(costs - solver.lam * ent, solver.gamma_seq) + solver.lam * ent


@pytest.mark.parametrize("grad_clip,binds", [(10.0, True), (1e5, False)],
                         ids=["clip_binds", "clip_free"])
def test_softq_solve_matches_jax_on_injected_noise(cartpole_softq, grad_clip, binds):
    """make_solve_fn's solve (the port's own solve, its white noise given)
    against the JAX composition: the rollout, the fit's gradient norm (so
    that the case is what its name says), the new Q and the action."""
    jenv, env, js, white, jq, jax_solve = cartpole_softq
    jnew, jaction, jgnorm, jtraj = jax_solve(grad_clip)
    assert (jgnorm > grad_clip) == binds
    solver = InjectedSoftQ(d_obs=4, d_action=1, grad_clip=grad_clip, device=DEVICE,
                           white=torch.as_tensor(white), **SOFTQ_CARTPOLE)
    state = convert.softq_state_from_reference(
        jsolvers.SoftQMPC(d_obs=4, d_action=1, **SOFTQ_CARTPOLE).init_state(
            jax.random.PRNGKey(0))._replace(q_params=jq), seed=5, device=DEVICE)
    es = convert.cartpole_state_from_reference(js, DEVICE)
    # the fit's inputs first, then the step
    mean_fn, chol, entropy = solver._policy(state.q_params)
    traj = rollout_closed_loop_policy(env, env.params, es, mean_fn,
                                      torch.as_tensor(white) @ chol.T)
    _close(traj.costs, jtraj.costs, atol=1e-4)
    _, gnorm = solver.clipped_gradient(state.q_params,
                                       *solver.fit_inputs(traj, solver.targets(
                                           state.q_params, traj, entropy)))
    assert float(gnorm) == pytest.approx(jgnorm, rel=1e-4)
    action, value, new = solvers.make_solve_fn(solver, env)(env.params, es, state)
    for got, want in zip(new.q_params, jnew.q_params):
        _close(got, want, atol=1e-4)
    _close(action, jaction, atol=1e-4)
    assert float(value) == 0.0 and int(new.step) == 1 and new.seed == 5
    assert not np.allclose(new.q_params.l_packed.numpy(), np.asarray(jq.l_packed))


def test_softq_grad_steps_and_whitening_match_jax(cartpole_softq):
    """Three SGD steps under the clip, with observation whitening, against
    JAX's update on the same trajectories."""
    jenv, env, js, white, jq, _ = cartpole_softq
    shift, scale = np.array([0.1, -0.2, 3.0, 0.5], np.float32), np.array([1.0, 2.0, 0.5, 4.0],
                                                                          np.float32)
    cfg = dict(d_obs=4, d_action=1, grad_clip=10.0, n_grad_steps=3, obs_shift=shift,
               obs_scale=scale, **SOFTQ_CARTPOLE)
    jsolver = jsolvers.SoftQMPC(**cfg)
    solver = solvers.SoftQMPC(**cfg, device=DEVICE)
    jstate = jsolver.init_state(jax.random.PRNGKey(0))._replace(q_params=jq)
    state = convert.softq_state_from_reference(jstate, device=DEVICE)
    _, chol, entropy = jsolver._policy(jq)
    jtraj = jax_scan_rollout(jenv, jenv.params, js, jnp.asarray(white) @ chol.T,
                             lambda t, o: jsolver._policy(jq)[0](o))
    traj = Trajectories(*(None if x is None else torch.as_tensor(np.array(x)) for x in jtraj))
    _, _, ent = solver._policy(state.q_params)
    _close(ent, entropy)
    new = solver.update(state, traj, ent)
    jnew = jsolver.update(jstate, jtraj, entropy)
    for got, want in zip(new.q_params, jnew.q_params):
        _close(got, want, atol=1e-4)
    obs = jenv.observe(jenv.params, js)
    _close(solver.act(new, torch.as_tensor(np.asarray(obs))), jsolver.act(jnew, obs), atol=1e-4)


def test_softq_solve_runs_and_moves_q():
    """tests/test_softq.py: a solve on LQR moves the Q parameters and a
    chained solve stays finite; the solve keeps its streams on (seed,
    step) and the act modes are the mean and a sample."""
    env = envs.make("LQR-v0", device=DEVICE)
    solver = solvers.SoftQMPC(d_obs=env.d_obs, d_action=env.d_action, horizon=8,
                              num_particles=16, lam=0.5, lr=1e-3, gamma=0.99, device=DEVICE)
    s0 = solver.init_state(0)
    es = env.init(env.params, 1)
    solve = solvers.make_solve_fn(solver, env, calc_val=True, hotstart=True, fused="auto")
    a, v, s1 = solve(env.params, es, s0)
    assert np.isfinite(a.numpy()).all() and float(v) == 0.0
    assert not np.allclose(s1.q_params.l_packed.numpy(), s0.q_params.l_packed.numpy())
    a2, _, s2 = solve(env.params, es, s1)
    assert np.isfinite(a2.numpy()).all() and int(s2.step) == 2
    # the same state gives the same solve; the next step draws new noise
    torch.testing.assert_close(solve(env.params, es, s1)[0], a2, rtol=0, atol=0)
    torch.testing.assert_close(solver.white_noise(s1), ops.standard_normals(
        rng.stream_key(0, 30), s1.step, (16, 8, env.d_action)), rtol=0, atol=0)
    assert not torch.equal(solver.white_noise(s1), solver.white_noise(s2))
    obs = env.observe(env.params, es)
    mean = solver.act(s1, obs)
    sampled = solver.act(s1, obs, mode="sample")
    assert not torch.equal(mean, sampled)
    torch.testing.assert_close(sampled, solver.act(s1, obs, mode="sample"), rtol=0, atol=0)
    with pytest.raises(ValueError):
        solver.act(s1, obs, mode="greedy")


def test_softq_init_state_is_kept_per_seed_and_guard_resets_it():
    """init_state draws a seed's Q once; when a solve's Q goes non-finite,
    guard_finite resets it to a fresh Q drawn on the device at the state's
    step (reset_state, as the JAX guard draws from fold_in(key, step)), not
    the seed's initial one, and the step advances."""
    env = envs.make("cartpole-v0", device=DEVICE)
    solver = solvers.SoftQMPC(d_obs=4, d_action=1, device=DEVICE, **SOFTQ_CARTPOLE)
    s0, again, other = solver.init_state(3), solver.init_state(3), solver.init_state(4)
    assert s0.q_params.l_packed is again.q_params.l_packed
    assert not torch.equal(s0.q_params.l_packed, other.q_params.l_packed)
    bad = dataclasses.replace(s0, q_params=s0.q_params._replace(
        j=torch.full_like(s0.q_params.j, float("nan"))))
    solve = solvers.guard_finite(solvers.make_solve_fn(solver, env), solver)
    a, v, s1 = solve(env.params, env.init(env.params, 1), bad)
    assert float(a.abs().max()) == 0.0 and int(s1.step) == 1
    fresh = solver.reset_state(3, rng.step_tensor(0, DEVICE)).q_params
    for got, want in zip(s1.q_params, fresh):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(s1.q_params.j, s0.q_params.j)


def test_softq_state_converter():
    jsolver = jsolvers.SoftQMPC(d_obs=3, d_action=2, horizon=4, num_particles=8)
    js = jsolver.init_state(jax.random.PRNGKey(1))._replace(step=jnp.int32(7))
    s = convert.softq_state_from_reference(js, seed=9, device=DEVICE)
    for got, want in zip(s.q_params, js.q_params):
        _close(got, want, atol=0)
    assert s.step.dtype == torch.int64 and int(s.step) == 7 and s.seed == 9
