"""The port's least-squares value functions (mjmpc_tpu_torch/value_functions)
and linear-Gaussian policy (mjmpc_tpu_torch/policies/linear_gaussian.py)
against the JAX package's, on inputs made with numpy from a seed.

Tolerances: fits and predictions rtol 1e-3, atol 1e-4, the JAX package's
for its linear fit against the NumPy normal equations
(tests/test_blending.py): f32 normal equations whose products are summed
in other orders. Policy log-probs and modes: atol 1e-6 (a handful of f32
operations).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu.policies import LinearGaussianPolicy as JLinearGaussianPolicy
from mjmpc_tpu.value_functions import REGISTRY as JREGISTRY
from mjmpc_tpu.value_functions import make_vf as jmake_vf
from mjmpc_tpu.value_functions.vf import VFParams as JVFParams
from mjmpc_tpu_torch import convert
from mjmpc_tpu_torch.policies import LinearGaussianPolicy
from mjmpc_tpu_torch.value_functions import REGISTRY, VFParams, make_vf
from mjmpc_tpu_torch.value_functions.vf import reg_ladder, solve_retry

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
KINDS = ["linear", "quadratic", "linear_time_varying", "quadratic_time_varying"]


def _close(got, want, rtol=1e-3, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_registry_and_feature_widths():
    assert REGISTRY == JREGISTRY
    for kind in REGISTRY:
        for d_obs in (3, 20):
            assert make_vf(kind, d_obs, 6).d_feat == jmake_vf(kind, d_obs, 6).d_feat
    with pytest.raises(ValueError):
        make_vf("cubic", 3, 6)


@pytest.mark.parametrize("kind", KINDS)
def test_fit_and_predict_match_jax(kind):
    """Targets from a random member of the class plus noise; params
    start nonzero so the error before the fit is exercised too."""
    n, h, d = 40, 6, 3
    rs = np.random.default_rng(KINDS.index(kind))
    jvf, vf = jmake_vf(kind, d, h), make_vf(kind, d, h, device=DEVICE)
    shape = (h, vf.d_feat) if vf.time_varying else (vf.d_feat,)
    true = JVFParams(weights=jnp.asarray(rs.normal(size=shape), jnp.float32),
                     bias=jnp.asarray(rs.normal(size=shape[:-1]), jnp.float32))
    obs = rs.normal(size=(n, h, d)).astype(np.float32)
    returns = np.asarray(jvf.predict(true, jnp.asarray(obs))) \
        + 0.1 * rs.normal(size=(n, h)).astype(np.float32)
    start = JVFParams(weights=0.5 * true.weights, bias=0.5 * true.bias)
    jfit, jbefore, jafter = jvf.fit(start, jnp.asarray(obs), jnp.asarray(returns), 1e-3, True)
    fit, before, after = vf.fit(convert.vf_params_from_reference(start, device=DEVICE),
                                torch.as_tensor(obs), torch.as_tensor(returns), 1e-3, True)
    _close(fit.weights.numpy(), jfit.weights)
    _close(fit.bias.numpy(), jfit.bias)
    _close(float(before), float(jbefore))
    _close(float(after), float(jafter))
    assert float(after) < float(before)
    _close(vf.predict(fit, torch.as_tensor(obs)).numpy(),
           jvf.predict(jfit, jnp.asarray(obs)))
    init = vf.init_params()
    assert init.weights.shape == jvf.init_params().weights.shape
    assert float(init.weights.abs().sum()) == 0.0


def test_reg_ladder_is_the_jax_escalation():
    np.testing.assert_array_equal(reg_ladder(0.0)[:3], np.float32([0.0, 1e-8, 1e-7]))
    assert reg_ladder(0.0).shape == (11,)
    want = [np.float32(1e-3)]
    for _ in range(10):
        want.append(want[-1] * np.float32(10.0))
    np.testing.assert_array_equal(reg_ladder(1e-3), np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["linear", "linear_time_varying"])
def test_singular_gram_retries_at_the_same_regularisation(kind):
    """All-zero observations make the gram singular: with delta_reg = 0 the
    first solve is not finite, in JAX as here, and both take the next
    rung, 1e-8."""
    n, h, d = 8, 4, 3
    jvf, vf = jmake_vf(kind, d, h), make_vf(kind, d, h, device=DEVICE)
    obs = np.zeros((n, h, d), np.float32)
    returns = np.random.default_rng(0).uniform(1.0, 2.0, (n, h)).astype(np.float32)
    jfit = jvf.fit(jvf.init_params(), jnp.asarray(obs), jnp.asarray(returns), 0.0)
    fit = vf.fit(vf.init_params(), torch.as_tensor(obs), torch.as_tensor(returns), 0.0)
    _close(fit.weights.numpy(), jfit.weights)
    _close(fit.bias.numpy(), jfit.bias)
    assert np.isfinite(fit.weights.numpy()).all()
    # the rung each side took
    feat = torch.cat([vf.features(torch.as_tensor(obs)), torch.ones(n, h, 1)], -1)
    f = feat.reshape(-1, feat.shape[-1]) if not vf.time_varying else feat[:, 0]
    r = torch.as_tensor(returns).reshape(-1) if not vf.time_varying else \
        torch.as_tensor(returns)[:, 0]
    _, k = solve_retry(f.T @ f, f.T @ r, 0.0)
    assert int(k) == 1
    jf = jnp.asarray(f.numpy())
    eye = jnp.eye(f.shape[-1])
    assert not np.isfinite(np.asarray(jnp.linalg.solve(jf.T @ jf, jf.T @ r.numpy()))).all()
    assert np.isfinite(np.asarray(jnp.linalg.solve(jf.T @ jf + 1e-8 * eye,
                                                   jf.T @ r.numpy()))).all()


def test_solve_retry_falls_back_to_the_last_rung():
    """A system no rung makes finite (a NaN in it) returns the last rung."""
    gram = torch.eye(3).repeat(2, 1, 1)
    gram[1, 0, 0] = float("nan")
    x, k = solve_retry(gram, torch.ones(2, 3), 0.0)
    assert k.tolist() == [0, 10]
    torch.testing.assert_close(x[0], torch.ones(3), rtol=0, atol=0)


def _lg_pair(seed, d_obs=4, d_action=2, init_log_std=-0.5):
    rs = np.random.default_rng(seed)
    jpol = JLinearGaussianPolicy(d_obs=d_obs, d_action=d_action, init_log_std=init_log_std)
    pol = LinearGaussianPolicy(d_obs=d_obs, d_action=d_action, init_log_std=init_log_std,
                               device=DEVICE)
    jparams = jpol.init_params()._replace(
        weight=jnp.asarray(rs.normal(size=(d_obs, d_action)), jnp.float32),
        bias=jnp.asarray(rs.normal(size=d_action), jnp.float32))
    return jpol, jparams, pol, convert.lg_policy_params_from_reference(jparams, device=DEVICE)


def test_lg_policy_log_prob_entropy_and_modes_match_jax():
    jpol, jparams, pol, params = _lg_pair(0)
    rs = np.random.default_rng(1)
    obs = rs.normal(size=(7, 4)).astype(np.float32)
    acts = rs.normal(size=(7, 2)).astype(np.float32)
    white = rs.normal(size=(7, 2)).astype(np.float32)
    to = torch.as_tensor
    _close(pol.log_prob(params, to(obs), to(acts)).numpy(),
           jpol.log_prob(jparams, jnp.asarray(obs), jnp.asarray(acts)), rtol=0, atol=1e-6)
    _close(float(pol.entropy(params)), float(jpol.entropy(jparams)), rtol=0, atol=1e-6)
    for mode in ("mean", "sample"):
        a, info = pol.get_action(params, to(obs), mode=mode, white_noise=to(white))
        ja, jinfo = jpol.get_action(jparams, jnp.asarray(obs), mode=mode,
                                    white_noise=jnp.asarray(white))
        _close(a.numpy(), ja, rtol=0, atol=1e-6)
        _close(info["log_prob"].numpy(), jinfo["log_prob"], rtol=0, atol=1e-6)
    drawn, _ = pol.get_action(params, to(obs), generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(drawn, pol.mean(params, to(obs)))
    with pytest.raises(ValueError):
        pol.get_action(params, to(obs), mode="greedy")


def test_lg_policy_cov_ops_and_rollout_weights_match_jax():
    jpol, jparams, pol, params = _lg_pair(2)
    low = params.__class__(params.weight, params.bias, torch.full((2,), -10.0))
    jlow = jparams._replace(log_std=jnp.full((2,), -10.0))
    _close(pol.clamp_cov(low).log_std.numpy(), jpol.clamp_cov(jlow).log_std, rtol=0, atol=0)
    _close(pol.grow_cov(params, 0.5).log_std.numpy(), jpol.grow_cov(jparams, 0.5).log_std,
           rtol=0, atol=0)
    w = pol.as_rollout_weights(params)
    _close(w.numpy(), jpol.as_rollout_weights(jparams), rtol=0, atol=0)
    back = LinearGaussianPolicy.from_rollout_weights(w, params.log_std)
    for f in ("weight", "bias", "log_std"):
        torch.testing.assert_close(getattr(back, f), getattr(params, f), rtol=0, atol=0)
    zero = pol.init_params()
    assert float(zero.weight.abs().sum()) == 0.0 and float(zero.log_std[0]) == -0.5


def test_converters_carry_jax_params_exactly():
    jvf = jmake_vf("quadratic_time_varying", 3, 5)
    rs = np.random.default_rng(3)
    jp = JVFParams(weights=jnp.asarray(rs.normal(size=(5, jvf.d_feat)), jnp.float32),
                   bias=jnp.asarray(rs.normal(size=5), jnp.float32))
    p = convert.vf_params_from_reference(jp, device=DEVICE)
    assert isinstance(p, VFParams)
    np.testing.assert_array_equal(p.weights.numpy(), np.asarray(jp.weights))
    np.testing.assert_array_equal(p.bias.numpy(), np.asarray(jp.bias))
    _, jparams, _, params = _lg_pair(4)
    for f in ("weight", "bias", "log_std"):
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(jparams, f)))
