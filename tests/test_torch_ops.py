"""The port's control and noise ops against mjmpc_tpu.ops and the NumPy
oracle, on the same numpy inputs.

Tolerance: atol 1e-6. Both sides compute in f32 with sums taken in
different orders; inputs are scaled so that every result is O(1), where
1e-6 is a few f32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import ops as jops
from mjmpc_tpu.oracle import cpp_oracle, numpy_ref
from mjmpc_tpu_torch import ops, rng

ATOL = 1e-6
DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU


def _ctg(costs, gamma):
    gamma_seq = ops.gamma_sequence(gamma, costs.shape[1])
    got = ops.cost_to_go(torch.as_tensor(costs), ops.discount_matrix(gamma_seq, device=DEVICE))
    return gamma_seq, got.numpy()


@pytest.mark.parametrize("gamma", [0.0, 0.99, 1.0])
def test_cost_to_go_matches_jax_and_oracle(gamma):
    h = 16
    costs = np.random.default_rng(0).uniform(0.0, 1.0 / h, (32, h)).astype(np.float32)
    gamma_seq, got = _ctg(costs, gamma)
    want_jax = np.asarray(jops.cost_to_go(jnp.asarray(costs), gamma_seq))
    want_ref = numpy_ref.cost_to_go(costs.astype(np.float64), gamma_seq)
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, cpp_oracle.cost_to_go(costs, gamma_seq),
                               rtol=0, atol=ATOL)


def test_cost_to_go_gamma_zero_is_exact_passthrough():
    costs = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    _, got = _ctg(costs, 0.0)
    np.testing.assert_array_equal(got, costs)


@pytest.mark.parametrize("coeffs", [(0.25, 0.8, 0.0), (0.5, 0.3, 0.2),
                                    (1.0, 0.0, 0.0)])
def test_ar_filter_matches_jax_and_oracle(coeffs):
    eps = (0.2 * np.random.default_rng(2).normal(size=(6, 16, 3))).astype(np.float32)
    got = ops.ar_filter(torch.as_tensor(eps), coeffs).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.ar_filter(jnp.asarray(eps), coeffs)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, cpp_oracle.ar_filter(eps, coeffs), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[:, :2], eps[:, :2])


def test_colouring_matches_jax_gaussian_noise():
    """JAX's own white noise, coloured by the port, equals JAX's
    gaussian_noise from the same key."""
    a = np.random.default_rng(3).normal(size=(4, 4))
    cov = (a @ a.T / 8 + 0.1 * np.eye(4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    shape = (16, 5)
    white = np.array(jax.random.normal(key, shape + (4,), jnp.float32))
    want = np.asarray(jops.gaussian_noise(key, jnp.asarray(cov), shape))
    got = ops.colour(torch.as_tensor(white), torch.as_tensor(cov)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_filtered_noise_is_seeded_by_its_generator():
    """The plain sampler's stream is Philox under (key, step): the same pair
    draws the same noise, another key or step other noise."""
    cov = torch.eye(3) * 0.5

    def draw(seed, step=0):
        return ops.filtered_noise(rng.stream_key(seed, 0), rng.step_tensor(step, "cpu"), cov,
                                  (8, 6), (0.25, 0.8, 0.0))

    assert draw(0).shape == (8, 6, 3)
    torch.testing.assert_close(draw(0), draw(0), rtol=0, atol=0)
    assert not torch.equal(draw(0), draw(1))
    assert not torch.equal(draw(0), draw(0, step=1))


def _gauss_inputs(seed, n=3, m=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) * 0.3
    cov = (a @ a.T + 0.5 * np.eye(n)).astype(np.float32)
    mean = (0.3 * rng.normal(size=(n, m))).astype(np.float32)
    x = (mean + 0.3 * rng.normal(size=(n, m))).astype(np.float32)
    return mean, cov, x


@pytest.mark.parametrize("cov_type", ["full", "diagonal"])
def test_gaussian_functions_match_jax(cov_type):
    mean0, cov0, x = _gauss_inputs(4)
    mean1, cov1, _ = _gauss_inputs(5)
    if cov_type == "diagonal":
        cov0, cov1 = np.diag(np.diag(cov0)), np.diag(np.diag(cov1))
    t = torch.as_tensor
    j = jnp.asarray
    cases = [
        (ops.gaussian_logprob(t(mean0), t(cov0), t(x), cov_type),
         jops.gaussian_logprob(j(mean0), j(cov0), j(x), cov_type)),
        (ops.gaussian_logprobgrad(t(mean0), t(cov0), t(x), cov_type),
         jops.gaussian_logprobgrad(j(mean0), j(cov0), j(x), cov_type)),
        (ops.gaussian_entropy(t(cov0), cov_type),
         jops.gaussian_entropy(j(cov0), cov_type)),
        (ops.gaussian_kl(t(mean0), t(cov0), t(mean1), t(cov1), cov_type),
         jops.gaussian_kl(j(mean0), j(cov0), j(mean1), j(cov1), cov_type)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_scale_and_clip_ctrl_match_jax():
    ctrl = np.linspace(-2, 2, 14, dtype=np.float32).reshape(2, 7)
    lo = np.full(7, -0.5, np.float32)
    hi = np.full(7, 1.5, np.float32)
    for squash in ("clip", "tanh", "none"):
        got = ops.scale_ctrl(torch.as_tensor(ctrl), torch.as_tensor(lo),
                             torch.as_tensor(hi), squash).numpy()
        want = np.asarray(jops.scale_ctrl(jnp.asarray(ctrl), jnp.asarray(lo),
                                          jnp.asarray(hi), squash))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    got = ops.clip_ctrl(torch.as_tensor(ctrl), torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(got.numpy(), np.clip(ctrl, lo, hi))
