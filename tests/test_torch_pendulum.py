"""The pendulum slice of the PyTorch port against the JAX package:
SimplePendulum-v0 (envs/pendulum.py), kernel #7's plain version (the fused
rollout) and kernel #8's (the one-kernel MPPI solve) from
ops/pendulum.py, csrc/pendulum.cuh built as host C++, and the fused MPPI
solve against the general one. The kernels themselves run only on a CUDA
card (tests/test_torch_cuda.py).

The start state crosses -pi: th0 = -3.0, thdot0 = -8 ("the crossing
start"). Along it th + pi turns negative, where a truncating modulo (fmodf,
torch.fmod) puts the wrapped angle outside [-pi, pi) and the cost off by
O(10), and the new thdot passes -8 before its clamp, where a step that
clamps before th advances goes wrong.

Tolerances:
- env step and observation against the JAX env over 40 steps: atol 1e-5;
- kernel #7's plain version against JAX rollout_open_loop and the Pallas
  kernel in interpret mode at (16, 8) and (37, 5): rtol = atol = 1e-5, the
  JAX package's own (tests/test_pallas_kernels.py);
- host C++ against the plain version: rtol = atol = 1e-5 (the same
  float32 operations; libm's and PyTorch's sin differ by an ulp or so);
  the host build's noise and cost-to-go for kernel #8: atol 1e-6 on the
  noise, rtol 1e-5 on the cost-to-go;
- kernel #8's update against the JAX package's composition (ar_filter,
  sigma, rollout_open_loop, MPPI(alpha=1).update) on the same white noise,
  at N = 1000 (1024 sampled) and 128, H = 32, lam 0.01 and 1.0: atol 1e-4.
  Not the MPPI parity 2.3e-6 of RESULTS.md: the two packages' rollouts
  from the crossing start differ by up to 1.9e-4 in a cost (ulps of sin
  carried over 32 steps), and the weights pass that on. Readings at this
  seed: 6.0e-8 to 5.8e-6; over six other seeds, up to 2.8e-5 at lam 1.0
  and, once, 2.1e-4 at lam 0.01, where the two best particles nearly tied
  and the sharp weights magnified the roundings. The blend alone, on the
  JAX rollout's own costs and noise: atol 2e-5 (readings 0 to 4.0e-6 here,
  up to 5.9e-6 over the other seeds but for that near-tie; the cost-to-go
  is a recurrence here and a discount-matrix product there). Another draw
  of the white noise moves the mean by 0.77 to 1.31;
- the fused MPPI solve against the general one: atol 2e-5.
"""
import ctypes
import dataclasses
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import ops as jops
from mjmpc_tpu.ops import pallas_kernels as pk
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout_open_loop
from mjmpc_tpu.solvers.base import GaussianState as JaxGaussianState
from mjmpc_tpu.solvers.mppi import MPPI as JaxMPPI
from mjmpc_tpu_torch import bounds, convert, envs, rng, solvers
from mjmpc_tpu_torch.envs import pendulum
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness.episode import _fused_mode
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops import noise as noise_ops
from mjmpc_tpu_torch.ops import pendulum as P
from mjmpc_tpu_torch.rollout.engine import rollout_open_loop

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
TH0, THDOT0 = -3.0, -8.0
FILTER = (0.25, 0.8, 0.0)
SIGMA = float(np.sqrt(3.5))
H = 32
COMPOSITION_ATOL = 1e-4
BLEND_ATOL = 2e-5
HOST_TOL = 1e-5


@pytest.fixture(scope="module")
def jenv():
    return jenvs.make("SimplePendulum-v0")


@pytest.fixture(scope="module")
def env():
    return envs.make("SimplePendulum-v0", device=DEVICE)


def _crossing(jenv):
    """The crossing start, as a JAX state and as the port's."""
    jst = jenv.init(jenv.params, jax.random.PRNGKey(0))._replace(
        th=jnp.float32(TH0), thdot=jnp.float32(THDOT0))
    return jst, convert.pendulum_state_from_reference(jst, device=DEVICE)


def _params(jenv):
    return convert.pendulum_params_from_reference(jenv.params, device=DEVICE)


def test_step_and_observe_match_jax_across_the_wrap(jenv, env):
    jst, st = _crossing(jenv)
    acts = np.random.default_rng(0).uniform(-2.5, 2.5, size=(40, 1)).astype(np.float32)
    params = _params(jenv)
    ths, dths = [], []
    np.testing.assert_allclose(env.observe(params, st).numpy(),
                               np.asarray(jenv.observe(jenv.params, jst)), atol=1e-5)
    for a in acts:
        th_before = float(st.th)
        jst, jobs, jr, jdone = jenv.step(jenv.params, jst, jnp.asarray(a))
        st, obs, r, done = env.step(params, st, torch.as_tensor(a))
        np.testing.assert_allclose([float(st.th), float(st.thdot), float(r)],
                                   [float(jst.th), float(jst.thdot), float(jr)], atol=1e-5)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5)
        assert not bool(done) and not bool(jdone)
        ths.append(float(st.th))
        dths.append((float(st.th) - th_before) / 0.05)
    # the run reaches both hazards: th + pi < 0, and an unclamped |thdot| > 8
    assert min(ths) < -np.pi - 1.0
    assert max(abs(d) for d in dths) > 8.0 + 1e-3


def test_env_contract(env):
    assert (env.name, env.d_obs, env.d_action, env.max_episode_steps) == (
        "SimplePendulum-v0", 3, 1, 200)
    st = env.init(env.params, 3)
    assert st == env.init(env.params, 3)
    assert -np.pi <= float(st.th) <= np.pi and -1.0 <= float(st.thdot) <= 1.0
    x = np.array([-3.5, 3.5, -10.0, 0.0], np.float32)
    wrapped = P.angle_normalize(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(wrapped, np.mod(x + np.pi, 2 * np.pi) - np.pi, atol=1e-6)
    assert wrapped.min() >= -np.pi and wrapped.max() < np.pi


def _rollout_inputs(n, h, seed):
    rng = np.random.default_rng(seed)
    mean = np.asarray(0.3 * rng.normal(size=(h, 1)), np.float32)
    noise = np.asarray(rng.normal(size=(n, h, 1)), np.float32)
    return mean, noise


@pytest.mark.parametrize("n,h", [(16, 8), (37, 5)])
def test_rollout_plain_matches_jax_and_pallas(jenv, env, n, h):
    jst, st = _crossing(jenv)
    mean, noise = _rollout_inputs(n, h, n)
    want = np.asarray(jax_rollout_open_loop(jenv, jenv.params, jst, jnp.asarray(mean),
                                            jnp.asarray(noise)).costs)
    pallas = np.asarray(pk.pendulum_rollout_pallas(jenv.params, jst.th, jst.thdot,
                                                   jnp.asarray(mean), jnp.asarray(noise)))
    args = (_params(jenv), st, torch.as_tensor(mean), torch.as_tensor(noise))
    got = P.pendulum_rollout_plain(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    # the wrapper runs the plain version on CPU tensors, and the port's
    # general rollout takes the same steps
    assert np.array_equal(P.pendulum_rollout(*args).numpy(), got)
    general = rollout_open_loop(env, *args)
    np.testing.assert_array_equal(general.costs.numpy(), got)


def test_truncating_modulo_fails_the_rollout_check(jenv, monkeypatch):
    """The check's power: torch.fmod in place of torch.remainder."""
    jst, st = _crossing(jenv)
    mean, noise = _rollout_inputs(37, 5, 37)
    want = np.asarray(jax_rollout_open_loop(jenv, jenv.params, jst, jnp.asarray(mean),
                                            jnp.asarray(noise)).costs)
    monkeypatch.setattr(torch, "remainder", torch.fmod)
    got = P.pendulum_rollout_plain(_params(jenv), st, torch.as_tensor(mean),
                                   torch.as_tensor(noise)).numpy()
    assert np.abs(got - want).max() > 1.0


_HOST_CPP = '''
#include <vector>
#include "pendulum.cuh"
// kernel #7's three phases over all n particles as one block: the clipped
// actions per element, the recurrence per particle, the cost per element
extern "C" void host_rollout(const float* s, const float* mean, const float* noise,
                             float* costs, int n, int horizon) {
  const pendulum::Model m = pendulum::model(s);
  const size_t items = (size_t)n * horizon;
  std::vector<float> u(items), th(items), thdot(items);
  for (size_t k = 0; k < items; ++k) u[k] = pendulum::control(m, mean[k % horizon] + noise[k]);
  for (int b = 0; b < n; ++b) {
    const size_t row = (size_t)b * horizon;
    pendulum::rollout_states(m, s[pendulum::TH0], s[pendulum::THDOT0], &u[row], &th[row],
                             &thdot[row], horizon);
  }
  for (size_t k = 0; k < items; ++k) costs[k] = pendulum::state_cost(th[k], thdot[k], u[k]);
}
// kernel #8's phases 1 and 2 over all n particles as one CTA: the items
// into the [H, n] eps tile, then each particle's row
extern "C" void host_solve_particles(uint64_t key, uint32_t step, const float* s,
                                     const float* mean, int n, int horizon, float b0,
                                     float b1, float b2, int filter, float sigma, float gamma,
                                     float* eps, float* costs, float* acc) {
  for (int k = 0; k < n * ((horizon + 1) / 2); ++k)
    pendulum::noise_item((uint32_t)key, (uint32_t)(key >> 32), step, k % n, k / n,
                         eps + k % n, n, horizon);
  const pendulum::Model m = pendulum::model(s);
  for (int i = 0; i < n; ++i)
    acc[i] = pendulum::solve_row(m, s[pendulum::TH0], s[pendulum::THDOT0], mean, eps + i,
                                 costs + i, n, horizon, b0, b1, b2, filter != 0, sigma, gamma);
}
'''
# the one line of the floor modulo; the wrong build keeps fmodf's remainder
_FLOOR_MOD = "return (r != 0.0f && (r < 0.0f) != (y < 0.0f)) ? r + y : r;"


def _build_host(tmp, source_dir):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host copy of the kernel source"
    (tmp / "host.cpp").write_text(_HOST_CPP)
    lib_path = tmp / "libpendulumhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(source_dir), "-I", str(CSRC), "-o", str(lib_path),
                    str(tmp / "host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.host_rollout.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int]
    lib.host_solve_particles.argtypes = ([ctypes.c_uint64, ctypes.c_uint32, p, p, ctypes.c_int,
                                          ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_int]
                                         + [ctypes.c_float] * 2 + [p, p, p])
    return lib


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """csrc/pendulum.cuh is host-and-device code: built with g++ it runs the
    kernels' per-thread arithmetic on the CPU. Also a build whose floor
    modulo is the truncating fmodf alone."""
    right = _build_host(tmp_path_factory.mktemp("pendulum_host"), CSRC)
    src = (CSRC / "pendulum.cuh").read_text()
    assert src.count(_FLOOR_MOD) == 1
    wrong_dir = tmp_path_factory.mktemp("pendulum_fmodf")
    (wrong_dir / "pendulum.cuh").write_text(src.replace(_FLOOR_MOD, "return r;"))
    wrong = _build_host(tmp_path_factory.mktemp("pendulum_fmodf_host"), wrong_dir)
    return right, wrong


def _host_rollout(lib, scalars, mean, noise):
    n, h = noise.shape[:2]
    costs = np.empty((n, h), np.float32)
    lib.host_rollout(scalars.ctypes.data, mean.ctypes.data, noise.ctypes.data,
                     costs.ctypes.data, n, h)
    return costs


def _scalars(st, params):
    return P._scalars(params, st, torch.device(DEVICE)).numpy()


@pytest.mark.parametrize("n,h", [(16, 8), (37, 5)])
def test_host_build_matches_plain_and_fmodf_build_fails(jenv, host_libs, n, h):
    right, wrong = host_libs
    _, st = _crossing(jenv)
    params = _params(jenv)
    mean, noise = _rollout_inputs(n, h, 100 + n)
    want = P.pendulum_rollout_plain(params, st, torch.as_tensor(mean),
                                    torch.as_tensor(noise)).numpy()
    scalars = _scalars(st, params)
    np.testing.assert_allclose(_host_rollout(right, scalars, mean, noise), want,
                               rtol=HOST_TOL, atol=HOST_TOL)
    assert np.abs(_host_rollout(wrong, scalars, mean, noise) - want).max() > 1.0


@pytest.mark.parametrize("coeffs,horizon", [(FILTER, H), ((1.0, 0.0, 0.0), 7)])
def test_host_solve_particles_match_plain(jenv, host_libs, coeffs, horizon):
    """Kernel #8's per-item noise (Philox in the filtered-noise kernel's
    counter layout, at step 9) and per-particle row (the filter and sigma,
    the rollout and the cost-to-go) on its [H, n] tiles, against the plain
    version given the step as a tensor."""
    right, _ = host_libs
    _, st = _crossing(jenv)
    params = _params(jenv)
    n, key, step, gamma = 128, 2 ** 40 + 17, 9, 0.98
    mean = np.asarray(0.4 * np.random.default_rng(3).normal(size=(horizon, 1)), np.float32)
    eps = np.empty((horizon, n), np.float32)
    costs = np.empty((horizon, n), np.float32)
    acc = np.empty(n, np.float32)
    use_filter = coeffs != (1.0, 0.0, 0.0) and horizon > 2
    scalars = _scalars(st, params)
    right.host_solve_particles(key, step, scalars.ctypes.data, mean.ctypes.data, n,
                               horizon, *coeffs, int(use_filter), SIGMA, gamma,
                               eps.ctypes.data, costs.ctypes.data, acc.ctypes.data)
    white = noise_ops.philox_normals(key, rng.step_tensor(step, DEVICE), n, horizon, 1)
    want_eps = SIGMA * noise_ops.ar_filter(white, coeffs)
    np.testing.assert_allclose(eps.T, want_eps[..., 0].numpy(), rtol=0, atol=1e-6)
    want_costs = P.pendulum_rollout_plain(params, st, torch.as_tensor(mean), want_eps)
    want_acc = want_costs[:, -1]
    for t in range(horizon - 2, -1, -1):
        want_acc = want_costs[:, t] + gamma * want_acc
    np.testing.assert_allclose(acc, want_acc.numpy(), rtol=HOST_TOL, atol=HOST_TOL)


def _jax_update(jenv, jst, mean, eps, lam):
    traj = jax_rollout_open_loop(jenv, jenv.params, jst, jnp.asarray(mean), eps)
    solver = JaxMPPI(d_action=1, horizon=mean.shape[0], num_particles=eps.shape[0], alpha=1,
                     lam=lam, step_size=0.55, gamma=1.0, filter_coeffs=FILTER)
    state = JaxGaussianState(mean=jnp.asarray(mean), cov=3.5 * jnp.eye(1), step=jnp.int32(0),
                             key=jax.random.PRNGKey(0))
    return np.asarray(solver.update(state, traj).mean), traj


@pytest.mark.parametrize("num_particles,lam", [(1000, 0.01), (1000, 1.0), (128, 0.01),
                                               (128, 1.0)])
def test_mppi_update_matches_jax_composition(jenv, num_particles, lam):
    n = P.sampled_particles(num_particles)
    assert n == (1024 if num_particles == 1000 else 128)
    jst, st = _crossing(jenv)
    rng = np.random.default_rng(0)
    mean = np.asarray(0.5 * rng.normal(size=(H, 1)), np.float32)
    white = np.asarray(rng.normal(size=(n, H)), np.float32)
    eps = SIGMA * jops.ar_filter(jnp.asarray(white)[..., None], FILTER)
    want, traj = _jax_update(jenv, jst, mean, eps, lam)
    got = P.mppi_pendulum_update_plain(_params(jenv), st, torch.as_tensor(mean),
                                       torch.as_tensor(white), FILTER, SIGMA, lam, 0.55, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=COMPOSITION_ATOL)
    blend = P.mppi_blend_plain(torch.as_tensor(mean), torch.tensor(np.asarray(eps)),
                               torch.tensor(np.asarray(traj.costs)), lam, 0.55, 1.0)
    np.testing.assert_allclose(blend.numpy(), want, rtol=0, atol=BLEND_ATOL)
    # the check's power: another draw of the noise moves the mean by far more
    other_white = np.asarray(rng.normal(size=(n, H)), np.float32)
    other = P.mppi_pendulum_update_plain(_params(jenv), st, torch.as_tensor(mean),
                                         torch.as_tensor(other_white), FILTER, SIGMA, lam,
                                         0.55, 1.0)
    assert np.abs(other.numpy() - want).max() > 10 * COMPOSITION_ATOL


def test_mppi_solve_plain_draws_the_kernel_noise(jenv):
    _, st = _crossing(jenv)
    params = _params(jenv)
    mean = torch.zeros(H, 1)
    step = rng.step_tensor(3, DEVICE)
    before = P.MppiPendulumSolve.launches
    got = P.mppi_pendulum_solve(params, st, mean, 1000, step, 24, FILTER, SIGMA, 0.01, 0.55,
                                1.0)
    assert P.MppiPendulumSolve.launches == before    # the plain version on CPU tensors
    white = noise_ops.philox_normals(1000, step, 128, H, 1)[..., 0]
    want = P.mppi_pendulum_update_plain(params, st, mean, white, FILTER, SIGMA, 0.01, 0.55, 1.0)
    assert got.shape == (H, 1) and torch.equal(got, want)
    for key, other_step in ((1001, step), (1000, step + 1)):   # another key, another step
        assert not torch.equal(got, P.mppi_pendulum_solve_plain(
            params, st, mean, key, other_step, 24, FILTER, SIGMA, 0.01, 0.55, 1.0))


def test_one_kernel_solve_plain_swings_up(env):
    """The JAX package's closed loop on kernel #8
    (tests/test_pallas_kernels.py test_one_kernel_mppi_solve_controls),
    through the plain version: 100 steps at N = 1024."""
    st = env.init(env.params, 1)
    mean, total, step = torch.zeros(H, 1), 0.0, rng.step_tensor(0, DEVICE)
    for _ in range(100):
        mean = P.mppi_pendulum_solve(env.params, st, mean, 1000, step, 1024, FILTER, SIGMA, 0.01,
                                     0.55, 1.0)
        step = step + 1
        st, _, r, _ = env.step(env.params, st, env.clip_action(mean[0]))
        total += float(r)
        mean = torch.cat([mean[1:], torch.zeros(1, 1)])
    assert total > -400.0


def _config_solver(env, controller, **small):
    exp = cfg.load_config("configs/SimplePendulum-v0.yml")
    return dataclasses.replace(cfg.make_solver_for_env(exp, controller, env), **small)


@pytest.mark.parametrize("controller", ["mppi", "pfmpc"])
def test_fused_solve_matches_general_solve(env, controller):
    solver = _config_solver(env, controller, num_particles=64, horizon=16)
    before = P.PendulumRollout.launches
    env_state = pendulum.PendulumState(th=torch.tensor(TH0), thdot=torch.tensor(THDOT0))
    out = {}
    for fused in ("auto", False):
        solve = solvers.make_solve_fn(solver, env, fused=fused)
        state, actions = solver.init_state(0), []
        for _ in range(3):
            action, _, state = solve(env.params, env_state, state)
            actions.append(action)
        out[fused] = (torch.stack(actions), state.mean)
    for a, b in zip(out["auto"], out[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    assert P.PendulumRollout.launches == before


def test_fused_rollout_plans_against_any_pendulum_params(env):
    assert set(env.fused_rollout.dynamic_fields) == set(P.PARAM_FIELDS)
    heavier = dataclasses.replace(env.params, m=torch.tensor(1.3), g=torch.tensor(9.0))
    assert _fused_mode(env, heavier) == "auto"


def test_wrappers_reject_bad_arguments(env):
    st = env.init(env.params, 0)
    with pytest.raises(ValueError):
        P.pendulum_rollout(env.params, st, torch.zeros(5, 1), torch.zeros(4, 6, 1))
    with pytest.raises(TypeError):
        P.pendulum_rollout(env.params, st, torch.zeros(5, 1), torch.zeros(4, 5, 1,
                                                                         dtype=torch.float64))
    with pytest.raises(ValueError):
        P.mppi_pendulum_solve(env.params, st, torch.zeros(5, 1), 0, rng.step_tensor(0, DEVICE),
                              64, lam=0.0)
    with pytest.raises(TypeError):     # a host step
        P.mppi_pendulum_solve(env.params, st, torch.zeros(5, 1), 0, 0, 64)


def test_convert_round_trip(jenv):
    params = convert.pendulum_params_from_reference(jenv.params, device=DEVICE)
    for f in P.PARAM_FIELDS:
        got = getattr(params, f)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(getattr(jenv.params, f))
    jst = jenv.init(jenv.params, jax.random.PRNGKey(4))
    st = convert.pendulum_state_from_reference(jst, device=DEVICE)
    assert (float(st.th), float(st.thdot)) == (float(jst.th), float(jst.thdot))
    batch = jst._replace(th=jnp.array([0.1, -3.2]), thdot=jnp.array([1.0, 7.5]))
    st = convert.pendulum_state_from_reference(batch, device=DEVICE)
    np.testing.assert_array_equal(st.th.numpy(), np.asarray(batch.th))


def test_bounds_count_the_pendulum_kernels():
    """#7 moves 2 N H floats against 26 operations per particle-step, so the
    bytes bound it; #8 moves only 2 H + 8 floats, so its operations do, at
    the sampled particle count."""
    r7 = bounds.pendulum_instance(7, 4096, 32)
    assert r7["bytes"] == 4 * (8 + 32 + 2 * 4096 * 32) and r7["bound_by"] == "bytes"
    assert r7["operations"] == 26 * 4096 * 32
    r8, r8_padded = bounds.pendulum_instance(8, 1000, 32), bounds.pendulum_instance(8, 1024, 32)
    assert r8["operations"] == r8_padded["operations"] and r8["bound_by"] == "operations"
    assert r8["bytes"] == 4 * (8 + 2 * 32)
    assert [r["number"] for r in bounds.kernel_table(
        envs.make("reacher_7dof-v0", device=DEVICE).params.model)][6:] == [7, 8]
