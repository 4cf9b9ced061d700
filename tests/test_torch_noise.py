"""The filtered-noise kernel's plain version and wrapper
(mjmpc_tpu_torch/ops/noise.py FilteredNoise) and the uniforms kernel's
(PhiloxUniforms) against Philox's published answers, the kernels' per-item
source compiled as host C++ (run in the kernel's phases: items, then the
filter along each column) at a step that is not 0, the JAX package's
filter and colouring, and the statistics the JAX package checks of its TPU
sampler (tests/test_pallas_kernels.py, which cannot run them on the CPU).
The kernels themselves run only on a CUDA card (tests/test_torch_cuda.py).

Tolerances:
- Philox words and uniforms: bit for bit (integer arithmetic and exact
  float conversions on both sides);
- host C++ against plain: atol 1e-6 on normals of magnitude < 6 (the same
  uniforms; libm and PyTorch's log/cos differ by an ulp or so, and the
  filter's gain of about 1.25 carries that over);
- filter + colouring against JAX: atol 1e-5 (f32, sums in other orders,
  outputs of order 1-5);
- statistics: the JAX package's own bounds.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import ops as jops
from mjmpc_tpu_torch import ops, rng, solvers
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops.noise import FilteredNoise, philox4x32_10, philox_normals

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
HOST_ATOL = 1e-6
JAX_ATOL = 1e-5


def _words(counters, key):
    c = tuple(torch.as_tensor(np.asarray(col, np.int64)) for col in np.asarray(counters).T)
    return np.stack([w.numpy() for w in philox4x32_10(c, key)], -1).astype(np.uint32)


def test_philox_known_answers():
    """The Random123 known-answer vectors of Philox4x32-10."""
    counters = [(0, 0, 0, 0), (0xFFFFFFFF,) * 4,
                (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)]
    keys = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0xA4093822, 0x299F31D0)]
    want = [(0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8),
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)]
    for c, k, w in zip(counters, keys, want):
        np.testing.assert_array_equal(_words([c], k)[0], np.array(w, np.uint32))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/philox.cuh + filtered_noise.cuh are host-and-device code: built
    with g++ they run the kernel's per-thread arithmetic on the CPU."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host copy of the kernel source"
    tmp = tmp_path_factory.mktemp("noise_host")
    (tmp / "host.cpp").write_text(
        '#include "filtered_noise.cuh"\n'
        'extern "C" void host_philox(const uint32_t* ctr, int n, uint64_t seed,\n'
        '                            uint32_t* out) {\n'
        '  for (int i = 0; i < n; ++i) {\n'
        '    philox::U4 r = philox::philox4x32_10(\n'
        '        {ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]},\n'
        '        (uint32_t)seed, (uint32_t)(seed >> 32));\n'
        '    out[4 * i] = r.x; out[4 * i + 1] = r.y;\n'
        '    out[4 * i + 2] = r.z; out[4 * i + 3] = r.w;\n'
        '  }\n'
        '}\n'
        'extern "C" void host_noise(uint64_t key, uint32_t step, float b0, float b1,\n'
        '                           float b2, int filter, int n, int horizon,\n'
        '                           int d_action, float* out) {\n'
        '  const int pairs = (horizon + 1) / 2, row = horizon * d_action;\n'
        '  for (int b = 0; b < n; ++b)\n'
        '    for (int p = 0; p < pairs; ++p)\n'
        '      for (int d = 0; d < d_action; ++d) {\n'
        '        float z0, z1;\n'
        '        filtered_noise::normal_pair((uint32_t)key, (uint32_t)(key >> 32), b, d,\n'
        '                                    p, step, z0, z1);\n'
        '        float* at = out + (size_t)b * row + 2 * p * d_action + d;\n'
        '        at[0] = z0;\n'
        '        if (2 * p + 1 < horizon) at[d_action] = z1;\n'
        '      }\n'
        '  if (filter)\n'
        '    for (int c = 0; c < n * d_action; ++c)\n'
        '      filtered_noise::filter_column(out + (c / d_action) * row + c % d_action,\n'
        '                                    d_action, horizon, b0, b1, b2);\n'
        '}\n'
        'extern "C" void host_uniforms(uint64_t key, uint32_t step, int n, float* out) {\n'
        '  for (int q = 0; 4 * q < n; ++q) {\n'
        '    float u[4];\n'
        '    filtered_noise::uniform_quad((uint32_t)key, (uint32_t)(key >> 32), q, step, u);\n'
        '    for (int k = 0; k < 4 && 4 * q + k < n; ++k) out[4 * q + k] = u[k];\n'
        '  }\n'
        '}\n')
    lib_path = tmp / "libnoisehost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(CSRC), "-o", str(lib_path), str(tmp / "host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.host_philox.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                                ctypes.c_void_p]
    lib.host_noise.argtypes = ([ctypes.c_uint64, ctypes.c_uint32] + [ctypes.c_float] * 3
                               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.host_uniforms.argtypes = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int,
                                  ctypes.c_void_p]
    return lib


def test_host_philox_matches_plain_bit_for_bit(host_lib):
    rs = np.random.default_rng(0)
    counters = rs.integers(0, 2 ** 32, size=(257, 4), dtype=np.uint64).astype(np.uint32)
    seed = rng.derive_seed(5, 0, 3)
    out = np.empty_like(counters)
    host_lib.host_philox(counters.ctypes.data, len(counters), seed, out.ctypes.data)
    np.testing.assert_array_equal(out, _words(counters, (seed & 0xFFFFFFFF, seed >> 32)))


@pytest.mark.parametrize("coeffs,horizon", [((0.25, 0.8, 0.0), 9), ((0.5, 0.3, 0.2), 6),
                                            ((1.0, 0.0, 0.0), 5), ((0.25, 0.8, 0.0), 2)])
def test_host_noise_matches_plain(host_lib, coeffs, horizon):
    """The kernel's items and filter, at step 7 (counter word 3), against
    the plain version given the step as a tensor."""
    n, d_action, step = 37, 3, 7
    key = rng.stream_key(11, 0)
    use_filter = coeffs != (1.0, 0.0, 0.0) and horizon > 2
    out = np.empty((n, horizon, d_action), np.float32)
    host_lib.host_noise(key, step, *coeffs, int(use_filter), n, horizon, d_action,
                        out.ctypes.data)
    want = FilteredNoise().white_plain(key, rng.step_tensor(step, DEVICE), n, horizon,
                                       d_action, coeffs)
    np.testing.assert_allclose(out, want.numpy(), rtol=0, atol=HOST_ATOL)
    at_0 = FilteredNoise().white_plain(key, rng.step_tensor(0, DEVICE), n, horizon, d_action,
                                       coeffs)
    assert np.abs(out - at_0.numpy()).max() > 1.0     # the step is read


@pytest.mark.parametrize("n,step", [(1, 0), (13, 3), (64, 2 ** 33 + 5)])
def test_host_uniforms_match_plain_bit_for_bit(host_lib, n, step):
    """The uniforms kernel's items against philox_uniforms; the step enters
    as its low 32 bits."""
    key = rng.stream_key(4, 10)
    out = np.empty(n, np.float32)
    host_lib.host_uniforms(key, step & 0xFFFFFFFF, n, out.ctypes.data)
    got = ops.uniforms(key, rng.step_tensor(step, DEVICE), n)
    np.testing.assert_array_equal(out, got.numpy())
    assert got.min() > 0.0 and got.max() < 1.0


@pytest.mark.parametrize("coeffs", [(0.25, 0.8, 0.0), (0.5, 0.3, 0.2)])
def test_filter_and_colouring_match_jax(coeffs):
    """Injected white noise through the plain version's filter and
    colouring against JAX ops.ar_filter(white) @ chol.T."""
    rs = np.random.default_rng(1)
    white = rs.normal(size=(16, 10, 4)).astype(np.float32)
    a = rs.normal(size=(4, 4))
    cov = (a @ a.T / 4 + 0.5 * np.eye(4)).astype(np.float32)
    chol = np.linalg.cholesky(cov.astype(np.float64) + 1e-6 * np.eye(4)).astype(np.float32)
    want = np.asarray(jops.ar_filter(jnp.asarray(white), coeffs) @ jnp.asarray(chol).T)
    got = ops.colour(ops.ar_filter(torch.as_tensor(white), coeffs), torch.as_tensor(cov))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_ATOL)


def _sample(seed, shape, d_action, coeffs, cov=None):
    cov = torch.eye(d_action) if cov is None else torch.as_tensor(cov)
    return FilteredNoise()(seed, rng.step_tensor(0, DEVICE), cov, shape, coeffs).numpy()


def test_statistics_and_seeding():
    eps = _sample(7, (2048, 12), 2, (1.0, 0.0, 0.0))
    assert eps.shape == (2048, 12, 2) and np.isfinite(eps).all()
    assert abs(eps.mean()) < 0.05
    assert abs(eps.std() - 1.0) < 0.05
    np.testing.assert_array_equal(eps, _sample(7, (2048, 12), 2, (1.0, 0.0, 0.0)))
    assert not np.allclose(eps, _sample(8, (2048, 12), 2, (1.0, 0.0, 0.0)))


def test_ar_recurrence_innovations_are_standard_normal():
    b0, b1, b2 = 0.25, 0.8, 0.1
    e = _sample(3, (64, 10), 1, (b0, b1, b2))[..., 0]
    z = (e[:, 2:] - b1 * e[:, 1:-1] - b2 * e[:, :-2]) / b0
    assert abs(z.std() - 1.0) < 0.1
    assert abs(e[:, :2].std() - 1.0) < 0.1
    # the innovations are the kernel's own normals
    raw = philox_normals(3, rng.step_tensor(0, DEVICE), 64, 10, 1).numpy()[..., 0]
    np.testing.assert_allclose(z, raw[:, 2:], rtol=0, atol=1e-4)


def test_covariance_colouring():
    cov = np.array([[2.0, 0.5], [0.5, 1.0]], np.float32)
    eps = _sample(11, (4096, 4), 2, (1.0, 0.0, 0.0), cov)
    np.testing.assert_allclose(np.cov(eps.reshape(-1, 2).T), cov, atol=0.1)


def test_kernel_noise_impl_runs_plain_on_the_cpu_and_counts_no_launch():
    solver = solvers.MPPI(d_action=3, horizon=6, num_particles=5, init_cov=0.7,
                          filter_coeffs=(0.25, 0.8, 0.0), noise_impl="kernel",
                          device=DEVICE)
    state = solver.init_state(4)
    before = FilteredNoise.launches
    got = solver.sample_noise(state)
    assert FilteredNoise.launches == before
    want = FilteredNoise().plain(rng.stream_key(4, 0), state.step, state.cov, (5, 6),
                                 (0.25, 0.8, 0.0))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(solver.sample_noise(solver.init_state(5)), got)


def test_noise_impl_is_checked():
    with pytest.raises(ValueError):
        solvers.MPPI(d_action=3, horizon=4, num_particles=4, noise_impl="pallas",
                     device=DEVICE)


@pytest.mark.parametrize("bad", ["dtype", "shape", "empty", "host_step", "step_dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    cov, shape, step = torch.eye(3), (4, 5), rng.step_tensor(0, DEVICE)
    if bad == "dtype":
        cov = cov.double()
    elif bad == "shape":
        cov = cov[:2]
    elif bad == "empty":
        shape = (0, 5)
    elif bad == "host_step":
        step = 0
    else:
        step = step.to(torch.int32)
    with pytest.raises((TypeError, ValueError)):
        FilteredNoise()(1, step, cov, shape, (1.0, 0.0, 0.0))
