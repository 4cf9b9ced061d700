"""The chain-rollout kernel's plain PyTorch version and its wrapper
(mjmpc_tpu_torch/ops/chain_rollout.py) against the JAX Pallas kernel, the
f64 C++ oracle and the port's general rollout, and the kernel source's
team code in its costs mode compiled as host C++ (each phase's lanes in
turn). The kernel itself runs only on a CUDA card
(tests/test_torch_cuda.py).

Tolerance: atol 5e-5 on costs of order 1-10, the JAX kernel's own
tolerance (tests/test_pallas_chain.py): f32 physics over H * 2 substeps,
with sums in different orders on each side.
"""
import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.ops.pallas_chain import build_chain_rollout as jax_build_chain_rollout
from mjmpc_tpu.oracle import cpp_oracle
from mjmpc_tpu_torch import envs
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops.chain_rollout import ChainRollout, build_chain_rollout
from mjmpc_tpu_torch.rollout import rollout_open_loop

ATOL = 5e-5
DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU


def _setup(n, h, seed):
    rng = np.random.default_rng(seed)
    mean = np.asarray(rng.normal(size=(h, 7)) * 0.3, np.float32)
    noise = np.asarray(rng.normal(size=(n, h, 7)) * 0.5, np.float32)
    q0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    qd0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    target = np.array([0.2, -0.1, 0.15], np.float32)
    return q0, qd0, target, mean, noise


def _oracle_costs(args):
    q0, qd0, target, mean, noise = args
    model = jenvs.make("reacher_7dof-v0").params.model
    sites = cpp_oracle.chain_site_rollout(model, q0, qd0, mean, noise, n_substeps=2)
    diff = sites - target
    return np.abs(diff).sum(-1) + 5.0 * np.linalg.norm(diff, axis=-1)


@pytest.fixture(scope="module")
def rollout():
    return build_chain_rollout(envs.make("reacher_7dof-v0", device=DEVICE).params.model, n_substeps=2)


def _plain(rollout, args):
    return rollout(*(torch.as_tensor(a) for a in args)).numpy()


def test_plain_matches_pallas_kernel(rollout):
    """The JAX Pallas kernel, in interpret mode on the CPU, once."""
    args = _setup(16, 4, seed=0)
    jax_roll = jax_build_chain_rollout(jenvs.make("reacher_7dof-v0").params.model,
                                       n_substeps=2)
    want = np.asarray(jax.jit(jax_roll)(*args))
    np.testing.assert_allclose(_plain(rollout, args), want, rtol=0, atol=ATOL)


def test_plain_matches_cpp_oracle_at_ragged_n(rollout):
    args = _setup(37, 8, seed=1)
    got = _plain(rollout, args)
    assert got.shape == (37, 8)
    np.testing.assert_allclose(got, _oracle_costs(args), rtol=0, atol=ATOL)


def test_plain_matches_general_rollout(rollout):
    """The kernel's hand RNEA against the engine's Lagrangian-derived bias,
    through the general rollout (costs on the post-step state)."""
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    q0, qd0, target, mean, noise = (torch.as_tensor(a) for a in _setup(24, 6, seed=2))
    state = env.init(env.params, 0)
    state = type(state)(qpos=q0, qvel=qd0, target=target, timestep=0, seed=0)
    traj = rollout_open_loop(env, env.params, state, mean, noise)
    torch.testing.assert_close(traj.actions, mean[None] + noise, rtol=0, atol=0)
    np.testing.assert_allclose(rollout(q0, qd0, target, mean, noise).numpy(),
                               traj.costs.numpy(), rtol=0, atol=ATOL)


def test_kernel_source_compiled_for_the_host_matches_plain(rollout, tmp_path):
    """csrc/chain_team.cuh is host-and-device code: built with g++ it runs
    the kernel's costs mode on the CPU, each phase's lanes one after
    another in the kernel's own partition and order."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host copy of the kernel source"
    (tmp_path / "chain_model.h").write_text(rollout.header)
    (tmp_path / "host.cpp").write_text(
        '#include "chain_team.cuh"\n'
        'extern "C" void host_rollout(const float* q0, const float* qd0,\n'
        '    const float* target, const float* mean, const float* noise,\n'
        '    float* costs, int n, int horizon) {\n'
        '  static chain_team::Particle s;   // one team, its lanes in turn\n'
        '  for (int b = 0; b < n; ++b)\n'
        '    chain_team::rollout_team<chain_rollout::COSTS, chain_rollout::BuildTask>(\n'
        '        s, chain_team::Team{}, q0, qd0, target, mean, noise, costs, nullptr,\n'
        '        nullptr, b, horizon);\n'
        '}\n')
    lib_path = tmp_path / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O0", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(tmp_path), "-I", str(CSRC), "-o", str(lib_path),
                    str(tmp_path / "host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    args = [np.ascontiguousarray(a) for a in _setup(37, 8, seed=3)]
    costs = np.empty((37, 8), np.float32)
    lib.host_rollout(*(a.ctypes.data_as(ctypes.c_void_p) for a in args + [costs]),
                     ctypes.c_int(37), ctypes.c_int(8))
    np.testing.assert_allclose(costs, _plain(rollout, args), rtol=0, atol=ATOL)


def test_header_bakes_the_model(rollout):
    h = rollout.header
    assert "constexpr int N = 7;" in h
    assert "constexpr int N_SUBSTEPS = 2;" in h
    assert "constexpr int SITE_BODY = 6;" in h
    assert "{-1, 0, 1, 2, 3, 4, 5}" in h


def test_cpu_wrapper_runs_plain_and_counts_no_launch(rollout):
    args = [torch.as_tensor(a) for a in _setup(5, 3, seed=4)]
    before = ChainRollout.launches
    torch.testing.assert_close(rollout(*args), rollout.plain(*args), rtol=0, atol=0)
    assert ChainRollout.launches == before


@pytest.mark.parametrize("bad", ["dtype", "nv", "mean_h", "q0", "target",
                                 "empty", "not_tensor"])
def test_wrapper_rejects_bad_inputs(rollout, bad):
    q0, qd0, target, mean, noise = (torch.as_tensor(a) for a in _setup(5, 3, seed=5))
    if bad == "dtype":
        noise = noise.double()
    elif bad == "nv":
        noise = noise[..., :6]
    elif bad == "mean_h":
        mean = mean[:2]
    elif bad == "q0":
        q0 = q0[:6]
    elif bad == "target":
        target = target[None]
    elif bad == "empty":
        noise = noise[:0]
    else:
        mean = mean.numpy()
    with pytest.raises((TypeError, ValueError)):
        rollout(q0, qd0, target, mean, noise)
