"""The obs-emitting chain rollout (mjmpc_tpu_torch/ops/chain_rollout.py
ChainObsRollout, reacher's fused_obs_rollout) in its plain version against
the JAX package's general rollout, the port's general rollout and the
kernel source's team code in its OBS mode compiled as host C++. The kernel
itself runs only on a CUDA card (tests/test_torch_cuda.py).

Tolerances: against JAX rollout_open_loop, obs atol 2e-5 and costs atol
2e-4, the JAX package's own tolerances for its obs kernel against that
rollout (tests/test_pallas_cl.py); against the host build and the port's
general rollout, atol 5e-5, the chain kernel's tolerance (f32 physics over
H * 2 substeps, sums in other orders).
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout_open_loop
from mjmpc_tpu_torch import bounds, convert, envs
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops.chain_rollout import (ChainObsRollout, ChainRollout,
                                               build_chain_obs_rollout, rollout_flops)
from mjmpc_tpu_torch.rollout import rollout_open_loop

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
ATOL = 5e-5


def _setup(n, h, seed):
    rs = np.random.default_rng(seed)
    mean = np.asarray(rs.normal(size=(h, 7)) * 0.3, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, 7)) * 0.5, np.float32)
    q0 = np.asarray(rs.normal(size=7) * 0.1, np.float32)
    qd0 = np.asarray(rs.normal(size=7) * 0.1, np.float32)
    target = np.array([0.2, -0.1, 0.15], np.float32)
    return q0, qd0, target, mean, noise


@pytest.fixture(scope="module")
def env():
    return envs.make("reacher_7dof-v0", device=DEVICE)


@pytest.fixture(scope="module")
def rollout(env):
    return build_chain_obs_rollout(env.params.model, n_substeps=2)


def test_env_wires_the_obs_rollout(env):
    assert env.fused_obs_rollout is not None
    assert envs.make("continual_reacher-v0", device=DEVICE).fused_obs_rollout is None


def test_plain_matches_jax_general_rollout(env):
    """reacher's fused_obs_rollout (plain on the CPU) against JAX
    rollout_open_loop at N=8, H=4, as tests/test_pallas_cl.py holds the
    TPU obs kernel."""
    jenv = jenvs.make("reacher_7dof-v0")
    rs = np.random.default_rng(11)
    mean = np.asarray(rs.normal(size=(4, 7)) * 0.2, np.float32)
    noise = np.asarray(rs.normal(size=(8, 4, 7)) * 0.3, np.float32)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    js = js._replace(qpos=js.qpos + jnp.asarray(rs.uniform(-0.2, 0.2, 7), jnp.float32))
    traj = jax_rollout_open_loop(jenv, jenv.params, js, jnp.asarray(mean), jnp.asarray(noise))
    state = convert.reacher_state_from_reference(js, device=DEVICE)
    obs, costs = env.fused_obs_rollout(env.params, state, torch.as_tensor(mean),
                                       torch.as_tensor(noise))
    assert obs.shape == (8, 4, env.d_obs) and costs.shape == (8, 4)
    np.testing.assert_allclose(obs.numpy(), np.asarray(traj.observations), rtol=0, atol=2e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(traj.costs), rtol=0, atol=2e-4)


def test_plain_matches_port_general_rollout_and_costs_kernel(env, rollout):
    q0, qd0, target, mean, noise = (torch.as_tensor(a) for a in _setup(24, 6, seed=2))
    state = env.init(env.params, 0)
    state = type(state)(qpos=q0, qvel=qd0, target=target, timestep=0, seed=0)
    traj = rollout_open_loop(env, env.params, state, mean, noise)
    obs, costs = rollout(q0, qd0, target, mean, noise)
    np.testing.assert_allclose(obs.numpy(), traj.observations.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(costs.numpy(), traj.costs.numpy(), rtol=0, atol=ATOL)
    torch.testing.assert_close(costs, env.fused_rollout(env.params, state, mean, noise),
                               rtol=0, atol=0)


def test_kernel_source_compiled_for_the_host_matches_plain(rollout, tmp_path):
    """The OBS-mode instantiation of csrc/chain_team.cuh's rollout_team,
    built with g++ (each phase's lanes in turn)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host copy of the kernel source"
    (tmp_path / "chain_model.h").write_text(rollout.header)
    (tmp_path / "host.cpp").write_text(
        '#include "chain_team.cuh"\n'
        'extern "C" void host_obs_rollout(const float* q0, const float* qd0,\n'
        '    const float* target, const float* mean, const float* noise,\n'
        '    float* costs, float* obs, int n, int horizon) {\n'
        '  static chain_team::Particle s;   // one team, its lanes in turn\n'
        '  for (int b = 0; b < n; ++b)\n'
        '    chain_team::rollout_team<chain_rollout::OBS, chain_rollout::BuildTask>(\n'
        '        s, chain_team::Team{}, q0, qd0, target, mean, noise, costs, obs, nullptr,\n'
        '        b, horizon);\n'
        '}\n')
    lib_path = tmp_path / "libobshost.so"
    subprocess.run([gxx, "-std=c++17", "-O0", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(tmp_path), "-I", str(CSRC), "-o", str(lib_path),
                    str(tmp_path / "host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    args = [np.ascontiguousarray(a) for a in _setup(37, 8, seed=3)]
    costs = np.empty((37, 8), np.float32)
    obs = np.empty((37, 8, rollout.d_obs), np.float32)
    lib.host_obs_rollout(*(a.ctypes.data_as(ctypes.c_void_p) for a in args + [costs, obs]),
                         ctypes.c_int(37), ctypes.c_int(8))
    want_obs, want_costs = rollout(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(obs, want_obs.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(costs, want_costs.numpy(), rtol=0, atol=ATOL)


def test_cpu_wrapper_runs_plain_and_counts_no_launch(rollout):
    args = [torch.as_tensor(a) for a in _setup(5, 3, seed=4)]
    before = (ChainObsRollout.launches, ChainRollout.launches)
    got_obs, got_costs = rollout(*args)
    want_obs, want_costs = rollout.plain(*args)
    torch.testing.assert_close(got_obs, want_obs, rtol=0, atol=0)
    torch.testing.assert_close(got_costs, want_costs, rtol=0, atol=0)
    assert (ChainObsRollout.launches, ChainRollout.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "nv", "mean_h", "qd0", "target", "empty",
                                 "not_tensor"])
def test_wrapper_rejects_bad_inputs(rollout, bad):
    q0, qd0, target, mean, noise = (torch.as_tensor(a) for a in _setup(5, 3, seed=5))
    if bad == "dtype":
        mean = mean.double()
    elif bad == "nv":
        noise = noise[..., :5]
    elif bad == "mean_h":
        mean = mean[:1]
    elif bad == "qd0":
        qd0 = qd0[:6]
    elif bad == "target":
        target = target[:2]
    elif bad == "empty":
        noise = noise[:, :0]
    else:
        noise = noise.numpy()
    with pytest.raises((TypeError, ValueError)):
        rollout(q0, qd0, target, mean, noise)


def test_op_counts_and_bounds(env):
    """The counts behind chip_smoke.py's bounds: linear in N and in H per
    particle, the obs stores' site and difference (21 ops) per step, and
    one bound for each of the eight TPU kernels."""
    model = env.params.model
    per_particle = rollout_flops(model, 2, 1, 32)
    assert rollout_flops(model, 2, 4096, 32) == 4096 * per_particle
    per_step = rollout_flops(model, 2, 1, 2) - rollout_flops(model, 2, 1, 1)
    assert per_particle == rollout_flops(model, 2, 1, 0) + 32 * per_step
    assert rollout_flops(model, 2, 5, 3, "obs") - rollout_flops(model, 2, 5, 3) == 5 * 3 * 21
    rows = bounds.kernel_table(model, 4096, 32)
    assert [r["number"] for r in rows] == list(range(1, 9))
    noise = rows[1]
    assert noise["bytes"] == 4 * 4096 * 32 * 7 and noise["bound_by"] == "bytes"
    assert noise["bound_ms"] == pytest.approx(noise["bytes"] / bounds.PEAK_BYTES_PER_S * 1e3)
    assert rows[0]["bound_by"] == "operations"
