"""The closed-loop-linear chain rollout (mjmpc_tpu_torch/ops/chain_rollout.py
ChainClRollout, the envs' fused_cl_rollout), the port's general
rollout_closed_loop_linear and the peg-insertion envs, against the JAX
package's general rollout, and the kernel source's team code in its
closed-loop and observation modes compiled as host C++ for both tasks. The
kernel itself runs only on a CUDA card (tests/test_torch_cuda.py).

Tolerances: against JAX rollout_closed_loop_linear, obs and actions atol
2e-5 and costs atol 2e-4, the JAX package's own tolerances for its
closed-loop kernel against that rollout (tests/test_pallas_cl.py); against
the host build and the port's general rollouts, atol 5e-5, the chain
kernel's tolerance (f32 physics over H * 2 substeps, sums in other
orders). Whole Reinforce solves against JAX's on injected noise (here,
beside the JAX rollout they share): atol 5e-5, the JAX package's tolerance
for its fused against its general solve.
"""
import ctypes
import dataclasses
import shutil
import subprocess
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.rollout.engine import rollout_closed_loop_linear as jax_rollout_cl
from mjmpc_tpu_torch import bounds, convert, envs, solvers
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops.chain_rollout import (PEG, REACHER, ChainClRollout, ChainObsRollout,
                                               ChainRollout, build_chain_cl_rollout,
                                               rollout_bytes, rollout_cl_plain, rollout_flops)
from mjmpc_tpu_torch.rollout import rollout_closed_loop_linear, rollout_open_loop

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
ATOL = 5e-5
ENVS = ("reacher_7dof-v0", "sawyer_peg_insertion-v0", "sawyer_peg_insertion-v1")
N, H = 16, 4     # one shape, so that each JAX rollout compiles once


def _policy_inputs(d_obs, n, h, seed):
    """W [d_obs + 1, 7] * 0.05, noise [n, h, 7] * 0.3 and a qpos offset, as
    tests/test_pallas_cl.py draws them."""
    rs = np.random.default_rng(seed)
    w = np.asarray(rs.normal(size=(d_obs + 1, 7)) * 0.05, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, 7)) * 0.3, np.float32)
    dq = np.asarray(rs.uniform(-0.2, 0.2, 7), np.float32)
    return w, noise, dq


def _state(env, dq, qd=None):
    """The env's initial state with qpos + dq (and qvel = qd)."""
    s = env.init(env.params, 0)
    qvel = s.qvel if qd is None else torch.as_tensor(qd)
    return type(s)(**{**vars(s), "qpos": s.qpos + torch.as_tensor(dq), "qvel": qvel})


@pytest.fixture(scope="module")
def jax_cl():
    """JAX's general closed-loop rollout at [N, H], one compile per task:
    the peg variants differ only in params, which are arguments."""
    fns = {}
    for name in ("reacher_7dof-v0", "sawyer_peg_insertion-v0"):
        jenv = jenvs.make(name)
        fns[name] = jax.jit(lambda p, s, w, nz, jenv=jenv: jax_rollout_cl(jenv, p, s, w, nz))
    fns["sawyer_peg_insertion-v1"] = fns["sawyer_peg_insertion-v0"]
    return fns


def test_envs_wire_the_rollouts():
    reacher = envs.make("reacher_7dof-v0", device=DEVICE)
    assert reacher.fused_cl_rollout is not None
    assert envs.make("continual_reacher-v0", device=DEVICE).fused_cl_rollout is None
    for name in ENVS[1:]:
        env = envs.make(name, device=DEVICE)
        assert env.d_obs == 19 and env.fused_cl_rollout is not None
        assert env.fused_obs_rollout is not None
        assert env.fused_rollout is not None  # the forest kernel with the peg task
    assert envs.make(ENVS[2], device=DEVICE).params.sensor_bias.abs().sum() > 0


@pytest.mark.parametrize("name", ENVS)
def test_rollouts_match_jax_general_rollout(jax_cl, name):
    """The env's fused_cl_rollout (plain on the CPU) and the port's general
    rollout against JAX rollout_closed_loop_linear, as tests/test_pallas_cl.py
    holds the TPU kernel."""
    jenv = jenvs.make(name)
    w, noise, dq = _policy_inputs(jenv.d_obs, N, H, seed=7)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    js = js._replace(qpos=js.qpos + jnp.asarray(dq))
    want = jax_cl[name](jenv.params, js, jnp.asarray(w), jnp.asarray(noise))
    env = envs.make(name, device=DEVICE)
    to_port = (convert.peg_state_from_reference if name.startswith("sawyer_peg")
               else convert.reacher_state_from_reference)
    state = to_port(js, device=DEVICE)
    tw, tnoise = torch.as_tensor(w), torch.as_tensor(noise)
    got = env.fused_cl_rollout(env.params, state, tw, tnoise)
    general = rollout_closed_loop_linear(env, env.params, state, tw, tnoise)
    for traj in (got, (general.observations, general.actions, general.costs)):
        for x, ref, atol in zip(traj, (want.observations, want.actions, want.costs),
                                (2e-5, 2e-5, 2e-4)):
            np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=0, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("name", ENVS[1:])
def test_peg_obs_rollout_matches_general_rollout(name):
    """Peg's fused_obs_rollout is the obs kernel with the peg task."""
    env = envs.make(name, device=DEVICE)
    rs = np.random.default_rng(11)
    mean = torch.as_tensor(np.asarray(rs.normal(size=(4, 7)) * 0.2, np.float32))
    noise = torch.as_tensor(np.asarray(rs.normal(size=(8, 4, 7)) * 0.3, np.float32))
    state = _state(env, np.asarray(rs.uniform(-0.2, 0.2, 7), np.float32))
    obs, costs = env.fused_obs_rollout(env.params, state, mean, noise)
    traj = rollout_open_loop(env, env.params, state, mean, noise)
    np.testing.assert_allclose(obs.numpy(), traj.observations.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(costs.numpy(), traj.costs.numpy(), rtol=0, atol=ATOL)


def test_the_loop_actually_closes():
    """With a nonzero W each particle's own observation feeds back: at
    t = 0 the actions differ only by the noise, by the last step by more
    (tests/test_pallas_cl.py)."""
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    w, noise, dq = _policy_inputs(env.d_obs, 8, 4, seed=1)
    _, acts, _ = env.fused_cl_rollout(env.params, _state(env, dq), torch.as_tensor(w),
                                      torch.as_tensor(noise))
    a = acts.numpy()
    np.testing.assert_allclose(a[:, 0] - a[:1, 0], noise[:, 0] - noise[:1, 0], rtol=0,
                               atol=1e-5)
    assert np.abs((a[:, -1] - a[:1, -1]) - (noise[:, -1] - noise[:1, -1])).max() > 1e-4


def _host_library(header, tmp_path):
    """The team code (csrc/chain_team.cuh, each phase's lanes in turn) in
    its closed-loop and obs modes, built with g++ for the task of
    `header`."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host copy of the kernel source"
    (tmp_path / "chain_model.h").write_text(header)
    (tmp_path / "host.cpp").write_text(
        '#include "chain_team.cuh"\n'
        'using namespace chain_rollout;\n'
        'extern "C" void host_cl(const float* q0, const float* qd0, const float* extras,\n'
        '    const float* w, const float* noise, float* costs, float* obs, float* acts,\n'
        '    int n, int horizon) {\n'
        '  static chain_team::Particle s;   // one team, its lanes in turn\n'
        '  for (int b = 0; b < n; ++b)\n'
        '    chain_team::rollout_team<CL, BuildTask>(s, chain_team::Team{}, q0, qd0, extras,\n'
        '                                            w, noise, costs, obs, acts, b, horizon);\n'
        '}\n'
        'extern "C" void host_obs(const float* q0, const float* qd0, const float* extras,\n'
        '    const float* mean, const float* noise, float* costs, float* obs,\n'
        '    int n, int horizon) {\n'
        '  static chain_team::Particle s;\n'
        '  for (int b = 0; b < n; ++b)\n'
        '    chain_team::rollout_team<OBS, BuildTask>(s, chain_team::Team{}, q0, qd0, extras,\n'
        '                                             mean, noise, costs, obs, nullptr, b,\n'
        '                                             horizon);\n'
        '}\n')
    lib_path = tmp_path / "libclhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(tmp_path), "-I", str(CSRC), "-o", str(lib_path),
                    str(tmp_path / "host.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def _extras(env):
    if env.name.startswith("sawyer_peg"):
        from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
        return peg_extras(env.params)
    return torch.tensor([0.2, -0.1, 0.15])


@pytest.mark.parametrize("name", ["reacher_7dof-v0", "sawyer_peg_insertion-v1"])
def test_kernel_source_compiled_for_the_host_matches_plain(name, tmp_path):
    env = envs.make(name, device=DEVICE)
    task = "peg" if name.startswith("sawyer_peg") else "reacher"
    roll = build_chain_cl_rollout(env.params.model, n_substeps=2, task=task)
    lib = _host_library(roll.header, tmp_path)
    n, h = 37, 6
    w, noise, dq = _policy_inputs(env.d_obs, n, h, seed=3)
    rs = np.random.default_rng(4)
    q0 = np.asarray(rs.normal(size=7) * 0.1, np.float32)
    qd0 = np.asarray(rs.normal(size=7) * 0.1, np.float32)
    mean = np.asarray(rs.normal(size=(h, 7)) * 0.3, np.float32)
    extras = _extras(env).numpy()
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)
    costs, obs = np.empty((n, h), np.float32), np.empty((n, h, roll.d_obs), np.float32)
    acts = np.empty((n, h, 7), np.float32)
    lib.host_cl(ptr(q0), ptr(qd0), ptr(extras), ptr(w), ptr(noise), ptr(costs), ptr(obs),
                ptr(acts), ctypes.c_int(n), ctypes.c_int(h))
    args = [torch.as_tensor(a) for a in (q0, qd0, extras, w, noise)]
    for got, want in zip((obs, acts, costs), roll(*args)):
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL, err_msg=name)
    costs_o, obs_o = np.empty((n, h), np.float32), np.empty((n, h, roll.d_obs), np.float32)
    lib.host_obs(ptr(q0), ptr(qd0), ptr(extras), ptr(mean), ptr(noise), ptr(costs_o),
                 ptr(obs_o), ctypes.c_int(n), ctypes.c_int(h))
    want_obs, want_costs = ChainObsRollout(env.params.model, 2, task=task).plain(
        *args[:3], torch.as_tensor(mean), args[4])
    np.testing.assert_allclose(obs_o, want_obs.numpy(), rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(costs_o, want_costs.numpy(), rtol=0, atol=ATOL, err_msg=name)


def test_headers_bake_the_task():
    reacher = envs.make("reacher_7dof-v0", device=DEVICE).params.model
    peg = envs.make("sawyer_peg_insertion-v0", device=DEVICE).params.model
    h_r = build_chain_cl_rollout(reacher, 2).header
    h_p = build_chain_cl_rollout(peg, 2, task="peg").header
    assert "constexpr int TASK = 0;" in h_r and "constexpr int TASK = 1;" in h_p
    assert "1.199999973e-01f" in h_p and "1.199999973e-01f" not in h_r    # peg's site
    assert build_chain_cl_rollout(peg, 2, task="peg").d_obs == 19


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    env = envs.make("sawyer_peg_insertion-v0", device=DEVICE)
    roll = build_chain_cl_rollout(env.params.model, 2, task="peg")
    w, noise, _ = _policy_inputs(env.d_obs, 5, 3, seed=4)
    args = [torch.zeros(7), torch.zeros(7), _extras(env), torch.as_tensor(w),
            torch.as_tensor(noise)]
    before = (ChainClRollout.launches, ChainObsRollout.launches, ChainRollout.launches)
    got = roll(*args)
    want = rollout_cl_plain(env.params.model, 2, -1.0, 1.0, *args, task="peg")
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (ChainClRollout.launches, ChainObsRollout.launches,
            ChainRollout.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "weights_rows", "weights_cols", "extras",
                                 "nv", "not_tensor", "task"])
def test_wrapper_rejects_bad_inputs(bad):
    model = envs.make("sawyer_peg_insertion-v0", device=DEVICE).params.model
    if bad == "task":
        with pytest.raises(ValueError):
            build_chain_cl_rollout(model, 2, task="door")
        return
    roll = build_chain_cl_rollout(model, 2, task="peg")
    w, noise, _ = _policy_inputs(roll.d_obs, 5, 3, seed=5)
    q0, qd0, extras = torch.zeros(7), torch.zeros(7), torch.zeros(10)
    w, noise = torch.as_tensor(w), torch.as_tensor(noise)
    if bad == "dtype":
        w = w.double()
    elif bad == "weights_rows":
        w = w[:-1]                  # the reacher's d_obs + 1 would be 21
    elif bad == "weights_cols":
        w = w[:, :6]
    elif bad == "extras":
        extras = extras[:3]         # the reacher's target
    elif bad == "nv":
        noise = noise[..., :6]
    else:
        w = w.numpy()
    with pytest.raises((TypeError, ValueError)):
        roll(q0, qd0, extras, w, noise)


def test_op_counts_and_bounds():
    """The closed-loop count adds the policy product, 2 d_obs operations
    per action per step, to the obs rollout's; row 4 of the bounds table
    and its peg instance come from the same counts."""
    reacher = envs.make("reacher_7dof-v0", device=DEVICE).params.model
    peg = envs.make("sawyer_peg_insertion-v0", device=DEVICE).params.model
    for model, task in ((reacher, REACHER), (peg, PEG)):
        d_obs = task.d_obs(7)
        extra = rollout_flops(model, 2, 5, 3, "cl", task) - rollout_flops(model, 2, 5, 3, "obs",
                                                                          task)
        assert extra == 5 * 3 * 7 * 2 * d_obs
        assert rollout_bytes(7, 5, 3, "cl", task) == 4 * (
            14 + task.n_extras + (d_obs + 1) * 7 + 5 * 3 * 7 + 5 * 3 * (1 + d_obs + 7))
    assert rollout_flops(peg, 2, 1, 1, "obs", PEG) - rollout_flops(peg, 2, 1, 1, "costs", PEG) \
        == PEG.obs_ops
    row4 = bounds.kernel_table(reacher, 4096, 32)[3]
    assert row4["number"] == 4 and row4["bound_by"] == "operations"
    assert row4["operations"] == rollout_flops(reacher, 2, 4096, 32, "cl", REACHER)
    assert row4["bytes"] == rollout_bytes(7, 4096, 32, "cl", REACHER)
    inst = bounds.peg_instance(peg)
    assert (inst["n"], inst["h"]) == (64, 32)
    assert inst["operations"] == rollout_flops(peg, 2, 64, 32, "cl", PEG)


def test_peg_state_converters():
    jenv = jenvs.make("sawyer_peg_insertion-v1")
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    params = convert.peg_params_from_reference(jenv.params, device=DEVICE)
    state = convert.peg_state_from_reference(js, device=DEVICE)
    env = envs.make("sawyer_peg_insertion-v1", device=DEVICE)
    for f in ("hole_entry", "hole_axis", "hole_depth", "sensor_bias"):
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(jenv.params, f)))
        torch.testing.assert_close(getattr(params, f), getattr(env.params, f), rtol=0, atol=0)
    torch.testing.assert_close(params.model.site_pos, env.params.model.site_pos, rtol=0, atol=0)
    assert state.timestep == 0 and state.qpos.shape == (7,)
    np.testing.assert_allclose(env.observe(params, state).numpy(),
                               np.asarray(jenv.observe(jenv.params, js)), rtol=0, atol=1e-6)


def _injected(cls, noise):
    """A Reinforce of `cls` whose sample_noise returns `noise`."""
    @dataclasses.dataclass(frozen=True)
    class Injected(cls):
        injected: Any = None

        def sample_noise(self, state):
            return self.injected

    return lambda **cfg: Injected(**cfg, injected=noise)


@pytest.mark.parametrize("name", ["reacher_7dof-v0", "sawyer_peg_insertion-v0"])
def test_solve_matches_jax_on_injected_noise(jax_cl, name):
    """make_solver("reinforce") + make_solve_fn against JAX's solve on the
    same noise: 2 iterations at the peg config's lr and delta_kl. JAX's
    solve runs its own general rollout (the compiled one above, in the
    env's fused slot). The mean-return baseline: peg's depth is minus the
    tip's z offset (the hole axis is -z), so a value function's gram is
    singular up to delta_reg and its f32 fit too ill-conditioned for this
    tolerance; the fits are held to JAX's in
    tests/test_torch_value_functions.py and tests/test_torch_reinforce.py."""
    jenv, env = jenvs.make(name), envs.make(name, device=DEVICE)
    _, noise, dq = _policy_inputs(env.d_obs, N, H, seed=5)
    cfg = dict(d_obs=env.d_obs, d_action=7, horizon=H, num_particles=N, lr=1.0, n_iters=2,
               gamma=1.0, baseline_type=None, delta_kl=15.0, filter_coeffs=(0.25, 0.8, 0.0))
    rollout = jax_cl[name]

    def fused_cl(p, s, w, nz):
        traj = rollout(p, s, w, nz)
        return traj.observations, traj.actions, traj.costs

    jsolver = _injected(jsolvers.Reinforce, jnp.asarray(noise))(**cfg)
    js = jenv.init(jenv.params, jax.random.PRNGKey(0))
    js = js._replace(qpos=js.qpos + jnp.asarray(dq))
    j0 = jsolver.init_state(jax.random.PRNGKey(0))
    ja, _, js1 = jsolvers.make_solve_fn(jsolver, dataclasses.replace(jenv, fused_cl_rollout=fused_cl),
                                        fused=True)(jenv.params, js, j0)
    solvers.REGISTRY["reinforce_injected"] = _injected(solvers.Reinforce,
                                                       torch.as_tensor(noise))
    try:
        solver = solvers.make_solver("reinforce_injected", **cfg, device=DEVICE)
    finally:
        del solvers.REGISTRY["reinforce_injected"]
    assert isinstance(solver, solvers.Reinforce)
    to_port = (convert.peg_state_from_reference if name.startswith("sawyer_peg")
               else convert.reacher_state_from_reference)
    solve = solvers.make_solve_fn(solver, env, calc_val=True, hotstart=True)
    a, v, s1 = solve(env.params, to_port(js, device=DEVICE),
                     convert.reinforce_state_from_reference(j0, 3, DEVICE))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=5e-5)
    np.testing.assert_allclose(s1.mean_weights.numpy(), np.asarray(js1.mean_weights), rtol=0,
                               atol=5e-5)
    assert not np.allclose(s1.mean_weights.numpy(), 0.0)
    assert float(v) == 0.0 and s1.step == 1 and s1.seed == 3
