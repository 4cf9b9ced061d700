"""The locomotion slice of the port (Swimmer-v0, HalfCheetah-v0) against the
JAX package: the models, the engine step with external forces, the env
steps, and kernel #5's plain version (the envs' fused_rollout on the CPU)
against the JAX fused rollout run as tests/test_pallas_loco.py runs it;
the kernel source's external-force instance compiled as host C++ for both
tasks; the wrapper's checks and the work counts. The kernel itself runs
only on a CUDA card (tests/test_torch_cuda.py). Each JAX reference is
computed once per module.

Tolerances:
- model fields (after the cheetah's mass rescale): atol 1e-6;
- engine step and env step (q, qd, obs, reward): swimmer atol 1e-4;
  cheetah 1e-3 of max(1, |value|) (stiff contact: kp 6000 over 25
  substeps amplifies f32 reordering between the two AD systems);
- fused rollout against the JAX kernel (both through analytic point
  Jacobians): swimmer atol 5e-5, cheetah 1e-5 of max(1, |cost|), far
  inside the JAX package's own 2e-3 / 5e-3 against its general rollout;
- the host build of the kernel source against the plain version: atol
  5e-5 (cheetah: of max(1, |cost|)), the chain kernels' tolerance.
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
from mjmpc_tpu.engine import chain as jchain
from mjmpc_tpu.envs import half_cheetah as jcheetah
from mjmpc_tpu.envs import swimmer as jswimmer
from mjmpc_tpu_torch import bounds, convert, envs
from mjmpc_tpu_torch.engine import chain
from mjmpc_tpu_torch.envs import half_cheetah, swimmer
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops.chain_rollout import (ChainExtRollout, ChainRollout,
                                               ext_rollout_bytes, ext_rollout_flops,
                                               rollout_ext_plain)

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
NAMES = ("Swimmer-v0", "HalfCheetah-v0")
# name: (port module, JAX module, converter, dA, fused-rollout (N, H, noise
# scale, seed), tolerance, scaled by max(1, |value|))
SPEC = {
    "Swimmer-v0": (swimmer, jswimmer, convert.swimmer_params_from_reference, 4,
                   (16, 6, 0.5, 0), 1e-4, False),
    "HalfCheetah-v0": (half_cheetah, jcheetah, convert.cheetah_params_from_reference, 6,
                       (8, 3, 0.3, 1), 1e-3, True),
}
ROLLOUT_TOL = {"Swimmer-v0": 5e-5, "HalfCheetah-v0": 1e-5}


def _close(got, want, name, tol=None, err_msg=""):
    """assert |got - want| <= tol, scaled by max(1, |want|) for the cheetah."""
    _, _, _, _, _, step_tol, scaled = SPEC[name]
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(1.0, np.abs(want)) if scaled else 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=step_tol if tol is None else tol, err_msg=err_msg)


def _jax_state(name, jenv, seed):
    """The env's initial state; the cheetah lowered by 0.15 so that its feet
    start in ground contact."""
    js = jenv.init(jenv.params, jax.random.PRNGKey(seed))
    if name == "HalfCheetah-v0":
        js = js._replace(qpos=js.qpos.at[1].add(-0.15))
    return js


@pytest.fixture(scope="module")
def jax_refs():
    """Per env: the JAX state, one engine step and one env step from it under
    an action, and the JAX fused rollout (interpret mode) with its inputs."""
    refs = {}
    for name in NAMES:
        _, jmod, _, da, (n, h, scale, seed), _, _ = SPEC[name]
        jenv = jenvs.make(name)
        js = _jax_state(name, jenv, seed)
        action = np.linspace(-1.2, 1.2, da).astype(np.float32)   # clipped inside
        full = jnp.concatenate([jnp.zeros(3), jnp.clip(jnp.asarray(action), -1.0, 1.0)])
        eng = jax.jit(lambda q, qd, u, jenv=jenv, jmod=jmod: jchain.step(
            jenv.params.model, q, qd, u, n_substeps=jmod._FRAME_SKIP,
            ext_force_fn=jmod._ext_forces(jenv.params)))(js.qpos, js.qvel, full)
        step = jax.jit(jenv.step)(jenv.params, js, jnp.asarray(action))
        rs = np.random.default_rng(seed)
        mean = np.asarray(rs.normal(size=(h, da)) * 0.3, np.float32)
        noise = np.asarray(rs.normal(size=(n, h, da)) * scale, np.float32)
        costs = jax.jit(jenv.fused_rollout)(jenv.params, js, jnp.asarray(mean),
                                           jnp.asarray(noise))
        refs[name] = dict(jenv=jenv, state=js, action=action, engine=eng, step=step,
                          mean=mean, noise=noise, costs=np.asarray(costs))
    return refs


@pytest.mark.parametrize("name", NAMES)
def test_model_matches_jax(name):
    """The ChainModel (after the cheetah's settotalmass rescale) and the
    env's params against the JAX package's, and the converter's params
    against the port's own."""
    mod, jmod, to_port, *_ = SPEC[name]
    jparams = jenvs.make(name).params
    env = envs.make(name, device=DEVICE)
    model, jmodel = env.params.model, jparams.model
    for f in ("joint_axis", "body_pos", "mass", "com", "inertia", "armature", "damping",
              "frictionloss", "stiffness", "gear", "qpos_low", "qpos_high", "gravity",
              "site_pos"):
        np.testing.assert_allclose(getattr(model, f).numpy(), np.asarray(getattr(jmodel, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert model.parent == tuple(int(p) for p in jmodel.parent)
    assert model.joint_types == tuple(jmodel.joint_types) and model.dt == jmodel.dt
    if name == "HalfCheetah-v0":
        assert model.parent[6] == 2 and float(model.mass.sum()) == pytest.approx(14.0, rel=1e-6)
    converted = to_port(jparams, device=DEVICE)
    for f in ("drag_perp", "drag_par", "vel_limit", "kp", "kd", "mu"):
        if hasattr(env.params, f):
            np.testing.assert_array_equal(getattr(converted, f).numpy(),
                                          getattr(env.params, f).numpy(), err_msg=f)


@pytest.mark.parametrize("name", NAMES)
def test_engine_step_with_external_forces_matches_jax(jax_refs, name):
    """engine.chain.step with the env's ext_force_fn (point_state and
    point_force_to_generalized through torch.func) against JAX's."""
    mod, _, to_port, *_ = SPEC[name]
    ref = jax_refs[name]
    params = to_port(ref["jenv"].params, device=DEVICE)
    state = convert.loco_state_from_reference(ref["state"], device=DEVICE)
    u = swimmer.pad_base(torch.clamp(torch.as_tensor(ref["action"]), -1.0, 1.0))
    q, qd = chain.step(params.model, state.qpos, state.qvel, u, n_substeps=mod._FRAME_SKIP,
                       ext_force_fn=mod._ext_forces(params))
    _close(q.numpy(), ref["engine"][0], name, err_msg="q")
    _close(qd.numpy(), ref["engine"][1], name, err_msg="qd")


def test_point_kinematics_match_jax():
    """point_state and point_force_to_generalized, one point and a batch of
    K points, against the JAX engine's on the cheetah's branched tree."""
    jmodel = jenvs.make("HalfCheetah-v0").params.model
    model = convert.chain_model_from_reference(jmodel, device=DEVICE)
    rs = np.random.default_rng(2)
    q = np.asarray(rs.normal(size=9) * 0.3, np.float32)
    qd = np.asarray(rs.normal(size=9), np.float32)
    f = np.asarray(rs.normal(size=(2, 3)), np.float32)
    pts = np.asarray([[0.1, 0.0, -0.2], [0.0, 0.0, 0.05]], np.float32)
    tq, tqd, tpts, tf = (torch.as_tensor(a) for a in (q, qd, pts, f))
    pos, vel = chain.point_state(model, tq, tqd, (5, 8), tpts)
    tau = chain.point_force_to_generalized(model, tq, (5, 8), tpts, tf)
    want_tau = 0.0
    for k, body in enumerate((5, 8)):
        jpos, jvel = jchain.point_state(jmodel, jnp.asarray(q), jnp.asarray(qd), body,
                                        jnp.asarray(pts[k]))
        np.testing.assert_allclose(pos[k].numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
        np.testing.assert_allclose(vel[k].numpy(), np.asarray(jvel), rtol=0, atol=1e-5)
        one_pos, one_vel = chain.point_state(model, tq, tqd, body, tpts[k])
        torch.testing.assert_close(one_pos, pos[k], rtol=0, atol=0)
        want_tau = want_tau + np.asarray(jchain.point_force_to_generalized(
            jmodel, jnp.asarray(q), body, jnp.asarray(pts[k]), jnp.asarray(f[k])))
    np.testing.assert_allclose(tau.numpy(), want_tau, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_env_step_matches_jax(jax_refs, name):
    ref = jax_refs[name]
    env = envs.make(name, device=DEVICE)
    state = convert.loco_state_from_reference(ref["state"], device=DEVICE)
    jn, jobs, jrew, _ = ref["step"]
    ns, obs, rew, done = env.step(env.params, state, torch.as_tensor(ref["action"]))
    _close(obs.numpy(), jobs, name, err_msg="obs")
    _close(float(rew), float(jrew), name, err_msg="reward")
    _close(ns.qpos.numpy(), jn.qpos, name, err_msg="qpos")
    _close(ns.qvel.numpy(), jn.qvel, name, err_msg="qvel")
    np.testing.assert_allclose(env.observe(env.params, state).numpy(),
                               np.asarray(ref["jenv"].observe(ref["jenv"].params, ref["state"])),
                               rtol=0, atol=1e-6)
    assert obs.shape == (env.d_obs,) and not bool(done)


@pytest.mark.parametrize("name", NAMES)
def test_fused_rollout_matches_jax_kernel(jax_refs, name):
    """The env's fused_rollout (kernel #5's plain version on the CPU)
    against the JAX package's fused rollout (its Pallas kernel in interpret
    mode) on the same inputs."""
    ref = jax_refs[name]
    env = envs.make(name, device=DEVICE)
    state = convert.loco_state_from_reference(ref["state"], device=DEVICE)
    before = ChainExtRollout.launches
    got = env.fused_rollout(env.params, state, torch.as_tensor(ref["mean"]),
                            torch.as_tensor(ref["noise"]))
    assert ChainExtRollout.launches == before       # the plain version counts nothing
    assert got.shape == ref["costs"].shape
    _close(got.numpy(), ref["costs"], name, tol=ROLLOUT_TOL[name])


def _host_library(header, tmp_path):
    """The external-force team code (csrc/chain_team.cuh, each phase's lanes
    in turn) for the task of `header`, built with g++."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host copy of the kernel source"
    (tmp_path / "chain_model.h").write_text(header)
    (tmp_path / "host.cpp").write_text(
        '#include "chain_team.cuh"\n'
        'using namespace chain_rollout;\n'
        'extern "C" void host_ext(const float* q0, const float* qd0, const float* mean,\n'
        '    const float* noise, float* costs, int n, int horizon) {\n'
        '  static chain_team::Particle s;   // one team, its lanes in turn\n'
        '  for (int b = 0; b < n; ++b)\n'
        '    chain_team::rollout_team<EXT, BuildTask>(s, chain_team::Team{}, q0, qd0, nullptr,\n'
        '                                             mean, noise, costs, nullptr, nullptr, b,\n'
        '                                             horizon);\n'
        '}\n')
    lib_path = tmp_path / "libexthost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(tmp_path), "-I", str(CSRC), "-o", str(lib_path),
                    str(tmp_path / "host.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def _kernel_inputs(nv, n, h, seed):
    """q0, qd0 * 0.1, mean * 0.3, noise * 0.5, the base dofs' columns zero."""
    rs = np.random.default_rng(seed)
    q0, qd0 = (np.asarray(rs.normal(size=nv) * 0.1, np.float32) for _ in range(2))
    mean = np.asarray(rs.normal(size=(h, nv)) * 0.3, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, nv)) * 0.5, np.float32)
    mean[:, :3], noise[..., :3] = 0.0, 0.0
    return q0, qd0, mean, noise


@pytest.mark.parametrize("name", NAMES)
def test_kernel_source_compiled_for_the_host_matches_plain(name, tmp_path):
    env = envs.make(name, device=DEVICE)
    roll = SPEC[name][0].build_rollout(env.params)
    lib = _host_library(roll.header, tmp_path)
    n, h = 37, 5
    arrays = _kernel_inputs(env.params.model.nv, n, h, 3)
    if name == "HalfCheetah-v0":
        arrays[0][1] = -0.15      # start in ground contact
    costs = np.empty((n, h), np.float32)
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)
    lib.host_ext(*(ptr(a) for a in arrays), ptr(costs), ctypes.c_int(n), ctypes.c_int(h))
    want = roll(*(torch.as_tensor(a) for a in arrays))
    _close(costs, want.numpy(), name, tol=5e-5)


def test_headers_bake_the_loco_tasks():
    s_env, c_env = (envs.make(n, device=DEVICE) for n in NAMES)
    h_s = swimmer.build_rollout(s_env.params).header
    h_c = half_cheetah.build_rollout(c_env.params).header
    assert "#define CHAIN_EXT_TASK 2" in h_s and "constexpr int TASK = 2;" in h_s
    assert "#define CHAIN_EXT_TASK 3" in h_c and "constexpr int TASK = 3;" in h_c
    assert "constexpr bool HAS_VEL_LIMIT = true;" in h_s
    assert "constexpr bool HAS_VEL_LIMIT = false;" in h_c
    assert "constexpr int N_LINKS = 5;" in h_s and "constexpr int N_CONTACTS = 7;" in h_c
    assert "constexpr float KP = 6.000000000e+03f;" in h_c
    assert "constexpr float INV_DT = 5.000000000e+01f;" in h_s      # 1 / 0.02
    assert "constexpr int N_SUBSTEPS = 25;" in h_c


@pytest.mark.parametrize("bad", ["dtype", "mean", "nv", "not_tensor", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    env = envs.make("Swimmer-v0", device=DEVICE)
    roll = swimmer.build_rollout(env.params)
    q0, qd0, mean, noise = (torch.as_tensor(a) for a in _kernel_inputs(7, 4, 3, 1))
    if bad == "dtype":
        noise = noise.double()
    elif bad == "mean":
        mean = mean[:2]
    elif bad == "nv":
        noise = noise[..., :4]
    elif bad == "not_tensor":
        mean = mean.numpy()
    else:
        noise = noise.to("meta")
    with pytest.raises((TypeError, ValueError)):
        roll(q0, qd0, mean, noise)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    env = envs.make("HalfCheetah-v0", device=DEVICE)
    roll = half_cheetah.build_rollout(env.params)
    args = [torch.as_tensor(a) for a in _kernel_inputs(9, 5, 2, 4)]
    before = (ChainExtRollout.launches, ChainRollout.launches)
    got = roll(*args)
    want = rollout_ext_plain(roll.model, 25, roll.task, None, -1.0, 1.0, *args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (ChainExtRollout.launches, ChainRollout.launches) == before


def test_ext_work_counts_and_bounds():
    """Operations scale with N * H (the work does not depend on the data);
    the swimmer's velocity limit adds 2 operations per dof and step; the
    bound at the configs' sizes is by operations; bytes are q0, qd0, the
    mean and the noise in and the costs out."""
    for name in NAMES:
        env = envs.make(name, device=DEVICE)
        roll = SPEC[name][0].build_rollout(env.params)
        model, task = roll.model, roll.task
        per = ext_rollout_flops(model, roll.n_substeps, 1, 1, task, False)
        assert ext_rollout_flops(model, roll.n_substeps, 512, 16, task, False) == 512 * 16 * per
        assert ext_rollout_flops(model, roll.n_substeps, 1, 1, task, True) == per + 2 * model.nv
        n, h = bounds.LOCO_SIZES[name]
        inst = bounds.ext_instance(roll, n, h)
        assert inst["bound_by"] == "operations" and inst["task"] == task.name
        assert inst["bytes"] == ext_rollout_bytes(model.nv, n, h) == 4 * (
            2 * model.nv + h * model.nv + n * h * model.nv + n * h)
    row5 = bounds.kernel_table(envs.make("reacher_7dof-v0", device=DEVICE).params.model)[4]
    assert row5["number"] == 5 and row5["bound_by"] == "operations"
