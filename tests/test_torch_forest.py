"""Kernel #6 of the port, the forest rollout (ops/forest_rollout.py,
csrc/forest_rollout.cuh), against the JAX package: the contact primitives
against mjmpc_tpu/envs/contact.py; the plain version on pen-v0 and on the
sawyer peg against the JAX general rollout (engine.chain.step and the env
cost: the reference the JAX kernel itself is held to); the coupled 6x6
free-body branch on a small forest against the JAX engine's step; the
kernel source compiled as host C++ (each phase running its team's lanes
one after another) for the pen, peg and ground-spheres tasks and the
cheetah's tree on spheres against the plain version, and at two team
sizes against itself; a repeated act body taking its last action; the
generated header's work tables; the wrapper's
checks, forest_consts' refusals and the work counts. The host build also
runs the relocate and hammer tasks (envs/relocate.py, envs/hammer.py:
the joint-torque hook, the hammer's coupled free-body branch), where a
build with the actions zeroed, or with the hammer on the decoupled branch,
must fail. The kernel itself
runs only on a CUDA card
(tests/test_torch_cuda.py). Each JAX reference is computed once per
module; no test calls the JAX pen or peg fused rollout (an interpret-mode
Pallas compile of minutes).

Tolerances:
- contact primitives: atol 1e-6 and rtol 2e-6, a few f32 ulps (the same
  formulas; forces reach kp * overlap ~ 50, where an ulp is 4e-6);
- pen against the JAX general rollout: atol 1e-4, from a pinch in which
  every fingertip presses on the pen (envs/pen.py pinch_qpos), so that
  the costs follow the hand through contact: they spread over 3.6e-2 and
  move by 4.5e-3 when the actions are zeroed, while the two agree to
  2e-7 (the JAX kernel's own bar, 5e-3, is wide enough to pass a rollout
  that ignores the actions); peg: atol 5e-5, the chain kernels' bar;
- one pen control step (five forest substeps) from the pinch against the
  JAX env step and against the port's engine step: atol 1e-5 on q and
  1e-4 on qd, the synthetic forest's bars (the pen spins at 4.5 rad/s
  after the step; the copies agree to 6e-8 and 2e-5);
- the coupled branch's substeps against the JAX engine: atol 1e-5 on q,
  1e-4 on qd (velocities of order 1-5 after contact);
- the host build against the plain version: pen 1e-4, peg and ground
  spheres 5e-5, the chip's tolerances at (N=37, H=5); the same check
  fails for a build of the kernel whose actions are zeroed; two team
  sizes agree bit for bit (no sum is split between lanes).
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
from mjmpc_tpu.engine import chain as jrb
from mjmpc_tpu.envs import contact as jcontact
from mjmpc_tpu.rollout.engine import rollout_open_loop as jax_rollout
from mjmpc_tpu_torch import bounds, convert, envs
from mjmpc_tpu_torch.engine import chain as rb
from mjmpc_tpu_torch.envs import (contact, hammer, hand_door, panda_tasks, pen, relocate,
                                  sawyer_tasks)
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops import forest_rollout as fr
from mjmpc_tpu_torch.ops.chain_rollout import ChainRollout
from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
N, H = 16, 4                       # the JAX kernel test's size (test_pallas_forest.py)
KP, KD, MU = 800.0, 2.0, 0.8       # the synthetic forest's contact


def _pinch(qpos, rs):
    """The pen's pinch (every fingertip pressing on the resting pen), the
    hand's joints perturbed by U(-0.05, 0.05) for a generic pose."""
    q = pen.pinch_qpos(torch.as_tensor(np.array(qpos)))
    q[:24] += torch.as_tensor(rs.uniform(-0.05, 0.05, 24), dtype=torch.float32)
    return q.numpy()


def _pen_inputs(jenv, n, h, seed):
    """Mean * 0.2 and noise * 0.3 as tests/test_pallas_forest.py draws them,
    from the pinch."""
    rs = np.random.default_rng(seed)
    d = jenv.d_action
    mean = np.asarray(rs.normal(size=(h, d)) * 0.2, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, d)) * 0.3, np.float32)
    js = jenv.init(jenv.params, jax.random.PRNGKey(seed))
    js = js._replace(qpos=jnp.asarray(_pinch(js.qpos, rs)))
    return js, mean, noise


def _peg_inputs(n, h, seed):
    rs = np.random.default_rng(seed)
    mean = np.asarray(rs.normal(size=(h, 7)) * 0.3, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, 7)) * 0.5, np.float32)
    dq = np.asarray(rs.normal(size=7) * 0.1, np.float32)
    return mean, noise, dq


def _synthetic(module, **kw):
    """One two-hinge tree (a friction-loss joint included) and one free box
    with an offset com (the coupled 6x6 branch), under gravity."""
    bodies = [
        dict(pos=(0, 0, 0.3), axis=(1, 0, 0), range=(-2, 2), damping=0.05, armature=0.01,
             gear=0.5, geoms=[module.capsule_geom(0.02, (0, 0, 0, 0, 0.1, -0.1))]),
        dict(pos=(0, 0.1, -0.1), axis=(0, 1, 0), range=(-1, 1), damping=0.05, armature=0.01,
             gear=0.5, frictionloss=0.01, geoms=[module.sphere_geom(0.02, (0, 0.05, 0))]),
        dict(pos=(0.2, 0, 0.0), type="free", parent=-1, damping=0.01, armature=0.0, gear=0.0,
             geoms=[module.box_geom((0.03, 0.02, 0.015), (0.02, 0.01, 0.0)),
                    module.sphere_geom(0.02, (-0.03, 0.0, 0.0))]),
    ]
    return module.build_chain(bodies, dt=0.002, site_body=2, site_pos=(0.0, 0.0, 0.0),
                              gravity=(0, 0, -9.81), **kw)


SYN_POINTS = [(2, (-0.03, 0.0, -0.005)), (2, (0.04, 0.01, -0.01)), (1, (0.0, 0.05, 0.0))]
SYN_RADII = [0.02, 0.015, 0.02]
# spheres on the half cheetah's torso and feet (bodies 2, 5, 8)
CHEETAH_POINTS = [(2, (0.5, 0.0, 0.0)), (5, (0.0, 0.0, -0.1)), (8, (0.0, 0.0, -0.07))]
CHEETAH_RADII = [0.05, 0.046, 0.046]


def _synthetic_state(seed=0):
    rs = np.random.default_rng(seed)
    q0 = np.zeros(9, np.float32)
    q0[0:2] = (0.3, -0.2)
    q0[2:5] = (0.0, 0.0, 0.015)          # the box's spheres in contact with z = 0
    quat = rs.normal(size=4) * 0.1 + np.array([1, 0, 0, 0])
    q0[5:9] = quat / np.linalg.norm(quat)
    return q0, np.asarray(rs.normal(size=8) * 0.5, np.float32)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX general rollouts of pen-v0 (N=16, H=4) and of the peg, four
    JAX pen env steps from the pinch, and the JAX engine's steps of the
    synthetic forest with its sphere contact."""
    refs = {}
    jenv = jenvs.make("pen-v0")
    js, mean, noise = _pen_inputs(jenv, N, H, 0)
    traj = jax.jit(lambda s, mu, nz: jax_rollout(jenv, jenv.params, s, mu, nz))(
        js, jnp.asarray(mean), jnp.asarray(noise))
    refs["pen"] = dict(state=js, mean=mean, noise=noise, costs=np.asarray(traj.costs))
    actions = np.asarray(np.random.default_rng(4).uniform(-1, 1, (4, 24)), np.float32)
    nxt = jax.jit(jax.vmap(jenv.step, in_axes=(None, None, 0)))(jenv.params, js,
                                                               jnp.asarray(actions))[0]
    refs["pen_step"] = dict(state=js, actions=actions, qpos=np.asarray(nxt.qpos),
                            qvel=np.asarray(nxt.qvel))
    jpeg = jenvs.make("sawyer_peg_insertion-v0")
    mean, noise, dq = _peg_inputs(N, H, 1)
    js = jpeg.init(jpeg.params, jax.random.PRNGKey(0))
    js = js._replace(qpos=js.qpos + jnp.asarray(dq))
    traj = jax.jit(lambda s, mu, nz: jax_rollout(jpeg, jpeg.params, s, mu, nz))(
        js, jnp.asarray(mean), jnp.asarray(noise))
    refs["peg"] = dict(state=js, mean=mean, noise=noise, costs=np.asarray(traj.costs))
    jmodel = _synthetic(jrb)
    pts = jnp.asarray([p for _, p in SYN_POINTS], jnp.float32)

    def ext(model, q, qd):
        pos, vel, apply = jrb.points_frame(model, q, qd, tuple(b for b, _ in SYN_POINTS), pts)
        return apply(jnp.stack([jcontact.sphere_plane_force(pos[k], vel[k], SYN_RADII[k],
                                                            KP, KD, MU)
                                for k in range(len(SYN_POINTS))]))

    q0, qd0 = _synthetic_state()
    ctrl = np.array([0.4, -0.7] + [0.0] * 6, np.float32)
    refs["synthetic"] = dict(model=jmodel, q0=q0, qd0=qd0, ctrl=ctrl, step=jax.jit(
        lambda q, qd: jrb.step(jmodel, q, qd, jnp.asarray(ctrl), n_substeps=10,
                               ext_force_fn=ext))(jnp.asarray(q0), jnp.asarray(qd0)))
    return refs


def _contact_cases(seed=0, n=8):
    rs = np.random.default_rng(seed)
    v = lambda *shape: np.asarray(rs.normal(size=shape) * 0.05, np.float32)
    return dict(p=v(n, 3), vel=10 * v(n, 3), a=v(n, 3), b=v(n, 3), va=10 * v(n, 3),
                vb=10 * v(n, 3), c=v(n, 3), d=v(n, 3))


def test_contact_primitives_match_jax():
    """Every primitive of envs/contact.py, batched over 8 random cases
    (overlapping and apart), against the JAX module's on each case."""
    x = _contact_cases()
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    r, kp, kd, mu = 0.05, 800.0, 2.0, 1.2
    got = dict(
        closest=contact.closest_on_segment(t["p"], t["a"], t["b"]),
        along=contact.force_along(t["a"] / torch.linalg.vector_norm(t["a"], dim=-1,
                                                                     keepdim=True),
                                  t["p"][:, 0] + 0.02, t["vel"], kp, kd, mu),
        penalty=contact.penalty_force(t["p"], t["vel"], t["c"][:, 0] + 0.01, kp, kd, mu),
        sphere_segment=contact.sphere_segment_force(t["p"], t["vel"], r, t["a"], t["b"],
                                                    t["va"], t["vb"], 0.012, kp, kd, mu),
        sphere_plane=contact.sphere_plane_force(t["p"], t["vel"], r, kp, kd, mu),
        seg_seg=contact.segment_segment_closest(t["a"], t["b"], t["c"], t["d"]),
        capsule=contact.capsule_capsule_force(t["a"], t["b"], t["va"], t["vb"], r, t["c"][0],
                                              t["d"][0], 0.012, kp, kd, mu),
        sphere_sphere=contact.sphere_sphere_force(t["p"], t["vel"], r, t["a"], t["va"], 0.03,
                                                  kp, kd, mu),
    )
    for i in range(len(x["p"])):
        j = {k: jnp.asarray(v[i]) for k, v in x.items()}
        want = dict(
            closest=jcontact.closest_on_segment(j["p"], j["a"], j["b"]),
            along=jcontact.force_along(j["a"] / jnp.linalg.norm(j["a"]), j["p"][0] + 0.02,
                                       j["vel"], kp, kd, mu),
            penalty=jcontact.penalty_force(j["p"], j["vel"], j["c"][0] + 0.01, kp, kd, mu),
            sphere_segment=jcontact.sphere_segment_force(j["p"], j["vel"], r, j["a"], j["b"],
                                                         j["va"], j["vb"], 0.012, kp, kd, mu),
            sphere_plane=jcontact.sphere_plane_force(j["p"], j["vel"], r, kp, kd, mu),
            seg_seg=jcontact.segment_segment_closest(j["a"], j["b"], j["c"], j["d"]),
            capsule=jcontact.capsule_capsule_force(
                j["a"], j["b"], j["va"], j["vb"], r, jnp.asarray(x["c"][0]),
                jnp.asarray(x["d"][0]), 0.012, kp, kd, mu),
            sphere_sphere=jcontact.sphere_sphere_force(j["p"], j["vel"], r, j["a"], j["va"],
                                                       0.03, kp, kd, mu),
        )
        for name, w in want.items():
            g = got[name]
            g, w = (g, w) if isinstance(w, tuple) else ((g,), (w,))
            for gk, wk in zip(g, w):
                np.testing.assert_allclose(gk[i].numpy(), np.asarray(wk), rtol=2e-6,
                                           atol=1e-6, err_msg=f"{name} case {i}")
    # the cases exercise contact: some forces are nonzero, some zero
    norms = torch.linalg.vector_norm(got["sphere_segment"][0], dim=-1)
    assert bool((norms > 0).any()) and bool((norms == 0).any())


def _pen_rollout(ref, n=N, h=H):
    env = envs.make("pen-v0", device=DEVICE)
    state = convert.pen_state_from_reference(ref["state"], device=DEVICE)
    before = (ForestRollout.launches, ChainRollout.launches)
    costs = env.fused_rollout(env.params, state, torch.as_tensor(ref["mean"][:h]),
                              torch.as_tensor(ref["noise"][:n, :h]))
    assert (ForestRollout.launches, ChainRollout.launches) == before   # plain on the CPU
    return costs.numpy()


def test_pen_plain_matches_jax_general_rollout(jax_refs):
    ref = jax_refs["pen"]
    got = _pen_rollout(ref)
    assert got.shape == (N, H) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref["costs"], rtol=0, atol=1e-4)
    # the pinch carries the hand's motion to the cost: far above the tolerance
    assert float(np.ptp(ref["costs"])) > 1e-2


def test_pen_plain_ragged_size_matches_jax_general_rollout(jax_refs):
    """N=13, H=3: the first 13 particles' first 3 steps of the same inputs
    (each particle's costs depend only on its own noise and earlier steps)."""
    ref = jax_refs["pen"]
    got = _pen_rollout(ref, 13, 3)
    assert got.shape == (13, 3)
    np.testing.assert_allclose(got, ref["costs"][:13, :3], rtol=0, atol=1e-4)


def test_pen_forest_substeps_match_jax_and_engine_step(jax_refs):
    """One pen control step from the pinch, four actions: five substeps of
    the forest's plain version (the kernel's reference) against the JAX
    env step and against the port's own env step on the engine, on the
    whole state: the hand's FK, the ancestor-sparse Cholesky, the finger
    contact and its reaction onto the free pen."""
    ref = jax_refs["pen_step"]
    env = envs.make("pen-v0", device=DEVICE)
    state = convert.pen_state_from_reference(ref["state"], device=DEVICE)
    actions = torch.as_tensor(ref["actions"])
    c, task = fr.forest_consts(env.params.model), fr.pen_task()
    q, qd = state.qpos.expand(4, 31).clone(), state.qvel.expand(4, 30).clone()
    ub = {j: actions[:, j] for j in range(24)}
    extras = pen.pen_extras(env.params, state)
    for _ in range(5):
        q, qd = fr.forest_substep(c, task, q, qd, ub, extras)
    batch = dataclasses.replace(state, qpos=state.qpos.expand(4, 31),
                                qvel=state.qvel.expand(4, 30), desired=state.desired.expand(4, 3))
    eng = env.step(env.params, batch, actions)[0]
    for got, name in ((q, "forest q"), (eng.qpos, "engine q")):
        np.testing.assert_allclose(got.numpy(), ref["qpos"], rtol=0, atol=1e-5, err_msg=name)
    for got, name in ((qd, "forest qd"), (eng.qvel, "engine qd")):
        np.testing.assert_allclose(got.numpy(), ref["qvel"], rtol=0, atol=1e-4, err_msg=name)
    # the fingers moved the pen, and by how much depends on the actions
    pen_qd = ref["qvel"][:, 24:]
    assert np.abs(pen_qd).max() > 1.0 and np.ptp(pen_qd, axis=0).max() > 1e-2


def test_peg_plain_matches_jax_general_rollout(jax_refs):
    """The peg's fused_rollout (kernel #6 with the peg task, plain on the
    CPU) against the JAX general rollout."""
    ref = jax_refs["peg"]
    env = envs.make("sawyer_peg_insertion-v0", device=DEVICE)
    state = convert.peg_state_from_reference(ref["state"], device=DEVICE)
    got = env.fused_rollout(env.params, state, torch.as_tensor(ref["mean"]),
                            torch.as_tensor(ref["noise"]))
    np.testing.assert_allclose(got.numpy(), ref["costs"], rtol=0, atol=5e-5)


def test_coupled_free_body_branch_matches_jax_engine(jax_refs):
    """The forest substep with the offset-com box (the 6x6 branch) and its
    sphere contacts against the JAX engine's step with the same contact
    through points_frame: 10 substeps."""
    ref = jax_refs["synthetic"]
    model = convert.chain_model_from_reference(ref["model"], device=DEVICE)
    own = _synthetic(rb, device=DEVICE)
    torch.testing.assert_close(own.com, model.com, rtol=0, atol=0)
    c = fr.forest_consts(model)
    assert c["free"] == [2] and c["free_consts"][2]["coupled"] and c["trees"] == [[0, 1]]
    task = fr.ground_spheres_task(SYN_POINTS, SYN_RADII)
    q, qd = torch.as_tensor(ref["q0"])[None], torch.as_tensor(ref["qd0"])[None]
    ub = {0: torch.tensor([0.4]), 1: torch.tensor([-0.7])}
    extras = torch.tensor([KP, KD, MU, 0.0, 0.0, 0.0])
    for _ in range(10):
        q, qd = fr.forest_substep(c, task, q, qd, ub, extras)
    jq, jqd = (np.asarray(x) for x in ref["step"])
    np.testing.assert_allclose(q[0].numpy(), jq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(qd[0].numpy(), jqd, rtol=0, atol=1e-4)
    assert float(jq[4]) > 0.015           # the spheres' contact pushed the box up


# The line of csrc/forest_rollout.cuh that hands the clipped actions to the
# substeps, and the same line with the actions zeroed (a wrong kernel that
# the pen check must catch).
ACTION_LINE = "                    s.ub[body] =\n"
ACTIONS_ZEROED = "                    s.ub[body] = 0.0f *\n"


_HOST_LIBRARIES = {}     # (header, zero_actions) -> the loaded build, once per module


def _host_library(header, tmp_path, zero_actions=False):
    """csrc/forest_rollout.cuh for the task of `header`, built with g++;
    with zero_actions, a copy of it whose actions are zeroed."""
    key = (header, zero_actions)
    if key not in _HOST_LIBRARIES:
        _HOST_LIBRARIES[key] = _build_host_library(header, tmp_path, zero_actions)
    return _HOST_LIBRARIES[key]


def _build_host_library(header, tmp_path, zero_actions):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the host copy of the kernel source"
    (tmp_path / "forest_model.h").write_text(header)
    if zero_actions:
        src = (CSRC / "forest_rollout.cuh").read_text()
        assert src.count(ACTION_LINE) == 1
        (tmp_path / "forest_rollout.cuh").write_text(src.replace(ACTION_LINE, ACTIONS_ZEROED))
    (tmp_path / "host.cpp").write_text(
        '#include "forest_rollout.cuh"\n'
        'using namespace forest_rollout;\n'
        'extern "C" void host_forest(const float* q0, const float* qd0, const float* extras,\n'
        '    const float* mean, const float* noise, float* costs, int n, int horizon) {\n'
        '  static Particle s;   // one team, its lanes in turn in every phase\n'
        '  for (int b = 0; b < n; ++b)\n'
        '    rollout_team<BuildTask>(s, Team{0}, q0, qd0, extras, mean, noise, costs, b,\n'
        '                            horizon);\n'
        '}\n')
    lib_path = tmp_path / "libforesthost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(tmp_path), "-I", str(CSRC), "-o", str(lib_path),
                    str(tmp_path / "host.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def _kernel_case(name, n, h, seed):
    """(wrapper, inputs q0, qd0, extras, mean, noise as numpy, tolerance)."""
    rs = np.random.default_rng(seed)
    if name == "pen":
        env = envs.make("pen-v0", device=DEVICE)
        roll, st = pen.build_rollout(env.params.model), env.init(env.params, seed)
        args = [_pinch(st.qpos, rs), st.qvel.numpy(), pen.pen_extras(env.params, st).numpy()]
        tol, d = 1e-4, 24
    elif name == "peg":
        env = envs.make("sawyer_peg_insertion-v0", device=DEVICE)
        roll = sawyer_tasks.build_rollout(env.params.model)
        args = [np.asarray(rs.normal(size=7) * 0.1, np.float32),
                np.asarray(rs.normal(size=7) * 0.1, np.float32),
                sawyer_tasks.peg_extras(env.params).numpy()]
        tol, d = 5e-5, 7
    elif name in ("relocate", "hammer", "hammer_spin"):
        # the grasp of the lifted ball; the hammer held on the nail, or
        # spinning in the air; the hand's joints perturbed
        env = envs.make("relocate-v0" if name == "relocate" else "hammer-v0", device=DEVICE)
        st = env.init(env.params, seed)
        if name == "relocate":
            roll, extras = relocate.build_rollout(env.params.model), relocate.relocate_extras(
                env.params, st)
            q0, qd0 = relocate.grasp_qpos(st.qpos), st.qvel
        else:
            roll, extras = hammer.build_rollout(env.params.model), hammer.hammer_extras(env.params)
            q0, qd0 = ((hammer.held_qpos(st.qpos), st.qvel) if name == "hammer"
                       else hammer.spin_state(st.qpos, st.qvel))
        q0[3:27] += torch.as_tensor(rs.uniform(-0.03, 0.03, 24), dtype=torch.float32)
        args = [q0.numpy(), qd0.numpy(), extras.numpy()]
        tol, d = 1e-4, 27
    elif name in ("sawyer_door", "pusher"):
        # the grab spring live (the door open, the radius widened); the block
        # against the hand; the arm's joints perturbed
        env = envs.make("sawyer_door-v0" if name == "sawyer_door" else "sawyer_pusher-v0",
                        device=DEVICE)
        st = env.init(env.params, seed)
        q0 = st.qpos.clone()
        q0[:7] += torch.as_tensor(rs.uniform(-0.1, 0.1, 7), dtype=torch.float32)
        if name == "sawyer_door":
            params, q0 = sawyer_tasks.door_grab_state(env.params, q0)
            roll = sawyer_tasks.build_door_rollout(env.params.model)
            extras = sawyer_tasks.door_extras(params)
        else:
            q0 = sawyer_tasks.pusher_contact_qpos(env.params.model, q0)
            roll = sawyer_tasks.build_pusher_rollout(env.params.model)
            extras = sawyer_tasks.pusher_extras(env.params, st)
        args = [q0.numpy(), np.asarray(rs.normal(size=q0.shape[0]) * 0.1, np.float32),
                extras.numpy()]
        tol, d = 1e-4, 7
    elif name in TRAY_ENVS:
        # the glass past the tray's edge (the fall penalty live; fixed-v1's
        # clamp takes it back at once), the arm's joints perturbed
        env = envs.make(TRAY_ENVS[name], device=DEVICE)
        st = env.init(env.params, seed)
        q0 = panda_tasks.fallen_qpos(st.qpos)
        q0[:7] += torch.as_tensor(rs.uniform(-0.2, 0.2, 7), dtype=torch.float32)
        roll = panda_tasks.build_rollout(env.params.model)
        args = [q0.numpy(), st.qvel.numpy(), panda_tasks.tray_extras(env.params, st).numpy()]
        tol, d = 1e-4, 7
    elif name in ("door", "door_open"):
        # the hand hooking the handle, the latch near its threshold; or the
        # door past 0.2 rad with the latch released; the hand's joints
        # perturbed
        env = envs.make("door-v0", device=DEVICE)
        st = env.init(env.params, seed)
        latch, door = (0.5, 0.0) if name == "door" else (0.6, 0.3)
        q0 = hand_door.hook_qpos(env.params.model, st.qpos, latch, door)
        q0[3:27] += torch.as_tensor(rs.uniform(-0.03, 0.03, 24), dtype=torch.float32)
        roll = hand_door.build_rollout(env.params.model)
        args = [q0.numpy(), st.qvel.numpy(), hand_door.door_extras(env.params).numpy()]
        tol, d = 1e-4, 27
    elif name == "ground_spheres":
        model = _synthetic(rb, device=DEVICE)
        roll = fr.build_forest_rollout(model, 4, [0, 1], fr.ground_spheres_task(SYN_POINTS,
                                                                                 SYN_RADII))
        q0, qd0 = _synthetic_state(seed)
        args = [q0, qd0, np.array([KP, KD, MU, 0.2, 0.0, 0.05], np.float32)]
        tol, d = 5e-5, 2
    else:   # the cheetah's branched tree, two slides at its root, on spheres
        model = envs.make("HalfCheetah-v0", device=DEVICE).params.model
        roll = fr.build_forest_rollout(model, 4, list(range(3, 9)),
                                       fr.ground_spheres_task(CHEETAH_POINTS, CHEETAH_RADII))
        q0 = np.asarray(rs.normal(size=9) * 0.1, np.float32)
        q0[1] = -0.03                      # the torso low enough that the spheres touch
        args = [q0, np.asarray(rs.normal(size=9) * 0.3, np.float32),
                np.array([KP, KD, MU, 0.5, 0.0, 0.0], np.float32)]
        tol, d = 5e-5, 6
    args += [np.asarray(rs.normal(size=(h, d)) * 0.2, np.float32),
             np.asarray(rs.normal(size=(n, h, d)) * 0.3, np.float32)]
    return roll, args, tol


# the tray-glass variants' tasks, each on its own model
TRAY_ENVS = {"tray": "panda_tray_glass-v0", "tray_v1": "panda_tray_glass-v1",
             "tray_fixed_v1": "panda_tray_glass_fixed-v1"}
# the tasks added with the sawyer, panda and hand-door envs
NEW_TASKS = ["sawyer_door", "pusher", *TRAY_ENVS, "door", "door_open"]


def _host_costs(lib, args, n, h):
    costs = np.empty((n, h), np.float32)
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)
    lib.host_forest(*(ptr(a) for a in args), ptr(costs), ctypes.c_int(n), ctypes.c_int(h))
    return costs


@pytest.mark.parametrize("name", ["pen", "peg", "ground_spheres", "cheetah_spheres", "relocate",
                                  "hammer", "hammer_spin"])
def test_kernel_source_compiled_for_the_host_matches_plain(name, tmp_path):
    n, h = 37, 5
    roll, args, tol = _kernel_case(name, n, h, 3)
    costs = _host_costs(_host_library(roll.header, tmp_path), args, n, h)
    want = roll(*(torch.as_tensor(a) for a in args)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(costs, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", NEW_TASKS)
def test_new_task_host_build_matches_plain_and_fails_with_actions_zeroed(name, tmp_path):
    """Each task of the sawyer door, the pusher, the three tray-glass models
    and door-v0 (hooking the handle, and the door opened past 0.2 rad),
    compiled for the host, against its plain version at (37, 4) from a
    state where its force law, hook and gates act; a build whose actions
    are zeroed misses the plain version by more than 10x the tolerance."""
    n, h = 37, 4
    roll, args, tol = _kernel_case(name, n, h, 3)
    want = roll(*(torch.as_tensor(a) for a in args)).numpy()
    assert np.isfinite(want).all()
    for sub in ("build", "zeroed"):
        (tmp_path / sub).mkdir()
    costs = _host_costs(_host_library(roll.header, tmp_path / "build"), args, n, h)
    np.testing.assert_allclose(costs, want, rtol=0, atol=tol)
    zeroed = _host_costs(_host_library(roll.header, tmp_path / "zeroed", zero_actions=True), args,
                         n, h)
    assert np.abs(zeroed - want).max() > 10 * tol


@pytest.mark.parametrize("name,team", [("pen", 8), ("ground_spheres", 1)])
def test_host_build_is_the_same_for_every_team_size(name, team, tmp_path):
    """No sum is split between lanes, so the lanes' partition of the work
    does not change a bit of the costs: the default team against a
    narrower one."""
    n, h = 9, 3
    roll, args, _ = _kernel_case(name, n, h, 5)
    other = fr._model_header(roll.model, roll.n_substeps, roll.act_bodies, roll.task,
                             roll.ulow, roll.uhigh, team)
    assert team != roll.team and f"constexpr int TEAM = {team};" in other
    got = []
    for k, header in enumerate((roll.header, other)):
        (tmp_path / str(k)).mkdir()
        got.append(_host_costs(_host_library(header, tmp_path / str(k)), args, n, h))
    np.testing.assert_array_equal(got[0], got[1])


def test_a_repeated_act_body_takes_its_last_action(tmp_path):
    """As in the JAX package's build_forest_rollout, a body listed twice in
    act_bodies takes the later action: the plain version and the host
    build of the kernel with act bodies (0, 1, 0) give the costs of (1, 0)
    on the last two actions."""
    n, h = 9, 3
    model = _synthetic(rb, device=DEVICE)
    task = fr.ground_spheres_task(SYN_POINTS, SYN_RADII)
    roll = fr.build_forest_rollout(model, 4, [0, 1, 0], task)
    once = fr.build_forest_rollout(model, 4, [1, 0], task)
    # the first action's lane writes nothing: no two lanes write one body
    assert _header_tables(roll.header)["act_body"] == [-1, 1, 0]
    rs = np.random.default_rng(6)
    q0, qd0 = _synthetic_state(6)
    args = [q0, qd0, np.array([KP, KD, MU, 0.2, 0.0, 0.05], np.float32),
            np.asarray(rs.normal(size=(h, 3)) * 0.2, np.float32),
            np.asarray(rs.normal(size=(n, h, 3)) * 0.3, np.float32)]
    want = once(*(torch.as_tensor(a) for a in args[:3] + [args[3][:, 1:], args[4][..., 1:]]))
    np.testing.assert_array_equal(roll(*(torch.as_tensor(a) for a in args)).numpy(),
                                  want.numpy())
    costs = _host_costs(_host_library(roll.header, tmp_path), args, n, h)
    np.testing.assert_allclose(costs, want.numpy(), rtol=0, atol=5e-5)


def _header_tables(header):
    """{name: flat list} of the header's host tables."""
    import re
    out = {}
    for name, body in re.findall(r"constexpr (?:int|float) h_(\w+)(?:\[\d+\])+ = (.*);",
                                 header):
        out[name] = [float(x.rstrip("f")) for x in re.findall(r"[-+0-9.e]+f?", body)]
    return out


def _schedule_case(name):
    if name == "pen":
        return pen.build_rollout(envs.make("pen-v0", device=DEVICE).params.model)
    if name == "peg":
        return sawyer_tasks.build_rollout(
            envs.make("sawyer_peg_insertion-v0", device=DEVICE).params.model)
    if name == "ground_spheres":
        return _kernel_case("cheetah_spheres", 1, 1, 0)[0]
    if name in NEW_TASKS:
        return _kernel_case(name, 1, 1, 0)[0]
    return _kernel_case("ground_spheres", 1, 1, 0)[0]     # the synthetic coupled forest


@pytest.mark.parametrize("name", ["pen", "peg", "ground_spheres", "coupled", "pusher", "tray",
                                  "door"])
def test_header_schedule_covers_every_item_once(name):
    """The team's work tables as the header carries them: every body once
    in the levels, after its parent; every Cholesky row once; every packed
    pair's terms and every body's generalized force dealt to exactly one
    lane;
    every (body, ancestor) slot once at its offset; each lane's mass terms
    one run per pair over the pair's bodies, marked at its ends; each
    contact point in
    the gather of every body it moves, in increasing order; children in
    decreasing order; each body's sum list itself then its descendants,
    increasing."""
    roll = _schedule_case(name)
    c, team = roll.consts, roll.team
    tables = _header_tables(roll.header)
    t = {k: [int(x) for x in v] for k, v in tables.items()}
    n = c["n"]
    paths = [fr._ancestors(c, i) + [i] for i in range(n)]
    scalar = [i for i in range(n) if c["jtype"][i] != fr.FREE]
    desc_of = lambda b: [k for k in range(n) if b in paths[k]]
    assert team == {"pen": 32, "peg": 8}.get(name, team) and 32 % team == 0
    assert f"constexpr int TEAM = {team};" in roll.header

    def lists(start, items, count):
        assert len(t[start]) == count + 1 and t[start][0] == 0
        return [t[items][t[start][k]:t[start][k + 1]] for k in range(count)]

    levels = lists("level_start", "level_body", len(t["level_start"]) - 1)
    assert sorted(sum(levels, [])) == list(range(n))
    level_of = {i: lv for lv, bodies in enumerate(levels) for i in bodies}
    for i in range(n):
        assert level_of[i] == (len(paths[i]) - 1 if i in scalar else 0)
        if c["parent"][i] >= 0:
            assert level_of[c["parent"][i]] < level_of[i]
    rows = [i for lv in levels for i in lv if i in scalar]       # the Cholesky rows
    assert sorted(rows) == scalar
    # each lane's mass terms: one run per packed pair (b, ka) over the
    # bodies i of desc[b], each term naming its slots, body a, m_i, the
    # entry's place in M, and its edge bits (first, last, diagonal, hinges)
    hinge = [c["jtype"][i] == fr.HINGE for i in range(n)]
    maxd = max(len(x) for x in paths)
    pairs = []
    for lane in range(team):
        e = t["term_start"][lane]
        while e < t["term_start"][lane + 1]:
            b, ka = divmod(t["term_m"][e], maxd)
            run = desc_of(b)
            for k, i in enumerate(run):
                assert t["term_ja"][e + k] == t["slot_off"][i] + ka
                assert t["term_jb"][e + k] == t["slot_off"][i] + len(paths[b]) - 1
                assert t["term_a"][e + k] == paths[b][ka] and t["term_m"][e + k] == b * maxd + ka
                assert tables["term_mass"][e + k] == pytest.approx(float(c["mass"][i]), rel=1e-6)
                edge = ((k == 0) + 2 * (k == len(run) - 1) + 4 * (ka == len(paths[b]) - 1)
                        + 8 * (hinge[paths[b][ka]] and hinge[b]))
                assert t["term_edge"][e + k] == edge
            pairs.append((b, ka))
            e += len(run)
    assert sorted(pairs) == [(b, ka) for b in scalar for ka in range(len(paths[b]))]
    assert len(set(pairs)) == len(pairs) == sum(len(paths[b]) for b in scalar)
    assert sorted(sum(lists("tau_start", "tau_body", team), [])) == list(range(n))
    slots = list(zip(t["slot_body"], t["slot_k"]))
    assert slots == [(i, k) for i in scalar for k in range(len(paths[i]))]
    for i in scalar:
        assert slots[t["slot_off"][i]] == (i, 0)
    points = lists("point_start", "dof_point", n)
    for k, (b, _) in enumerate(roll.task.points):
        assert [i for i in range(n) if k in points[i]] == sorted(paths[b])
    for i in range(n):
        assert points[i] == sorted(points[i])
    assert sum(len(x) for x in points) == sum(len(paths[b]) for b, _ in roll.task.points)
    children = lists("child_start", "child", n)
    desc = lists("desc_start", "desc", n)
    for i in range(n):
        assert children[i] == [k for k in range(n - 1, -1, -1) if c["parent"][k] == i]
        assert desc[i] == ([k for k in range(n) if i in paths[k]] if i in scalar else [])
        lo = t["desc_start"][i]
        assert t["desc_m"][lo:lo + len(desc[i])] == [k * maxd + len(paths[i]) - 1
                                                     for k in desc[i]]


def test_pen_check_fails_for_a_kernel_whose_actions_are_zeroed(tmp_path):
    """The pen check at (37, 5) from the pinch has the power to catch a
    kernel that ignores the actions: such a build misses the plain
    version by far more than the tolerance."""
    n, h = 37, 5
    roll, args, tol = _kernel_case("pen", n, h, 3)
    costs = _host_costs(_host_library(roll.header, tmp_path, zero_actions=True), args, n, h)
    want = roll(*(torch.as_tensor(a) for a in args)).numpy()
    assert np.abs(costs - want).max() > 10 * tol


@pytest.mark.parametrize("name", ["relocate", "hammer"])
def test_hand_check_fails_for_a_kernel_whose_actions_are_zeroed(name, tmp_path):
    """The relocate check from the grasp and the hammer check with the
    hammer held on the nail, at (37, 5), have the power to catch a kernel
    that ignores the actions."""
    n, h = 37, 5
    roll, args, tol = _kernel_case(name, n, h, 3)
    costs = _host_costs(_host_library(roll.header, tmp_path, zero_actions=True), args, n, h)
    want = roll(*(torch.as_tensor(a) for a in args)).numpy()
    assert np.abs(costs - want).max() > 10 * tol


@pytest.mark.parametrize("name", ["hammer", "hammer_spin"])
def test_hammer_check_fails_for_a_kernel_on_the_decoupled_branch(name, tmp_path):
    """hammer's header turns the coupled 6x6 solve on for its free body; a
    build whose header turns it off (the decoupled 3x3 solves) misses the
    plain version by more than 10x the tolerance, held and spinning."""
    n, h = 37, 5
    roll, args, tol = _kernel_case(name, n, h, 3)
    on = "constexpr bool HAS_COUPLED = true;"
    assert roll.header.count(on) == 1
    off = roll.header.replace(on, "constexpr bool HAS_COUPLED = false;")
    costs = _host_costs(_host_library(off, tmp_path), args, n, h)
    want = roll(*(torch.as_tensor(a) for a in args)).numpy()
    assert np.abs(costs - want).max() > 10 * tol


def test_headers_bake_the_tasks():
    pen_h = pen.build_rollout(envs.make("pen-v0", device=DEVICE).params.model).header
    peg_h = sawyer_tasks.build_rollout(
        envs.make("sawyer_peg_insertion-v0", device=DEVICE).params.model).header
    assert "#define FOREST_TASK 0" in pen_h and "#define FOREST_TASK 1" in peg_h
    for text in ("constexpr int NB = 25;", "constexpr int NQ = 31;", "constexpr int NV = 30;",
                 "constexpr int D_ACT = 24;", "constexpr int N_POINTS = 12;",
                 "constexpr int N_SUBSTEPS = 5;", "constexpr int MAXD = 7;",
                 "constexpr int N_EXTRAS = 7;", "constexpr int PEN_BODY = 24;"):
        assert text in pen_h, text
    for text in ("constexpr int NB = 7;", "constexpr int N_POINTS = 0;",
                 "constexpr int N_SUBSTEPS = 2;", "constexpr int N_EXTRAS = 10;"):
        assert text in peg_h, text
    # the tables have a constant-memory copy for the card and one for the host
    assert "__constant__ int d_anc[25][7]" in pen_h and "constexpr int h_anc[25][7]" in pen_h


@pytest.mark.parametrize("bad", ["dtype", "mean", "da", "q0", "extras", "not_tensor", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    roll, args, _ = _kernel_case("peg", 4, 3, 1)
    q0, qd0, extras, mean, noise = (torch.as_tensor(a) for a in args)
    if bad == "dtype":
        noise = noise.double()
    elif bad == "mean":
        mean = mean[:2]
    elif bad == "da":
        noise = noise[..., :4]
    elif bad == "q0":
        q0 = q0[:5]
    elif bad == "extras":
        extras = extras[:3]
    elif bad == "not_tensor":
        mean = mean.numpy()
    else:
        noise = noise.to("meta")
    with pytest.raises((TypeError, ValueError)):
        roll(q0, qd0, extras, mean, noise)


def test_forest_consts_refuses_what_the_kernel_does_not_take():
    hinge = dict(pos=(0, 0, 0), axis=(1, 0, 0), range=(-1, 1), geoms=[rb.sphere_geom(0.02)])
    free = dict(pos=(0, 0, 0), type="free", geoms=[rb.sphere_geom(0.02)])
    cases = {
        "ball": [dict(hinge, type="ball", parent=-1)],
        "non-root free": [dict(hinge, parent=-1), dict(free, parent=0)],
        "free with a child": [dict(free, parent=-1), dict(hinge, parent=0)],
        "parent after child": [dict(hinge, parent=1), dict(hinge, parent=-1)],
    }
    for name, bodies in cases.items():
        model = rb.build_chain(bodies, dt=0.01, site_body=0, site_pos=(0, 0, 0), device=DEVICE)
        with pytest.raises(ValueError):
            fr.forest_consts(model)
    pen_model = envs.make("pen-v0", device=DEVICE).params.model
    with pytest.raises(ValueError):   # an action on the free pen
        fr.build_forest_rollout(pen_model, 5, [24], fr.pen_task())


def test_pen_forest_topology():
    """The hand is one 24-dof tree rooted at the wrist; the pen a free root
    with its com at the joint origin (the decoupled branch); 107 packed
    ancestor entries."""
    c = fr.forest_consts(envs.make("pen-v0", device=DEVICE).params.model)
    assert c["trees"] == [list(range(24))] and c["free"] == [24]
    assert not c["free_consts"][24]["coupled"]
    assert sum(len(fr._ancestors(c, i)) + 1 for i in range(24)) == 107


def test_work_counts_and_bounds():
    """Operations scale with N and, past the first FK pass, with H (the
    work does not depend on the data) and bound both instances; bytes are
    q0, qd0, extras, the mean and the noise in and the costs out."""
    for name in bounds.FOREST_SIZES:
        roll = bounds._forest_rollout(name)
        model, task, d = roll.model, roll.task, len(roll.act_bodies)
        ops = lambda n, h: fr.forest_rollout_flops(model, roll.n_substeps, n, h,
                                                   roll.act_bodies, task)
        step = ops(1, 2) - ops(1, 1)
        assert step > 0 and 0 < ops(1, 1) - step < step
        assert ops(256, 16) == 256 * ops(1, 16) == 256 * (ops(1, 1) + 15 * step)
        n, h = bounds.FOREST_SIZES[name]
        inst = bounds.forest_instance(roll, n, h)
        assert inst["bound_by"] == "operations" and inst["task"] == task.name
        assert inst["bytes"] == fr.forest_rollout_bytes(model, n, h, d, task) == 4 * (
            model.nq + model.nv + task.n_extras + h * d + n * h * d + n * h)
    row6 = bounds.kernel_table(envs.make("reacher_7dof-v0", device=DEVICE).params.model)[5]
    assert row6["number"] == 6 and row6["bound_by"] == "operations" and row6["task"] == "pen"


def test_gated_cost_agreement_counts_bonus_steps_and_other_misses():
    """The pen check at the config's size: entries within atol, entries off
    by a signed sum of the bonuses (5, 10, 50) to within atol, and any
    other miss, all on an absolute tolerance."""
    want = torch.full((4, 5), -10.9)
    got = want.clone()
    got[0, 0] += 5e-4                     # within 1e-3
    got[1, 1] -= 60.0                     # both bonuses lost at a gate
    got[2, 2] += 45.0 + 5e-4              # +50 gained, -5 lost
    got[3, 3] += 2e-3                     # a miss that no bonus explains
    agree = fr.gated_cost_agreement(got, want, 1e-3)
    assert (agree["bonus_steps"], agree["other"]) == (2, 1)
    assert agree["share_within"] == pytest.approx(17 / 20)
    assert fr.gated_cost_agreement(got, want, 1e-2)["other"] == 0
    assert 60.0 in fr.PEN_BONUS_STEPS and -45.0 in fr.PEN_BONUS_STEPS
