"""The analytic envs of the PyTorch port against the JAX package: LQR-v0,
point_mass-v0 (alias mjrl_point_mass-v0), cartpole-v0, acrobot-v0,
trajopt_reacher-v0, maze-v0 and continual_maze-v0.

Each env's step (next state, observation, reward, done) and the success
of the next state, and its observation of the start, from a batch of
injected states made with numpy, against the JAX env step vmapped over the
same batch: atol = rtol = 1e-5 for LQR, point_mass, cartpole and the maze,
1e-4 for acrobot and trajopt_reacher, which run on the chain engine (the
engines' float32 sums differ in order). The batches reach each env's
edges: cartpole off its track (the penalty and `done`) and with angles
past +-pi (the wrap), the maze inside an obstacle (the penetration
penalty) and against the box, actions beyond the clip.

The maze's goal draw (Philox under a host key, the timestep as counter)
cannot match JAX's threefry draw, so the continual maze is held against
JAX away from the switch (the goal passed in) and at the switch in every
field but the goal; the draw is tested by its properties: the goal clears
every obstacle, it switches exactly at the period, it is the same for
every particle at a step, and it is a function of (key, t).

Last, convert.py's converters of the JAX params, states and models give
the port's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.envs import acrobot as jacrobot
from mjmpc_tpu.envs import cartpole as jcartpole
from mjmpc_tpu.envs import lqr as jlqr
from mjmpc_tpu.envs import maze as jmaze
from mjmpc_tpu.envs import point_mass as jpoint_mass
from mjmpc_tpu.envs import trajopt_reacher as jtrajopt
from mjmpc_tpu_torch import convert, envs, rng
from mjmpc_tpu_torch.envs import maze

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
B = 12


def _batch(seed):
    return np.random.default_rng(seed)


def _lqr(r):
    x = r.uniform(-5, 5, (B, 2)).astype(np.float32)
    return (jlqr.LQRState(x=jnp.asarray(x)), envs.lqr.LQRState(x=torch.as_tensor(x)),
            r.normal(0, 2, (B, 1)))


def _point_mass(r):
    pos, vel = (r.uniform(-1, 1, (B, 2)).astype(np.float32) for _ in range(2))
    js = jpoint_mass.PointMassState(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    return js, convert.point_mass_state_from_reference(js, DEVICE), r.uniform(-2, 2, (B, 2))


def _cartpole(r):
    x = np.concatenate([r.uniform(-1, 1, B // 2), r.choice([-1, 1], B - B // 2)
                        * r.uniform(2.3, 3.0, B - B // 2)]).astype(np.float32)
    rest = [r.uniform(-lim, lim, B).astype(np.float32) for lim in (2.0, 4.0, 3.0)]
    js = jcartpole.CartpoleState(*(jnp.asarray(v) for v in [x] + rest))
    return js, convert.cartpole_state_from_reference(js, DEVICE), r.uniform(-1.5, 1.5, (B, 1))


def _acrobot(r):
    js = jacrobot.AcrobotState(qpos=jnp.asarray(r.uniform(-np.pi, np.pi, (B, 2)), jnp.float32),
                               qvel=jnp.asarray(r.uniform(-2, 2, (B, 2)), jnp.float32))
    return js, convert.acrobot_state_from_reference(js, DEVICE), r.uniform(-1.5, 1.5, (B, 1))


def _trajopt(r):
    ang, rad = r.uniform(-np.pi, np.pi, B), r.uniform(0.05, 0.19, B)
    target = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    js = jtrajopt.TrajoptReacherState(
        qpos=jnp.asarray(r.uniform(-2.5, 2.5, (B, 2)), jnp.float32),
        qvel=jnp.asarray(r.uniform(-1, 1, (B, 2)), jnp.float32),
        target=jnp.asarray(target, jnp.float32), timestep=jnp.full(B, 7, jnp.int32))
    # the port's timestep is an int64 tensor, here one shared by the batch
    port = convert.trajopt_reacher_state_from_reference(js._replace(timestep=7), DEVICE)
    return js, port, r.uniform(-1.5, 1.5, (B, 2))


def _maze_batch(r, timestep):
    pos = r.uniform(-2.1, 2.1, (B, 2)).astype(np.float32)
    pos[:3] = [[0.0, 0.0], [0.1, -0.2], [-1.0, 1.05]]       # inside obstacles
    pos[3] = [1.99, -1.99]                                    # against the box
    vel = r.uniform(-2, 2, (B, 2)).astype(np.float32)
    goal = r.uniform(-1.8, 1.8, (B, 2)).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))
    js = jmaze.MazeState(pos=jnp.asarray(pos), vel=jnp.asarray(vel), goal=jnp.asarray(goal),
                         timestep=jnp.full(B, timestep, jnp.int32), key=keys)
    port = convert.maze_state_from_reference(js, key=5, device=DEVICE)
    return js, port, r.uniform(-1.5, 1.5, (B, 2))


def _maze(r):
    return _maze_batch(r, 17)


CASES = {
    "LQR-v0": (_lqr, 1e-5), "point_mass-v0": (_point_mass, 1e-5),
    "mjrl_point_mass-v0": (_point_mass, 1e-5), "cartpole-v0": (_cartpole, 1e-5),
    "acrobot-v0": (_acrobot, 1e-4), "trajopt_reacher-v0": (_trajopt, 1e-4),
    "maze-v0": (_maze, 1e-5), "continual_maze-v0": (_maze, 1e-5),
}


def _fields(state):
    """A state's array fields as numpy, for either package."""
    names = state._fields if hasattr(state, "_fields") else [
        f.name for f in dataclasses.fields(state)]
    out = {}
    for name in names:
        v = getattr(state, name)
        if name != "key" and isinstance(v, (torch.Tensor, jax.Array)):
            out[name] = np.asarray(v)
    return out


def _jax_step(name, js, actions, env_j):
    step = jax.jit(jax.vmap(env_j.step, in_axes=(None, 0, 0)))
    nxt, obs, rew, done = step(env_j.params, js, jnp.asarray(actions, jnp.float32))
    succ = (jax.vmap(env_j.success, in_axes=(None, 0))(env_j.params, nxt)
            if env_j.success is not None else None)
    return nxt, obs, rew, done, succ


def _check_step(name, make_batch, tol, skip=()):
    env_j, env = jenvs.make(name), envs.make(name, device=DEVICE)
    js, ps, actions = make_batch(_batch(sorted(CASES).index(name)))
    close = dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(env.observe(env.params, ps).numpy(),
                               np.asarray(jax.vmap(env_j.observe, in_axes=(None, 0))(
                                   env_j.params, js)), **close)
    nxt_j, obs_j, rew_j, done_j, succ_j = _jax_step(name, js, actions, env_j)
    nxt, obs, rew, done = env.step(env.params, ps, torch.as_tensor(actions, dtype=torch.float32))
    got, want = _fields(nxt), _fields(nxt_j)
    for k, v in got.items():
        if k not in skip:
            np.testing.assert_allclose(v, want[k], err_msg=k, **close)
    if "goal" not in skip:
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), **close)
        np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), **close)
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
    if succ_j is not None and "goal" not in skip:
        np.testing.assert_array_equal(env.success(env.params, nxt).numpy(), np.asarray(succ_j))
    return nxt, rew, done


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_jax_from_injected_states(name):
    make_batch, tol = CASES[name]
    nxt, rew, done = _check_step(name, make_batch, tol)
    assert rew.shape == (B,) and done.shape == (B,)
    if name == "cartpole-v0":          # off the track: penalised and done
        assert done.any() and not done.all()
        assert (rew[done] < -99.0).all()
    if name.endswith("maze-v0"):       # inside an obstacle: penalised
        assert (rew[:3] < rew[4:].min()).all()


def test_continual_maze_at_the_switch_matches_jax_but_for_the_goal():
    nxt, _, _ = _check_step("continual_maze-v0", lambda r: _maze_batch(r, 49), 1e-5,
                            skip=("goal",))
    assert (nxt.timestep == 50).all()
    want = maze.sample_free_point(envs.make("continual_maze-v0", device=DEVICE).params, 5,
                                  rng.step_tensor(50, DEVICE))
    assert torch.equal(nxt.goal, want.expand(B, 2))


def test_registry_holds_every_jax_name():
    assert envs.NOT_PORTED == ()
    assert set(envs.available()) == set(jenvs.available())
    for name in CASES:
        env, env_j = envs.make(name, device=DEVICE), jenvs.make(name)
        assert (env.d_obs, env.d_action) == (env_j.d_obs, env_j.d_action)
        assert env.max_episode_steps == env_j.max_episode_steps
        np.testing.assert_array_equal(env.action_lows.numpy(), env_j.action_lows)
        np.testing.assert_array_equal(env.action_highs.numpy(), env_j.action_highs)
        assert env.device == torch.device(DEVICE)


def test_lqr_riccati_gain_matches_jax():
    p = jenvs.make("LQR-v0").params
    mats = [np.asarray(getattr(p, k), np.float64) for k in "ABQR"]
    np.testing.assert_allclose(envs.lqr.riccati_gain(*mats), jlqr.riccati_gain(*mats),
                               rtol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_gives_a_finite_start(name):
    env = envs.make(name, device=DEVICE)
    s0, s1 = env.init(env.params, 3), env.init(env.params, 3)
    obs = env.observe(env.params, s0)
    assert obs.shape == (env.d_obs,) and torch.isfinite(obs).all()
    assert torch.equal(obs, env.observe(env.params, s1))


# ---- the maze's goal draw --------------------------------------------------

def _clear(params, points):
    obst = params.obstacles
    d = torch.linalg.vector_norm(points[..., None, :] - obst[:, :2], dim=-1)
    return (d > obst[:, 2]).all(-1)


def test_maze_draws_clear_every_obstacle():
    params = envs.make("continual_maze-v0", device=DEVICE).params
    t = torch.arange(300, dtype=torch.int64)
    for key in (0, 1, 2**63 + 5):
        points = maze.sample_free_point(params, key, t)
        assert points.shape == (300, 2)
        assert _clear(params, points).all()
        assert (points.abs() <= 1.8).all()
    env = envs.make("maze-v0", device=DEVICE)
    for seed in range(10):
        s = env.init(env.params, seed)
        assert _clear(env.params, s.pos).all() and _clear(env.params, s.goal).all()


def test_maze_goal_switches_exactly_at_the_period_for_every_particle():
    env = envs.make("continual_maze-v0", device=DEVICE)
    s = env.init(env.params, 4)
    n = 6
    s = dataclasses.replace(s, pos=s.pos.expand(n, 2), vel=s.vel.expand(n, 2),
                            goal=s.goal.expand(n, 2),
                            timestep=rng.step_tensor(47, DEVICE).expand(n))
    acts = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (5, n, 2)), dtype=torch.float32)
    goals = [s.goal]
    for a in acts:
        s, _, _, _ = env.step(env.params, s, a)
        goals.append(s.goal)
    # t = 48, 49 keep the goal; t = 50 switches, the same for every particle;
    # t = 51, 52 keep the new one
    assert torch.equal(goals[1], goals[0]) and torch.equal(goals[2], goals[0])
    assert not torch.allclose(goals[3], goals[0])
    assert torch.equal(goals[3], goals[3][:1].expand(n, 2))
    assert torch.equal(goals[4], goals[3]) and torch.equal(goals[5], goals[3])
    assert _clear(env.params, goals[3]).all()
    # maze-v0 never moves its goal
    plain = envs.make("maze-v0", device=DEVICE)
    p = dataclasses.replace(plain.init(plain.params, 4), timestep=rng.step_tensor(49, DEVICE))
    assert torch.equal(plain.step(plain.params, p, torch.zeros(2))[0].goal, p.goal)


def test_maze_draw_is_a_function_of_key_and_timestep():
    params = envs.make("continual_maze-v0", device=DEVICE).params
    t = torch.tensor([50, 100, 50], dtype=torch.int64)
    a, b = maze.candidates(9, t), maze.candidates(9, t.clone())
    assert torch.equal(a, b) and torch.equal(a[0], a[2]) and not torch.equal(a[0], a[1])
    assert not torch.equal(maze.candidates(10, t), a)
    assert torch.equal(maze.sample_free_point(params, 9, t[1]),
                       maze.sample_free_point(params, 9, t)[1])


def test_maze_draw_makes_no_generator(monkeypatch):
    env = envs.make("continual_maze-v0", device=DEVICE)
    s = dataclasses.replace(env.init(env.params, 1), timestep=rng.step_tensor(49, DEVICE))

    def boom(*args, **kwargs):
        raise AssertionError("a torch.Generator inside the step")

    monkeypatch.setattr(torch, "Generator", boom)
    nxt, _, _, _ = env.step(env.params, s, torch.zeros(2))
    assert int(nxt.timestep) == 50 and nxt.key == s.key


# ---- convert.py ---------------------------------------------------------------

def _assert_same(port, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        elif dataclasses.is_dataclass(b):
            _assert_same(a, b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name,params_fn", [
    ("LQR-v0", convert.lqr_params_from_reference),
    ("point_mass-v0", convert.point_mass_params_from_reference),
    ("cartpole-v0", convert.cartpole_params_from_reference),
    ("maze-v0", convert.maze_params_from_reference),
    ("continual_maze-v0", convert.maze_params_from_reference),
    ("acrobot-v0", convert.acrobot_params_from_reference),
    ("trajopt_reacher-v0", convert.trajopt_reacher_params_from_reference),
])
def test_converted_params_are_the_ports_own(name, params_fn):
    _assert_same(params_fn(jenvs.make(name).params, device=DEVICE),
                 envs.make(name, device=DEVICE).params)


def test_converted_states_keep_every_field():
    key = jax.random.PRNGKey(0)
    s = jenvs.make("continual_maze-v0").init(jenvs.make("continual_maze-v0").params, key)
    port = convert.maze_state_from_reference(s, key=77, device=DEVICE)
    np.testing.assert_array_equal(port.goal.numpy(), np.asarray(s.goal))
    assert port.timestep.dtype == torch.int64 and port.key == 77
    for name, fn in (("acrobot-v0", convert.acrobot_state_from_reference),
                     ("trajopt_reacher-v0", convert.trajopt_reacher_state_from_reference),
                     ("cartpole-v0", convert.cartpole_state_from_reference),
                     ("point_mass-v0", convert.point_mass_state_from_reference),
                     ("LQR-v0", convert.lqr_state_from_reference)):
        ref = jenvs.make(name).init(jenvs.make(name).params, key)
        got = _fields(fn(ref, device=DEVICE))
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), err_msg=k)
