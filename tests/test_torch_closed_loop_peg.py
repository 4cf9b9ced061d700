"""run_mpc_cl's Reinforce on configs/sawyer/sawyer_peg_insertion-v0_cl.yml
(N=64, H=32, 4 iterations a solve, the quadratic critic), the port's
closed loop against the JAX package's on the CPU: K = 3 control steps of
solve, clip and env step from the same start, each solve on the same
injected noise, the actor and critic built as run_mpc_cl builds them.
The helpers are test_torch_closed_loop.py's.

What the loop shows: the first rollout agrees to 1e-4; the port's update
on JAX's first trajectory agrees with JAX's update where the quadratic
critic's near-singular f32 fit leaves it well conditioned (the fit error,
the fitted baselines within f32 rounding of the float64 fit, the actor
step on JAX's baselines at 1e-5); from the first step on, the port's loop
parts from JAX's by as much as the JAX loop with its particles permuted
(the same mathematics, sums in other orders) parts from itself. So the
peg CL episode result that differs from the JAX record is spread, not a
fault of the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.harness.run_mpc_cl import build_cl_solver as jax_build_cl_solver
from mjmpc_tpu.rollout.engine import rollout_closed_loop_linear as jax_rollout_cl
from mjmpc_tpu.value_functions import vf as jvf
from mjmpc_tpu_torch import convert, envs, ops, solvers
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness.run_mpc_cl import build_cl_solver
from mjmpc_tpu_torch.rollout import Trajectories
from mjmpc_tpu_torch.value_functions.vf import VFParams
from test_torch_closed_loop import ATOL, DEVICE, K, _d, _injected, _lightly_compiled, _noises

PEG_CL = "configs/sawyer/sawyer_peg_insertion-v0_cl.yml"
PERMUTATIONS = 3


@pytest.fixture(scope="module")
def peg_loops():
    """The JAX loop, the JAX loop with the particles permuted in
    PERMUTATIONS ways and the port's loop (its own solve: the closed-loop
    rollout's plain version on the CPU), K steps each, the actor and
    critic built as run_mpc_cl builds them; and JAX's first rollout with
    JAX's update on it and that update's fitted baselines."""
    exp = cfg.load_config(PEG_CL)
    jenv, env = jenvs.make(exp["env_name"]), envs.make(exp["env_name"], device=DEVICE)
    jsolver = jax_build_cl_solver(exp, "reinforce", jenv)
    noises = _noises(jsolver, env.d_action, jsolver.init_cov, seed=4)
    port_solver = build_cl_solver(exp, "reinforce", env)
    solver = _injected(solvers.Reinforce)(
        **{f.name: getattr(port_solver, f.name) for f in dataclasses.fields(port_solver)},
        noises=noises, costs=[])
    rollout = jax.jit(lambda p, e, w, nz: jax_rollout_cl(jenv, p, e, w, nz))
    update = jax.jit(jsolver.update)

    @_lightly_compiled
    def finish(p, e, s):
        action = jenv.clip_action(jsolver.act(s, jenv.observe(p, e)))
        e, _, reward, _ = jenv.step(p, e, action)
        return action, reward, s._replace(step=s.step + 1), e

    def jax_loop(perm=None):
        e = jenv.init(jenv.params, jax.random.PRNGKey(0))
        s = jsolver.init_state(jax.random.PRNGKey(1))
        records, first = [], None
        for k in range(K):
            noise = jnp.asarray(noises[k] if perm is None else noises[k][perm])
            for _ in range(jsolver.n_iters):
                traj = rollout(jenv.params, e, s.mean_weights, noise)
                s = update(s, traj)
                first = (traj, s) if first is None else first
            a, r, s, e = finish(jenv.params, e, s)
            records.append((a, r, s.mean_weights, e.qpos))
        return records, first

    jax_records, (jax_first, jax_first_update) = jax_loop()
    perm_records = [jax_loop(np.random.default_rng(seed).permutation(jsolver.num_particles))[0]
                    for seed in range(PERMUTATIONS)]
    jax_baselines = jsolver.vf.predict(
        jvf.VFParams(jax_first_update.vf_weights, jax_first_update.vf_bias),
        jax_first.observations)
    je = jenv.init(jenv.params, jax.random.PRNGKey(0))
    es = convert.peg_state_from_reference(je, DEVICE)
    st = convert.reinforce_state_from_reference(jsolver.init_state(jax.random.PRNGKey(1)), 0,
                                                DEVICE)
    first = env.fused_cl_rollout(env.params, es, st.mean_weights, torch.as_tensor(noises[0]))
    start = st
    solve = solvers.make_solve_fn(solver, env)
    port_records = []
    for _ in range(K):
        a, _, st = solve(env.params, es, st)
        a = env.clip_action(a)
        es, _, r, _ = env.step(env.params, es, a)
        port_records.append((a, r, st.mean_weights, es.qpos))
    return dict(jax=jax_records, perm=perm_records, port=port_records, jax_first=jax_first,
                jax_first_update=jax_first_update, jax_baselines=jax_baselines,
                port_first=first, port_start=start, solver=port_solver)


def test_peg_cl_first_rollout_matches_jax(peg_loops):
    """The first rollout of the first solve (the port's closed-loop
    rollout, JAX's general one) and its returns at 1e-4."""
    jt, (obs, acts, costs) = peg_loops["jax_first"], peg_loops["port_first"]
    assert _d(obs, jt.observations) <= ATOL and _d(acts, jt.actions) <= ATOL
    assert _d(costs, jt.costs) <= ATOL
    returns = ops.cost_to_go(costs, peg_loops["solver"].discount)
    assert _d(returns, np.cumsum(np.asarray(jt.costs)[:, ::-1], 1)[:, ::-1]) <= ATOL


def test_peg_cl_update_on_jax_trajectory_matches_jax(peg_loops):
    """The port's Reinforce update on JAX's first trajectory, from JAX's
    first state, against JAX's update on it. The quadratic critic's gram
    is near-singular: its weights differ between the packages by about 27
    where they reach 47, and each f32 fit lies as far from the port's
    float64 fit. So the update is held where it is well conditioned, and
    JAX's f32 result against the port's float64 update on the same
    trajectory (measured on the CPU):
    - the fit error at 1e-4 (8.3e-6 from the port's f32 fit);
    - the fitted baselines: JAX's within 1e-2 of the largest return of the
      float64 fit's (0.118 where returns reach 32.4; the port's f32 fit
      0.072), and each package's f32 baselines within 3x of the other's
      distance from it;
    - the actor step on JAX's baselines gives JAX's new weights at 1e-5
      (4.2e-7, where the step moves W by 0.232);
    - the whole update's weights: JAX's within 2e-2 of the step of the
      float64 update's (1.7e-3; the port's f32 update 1.2e-3), each
      package's f32 update within 3x of the other's distance from it. A wrong step (a sign, a missing
      whitening) would move W by the order of the step itself."""
    solver, st = peg_loops["solver"], peg_loops["port_start"]
    jt, ju = peg_loops["jax_first"], peg_loops["jax_first_update"]
    traj = Trajectories(*(None if x is None else torch.as_tensor(np.array(x)) for x in jt))
    double = lambda x: solvers.map_tensors(
        lambda t: t.double() if t.is_floating_point() else t, x)
    ours = solvers.Reinforce.update(solver, st, traj)
    ours64 = solvers.Reinforce.update(solver, double(st), double(traj))
    assert ours64.mean_weights.dtype == torch.float64
    assert _d(ours.fit_error, ju.fit_error) <= ATOL

    returns = ops.cost_to_go(traj.costs, solver.discount)
    base = lambda s, obs: solver.vf.predict(VFParams(s.vf_weights, s.vf_bias), obs)
    base32, base64 = base(ours, traj.observations), base(ours64, double(traj.observations))
    err_jax, err_port = _d(peg_loops["jax_baselines"], base64), _d(base32, base64)
    assert err_jax <= 1e-2 * float(returns.abs().max()), (err_jax, err_port)
    assert err_port <= 3 * err_jax and err_jax <= 3 * err_port, (err_jax, err_port)

    jb = torch.as_tensor(np.array(peg_loops["jax_baselines"]))
    obs_cat, grad = solver.gradient(st, traj, returns - jb)
    w = st.mean_weights - solver.step_size(st, obs_cat, grad) * grad
    assert _d(w, ju.mean_weights) <= 1e-5

    step = _d(ju.mean_weights, st.mean_weights)
    err_jax = _d(ju.mean_weights, ours64.mean_weights)
    err_port = _d(ours.mean_weights, ours64.mean_weights)
    assert err_jax <= 2e-2 * step, (err_jax, err_port, step)
    assert err_port <= 3 * err_jax and err_jax <= 3 * err_port, (err_jax, err_port)


def test_peg_cl_closed_loop_is_within_the_jax_packages_own_spread(peg_loops):
    """For each record (action, reward, W, qpos), at the first step and at
    its largest over the K steps, the port's loop is no farther from JAX's
    than twice the farthest of the JAX loops with the particles permuted
    (the same mathematics, sums in other orders); every record is
    finite. Past the first step the loops are chaotic, so the later steps
    are held by their largest difference, not one by one.

    The spread this holds to is large, as four iterations of the
    near-singular fit a step make it (measured on the CPU: the largest
    over the three permutations at steps 1-3, the port's loop in
    brackets): action 0.254, 0.938, 2.0 (the whole clip range) [0.185,
    0.929, 2.0]; reward 1.7e-4, 6.2e-4, 1.3e-3 [1.5e-4, 5.3e-4, 2.5e-3];
    W 0.427, 0.468, 0.818 [0.299, 0.517, 0.681]; qpos 0.041, 0.058,
    0.255 [0.032, 0.044, 0.136]. So this test only says that the port's
    loop is as far from JAX's as JAX's own rounding puts it: the test
    above holds the port's update itself, on one trajectory."""
    for field, i in (("action", 0), ("reward", 1), ("W", 2), ("qpos", 3)):
        port = [_d(p[i], j[i]) for p, j in zip(peg_loops["port"], peg_loops["jax"])]
        own = [max(_d(p[k][i], peg_loops["jax"][k][i]) for p in peg_loops["perm"])
               for k in range(K)]
        assert port[0] <= 2 * own[0] + ATOL, (field, "first step", port, own)
        assert max(port) <= 2 * max(own) + ATOL, (field, "over the steps", port, own)
    for rec in peg_loops["port"]:
        assert all(np.isfinite(np.asarray(x)).all() for x in rec)
