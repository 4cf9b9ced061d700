"""SoftQMPC on sawyer_reacher-v0 (the config's softq block: H=16, lam 0.05,
lr 0.1, 8 gradient steps a solve, clip 10, gamma 0.99; N cut to 16, where
the clip still binds on every solve), the port's closed loop against the
JAX package's on the CPU: K = 3 control steps of solve, clip and env step
from the same start and the same initial Q, each solve on the same
injected white noise, the JAX solve composed from the package's own
pieces (_policy, _scan_rollout, update, act) as its build_solve_fn
composes them. The helpers are test_torch_closed_loop.py's.

What the loop shows (the softq episodes on the card scored -445.5 +-
69.1 against the JAX record's -332 +- 12; the JAX package's own softq_diag
stock arm -620.5): the clip binds at every step (the fit's first gradient
norms 2.1e5, 1.5e5 and 3.5e5 against the clip's 10), and yet the port's
loop holds JAX's to about 1e-6 over the three steps (measured on the CPU,
per step; the JAX loops with the particles permuted, the largest of three,
in brackets): action 2.1e-7, 3.4e-7, 8.0e-7 [1.2e-7, 2.7e-7, 6.9e-7];
Q's packed L 4.8e-7, 9.5e-7, 3.3e-6 [7.2e-7, 1.2e-6, 3.8e-6]; qpos
2.3e-8, 3.6e-8, 7.5e-8 [1.3e-8, 3.4e-8, 1.0e-7]; rewards equal. The port's
control law is JAX's, and it parts from JAX's no more than JAX's own sums
in other orders do; so the episode result below the JAX record is the
spread between the noise streams of a three-episode run, not a fault of
the port.
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjmpc_tpu import envs as jenvs
from mjmpc_tpu.harness import config as jcfg
from mjmpc_tpu.rollout.engine import _scan_rollout as jax_scan_rollout
from mjmpc_tpu_torch import convert, envs, solvers
from mjmpc_tpu_torch.harness import config as cfg
from test_torch_closed_loop import ATOL, DEVICE, K, _d, _lightly_compiled

SAWYER = "configs/sawyer/sawyer_reacher-v0.yml"
N = 16
PERMUTATIONS = 3
SPREAD_ATOL = 1e-5   # beside twice the permuted loops' spread, about 1e-6


@dataclasses.dataclass(frozen=True)
class InjectedSoftQ(solvers.SoftQMPC):
    """Test-only SoftQMPC whose white noise at step k is whites[k]."""
    whites: Any = None

    def white_noise(self, state):
        return torch.as_tensor(self.whites[int(state.step)]).clone()


@pytest.fixture(scope="module")
def softq_loops():
    """The JAX loop, the JAX loop with the particles permuted in
    PERMUTATIONS ways and the port's loop, K steps each: per step (action,
    reward, Q's packed L, qpos), and the port's fit's first gradient norm
    before the clip."""
    exp = cfg.load_config(SAWYER)
    exp["softq"] = dict(exp["softq"], num_particles=N)
    jenv, env = jenvs.make(exp["env_name"]), envs.make(exp["env_name"], device=DEVICE)
    jsolver = jcfg.make_solver_for_env(exp, "softq", jenv)
    rs = np.random.default_rng(7)
    whites = [rs.normal(size=(N, jsolver.horizon, env.d_action)).astype(np.float32)
              for _ in range(K)]

    @_lightly_compiled
    def jax_step(p, e, s, white):
        mean_fn, chol, entropy = jsolver._policy(s.q_params)
        traj = jax_scan_rollout(jenv, p, e, white @ chol.T, lambda t, obs: mean_fn(obs))
        s = jsolver.update(s, traj, entropy)
        action = jenv.clip_action(jsolver.act(s, jenv.observe(p, e)))
        e, _, reward, _ = jenv.step(p, e, action)
        return action, reward, s._replace(step=s.step + 1), e

    def jax_loop(perm=None):
        e = jenv.init(jenv.params, jax.random.PRNGKey(0))
        s = jsolver.init_state(jax.random.PRNGKey(1))
        records = []
        for k in range(K):
            white = jnp.asarray(whites[k] if perm is None else whites[k][perm])
            a, r, s, e = jax_step(jenv.params, e, s, white)
            records.append((a, r, s.q_params.l_packed, e.qpos))
        return records

    jax_records = jax_loop()
    perm_records = [jax_loop(np.random.default_rng(seed).permutation(N))
                    for seed in range(PERMUTATIONS)]

    solver = InjectedSoftQ(**cfg.solver_params_from_config(exp, "softq", env), whites=whites)
    es = convert.reacher_state_from_reference(jenv.init(jenv.params, jax.random.PRNGKey(0)),
                                              device=DEVICE)
    st = convert.softq_state_from_reference(jsolver.init_state(jax.random.PRNGKey(1)), seed=0,
                                            device=DEVICE)
    solve = solvers.make_solve_fn(solver, env)
    port_records, gnorms = [], []
    for _ in range(K):
        mean_fn, chol, entropy = solver._policy(st.q_params)
        traj = solvers.softq._scan_rollout(env, env.params, es, solver.white_noise(st) @ chol.T,
                                           lambda t, obs: mean_fn(obs))
        gnorms.append(float(solver.clipped_gradient(st.q_params, *solver.fit_inputs(
            traj, solver.targets(st.q_params, traj, entropy)))[1]))
        a, _, st = solve(env.params, es, st)
        a = env.clip_action(a)
        es, _, r, _ = env.step(env.params, es, a)
        port_records.append((a, r, st.q_params.l_packed, es.qpos))
    return dict(jax=jax_records, perm=perm_records, port=port_records, gnorms=gnorms,
                clip=solver.grad_clip)


def test_softq_clip_binds_on_every_solve(softq_loops):
    """The case is what it says: the fit's first gradient is longer than
    the clip at every step of the port's loop."""
    assert all(g > softq_loops["clip"] for g in softq_loops["gnorms"]), softq_loops["gnorms"]


def test_softq_closed_loop_is_within_the_jax_packages_own_spread(softq_loops):
    """For each record (action, reward, Q's packed L, qpos): the port's
    loop within 1e-4 of JAX's at every step and, at the first step and at
    its largest over the K steps, no farther from JAX's than twice the
    farthest of the JAX loops with the particles permuted, plus 1e-5;
    every record is finite."""
    for field, i in (("action", 0), ("reward", 1), ("L", 2), ("qpos", 3)):
        port = [_d(p[i], j[i]) for p, j in zip(softq_loops["port"], softq_loops["jax"])]
        own = [max(_d(p[k][i], softq_loops["jax"][k][i]) for p in softq_loops["perm"])
               for k in range(K)]
        assert max(port) <= ATOL, (field, port)
        assert port[0] <= 2 * own[0] + SPREAD_ATOL, (field, "first step", port, own)
        assert max(port) <= 2 * max(own) + SPREAD_ATOL, (field, "over the steps", port, own)
    for rec in softq_loops["port"]:
        assert all(np.isfinite(np.asarray(x)).all() for x in rec)
