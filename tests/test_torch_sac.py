"""The port's SAC stack (mjmpc_tpu_torch/rl/: replay memories, SAC with its
functional Adam, SACMPC) and harness/sacq_eval.py against the JAX
package's, on inputs made with numpy and the normals of the JAX keys, and
the properties of tests/test_sac.py.

Tolerances:
- the actor's sample, the twin Q and Adam against optax: atol 1e-5 (Adam
  1e-6 on its parameter updates);
- one SAC update at the JAX defaults (hidden (256, 256), batch 128) from
  converted parameters and the JAX keys' normals: the three losses rtol
  1e-4; the gradients 1e-4 of each leaf's largest; the new parameters,
  log_alpha and the target atol 2e-6 wherever |g| > 1e-6. One Adam step
  moves a parameter by lr g / (|g| + 1e-8), about lr = 3e-4 whatever the
  gradient's size, so where |g| is near 1e-8 (under 1% of the entries)
  the step turns on g's last bits: there both steps must have the
  gradient's sign and stay within lr (a flipped sign would miss by 6e-4);
- MPPIQ's update and value with SACMPC's q_fn (-min(Q1, Q2)) against the
  same composition in JAX on injected trajectories: atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.rl import SAC as JSAC
from mjmpc_tpu.rl import ReplayMemory as JReplayMemory
from mjmpc_tpu.rl import ReplayMemoryTraj as JReplayMemoryTraj
from mjmpc_tpu.rl.sac import GaussianPolicy as JGaussianPolicy
from mjmpc_tpu.rollout.engine import Trajectories as JTrajectories
from mjmpc_tpu_torch import convert, envs
from mjmpc_tpu_torch.harness import sacq_eval
from mjmpc_tpu_torch.rl import (SAC, SACMPC, GaussianPolicy, ReplayMemory, ReplayMemoryTraj,
                                adam_init, adam_step)
from mjmpc_tpu_torch.rollout import Trajectories

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
D_OBS, D_ACT, B = 6, 3, 128


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _torch_leaves(tree):
    return [x.numpy() for x in torch.utils._pytree.tree_leaves(tree)]


def _batch(seed, b=B, d_obs=D_OBS, d_act=D_ACT, done=0.0):
    rs = np.random.default_rng(seed)
    host = dict(obs=rs.normal(size=(b, d_obs)), action=np.tanh(rs.normal(size=(b, d_act))),
                reward=rs.normal(size=b), next_obs=rs.normal(size=(b, d_obs)),
                done=(rs.uniform(size=b) < done).astype(np.float64))
    host = {k: v.astype(np.float32) for k, v in host.items()}
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v) for k, v in host.items()})


def test_policy_sample_matches_jax_on_the_keys_normals():
    jpol, pol = JGaussianPolicy(D_OBS, D_ACT, (32, 32)), GaussianPolicy(D_OBS, D_ACT, (32, 32))
    jp = jpol.init_params(jax.random.PRNGKey(0))
    p = convert.mlp_params_from_reference(jp, DEVICE)
    jbatch, batch = _batch(1)
    key = jax.random.PRNGKey(5)
    ja, jlogp, jmean = jpol.sample(jp, jbatch["obs"], key)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (B, D_ACT))))
    a, logp, mean = pol.sample(p, batch["obs"], eps=eps)
    _close(a, ja)
    _close(logp, jlogp, rtol=1e-5)
    _close(mean, jmean)
    assert (a.abs() <= 1.0).all() and torch.isfinite(logp).all()
    # with a generator: the same draw for the same seed, in bounds
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    torch.testing.assert_close(pol.sample(p, batch["obs"], g1)[0],
                               pol.sample(p, batch["obs"], g2)[0], rtol=0, atol=0)


def test_twin_q_matches_jax():
    jsac, sac = JSAC(D_OBS, D_ACT), SAC(D_OBS, D_ACT)
    jparams = jsac.init_params(jax.random.PRNGKey(1))
    params = convert.sac_params_from_reference(jparams, DEVICE)
    jbatch, batch = _batch(2)
    jq1, jq2 = jsac.critic(jparams.q, jbatch["obs"], jbatch["action"])
    q1, q2 = sac.critic(params.q, batch["obs"], batch["action"])
    _close(q1, jq1)
    _close(q2, jq2)
    _close(sac.critic.min_q(params.q, batch["obs"], batch["action"]),
           jsac.critic.min_q(jparams.q, jbatch["obs"], jbatch["action"]))
    _close(sac.act(params, batch["obs"], deterministic=True),
           jsac.act(jparams, jbatch["obs"], deterministic=True))


def test_adam_matches_optax():
    rs = np.random.default_rng(4)
    tree = [rs.normal(size=(3, 2)).astype(np.float32), rs.normal(size=4).astype(np.float32)]
    opt = optax.adam(3e-4)
    jp = [jnp.asarray(x) for x in tree]
    jstate = opt.init(jp)
    p = [torch.as_tensor(x) for x in tree]
    state = adam_init(p)
    for k in range(3):
        grads = [rs.normal(size=x.shape).astype(np.float32) * 10.0 ** (k - 1) for x in tree]
        up, jstate = opt.update([jnp.asarray(g) for g in grads], jstate)
        jp = optax.apply_updates(jp, up)
        p, state = adam_step([torch.as_tensor(g) for g in grads], state, p, 3e-4)
        for got, want in zip(p, jp):
            _close(got, want, atol=1e-6)
    assert int(state.count) == 3


@pytest.mark.parametrize("done", [0.0, 0.3], ids=["no_terminal", "terminals"])
def test_sac_update_matches_jax_on_the_keys_normals(done):
    """One update from the same parameters, batch and normals: the losses;
    the gradients (Adam's first moments, 0.1 g after one step) to 1e-4 of
    each leaf's largest; then every new parameter, log_alpha and the
    target. Adam's first step moves a parameter by lr g / (|g| + 1e-8):
    where |g| > 1e-6 that is lr to 1e-2 and the parameters agree to 2e-6;
    where |g| is near 1e-8 the step turns on rounding of g itself, so
    there the step must have the gradient's sign on both sides and stay
    within lr."""
    jsac, sac = JSAC(D_OBS, D_ACT), SAC(D_OBS, D_ACT)
    jparams = jsac.init_params(jax.random.PRNGKey(7))
    params = convert.sac_params_from_reference(jparams, DEVICE)
    jbatch, batch = _batch(8, done=done)
    key = jax.random.PRNGKey(9)
    kn, kp = jax.random.split(key)
    eps = tuple(torch.as_tensor(np.array(jax.random.normal(k, (B, D_ACT)))) for k in (kn, kp))
    jnew, jinfo = jax.jit(jsac.update)(jparams, jbatch, key)
    new, info = sac.update(params, batch, eps=eps)
    for k in ("q_loss", "pi_loss", "alpha_loss", "alpha"):
        _close(info[k], jinfo[k], rtol=1e-4, atol=1e-6)
    lr, near_zero = sac.lr, 0
    for field, opt in (("policy", "policy_opt"), ("q", "q_opt"), ("log_alpha", "alpha_opt")):
        grads = [10.0 * g for g in _torch_leaves(getattr(new, opt).mu)]
        jgrads = [10.0 * np.asarray(g) for g in jax.tree_util.tree_leaves(
            getattr(jnew, opt)[0].mu)]
        old, got, want = (_torch_leaves(getattr(params, field)),
                          _torch_leaves(getattr(new, field)), _leaves(getattr(jnew, field)))
        assert len(grads) == len(jgrads) == len(got) == len(want)
        for g, jg, o, p_, w in zip(grads, jgrads, old, got, want):
            _close(g, jg, atol=1e-4 * float(np.abs(jg).max()))
            big = np.abs(jg) > 1e-6
            near_zero += int(((jg != 0) & ~big).sum())
            _close(p_[big], w[big], atol=2e-6)
            for step in (p_[~big] - o[~big], w[~big] - o[~big]):
                assert (np.sign(step) == -np.sign(jg[~big])).all() | (step == 0).all()
                assert np.abs(step).max(initial=0.0) <= lr * (1 + 1e-4)
    assert near_zero < 0.01 * sum(x.size for x in _torch_leaves(params.policy)
                                  + _torch_leaves(params.q))
    for got, want in zip(_torch_leaves(new.q_target), _leaves(jnew.q_target)):
        _close(got, want, atol=2e-6)
    assert int(new.q_opt.count) == 1 and int(new.alpha_opt.count) == 1


def test_sac_update_reduces_q_loss_and_the_target_lags():
    """tests/test_sac.py: terminal transitions make the TD target the
    fixed reward, so the twin-Q regression converges; the target moves but
    lags the critic."""
    sac = SAC(d_obs=3, d_action=1, hidden=(32, 32), lr=3e-3)
    g = torch.Generator().manual_seed(0)
    params = sac.init_params(g, DEVICE)
    rs = np.random.RandomState(42)
    batch = {k: torch.as_tensor(v.astype(np.float32)) for k, v in dict(
        obs=rs.randn(256, 3), action=np.tanh(rs.randn(256, 1)), reward=rs.randn(256),
        next_obs=rs.randn(256, 3), done=np.ones(256)).items()}
    q0 = _torch_leaves(params.q_target)[0]
    losses = []
    for _ in range(100):
        params, info = sac.update(params, batch, g)
        losses.append(float(info["q_loss"]))
    assert losses[-1] < 0.75 * losses[0] and np.isfinite(losses).all()
    q_leaf, t_leaf = _torch_leaves(params.q)[0], _torch_leaves(params.q_target)[0]
    assert not np.allclose(q_leaf, t_leaf) and not np.allclose(t_leaf, q0)
    no_tune = dataclasses.replace(sac, auto_entropy=False)
    after, info = no_tune.update(params, batch, g)
    assert after.log_alpha is params.log_alpha and float(info["alpha_loss"]) == 0.0


def test_replay_batches_match_jax_for_a_seed():
    jmem, mem = JReplayMemory(capacity=10, seed=3), ReplayMemory(capacity=10, seed=3)
    for i in range(25):
        for m in (jmem, mem):
            m.push(np.full(3, i, np.float32), np.full(1, -i), float(i), np.zeros(3), i % 2)
    assert len(mem) == len(jmem) == 10
    for _ in range(3):
        got, want = mem.sample(8), jmem.sample(8)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert (mem.sample(8)["reward"] >= 15).all()     # the ring keeps the last 10
    jtm, tm = JReplayMemoryTraj(capacity=3, seed=1), ReplayMemoryTraj(capacity=3, seed=1)
    for i in range(5):
        for m in (jtm, tm):
            m.push(dict(obs=np.ones((4, 3)) * i, reward=np.ones(4) * i))
    assert len(tm) == 3
    got, want = tm.sample(6), jtm.sample(6)
    assert got["obs"].shape == (6, 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_sacmpc_q_fn_matches_jax_in_mppiq():
    """SACMPC's q_fn (-min(Q1, Q2) of the live params) in MPPIQ's update
    and value on injected trajectories, against the same composition in
    JAX (mjmpc_tpu/rl/sac_mpc.py:58-77); and the sign: a higher SAC Q is a
    lower MPPIQ cost."""
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    m = SACMPC(env, horizon=6, num_particles=16, seed=0)
    jsac = JSAC(env.d_obs, env.d_action, gamma=m.gamma)
    jparams = jsac.init_params(jax.random.PRNGKey(3))
    q = convert.sac_params_from_reference(jparams, DEVICE).q

    def jq_fn(obs, acts):
        qv = jsac.critic.min_q(jparams.q, obs.reshape(-1, env.d_obs),
                               acts.reshape(-1, env.d_action))
        return -qv.reshape(obs.shape[:-1])

    cfg = dict(d_action=7, horizon=6, num_particles=16, beta=m.beta, td_lam=m.td_lam,
               gamma=m.gamma, init_cov=m.init_cov, step_size=0.55,
               filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat")
    jsolver = jsolvers.MPPIQ(**cfg, q_fn=jq_fn)
    solver = dataclasses.replace(m.solver, q_fn=m.q_fn_of(q))
    assert dataclasses.replace(solver, q_fn=None) == m.solver
    rs = np.random.default_rng(5)
    obs = rs.normal(size=(16, 6, env.d_obs)).astype(np.float32)
    acts = (0.5 * rs.normal(size=(16, 6, 7))).astype(np.float32)
    costs = rs.uniform(0, 2, size=(16, 6)).astype(np.float32)
    mean = (0.2 * rs.normal(size=(6, 7))).astype(np.float32)
    jstate = jsolver.init_state(jax.random.PRNGKey(0))._replace(mean=jnp.asarray(mean))
    state = convert.gaussian_state_from_reference(jstate, device=DEVICE)
    jtraj = JTrajectories(jnp.asarray(obs), jnp.asarray(acts), jnp.asarray(costs), None, None,
                          None)
    traj = Trajectories(torch.as_tensor(obs), torch.as_tensor(acts), torch.as_tensor(costs),
                        None, None, None)
    _close(solver.value(state, traj), jsolver.value(jstate, jtraj), atol=1e-4)
    _close(solver.update(state, traj).mean, jsolver.update(jstate, jtraj).mean, atol=1e-4)
    qv = m.q_fn_of(q)(traj.observations, traj.actions)
    torch.testing.assert_close(qv, -m.sac.critic.min_q(q, traj.observations, traj.actions))


def test_sacmpc_plans_on_the_obs_rollout_once_a_control_step():
    """With the Q plugged, MPPIQ reads observations, so on reacher_7dof-v0
    each control step calls the env's obs-emitting rollout (kernel #3 on
    the card) once; a SAC update changes what the next solve plans with."""
    env = envs.make("reacher_7dof-v0", device=DEVICE)
    calls = []

    def spy(*args):
        calls.append(1)
        return env.fused_obs_rollout(*args)

    m = SACMPC(dataclasses.replace(env, fused_obs_rollout=spy), horizon=4, num_particles=8,
               batch_size=4, seed=1)
    rewards = m.train(n_steps=6, episode_length=3, min_buffer=4)
    assert len(calls) == 6 and len(rewards) == 2 and len(m.update_info) == 3
    es, ss = m.env.init(env.params, 0), m.solver.init_state(0)
    a1 = m.solve_with_q(env.params, es, ss, m.sac_params.q)[0]
    shifted = torch.utils._pytree.tree_map(lambda x: x + 0.5, m.sac_params.q)
    a2 = m.solve_with_q(env.params, es, ss, shifted)[0]
    assert not torch.equal(a1, a2)
    # the Q of each call, never an earlier call's
    assert torch.equal(m.solve_with_q(env.params, es, ss, m.sac_params.q)[0], a1)


def test_sacmpc_smoke_on_the_pendulum():
    """tests/test_sac.py: two episodes of 30 steps, SAC updates from step
    40 on, every transition in the memory."""
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    agent = SACMPC(env, horizon=8, num_particles=32, batch_size=32, replay_capacity=1000,
                   seed=0)
    rewards = agent.train(n_steps=60, episode_length=30, min_buffer=40)
    assert len(rewards) == 2 and all(np.isfinite(r) for r in rewards)
    assert len(agent.memory) == 60 and len(agent.update_info) == 21


def test_sacq_eval_runs_its_three_arms():
    rows = sacq_eval.main(["--env", "SimplePendulum-v0", "--train_steps", "12", "--horizon",
                           "4", "--num_particles", "8", "--episodes", "1", "--episode_length",
                           "5", "--device", DEVICE])
    assert [r["arm"] for r in rows] == ["mppi", "mppiq", "mppiq+sacq"]
    assert all(np.isfinite(r["avg_reward"]) for r in rows)
