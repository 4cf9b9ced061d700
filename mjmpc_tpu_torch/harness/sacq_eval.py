"""MPPIQ-with-learned-Q experiment driver (counterpart of
mjmpc_tpu/harness/sacq_eval.py): train SACMPC (MPC collects, SAC fits the
twin Q, -min(Q1, Q2) feeds MPPIQ's blended returns), then run three arms
at the same horizon, particle count and seeds with the episode runner:

  mppi        -- plain MPPI (lam = beta)
  mppiq       -- MPPIQ without a Q (terminal-cost TD(lambda) blending)
  mppiq+sacq  -- MPPIQ with the SAC-trained -min(Q1, Q2)

Usage:
  python -m mjmpc_tpu_torch.harness.sacq_eval --env reacher_7dof-v0 \\
      --train_steps 1500 --horizon 16 --num_particles 100 --episodes 3 [--device cuda]

The short horizon is the point: value blending is claimed to recover
long-horizon behaviour from truncated rollouts, and all arms at the same
short horizon isolate what the learned value adds. Prints one JSON line
for the training rewards and one per arm; main returns the arms' rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from .. import envs, solvers
from ..rl.sac_mpc import SACMPC
from .episode import run_episodes


def _eval_arm(name, solver, env, episodes, episode_length, seed):
    out = run_episodes(solver, env, episodes, episode_length, base_seed=seed)
    rew = np.asarray(out["rewards"]).sum(axis=1)
    row = dict(arm=name, avg_reward=round(float(rew.mean()), 1),
               std_reward=round(float(rew.std()), 1), success_pct=out["success_metric"])
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="pen-v0")
    p.add_argument("--train_steps", type=int, default=1500)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--num_particles", type=int, default=100)
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--episode_length", type=int, default=None)
    p.add_argument("--beta", type=float, default=0.15)
    p.add_argument("--td_lam", type=float, default=0.9)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--init_cov", type=float, default=0.3)
    p.add_argument("--updates_per_step", type=int, default=1,
                   help="SAC gradient updates per environment step; raise above 1 to fit "
                        "harder on small data budgets")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the env, the solvers and SAC")
    args = p.parse_args(argv)

    env = envs.make(args.env, device=args.device)
    ep_len = args.episode_length or env.max_episode_steps or 100

    m = SACMPC(env=env, horizon=args.horizon, num_particles=args.num_particles,
               beta=args.beta, td_lam=args.td_lam, gamma=args.gamma, init_cov=args.init_cov,
               updates_per_step=args.updates_per_step, seed=args.seed)
    train_rewards = m.train(args.train_steps, episode_length=ep_len)
    print(json.dumps({"train_episode_rewards": [round(r, 1) for r in train_rewards]}),
          flush=True)

    # the trained Q, frozen: no more SAC updates reach the planner
    mppiq_sacq = dataclasses.replace(m.solver, q_fn=m.q_fn_of(m.sac_params.q))
    mppiq_plain = dataclasses.replace(m.solver, q_fn=None)
    mppi = solvers.MPPI(
        d_action=env.d_action, horizon=args.horizon, num_particles=args.num_particles,
        lam=args.beta, init_cov=args.init_cov, step_size=m.solver.step_size,
        gamma=m.solver.gamma, alpha=m.solver.alpha, filter_coeffs=m.solver.filter_coeffs,
        base_action=m.solver.base_action, device=env.device)
    return [_eval_arm("mppi", mppi, env, args.episodes, ep_len, args.seed),
            _eval_arm("mppiq", mppiq_plain, env, args.episodes, ep_len, args.seed),
            _eval_arm("mppiq+sacq", mppiq_sacq, env, args.episodes, ep_len, args.seed)]


if __name__ == "__main__":
    main()
