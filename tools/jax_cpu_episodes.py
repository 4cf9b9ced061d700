"""The JAX package's own episodes on the CPU for the configs whose port
results differ from the JAX records (RESULTS.md:29, 216, 219): the
reference's spread across seeds, against which the port's card episodes
(tools/analytic_episodes.py) are read.

    JAX_PLATFORMS=cpu python3 tools/jax_cpu_episodes.py [--only NAME ...]

CPU only: it sets JAX_PLATFORMS=cpu before jax is imported and never runs
on the card. One JSON line per result, then {"ok": true}:

- trajopt_reacher: configs/trajopt_reacher-v0.yml as it is (3 episodes x
  200 steps, seeds 123 + 12345 i) with mppi and random_shooting through
  mjmpc_tpu.harness.episode.run_episodes: each episode's reward;
- acrobot: configs/classic_control/acrobot-v0.yml's mppi (3 x 75): each
  episode's reward and its last step's reward (the tip height less the
  control cost);
- peg_cl: run_mpc_cl's Reinforce on
  configs/sawyer/sawyer_peg_insertion-v0_cl.yml (2 episodes x 75, the JAX
  solve with its general rollout, fused=False, since the Pallas kernel has
  no fast CPU mode): each episode's reward and its baseline fit errors.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parent.parent
RESULTS = ("trajopt_reacher", "acrobot", "peg_cl")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--only", nargs="*", choices=RESULTS, default=list(RESULTS))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    from mjmpc_tpu import envs, solvers
    from mjmpc_tpu.harness import config as jcfg
    from mjmpc_tpu.harness.episode import run_episodes
    from mjmpc_tpu.harness.run_mpc_cl import build_cl_solver

    def episodes(path, controller):
        exp = jcfg.load_config(str(ROOT / path))
        env = envs.make(exp["env_name"])
        solver = jcfg.make_solver_for_env(exp, controller, env)
        out = run_episodes(solver, env, exp["n_episodes"], exp["max_ep_length"],
                           base_seed=exp["seed"])
        rewards = np.asarray(out["rewards"])
        return dict(config=path, controller=controller, ep_rewards=rewards.sum(1).tolist(),
                    last_step_rewards=rewards[:, -1].tolist(),
                    success_metric=out["success_metric"])

    if "trajopt_reacher" in args.only:
        for controller in ("mppi", "random_shooting"):
            print(json.dumps(dict(result="trajopt_reacher", device="cpu",
                                  **episodes("configs/trajopt_reacher-v0.yml", controller))),
                  flush=True)
    if "acrobot" in args.only:
        print(json.dumps(dict(result="acrobot", device="cpu", **episodes(
            "configs/classic_control/acrobot-v0.yml", "mppi"))), flush=True)
    if "peg_cl" in args.only:
        exp = jcfg.load_config(str(ROOT / "configs/sawyer/sawyer_peg_insertion-v0_cl.yml"))
        env = envs.make(exp["env_name"])
        solver = build_cl_solver(exp, "reinforce", env)
        solve = jax.jit(solvers.make_solve_fn(solver, env, fused=False))
        step = jax.jit(env.step)
        for ep in range(2):
            key = jax.random.PRNGKey(exp["seed"] + ep * 12345)
            es = env.init(env.params, jax.random.fold_in(key, 0))
            ss = solver.init_state(jax.random.fold_in(key, 1))
            total, fits = 0.0, []
            for _ in range(exp["max_ep_length"]):
                action, _, ss = solve(env.params, es, ss)
                es, _, reward, _ = step(env.params, es, env.clip_action(action))
                total += float(reward)
                fits.append(float(ss.fit_error))
            print(json.dumps(dict(result="peg_cl", device="cpu", episode=ep, ep_reward=total,
                                  final_fit_error=fits[-1], max_fit_error=max(fits),
                                  steps=exp["max_ep_length"])), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
