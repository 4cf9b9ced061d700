"""The JAX package's own episodes on the CPU for the configs whose port
results differ from the JAX records (RESULTS.md:29, 104, 109, 210, 213,
216, 219): the reference's spread across seeds, against which the port's
card episodes (tools/analytic_episodes.py, tools/episode_refs.py) are
read.

    JAX_PLATFORMS=cpu python3 tools/jax_cpu_episodes.py [--only NAME ...] [--episodes N]

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
  no fast CPU mode): each episode's reward and its baseline fit errors;
- pusher, tray_v0, hammer, door: mppi on configs/sawyer/sawyer_pusher-v0.yml,
  configs/panda/tray_glass-v0.yml, configs/hand/hammer-v0.yml and
  configs/hand/door-v0.yml at each config's own protocol (n_episodes x
  max_ep_length, episode key PRNGKey(seed + 12345 i) split into the env's
  and the solver's key as run_episodes splits it, solves under
  guard_finite), solved through make_solve_fn(..., fused=False) in a host
  loop: one line per episode (its reward and its count of goal-achieved
  steps), then one line with the success_metric (the share of episodes
  with more than 10 such steps). `--episodes N` runs the first N episodes
  only. CPU time per episode on an 8-core x86 host, two such processes
  side by side: pusher about 1 minute, tray_v0 about 3.5, hammer about
  17 and door 21-26 (door's first solve compiles for about 50 s).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parent.parent
RESULTS = ("trajopt_reacher", "acrobot", "peg_cl", "pusher", "tray_v0", "hammer",
           "door")
HAND_CONFIGS = {"pusher": "configs/sawyer/sawyer_pusher-v0.yml",
                "tray_v0": "configs/panda/tray_glass-v0.yml",
                "hammer": "configs/hand/hammer-v0.yml",
                "door": "configs/hand/door-v0.yml"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--only", nargs="*", choices=RESULTS, default=list(RESULTS))
    p.add_argument("--episodes", type=int, default=None,
                   help="run the first N episodes of the pusher/tray_v0/hammer/door results")
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
    for name in [n for n in RESULTS if n in HAND_CONFIGS and n in args.only]:
        path = HAND_CONFIGS[name]
        exp = jcfg.load_config(str(ROOT / path))
        env = envs.make(exp["env_name"])
        solver = jcfg.make_solver_for_env(exp, "mppi", env)
        solve = jax.jit(solvers.guard_finite(
            solvers.make_solve_fn(solver, env, fused=False), solver))
        step = jax.jit(env.step)
        success = jax.jit(env.success)
        n_eps = min(args.episodes or exp["n_episodes"], exp["n_episodes"])
        counts = []
        for ep in range(n_eps):
            t0 = time.time()
            env_key, solver_key = jax.random.split(jax.random.PRNGKey(exp["seed"] + ep * 12345))
            es = env.init(env.params, env_key)
            ss = solver.init_state(solver_key)
            total, n_succ = 0.0, 0
            for _ in range(exp["max_ep_length"]):
                action, _, ss = solve(env.params, es, ss)
                es, _, reward, _ = step(env.params, es, env.clip_action(action))
                total += float(reward)
                n_succ += int(success(env.params, es))
            counts.append(n_succ)
            print(json.dumps(dict(result=name, device="cpu", config=path, controller="mppi",
                                  episode=ep, ep_reward=total, success_steps=n_succ,
                                  steps=exp["max_ep_length"],
                                  seconds=time.time() - t0)), flush=True)
        print(json.dumps(dict(result=name, device="cpu", config=path, episodes=n_eps,
                              success_metric=100.0 * float(np.mean(np.asarray(counts) > 10)))),
              flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
