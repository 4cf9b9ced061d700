"""Episode results of the analytic envs and the closed-loop configs on the
card, for comparison with the JAX package's records (RESULTS.md:29,216-220).

    python3 tools/analytic_episodes.py [--device cuda] [--only NAME ...] \
        [--episodes N] [--trajopt-controllers mppi,random_shooting,cem]

One JSON line per result, each beside the card's name and power limit
(nvidia-smi), then a last line {"ok": true}:

- trajopt_reacher: configs/trajopt_reacher-v0.yml as it is (3 episodes x
  200 steps) with mppi, random_shooting and cem: the average episode reward
  and the success metric (JAX -6.2 / -5.9 / -6.4, 100% each);
- acrobot: configs/classic_control/acrobot-v0.yml's mppi (3 x 75 steps):
  the tip height at the start and the end of each episode and its maximum
  (JAX -1.45 -> +1.64);
- cartpole_cl: run_mpc_cl on configs/cartpole-v0_cl.yml (3 x 100): each
  episode's reward and baseline fit error (JAX fit error <= 0.12);
- maze: continual_maze-v0 with the JAX package's maze MPPI (N=256, H=24,
  lam 0.05, init_cov 0.6, step 0.7, filter (0.25, 0.8, 0), base action
  repeat), one 150-step episode per seed: the steps in the goal region
  (JAX 84 / 150);
- peg_cl: run_mpc_cl on configs/sawyer/sawyer_peg_insertion-v0_cl.yml (1 x
  75): reward and fit error (JAX -40.4, 1.45);
- profile: the analytic runs of chip_smoke.py whose solves make tens of
  thousands of launches (every controller of ANALYTIC_CONFIGS but
  LIGHT_PROFILES, iLQR on LQR, MPPI on the continual maze across its
  switch): read-verified solves/s over one window of 2 solves and
  chip_smoke.profile over one solve after one warm-up (`profile` lines:
  kernels and device ms per solve, busy share).

--episodes cuts the trajopt_reacher and acrobot runs to N episodes each:
their planning runs the chain engine's eager steps (about 2 s a control
step on trajopt_reacher, 4 s on acrobot; NVIDIA H100 80GB HBM3, 700 W).
The RNG streams differ from the JAX package's, so a result is one draw,
not a replay of the JAX episode. Without CUDA (and no --device cpu) it
exits 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RESULTS = ("trajopt_reacher", "acrobot", "cartpole_cl", "maze", "peg_cl", "profile")
MAZE_MPPI = dict(horizon=24, num_particles=256, lam=0.05, init_cov=0.6, step_size=0.7,
                 gamma=1.0, filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat")
MAZE_STEPS = 150
MAZE_SEEDS = (0, 1, 2)


def emit(result: str, card: str, **fields) -> None:
    print(json.dumps({"result": result, "card": card, **fields}), flush=True)


def profile_heavy_runs(device, card: str) -> None:
    """The `profile` result (module docstring)."""
    import dataclasses
    import chip_smoke
    from mjmpc_tpu_torch import envs, rng, solvers
    from mjmpc_tpu_torch.envs.lqr import LQRState
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import run_mpc_cl
    from mjmpc_tpu_torch.harness.benchmark import solves_per_s
    import torch
    runs = []
    for path, controllers in chip_smoke.ANALYTIC_CONFIGS.items():
        exp = hconfig.load_config(path)
        e = envs.make(exp["env_name"], device=device)
        for c in controllers:
            if (e.name, c) in chip_smoke.LIGHT_PROFILES:
                continue
            s = (run_mpc_cl.build_cl_solver(exp, c, e) if "actor_params" in exp
                 else hconfig.make_solver_for_env(exp, c, e))
            runs.append((path, c, s, e, e.init(e.params, 1)))
    lqr = envs.make("LQR-v0", device=device)
    runs.append(("LQR-v0", "ilqr", solvers.ILQR(d_action=1, horizon=chip_smoke.LQR_H, n_iters=3,
                                                mu=1e-6, device=device), lqr,
                 LQRState(x=torch.tensor(chip_smoke.LQR_X0, device=device))))
    maze = envs.make("continual_maze-v0", device=device)
    runs.append(("continual_maze-v0", "mppi",
                 solvers.MPPI(d_action=2, device=device, **chip_smoke.MAZE_MPPI), maze,
                 dataclasses.replace(maze.init(maze.params, 1),
                                     timestep=rng.step_tensor(chip_smoke.MAZE_START, device))))
    for path, c, s, e, es in runs:
        solve = solvers.make_solve_fn(s, e)
        rate, windows, _ = solves_per_s(solve, e, es, s.init_state(0), 2, 1)
        emit("profile_rate", card, config=path, env=e.name, controller=c,
             n=getattr(s, "num_particles", 1), h=s.horizon, n_iters=s.n_iters,
             solves_per_s=rate, windows=windows)
        chip_smoke.profile(solve, e, es, s.init_state(0), card, 1, 1, solver=c, env=e.name,
                           config=path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--only", nargs="*", default=list(RESULTS), choices=RESULTS)
    parser.add_argument("--episodes", type=int, default=None,
                        help="episodes of trajopt_reacher and acrobot (default: the config's)")
    parser.add_argument("--trajopt-controllers", default="mppi,random_shooting,cem")
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("analytic_episodes: no CUDA device", file=sys.stderr)
        return 1
    from mjmpc_tpu_torch import envs, solvers
    from mjmpc_tpu_torch.envs import acrobot
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import run_mpc_cl
    from mjmpc_tpu_torch.harness.episode import run_episodes

    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device(args.device)

    if "trajopt_reacher" in args.only:
        exp = hconfig.load_config("configs/trajopt_reacher-v0.yml")
        env = envs.make(exp["env_name"], device=device)
        episodes = args.episodes or exp["n_episodes"]
        for controller in args.trajopt_controllers.split(","):
            solver = hconfig.make_solver_for_env(exp, controller, env)
            t0 = time.perf_counter()
            out = run_episodes(solver, env, n_episodes=episodes,
                               episode_length=exp["max_ep_length"], base_seed=exp["seed"])
            emit("trajopt_reacher", card, controller=controller, n=solver.num_particles,
                 h=solver.horizon, episodes=episodes, steps=exp["max_ep_length"],
                 ep_rewards=out["ep_rewards"].tolist(), average_reward=out["average_reward"],
                 success_metric=out["success_metric"], seconds=time.perf_counter() - t0)

    if "acrobot" in args.only:
        exp = hconfig.load_config("configs/classic_control/acrobot-v0.yml")
        env = envs.make(exp["env_name"], device=device)
        solver = hconfig.make_solver_for_env(exp, "mppi", env)
        episodes = args.episodes or exp["n_episodes"]
        t0 = time.perf_counter()
        out = run_episodes(solver, env, n_episodes=episodes,
                           episode_length=exp["max_ep_length"], base_seed=exp["seed"])
        tips = []
        for i, states in enumerate(out["states"]):
            start = env.init(env.params, exp["seed"] + i * 12345)   # run_episodes' seeding
            qpos = torch.as_tensor(states.qpos, device=device)
            tip = acrobot.tip_height(env.params,
                                     acrobot.AcrobotState(qpos, torch.zeros_like(qpos)))
            tips.append(dict(start=float(acrobot.tip_height(env.params, start)),
                             end=float(tip[-1]), max=float(tip.max())))
        emit("acrobot", card, controller="mppi", n=solver.num_particles, h=solver.horizon,
             episodes=episodes, steps=exp["max_ep_length"], tip_height=tips,
             ep_rewards=out["ep_rewards"].tolist(), seconds=time.perf_counter() - t0)

    for key, config in (("cartpole_cl", "configs/cartpole-v0_cl.yml"),
                        ("peg_cl", "configs/sawyer/sawyer_peg_insertion-v0_cl.yml")):
        if key not in args.only:
            continue
        exp = hconfig.load_config(config)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out_dir:
            out = run_mpc_cl.main(["--config", config, "--device", args.device,
                                   "--save_dir", out_dir])["reinforce"]
        emit(key, card, config=config, episodes=exp["n_episodes"], steps=exp["max_ep_length"],
             ep_rewards=out["ep_rewards"].tolist(), fit_errors=out["fit_errors"].tolist(),
             seconds=time.perf_counter() - t0)

    if "profile" in args.only:
        profile_heavy_runs(device, card)

    if "maze" in args.only:
        env = envs.make("continual_maze-v0", device=device)
        solver = solvers.MPPI(d_action=2, device=device, **MAZE_MPPI)
        episode = solvers.evaluate_episode(solver, env, MAZE_STEPS)
        for seed in MAZE_SEEDS:
            t0 = time.perf_counter()
            out = episode(env.params, seed)
            emit("maze", card, env=env.name, controller="mppi", seed=seed, steps=MAZE_STEPS,
                 steps_in_goal=int(out["success"].sum()),
                 ep_reward=float(out["reward"].sum()), seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
