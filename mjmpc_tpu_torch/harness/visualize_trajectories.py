"""Replay optimized trajectories as videos (counterpart of
mjmpc_tpu/harness/visualize_trajectories.py; reference
examples/visualize_trajectories.py:23-26 unpickles trajectories and
replays them through the mujoco viewer). Episodes are deterministic in
(config, seed), so the tool runs the config's episodes again and renders
the recorded states, one GIF per episode.

Usage:
    python -m mjmpc_tpu_torch.harness.visualize_trajectories \\
        --config cfg.yml --controller mppi --out /tmp/vids [--episodes N] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from .. import envs, render
from . import config as cfg
from .episode import run_episodes


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--controller", type=str, default="mppi")
    parser.add_argument("--out", type=str,
                        default=os.path.join(tempfile.gettempdir(), "mjmpc_vids"))
    parser.add_argument("--episodes", type=int, default=None,
                        help="number of episodes to render")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the env and the solver")
    args = parser.parse_args(argv)

    exp = cfg.load_config(args.config)
    env = envs.make(exp["env_name"], device=args.device)
    solver = cfg.make_solver_for_env(exp, args.controller, env)
    n_eps = args.episodes or exp["n_episodes"]
    out = run_episodes(solver, env, n_episodes=n_eps, episode_length=exp["max_ep_length"],
                       base_seed=exp["seed"])
    paths = render.dump_videos(env, out["states"], args.out)
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
