"""Open-loop MPC experiment entry point (counterpart of
mjmpc_tpu/harness/run_mpc.py, reference examples/example_mpc.py).

Usage:
    python -m mjmpc_tpu_torch.harness.run_mpc --config configs/Swimmer-v0.yml \
        --controller mppi [--dyn_randomize_config SPEC] [--save_dir DIR] \
        [--save_trajectories] [--checkpoint] [--dump_vids] [--device cuda]

The same flags and YAML schema as the JAX run_mpc, plus --device (the
card unless the caller asks for the CPU). With --dyn_randomize_config
(a spec of configs/dyn_randomize/) only the planner's model is perturbed,
from the config's seed (envs.randomize_dynamics): the real env stays
nominal, and the perturbed env plans on kernels built from its own
perturbed model. The config's episodes run as one batched episode where
the batched solve covers the controller and the planning env, else one
after another (harness/episode.py run_episodes, on the card a replayed
captured control step; the log says which); each controller's log
(.log and .csv) goes to <save_dir>/<env>/<date>/<controller>/, and with
--checkpoint the final solver state of every episode to solver_state.npz
and solver_state.manifest.json there (harness/checkpoint.py), and with
--dump_vids one GIF per episode, vid_traj_<i>.gif, drawn from the states
the episodes already read to the host (render/), so the episodes' records
are the same with the flag as without it. Every
controller's solver is built before the first episode runs, so a
controller or flag the port lacks, or a spec that names an unknown
field, raises before anything runs.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from datetime import datetime

import numpy as np
import yaml

from .. import envs, render
from ..utils import get_logger, timeit
from . import checkpoint
from . import config as cfg
from .episode import run_episodes


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run MPC algorithm on given environment")
    parser.add_argument("--config", type=str, required=True,
                        help="yaml file with experiment parameters")
    parser.add_argument("--dyn_randomize_config", type=str, default=None,
                        help="yaml file with dynamics randomization parameters "
                             "(perturbs the planner's model only)")
    parser.add_argument("--save_dir", type=str, default=tempfile.gettempdir(),
                        help="folder to save data in")
    parser.add_argument("--controller", type=str, default="mppi",
                        help="controller(s) to run, comma separated")
    parser.add_argument("--save_trajectories", action="store_true",
                        help="dump episode arrays to npz")
    parser.add_argument("--checkpoint", action="store_true",
                        help="save the final solver state of every episode")
    parser.add_argument("--dump_vids", action="store_true",
                        help="render episode videos (one GIF per episode)")
    parser.add_argument("--chunk_size", type=int, default=None,
                        help="accepted for the JAX run_mpc's command lines and has no "
                             "effect: it splits the JAX episode program into compile "
                             "units, and this entry point runs a host loop")
    parser.add_argument("--no_guard", action="store_true",
                        help="disable the NaN/Inf solve guard (failure recovery is ON "
                             "by default: a diverged solve re-initializes the control "
                             "distribution)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the envs and solvers")
    args = parser.parse_args(argv)

    exp_params = cfg.load_config(args.config)
    env = envs.make(exp_params["env_name"], device=args.device)
    sim_env = envs.make(exp_params.get("sim_env_name", exp_params["env_name"]),
                        device=args.device)

    names = [c.strip() for c in args.controller.split(",")]
    built = {c: cfg.make_solver_for_env(exp_params, c, env) for c in names}
    plan_env = sim_env
    if args.dyn_randomize_config is not None:
        with open(args.dyn_randomize_config) as f:
            dyn_params = yaml.safe_load(f)
        plan_env, defaults, randomized = envs.randomize_dynamics(
            sim_env, dyn_params, base_seed=exp_params["seed"])

    date_time = datetime.now().strftime("%m_%d_%Y_%H_%M_%S")
    results = {}
    for controller_name in names:
        log_dir = os.path.join(args.save_dir, exp_params["env_name"], date_time,
                               controller_name)
        os.makedirs(log_dir, exist_ok=True)
        logger = get_logger(f"{controller_name}_{exp_params['env_name']}", log_dir)

        solver = built[controller_name]
        if plan_env is not sim_env:
            logger.info("Default params = %s", defaults)
            logger.info("Randomized params = %s", randomized)
        logger.info("%s", exp_params[controller_name])

        timeit.start("start_" + controller_name)
        out = run_episodes(
            solver, env, n_episodes=exp_params["n_episodes"],
            episode_length=exp_params["max_ep_length"], base_seed=exp_params["seed"],
            sim_env=plan_env if plan_env is not env else None, guard=not args.no_guard)
        timeit.stop("start_" + controller_name)

        logger.info("%d episodes %s", exp_params["n_episodes"],
                    "as one batched episode" if out["batched"] else "one after another")
        logger.info("Avg. reward = %s, Std. Reward = %s, Success Metric = %s",
                    out["average_reward"], out["reward_std"], out["success_metric"])
        logger.record_tabular("EpisodeReward", out["ep_rewards"].tolist())
        logger.record_tabular("Horizon", solver.horizon)
        logger.record_tabular("AverageReward", out["average_reward"])
        logger.record_tabular("StdReward", out["reward_std"])
        logger.record_tabular("SuccessMetric", out["success_metric"])
        logger.record_tabular("NumEpisodes", exp_params["n_episodes"])
        logger.record_tabular("NumParticles", solver.num_particles)
        logger.dump_tabular()
        logger.info("\n%s", timeit.report())

        if args.save_trajectories:
            np.savez(os.path.join(log_dir, "trajectories.npz"), rewards=out["rewards"],
                     actions=out["actions"], successes=out["successes"])
        if args.checkpoint:
            checkpoint.save_solver_state(
                os.path.join(log_dir, "solver_state"), out["final_solver_states"],
                metadata=dict(controller=controller_name, env=env.name,
                              n_episodes=exp_params["n_episodes"]))
            logger.info("saved solver-state checkpoint")
        if args.dump_vids:
            try:
                paths = render.dump_videos(env, out["states"], log_dir)
                logger.info("dumped videos: %s", paths)
            except (ValueError, AttributeError) as e:
                logger.warning("video dump skipped: %s", e)
        out["log_dir"] = log_dir
        out["sim_params"] = plan_env.params
        out["real_params"] = env.params
        results[controller_name] = out
    return results


if __name__ == "__main__":
    main()
