"""Closed-loop MPC entry point (counterpart of mjmpc_tpu/harness/run_mpc_cl.py,
reference examples/example_mpc_cl.py): the ICLR'21 actor/critic path.

Usage:
    python -m mjmpc_tpu_torch.harness.run_mpc_cl \\
        --config configs/sawyer/sawyer_peg_insertion-v0_cl.yml \\
        [--controller reinforce] [--save_dir DIR] [--device cuda]

build_cl_solver reads the config's actor_params and critic_params: the
linear-Gaussian actor's init_log_std sets the default action variance
(init_cov = exp(2 init_log_std)) and the critic_type names the baseline
value function (value_functions.REGISTRY), fit inside every solve. Each
episode runs the solver in the loop (harness/episode.py), and its final
baseline fit error is read once, on the host, after the episode; the log
records each episode's reward and fit error and their averages
(AvgBaselineFitError).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from datetime import datetime

import numpy as np

from .. import envs, solvers
from ..utils import get_logger, timeit
from . import config as cfg
from .episode import build_episode_fn


def build_cl_solver(exp_params, controller_name, env):
    """The closed-loop solver of the config's controller section, its
    actor and its critic."""
    params = cfg.solver_params_from_config(exp_params, controller_name, env)
    actor = exp_params.get("actor_params", {})
    critic = exp_params.get("critic_params", {})
    if actor.get("actor_type", "linear_gaussian") != "linear_gaussian":
        raise ValueError("only linear_gaussian actor is supported "
                         "(reference example_mpc_cl.py:84-90)")
    init_log_std = float(actor.get("init_log_std", 0.0))
    params.setdefault("init_cov", float(np.exp(2.0 * init_log_std)))
    # critic_type names match value_functions.REGISTRY directly
    params["baseline_type"] = critic.get("critic_type")
    return solvers.make_solver(controller_name, **params)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Closed-loop MPC driver")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--controller", type=str, default="reinforce")
    parser.add_argument("--save_dir", type=str, default=tempfile.gettempdir())
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the env and the solver")
    args = parser.parse_args(argv)

    exp_params = cfg.load_config(args.config)
    env = envs.make(exp_params["env_name"], device=args.device)
    date_time = datetime.now().strftime("%m_%d_%Y_%H_%M_%S")

    results = {}
    for controller_name in args.controller.split(","):
        controller_name = controller_name.strip()
        log_dir = os.path.join(args.save_dir, exp_params["env_name"], date_time,
                               controller_name + "_cl")
        os.makedirs(log_dir, exist_ok=True)
        logger = get_logger(f"{controller_name}_cl_{exp_params['env_name']}", log_dir)

        solver = build_cl_solver(exp_params, controller_name, env)
        episode = build_episode_fn(solver, env, exp_params["max_ep_length"])

        n_episodes = exp_params["n_episodes"]
        ep_rewards = np.zeros(n_episodes)
        fit_errors = np.zeros(n_episodes)
        timeit.start("cl_" + controller_name)
        for i in range(n_episodes):
            records, _, final_state = episode(env.params, env.params,
                                              exp_params["seed"] + i * 12345)
            ep_rewards[i] = float(records["reward"].sum())
            fit_error = getattr(final_state, "fit_error", None)
            fit_errors[i] = 0.0 if fit_error is None else float(fit_error)
            logger.info("episode %d reward %.3f baseline fit err %.4f",
                        i, ep_rewards[i], fit_errors[i])
        timeit.stop("cl_" + controller_name)

        logger.record_tabular("EpisodeReward", ep_rewards.tolist())
        logger.record_tabular("AverageReward", float(ep_rewards.mean()))
        logger.record_tabular("StdReward", float(ep_rewards.std()))
        logger.record_tabular("AvgBaselineFitError", float(fit_errors.mean()))
        logger.record_tabular("NumEpisodes", n_episodes)
        logger.dump_tabular()
        logger.info("\n%s", timeit.report())
        results[controller_name] = dict(ep_rewards=ep_rewards, fit_errors=fit_errors,
                                        log_dir=log_dir)
    return results


if __name__ == "__main__":
    main()
