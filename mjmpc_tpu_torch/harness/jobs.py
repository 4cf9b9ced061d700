"""Hyperparameter tune and sweep jobs (counterpart of
mjmpc_tpu/harness/jobs.py, reference examples/job_script.py).

- tune: the grid product of the list-valued entries of the controller
  section (job_script.py:151-285), restricted to `tune_keys` when given:
  every cell runs the config's episodes, the best cell by average reward
  is kept, and the grid stops early once a cell's success exceeds 95%;
  best_params.json holds the best cell and the history.
- sweep: paired lists (job_script.py:287-354): the i-th entries of every
  list run together; sweep_results.json holds every cell.

Genuinely list-valued fields (config._LIST_VALUED: filter_coeffs, a
per-dimension init_cov) are never grid axes. Each cell builds its solver
and runs its episodes one after another (harness/episode.py).

Usage:
    python -m mjmpc_tpu_torch.harness.jobs --config configs/tune/tray_glass-v0.yml \\
        --controller mppi [--job_mode tune|sweep] [--save_dir DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
from datetime import datetime
from typing import Any, Dict, List

import numpy as np

from .. import envs
from ..utils import get_logger
from . import config as cfg
from .episode import run_episodes


def _list_keys(section: Dict[str, Any], tune_keys) -> List[str]:
    """The section's grid axes: list-valued keys but the genuinely
    list-valued fields and tune_keys itself, within tune_keys if given."""
    return [k for k, v in section.items()
            if isinstance(v, list) and k not in cfg._LIST_VALUED and k != "tune_keys"
            and (tune_keys is None or k in tune_keys)]


def run_cell(exp_params, controller_name, env, overrides, sim_params=None) -> Dict[str, Any]:
    """The config's episodes with the controller section's entries replaced
    by `overrides`."""
    exp = dict(exp_params)
    exp[controller_name] = dict(exp_params[controller_name], **overrides)
    solver = cfg.make_solver_for_env(exp, controller_name, env)
    return run_episodes(solver, env, n_episodes=exp_params["n_episodes"],
                        episode_length=exp_params["max_ep_length"],
                        base_seed=exp_params["seed"], sim_params=sim_params)


def _row(overrides, out) -> Dict[str, Any]:
    return dict(params=overrides, average_reward=out["average_reward"],
                reward_std=out["reward_std"], success_metric=out["success_metric"])


def tune(exp_params, controller_name, env, log_dir, tune_keys=None,
         success_early_stop: float = 95.0):
    """Grid search over the list-valued controller params: (best, history)."""
    logger = get_logger(f"tune_{controller_name}", log_dir)
    section = exp_params[controller_name]
    keys = _list_keys(section, tune_keys)

    best = dict(reward=-np.inf, params=None)
    history = []
    for combo in itertools.product(*(section[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        out = run_cell(exp_params, controller_name, env, overrides)
        history.append(_row(overrides, out))
        logger.info("cell %s -> avg %.3f succ %.1f%%", overrides, out["average_reward"],
                    out["success_metric"])
        if out["average_reward"] > best["reward"]:
            best = dict(reward=out["average_reward"], params=overrides,
                        success=out["success_metric"])
        if out["success_metric"] > success_early_stop:
            logger.info("early stop: success %.1f%% > %.1f%%", out["success_metric"],
                        success_early_stop)
            break

    with open(os.path.join(log_dir, "best_params.json"), "w") as f:
        json.dump(dict(best=best, history=history), f, indent=2, default=float)
    return best, history


def sweep(exp_params, controller_name, env, log_dir, tune_keys=None):
    """Paired lists: the i-th entries of every list run together; the
    cells' rows."""
    logger = get_logger(f"sweep_{controller_name}", log_dir)
    section = exp_params[controller_name]
    keys = _list_keys(section, tune_keys)
    lengths = {len(section[k]) for k in keys}
    if len(lengths) > 1:
        raise ValueError(f"sweep lists must be equal length, got {lengths} for {keys}")
    n_cells = lengths.pop() if lengths else 1

    rows = []
    for i in range(n_cells):
        overrides = {k: section[k][i] for k in keys}
        out = run_cell(exp_params, controller_name, env, overrides)
        logger.record_tabular("Cell", i)
        for k, v in overrides.items():
            logger.record_tabular(k, v)
        logger.record_tabular("AverageReward", out["average_reward"])
        logger.record_tabular("StdReward", out["reward_std"])
        logger.record_tabular("SuccessMetric", out["success_metric"])
        logger.dump_tabular()
        rows.append(_row(overrides, out))
    with open(os.path.join(log_dir, "sweep_results.json"), "w") as f:
        json.dump(rows, f, indent=2, default=float)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description="tune/sweep jobs")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--controller", type=str, default="mppi")
    parser.add_argument("--job_mode", type=str, default=None,
                        help="tune | sweep (default: the config's job_mode)")
    parser.add_argument("--save_dir", type=str, default=tempfile.gettempdir())
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the env and the solvers")
    args = parser.parse_args(argv)

    exp_params = cfg.load_config(args.config)
    mode = args.job_mode or exp_params.get("job_mode", "sweep")
    if mode not in ("tune", "sweep"):
        raise ValueError(f"unknown job_mode {mode!r}")
    env = envs.make(exp_params["env_name"], device=args.device)

    date_time = datetime.now().strftime("%m_%d_%Y_%H_%M_%S")
    results = {}
    for controller_name in args.controller.split(","):
        controller_name = controller_name.strip()
        log_dir = os.path.join(args.save_dir, exp_params["env_name"], date_time, mode,
                               controller_name)
        os.makedirs(log_dir, exist_ok=True)
        # tune_keys lives inside the controller section in the reference
        # schema (job_script.py:170); a top-level one is the fallback
        tune_keys = exp_params[controller_name].get("tune_keys", exp_params.get("tune_keys"))
        run = tune if mode == "tune" else sweep
        results[controller_name] = run(exp_params, controller_name, env, log_dir,
                                       tune_keys=tune_keys)
    return results


if __name__ == "__main__":
    main()
