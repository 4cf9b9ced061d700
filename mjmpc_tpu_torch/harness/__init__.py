"""Experiment harness: reference-schema YAML configs and episode runners
(counterpart of mjmpc_tpu/harness/; the tune/sweep jobs and checkpoints
are not ported yet)."""
from .config import load_config, make_solver_for_env, solver_params_from_config
from .episode import build_episode_fn, run_episodes

__all__ = ["load_config", "solver_params_from_config", "make_solver_for_env",
           "build_episode_fn", "run_episodes"]
