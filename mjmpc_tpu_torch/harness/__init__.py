"""Experiment harness: reference-schema YAML configs, episode runners,
solver-state checkpoints and the entry points run_mpc, run_mpc_cl, jobs,
sacq_eval, softq_diag, benchmark and forest_perf (counterpart of
mjmpc_tpu/harness/)."""
from .config import load_config, make_solver_for_env, solver_params_from_config
from .episode import build_episode_fn, run_episodes

__all__ = ["load_config", "solver_params_from_config", "make_solver_for_env",
           "build_episode_fn", "run_episodes"]
