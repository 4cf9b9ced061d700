"""RL sidecar (counterpart of mjmpc_tpu/rl/): replay memories, SAC and
SAC-guided MPC."""
from .replay import ReplayMemory, ReplayMemoryTraj
from .sac import SAC, AdamState, GaussianPolicy, QNetwork, SACParams, adam_init, adam_step
from .sac_mpc import SACMPC

__all__ = ["ReplayMemory", "ReplayMemoryTraj", "SAC", "SACParams", "GaussianPolicy",
           "QNetwork", "AdamState", "adam_init", "adam_step", "SACMPC"]
