from .engine import Trajectories, rollout_closed_loop_linear, rollout_open_loop

__all__ = ["Trajectories", "rollout_closed_loop_linear", "rollout_open_loop"]
