from .engine import Trajectories, rollout_open_loop

__all__ = ["Trajectories", "rollout_open_loop"]
