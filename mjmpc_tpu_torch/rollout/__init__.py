from .engine import (Trajectories, make_rollout_fn, rollout_closed_loop_linear,
                     rollout_closed_loop_policy, rollout_open_loop)

__all__ = ["Trajectories", "make_rollout_fn", "rollout_closed_loop_linear",
           "rollout_closed_loop_policy", "rollout_open_loop"]
