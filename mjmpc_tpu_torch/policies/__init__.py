"""Policy API (counterpart of mjmpc_tpu/policies/ for the ported
controllers)."""
from .base import Policy
from .linear_gaussian import LGPolicyParams, LinearGaussianPolicy
from .mpc_policy import MPCPolicy
from .random_policy import RandomPolicy

__all__ = ["Policy", "MPCPolicy", "RandomPolicy", "LinearGaussianPolicy", "LGPolicyParams"]
