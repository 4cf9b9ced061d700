"""Least-squares value-function baselines (counterpart of
mjmpc_tpu/value_functions/)."""
from .vf import REGISTRY, ValueFunction, VFParams, make_vf

__all__ = ["REGISTRY", "ValueFunction", "VFParams", "make_vf"]
