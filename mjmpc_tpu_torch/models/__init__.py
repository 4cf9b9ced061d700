"""Learnable models (counterpart of mjmpc_tpu/models/): the quadratic Q
function, the batched-ensemble MLP and the MLP policy, as plain functions
over NamedTuples of tensors (pytrees for torch.func)."""
from .ensemble import EnsembleLayerParams, EnsembleMLP, init_ensemble
from .mlp import MLPLayerParams, MLPPolicy
from .quadratic_q import QuadraticQFunc, QuadraticQParams

__all__ = ["QuadraticQFunc", "QuadraticQParams", "EnsembleMLP", "EnsembleLayerParams",
           "init_ensemble", "MLPPolicy", "MLPLayerParams"]
