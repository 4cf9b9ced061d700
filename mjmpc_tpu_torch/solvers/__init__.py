"""Solvers: the open-loop family (GaussianMPC: MPPI, MPPIQ, RandomShooting,
CEM, DMD), PFMPC, the closed-loop Reinforce and iLQR, and the learned-model
family (SoftQMPC, RandomShootingNN), with the registry of
mjmpc_tpu/solvers/__init__.py."""
from .base import (GaussianBatch, GaussianMPC, GaussianState, build_batched_solve_fn,
                   build_optimal_value_fn, build_solve_fn, check_batchable, evaluate_episode,
                   guard_finite, map_tensors, stack_states, tensor_leaves)
from .cem import CEM
from .dmd import DMDMPC
from .ilqr import ILQR, ILQRState
from .ilqr import build_solve_fn as build_ilqr_solve_fn
from .mppi import MPPI
from .mppiq import MPPIQ
from .pfmpc import PFMPC, PFState
from .pfmpc import build_solve_fn as build_pf_solve_fn
from .random_shooting import RandomShooting
from .reinforce import Reinforce, ReinforceState
from .reinforce import build_solve_fn as build_reinforce_solve_fn
from .random_shooting_nn import RandomShootingNN, RSNNState
from .random_shooting_nn import build_solve_fn as build_rsnn_solve_fn
from .softq import SoftQMPC, SoftQState
from .softq import build_solve_fn as build_softq_solve_fn

REGISTRY = {
    "mppi": MPPI,
    "mppiq": MPPIQ,
    "random_shooting": RandomShooting,
    "cem": CEM,
    "dmd": DMDMPC,
    "gaussian_dmd": DMDMPC,
    "pfmpc": PFMPC,
    "reinforce": Reinforce,
    "softqmpc": SoftQMPC,
    "softq": SoftQMPC,       # the reference configs' section name
    "random_shooting_nn": RandomShootingNN,
    "ilqr": ILQR,
}

# Controllers of the JAX package's registry that the port lacks: none since
# the learned-model family landed.
NOT_PORTED = ()


def solver_class(name: str):
    """The registry's class for `name`; NotImplementedError for a
    controller of the JAX package not ported yet, ValueError for an
    unknown one."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"controller {name!r} is not ported to PyTorch yet; "
                                  f"ported: {sorted(REGISTRY)}")
    if name not in REGISTRY:
        raise ValueError(f"unknown controller {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def make_solver(name: str, **params):
    return solver_class(name)(**params)


def make_solve_fn(solver, env, **kwargs):
    """Dispatch to the solve builder of the solver's family."""
    if isinstance(solver, PFMPC):
        kwargs.pop("calc_val", None)
        return build_pf_solve_fn(solver, env, **kwargs)
    if isinstance(solver, Reinforce):
        kwargs.pop("calc_val", None)
        kwargs.pop("hotstart", None)   # the reference's shift is a no-op
        return build_reinforce_solve_fn(solver, env, **kwargs)
    if isinstance(solver, (SoftQMPC, RandomShootingNN)):
        for k in ("calc_val", "hotstart", "fused"):   # no value, a fixed shift, no kernel
            kwargs.pop(k, None)
        build = build_softq_solve_fn if isinstance(solver, SoftQMPC) else build_rsnn_solve_fn
        return build(solver, env, **kwargs)
    if isinstance(solver, ILQR):
        for k in ("calc_val", "hotstart", "fused"):   # iLQR samples and fuses nothing
            kwargs.pop(k, None)
        return build_ilqr_solve_fn(solver, env, **kwargs)
    if isinstance(solver, GaussianMPC):
        return build_solve_fn(solver, env, **kwargs)
    raise NotImplementedError(f"no solve builder ported for {type(solver).__name__}")


__all__ = [
    "GaussianMPC", "GaussianState", "GaussianBatch", "build_solve_fn",
    "build_batched_solve_fn", "check_batchable", "stack_states", "evaluate_episode",
    "build_optimal_value_fn", "guard_finite", "MPPI", "MPPIQ", "RandomShooting",
    "CEM", "DMDMPC", "PFMPC", "PFState", "Reinforce", "ReinforceState", "ILQR",
    "ILQRState", "SoftQMPC", "SoftQState", "RandomShootingNN", "RSNNState",
    "tensor_leaves", "map_tensors", "REGISTRY",
    "NOT_PORTED", "solver_class", "make_solver", "make_solve_fn",
]
