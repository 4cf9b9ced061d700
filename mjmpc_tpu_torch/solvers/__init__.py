"""Solvers (ported family: GaussianMPC / MPPI)."""
from .base import (GaussianMPC, GaussianState, build_optimal_value_fn,
                   build_solve_fn, evaluate_episode)
from .mppi import MPPI


def make_solve_fn(solver, env, **kwargs):
    """Dispatch to the solve builder of the solver's family (only the
    GaussianMPC family is ported)."""
    if isinstance(solver, GaussianMPC):
        return build_solve_fn(solver, env, **kwargs)
    raise NotImplementedError(
        f"no solve builder ported for {type(solver).__name__}")


__all__ = [
    "GaussianMPC", "GaussianState", "build_solve_fn", "evaluate_episode",
    "build_optimal_value_fn", "MPPI", "make_solve_fn",
]
