"""Environment registry.

Counterpart of mjmpc_tpu/envs/__init__.py for the ported envs. Every env
module is imported directly: an ImportError from an in-repo module is a
bug and propagates, it is never swallowed. A name that the JAX package
registers but the port has not ported yet (NOT_PORTED) raises
NotImplementedError, as an unported controller does
(solvers.solver_class); a name neither package knows raises ValueError.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import half_cheetah, pen, pendulum, reacher_7dof, sawyer_tasks, swimmer
from .base import Env

_REGISTRY: Dict[str, Callable[..., Env]] = {
    "SimplePendulum-v0": pendulum.make,
    "reacher_7dof-v0": reacher_7dof.make,
    "continual_reacher-v0": reacher_7dof.make_continual,
    # the sawyer and panda reacher configs plan on the same 7-DOF arm
    "sawyer_reacher-v0": reacher_7dof.make,
    "panda_reacher-v0": reacher_7dof.make,
    "sawyer_peg_insertion-v0": sawyer_tasks.make_peg_insertion,
    "sawyer_peg_insertion-v1": sawyer_tasks.make_peg_insertion_v1,
    "Swimmer-v0": swimmer.make,
    "HalfCheetah-v0": half_cheetah.make,
    "pen-v0": pen.make,
}

# Envs of the JAX package's registry that the port lacks so far.
NOT_PORTED = (
    "LQR-v0", "acrobot-v0", "cartpole-v0", "continual_maze-v0", "door-v0", "hammer-v0",
    "maze-v0", "mjrl_point_mass-v0", "panda_tray_glass-v0", "panda_tray_glass-v1",
    "panda_tray_glass_fixed-v1", "point_mass-v0", "pusher-v0", "relocate-v0",
    "sawyer_door-v0", "sawyer_pusher-v0", "trajopt_reacher-v0",
)

_CACHE: Dict[Tuple[str, str], Env] = {}


def register(name: str, factory: Callable[..., Env]) -> None:
    """Register (or replace) `factory(device=..., **kwargs) -> Env` under
    `name`; a replaced name's cached envs are dropped."""
    _REGISTRY[name] = factory
    for key in [k for k in _CACHE if k[0] == name]:
        del _CACHE[key]


def make(name: str, device="cuda", **kwargs) -> Env:
    """Build (or fetch) an env on `device` (the card unless the caller asks
    for the CPU). Calls without other kwargs are cached per (name, device),
    so repeated makes reuse one env and its built kernels."""
    if name not in _REGISTRY:
        if name in NOT_PORTED:
            raise NotImplementedError(f"env {name!r} is not ported to PyTorch yet; "
                                      f"ported: {sorted(_REGISTRY)}")
        raise ValueError(f"unknown env {name!r}; known: {sorted(_REGISTRY)}")
    if kwargs:
        return _REGISTRY[name](device=device, **kwargs)
    key = (name, str(torch.device(device)))
    env = _CACHE.get(key)
    if env is None:
        env = _CACHE[key] = _REGISTRY[name](device=device)
    return env


def available() -> list:
    return sorted(_REGISTRY)


__all__ = ["Env", "NOT_PORTED", "make", "register", "available"]
