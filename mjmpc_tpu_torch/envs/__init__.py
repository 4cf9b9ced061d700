"""Environment registry.

Counterpart of mjmpc_tpu/envs/__init__.py for the ported envs. Every env
module is imported directly: an ImportError from an in-repo module is a
bug and propagates, it is never swallowed. A name that the JAX package
registers but the port has not ported (NOT_PORTED, empty since every
name is ported) raises NotImplementedError, as an unported controller does
(solvers.solver_class); a name neither package knows raises ValueError.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import (acrobot, cartpole, half_cheetah, hammer, hand_door, lqr, maze, panda_tasks, pen,
               pendulum, point_mass, reacher_7dof, relocate, sawyer_tasks, swimmer,
               trajopt_reacher)
from .base import Env
from .randomize import randomize_batch, randomize_dynamics, register_names, register_param_paths
from .wrappers import frame_stack, normalize_obs

_REGISTRY: Dict[str, Callable[..., Env]] = {
    "SimplePendulum-v0": pendulum.make,
    "reacher_7dof-v0": reacher_7dof.make,
    "continual_reacher-v0": reacher_7dof.make_continual,
    # the sawyer and panda reacher configs plan on the same 7-DOF arm
    "sawyer_reacher-v0": reacher_7dof.make,
    "panda_reacher-v0": reacher_7dof.make,
    "sawyer_peg_insertion-v0": sawyer_tasks.make_peg_insertion,
    "sawyer_peg_insertion-v1": sawyer_tasks.make_peg_insertion_v1,
    "sawyer_pusher-v0": sawyer_tasks.make_pusher,
    "pusher-v0": sawyer_tasks.make_pusher,
    "sawyer_door-v0": sawyer_tasks.make_door,
    "panda_tray_glass-v0": panda_tasks.make,
    "panda_tray_glass-v1": panda_tasks.make_v1,
    "panda_tray_glass_fixed-v1": panda_tasks.make_fixed_v1,
    "Swimmer-v0": swimmer.make,
    "HalfCheetah-v0": half_cheetah.make,
    "pen-v0": pen.make,
    "relocate-v0": relocate.make,
    "hammer-v0": hammer.make,
    "door-v0": hand_door.make,
    "LQR-v0": lqr.make,
    "point_mass-v0": point_mass.make,
    # the point-mass config names the mjrl-registered id
    "mjrl_point_mass-v0": point_mass.make,
    "cartpole-v0": cartpole.make,
    "acrobot-v0": acrobot.make,
    "trajopt_reacher-v0": trajopt_reacher.make,
    "maze-v0": maze.make,
    "continual_maze-v0": maze.make_continual,
}

# Envs of the JAX package's registry that the port lacks: none.
NOT_PORTED: Tuple[str, ...] = ()

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


__all__ = ["Env", "NOT_PORTED", "make", "register", "available", "randomize_dynamics",
           "randomize_batch", "register_names", "register_param_paths", "normalize_obs",
           "frame_stack"]
