"""Environment registry.

Counterpart of mjmpc_tpu/envs/__init__.py for the ported envs. Every env
module is imported directly: an ImportError from an in-repo module is a
bug and propagates, it is never swallowed.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import half_cheetah, pen, reacher_7dof, sawyer_tasks, swimmer
from .base import Env

_REGISTRY: Dict[str, Callable[..., Env]] = {
    "reacher_7dof-v0": reacher_7dof.make,
    "continual_reacher-v0": reacher_7dof.make_continual,
    "sawyer_peg_insertion-v0": sawyer_tasks.make_peg_insertion,
    "sawyer_peg_insertion-v1": sawyer_tasks.make_peg_insertion_v1,
    "Swimmer-v0": swimmer.make,
    "HalfCheetah-v0": half_cheetah.make,
    "pen-v0": pen.make,
}

_CACHE: Dict[Tuple[str, str], Env] = {}


def make(name: str, device="cuda", **kwargs) -> Env:
    """Build (or fetch) an env on `device` (the card unless the caller asks
    for the CPU). Calls without other kwargs are cached per (name, device),
    so repeated makes reuse one env and its built kernels."""
    if name not in _REGISTRY:
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


__all__ = ["Env", "make", "available"]
