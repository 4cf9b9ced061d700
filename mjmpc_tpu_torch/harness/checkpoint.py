"""Solver-state checkpoint and resume.

Counterpart of mjmpc_tpu/harness/checkpoint.py: a solver state, or a list
of them (run_mpc's final state of every episode), goes to `<path>.npz`
(every tensor field, the step among them) plus `<path>.manifest.json`
(the structure, the host fields such as the seed, and the caller's
metadata). load_solver_state restores it into the structure of an example
state `like`, each tensor on the device of `like`'s. Every random stream
of a solve is a function of (seed, tag, step) (rng.py), so the solve after
a restored state equals, bit for bit, the solve that would have come next.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch


def _encode(x, arrays: Dict[str, np.ndarray]):
    """The manifest entry of x; its tensors go into `arrays`."""
    if isinstance(x, torch.Tensor):
        name = f"leaf_{len(arrays)}"
        arrays[name] = x.detach().cpu().numpy()
        return {"tensor": name}
    if dataclasses.is_dataclass(x):
        return {"dataclass": type(x).__name__,
                "fields": {f.name: _encode(getattr(x, f.name), arrays)
                           for f in dataclasses.fields(x)}}
    if isinstance(x, (list, tuple)):
        return {"list": [_encode(v, arrays) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"value": x}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _decode(entry, like, npz, where: str):
    """`like`'s structure filled from the manifest entry and the arrays."""
    def mismatch(what):
        return ValueError(f"checkpoint does not match the example state at {where}: {what}")

    if isinstance(like, torch.Tensor):
        if "tensor" not in entry:
            raise mismatch("expected a tensor")
        return torch.as_tensor(npz[entry["tensor"]]).to(like.device)
    if dataclasses.is_dataclass(like):
        names = [f.name for f in dataclasses.fields(like)]
        if entry.get("dataclass") != type(like).__name__ or list(entry["fields"]) != names:
            raise mismatch(f"expected a {type(like).__name__} with fields {names}")
        return dataclasses.replace(like, **{
            k: _decode(entry["fields"][k], getattr(like, k), npz, f"{where}.{k}") for k in names})
    if isinstance(like, (list, tuple)):
        if len(entry.get("list", ())) != len(like):
            raise mismatch(f"expected a list of {len(like)}")
        items = [_decode(e, v, npz, f"{where}[{i}]")
                 for i, (e, v) in enumerate(zip(entry["list"], like))]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    if "value" not in entry:
        raise mismatch("expected a host value")
    return entry["value"]


def _paths(path: str):
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".npz", base + ".manifest.json"


def save_solver_state(path: str, state: Any, metadata: dict = None) -> None:
    """Write `state` (a solver state dataclass or a list of them) to
    <path>.npz and <path>.manifest.json."""
    npz_path, manifest_path = _paths(path)
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    structure = _encode(state, arrays)
    np.savez(npz_path, **arrays)
    with open(manifest_path, "w") as f:
        json.dump(dict(structure=structure, n_leaves=len(arrays), metadata=metadata or {}), f,
                  indent=2)


def load_solver_state(path: str, like: Any) -> Any:
    """The checkpoint at `path` in the structure of `like` (an example
    state, or list of states, as saved), each tensor on its example's
    device; host fields (the seed) as saved."""
    npz_path, manifest_path = _paths(path)
    with open(manifest_path) as f:
        manifest = json.load(f)
    with np.load(npz_path) as npz:
        if len(npz.files) != manifest["n_leaves"]:
            raise ValueError(f"checkpoint has {len(npz.files)} arrays, its manifest "
                             f"{manifest['n_leaves']}")
        return _decode(manifest["structure"], like, npz, "state")
