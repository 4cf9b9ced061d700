"""Dynamics randomization: perturb an env's params.

Counterpart of mjmpc_tpu/envs/randomize.py (reference
GymEnvWrapper.randomize_dynamics): for each (field, name) with
[noise_scale, bias_scale], the value becomes
    biased_mean = (1 + bias_scale) * default
    new ~ U(biased_mean * (1 - noise_scale), biased_mean * (1 + noise_scale))
drawn from np.random.RandomState(base_seed) in the spec's order, exactly as
the JAX package draws them, so that for one spec and seed both packages
give the same defaults and values. Defaults are read from the env's own
params, so repeated randomization never drifts.

- `randomize_dynamics`: one perturbed Env (the reference's per-experiment
  model-mismatch setup). The env it returns is `env.with_params(new)`: its
  fused rollout kernels are built anew from the perturbed model (a new
  generated header and build, cached by content hash), so planning on it
  keeps its kernel;
- `randomize_batch`: n independently perturbed params, every tensor leaf
  stacked on a leading axis.

Field addressing: dotted paths into the params dataclasses (e.g.
"model.mass"), plus per-env name -> chain-row tables for MuJoCo-style names
(body_mass/r_forearm_roll_link etc. map onto ChainModel rows), registered
by each env module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..engine.chain import _JOINT_NV
from .base import Env

# MuJoCo-style field -> ChainModel attribute (the reference's field set).
# Envs whose contact model exposes its own friction/geometry leaves register
# geom_friction -> mu and geom_size -> radius paths via
# `register_param_paths` (checked first in _resolve); this table is the
# chain-level fallback, where geom_friction degrades to the viscous damping
# of the named contact DOF.
_CHAIN_FIELDS = {
    "body_mass": "mass",
    "body_inertia": "inertia",
    "dof_damping": "damping",
    "dof_frictionloss": "frictionloss",
    "dof_armature": "armature",
    "actuator_gear": "gear",
    "geom_friction": "damping",
}

# per-env name tables (index into the chain)
_NAME_TABLES: Dict[str, Dict[str, int]] = {}

# per-env (field, name) -> params-path tables for parameters outside the
# chain (analytic envs like cartpole; sensor-noise leaves)
_PARAM_PATHS: Dict[str, Dict[str, Dict[str, str]]] = {}


def register_param_paths(env_name: str, mapping: Dict[str, Dict[str, str]]) -> None:
    """Map reference dyn-randomize (field, name) pairs onto params paths,
    for envs whose dynamics are not a ChainModel (cartpole-v0:
    body_mass/cart -> 'masscart') or for sensor fields
    (sensor_noise/target_pos -> 'sensor_bias')."""
    _PARAM_PATHS.setdefault(env_name, {}).update(
        {f: dict(names) for f, names in mapping.items()})


def register_names(env_name: str, body_names, joint_names=None, extra=None) -> None:
    """Register the body/joint name -> chain-row table of an env. `extra`
    maps more MuJoCo-style names (geom names, the reference YAMLs' other
    spellings) onto rows."""
    table = {n: i for i, n in enumerate(body_names)}
    for i, n in enumerate(joint_names or []):
        table.setdefault(n, i)
    table.update(extra or {})
    _NAME_TABLES[env_name] = table


def _get_path(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set_path(obj, path: str, value):
    """obj with the nested dataclass field at `path` replaced."""
    head, _, rest = path.partition(".")
    if rest:
        value = _set_path(getattr(obj, head), rest, value)
    return dataclasses.replace(obj, **{head: value})


def _resolve(env: Env, field: str, name: str) -> Tuple[str, Any]:
    """(params path, the row index or DOF slice, or None) for a (field, name)
    pair."""
    paths = _PARAM_PATHS.get(env.name, {})
    if field in paths and name in paths[field]:
        return paths[field][name], None
    if field in _CHAIN_FIELDS:
        table = _NAME_TABLES.get(env.name)
        if table is None or name not in table:
            raise ValueError(f"no name table entry for {name!r} in env {env.name!r}")
        attr = _CHAIN_FIELDS[field]
        row = table[name]
        if attr in ("damping", "armature", "gear", "frictionloss"):
            # per-DOF arrays are [nv]; with quaternion joints a body row
            # spans a slice of velocity DOFs, not a single entry
            model = getattr(env.params, "model", None)
            if model is not None and hasattr(model, "v_offsets"):
                voff = model.v_offsets
                width = _JOINT_NV[model.joint_types[row]]
                if width > 1 or voff[row] != row:
                    return "model." + attr, slice(voff[row], voff[row] + width)
        return "model." + attr, row
    if field == "params":   # a direct field of the params
        return name, None
    raise ValueError(f"unknown dynamics field {field!r}")


def _perturb(default: np.ndarray, dist_params, rng) -> np.ndarray:
    noise_scale, bias_scale = dist_params
    biased = (1.0 + bias_scale) * default
    return rng.uniform(biased - biased * noise_scale, biased + biased * noise_scale)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def perturbed_params(env: Env, param_dict: Dict[str, Dict[str, Any]], base_seed: int = 0):
    """(perturbed params, defaults, randomized): randomize_dynamics without
    building the env's kernels."""
    rng = np.random.RandomState(base_seed)
    params = env.params
    defaults: Dict[str, Dict[str, Optional[np.ndarray]]] = {}
    randomized: Dict[str, Dict[str, Optional[np.ndarray]]] = {}

    for field, names in param_dict.items():
        defaults[field] = {}
        randomized[field] = {}
        for name, dist in names.items():
            try:
                path, idx = _resolve(env, field, name)
            except ValueError:
                # A [0, 0] spec means "keep the default" wherever the value
                # lives: tolerate unmapped names for exactly that case (the
                # reference's cartpole spec lists zeroed axes for params its
                # model lacks too).
                if float(dist[0]) == 0.0 and float(dist[1]) == 0.0:
                    defaults[field][name] = None
                    randomized[field][name] = None
                    continue
                raise
            old = _get_path(params, path)
            arr = _host(old)
            cur = arr[idx] if idx is not None else arr
            defaults[field][name] = np.array(cur, copy=True)
            new_val = _perturb(np.asarray(cur, np.float64), dist, rng)
            new_arr = np.array(arr, copy=True)
            if idx is not None:
                new_arr[idx] = new_val
            else:
                new_arr = np.asarray(new_val, arr.dtype)
            randomized[field][name] = np.asarray(new_val)
            if isinstance(old, torch.Tensor):
                new = torch.as_tensor(new_arr, dtype=old.dtype, device=old.device)
            else:
                new = new_arr
            params = _set_path(params, path, new)
    return params, defaults, randomized


def randomize_dynamics(env: Env, param_dict: Dict[str, Dict[str, Any]], base_seed: int = 0):
    """(perturbed Env, defaults, randomized): the value dicts map field ->
    name -> numpy array (None for a tolerated [0, 0] name).

    param_dict: {field: {name: [noise_scale, bias_scale]}}, the reference's
    YAML schema (configs/dyn_randomize/*). The env is env.with_params(the
    perturbed params), its fused rollouts built from the perturbed model.
    """
    params, defaults, randomized = perturbed_params(env, param_dict, base_seed)
    return env.with_params(params), defaults, randomized


def _stack(leaves):
    first = leaves[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(leaves)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(x, f.name) for x in leaves])
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(first, f.name))})
    return first   # host topology and constants are the same in every draw


def randomize_batch(env: Env, param_dict, base_seed: int, n: int):
    """n independently perturbed params (seeds base_seed + i * 12345, as
    the JAX package's), every tensor leaf stacked on a leading axis [n, ...]
    (host fields, the chain's topology, taken from the first)."""
    drawn = [perturbed_params(env, param_dict, base_seed + i * 12345)[0] for i in range(n)]
    return _stack(drawn)
