"""Reference-schema YAML configuration.

Counterpart of mjmpc_tpu/harness/config.py. The reference's experiment
YAMLs have top-level keys (env_name, n_episodes, max_ep_length, seed,
base_action, render, job_mode, ...) plus one section per controller.
Derived params are injected at load: d_obs and d_action, the action
bounds, num_particles = num_cpu * particles_per_cpu, and here the solver's
device, the env's. Reference configs load unmodified.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import yaml

from .. import solvers

# Keys in reference controller sections that do not map to solver fields.
_DROPPED_KEYS = {
    "num_cpu", "particles_per_cpu",   # folded into num_particles
    "loss_thresh",                    # the reference reads it, never uses it
    "max_iters",
    "update_cov",                     # DMD field name, handled below
    "particles_per_model",
}

# reference name -> solver field
_RENAMED = {
    "kl_delta": "delta_kl",
    # the reference softq sections name the particle count n_rollouts or
    # num_samples
    "n_rollouts": "num_particles",
    "num_samples": "num_particles",
}

# The JAX package's noise_impl names -> the port's (ops.FilteredNoise is
# the kernel sampler).
_NOISE_IMPL = {"xla": "plain", "pallas": "kernel"}


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


# Keys whose values are legitimately list-valued (not tune axes).
_LIST_VALUED = {"filter_coeffs", "init_cov", "hidden"}


def _scalarize(key: str, v):
    """Sweep/tune configs put lists in scalar fields (grid axes); a single
    run takes the FIRST entry, except for genuinely list-valued fields (AR
    coefficients; per-action-dim init_cov, averaged later)."""
    if key in _LIST_VALUED or not isinstance(v, list) or not v:
        return _denoise(v)
    return _denoise(v[0])


def _denoise(v):
    """Salvage numbers mangled by YAML typos in the reference's own configs
    ('step_size : 1.]' parses as the string '1.]'): strip stray bracket
    characters only and re-parse. Anything that is not a number once the
    brackets are gone ('null', 'full', 'v1', 'AR2') passes unchanged."""
    if not isinstance(v, str):
        return v
    cleaned = v.strip("[](), \t")
    if cleaned == v:
        return v
    try:
        f = float(cleaned)
    except ValueError:
        return v
    return int(f) if f.is_integer() and "." not in cleaned else f


def solver_params_from_config(exp_params: Dict[str, Any], controller_name: str,
                              env) -> Dict[str, Any]:
    """Translate a controller section into solver kwargs. A controller of
    the JAX package that the port lacks raises NotImplementedError."""
    if controller_name not in exp_params:
        raise ValueError(f"config has no section for controller {controller_name!r}")
    solver_cls = solvers.solver_class(controller_name)
    section = {k: _scalarize(k, v) for k, v in exp_params[controller_name].items()}

    if "num_cpu" in section and "particles_per_cpu" in section:
        section["num_particles"] = int(section["num_cpu"]) * int(section["particles_per_cpu"])
    for k in _DROPPED_KEYS & set(section):
        if k == "update_cov":
            section["update_cov"] = bool(section["update_cov"])
            continue
        section.pop(k)
    for old, new in _RENAMED.items():
        if old in section:
            section[new] = section.pop(old)

    # per-action-dim init_cov lists (reference CEM) become one variance
    if isinstance(section.get("init_cov"), list):
        section["init_cov"] = float(np.mean(section["init_cov"]))
    if "filter_coeffs" in section:
        section["filter_coeffs"] = tuple(section["filter_coeffs"])
    if "noise_impl" in section:
        section["noise_impl"] = _NOISE_IMPL.get(section["noise_impl"], section["noise_impl"])

    section["d_action"] = env.d_action
    section["action_lows"] = env.action_lows
    section["action_highs"] = env.action_highs
    section["device"] = env.device

    field_names = {f.name for f in dataclasses.fields(solver_cls)}
    if "d_obs" in field_names:
        section["d_obs"] = env.d_obs
    if "base_action" not in section and "base_action" in exp_params \
            and "base_action" in field_names:
        section["base_action"] = exp_params["base_action"]

    for k in set(section) - field_names:
        section.pop(k)
    return section


def make_solver_for_env(exp_params: Dict[str, Any], controller_name: str, env):
    params = solver_params_from_config(exp_params, controller_name, env)
    return solvers.make_solver(controller_name, **params)
