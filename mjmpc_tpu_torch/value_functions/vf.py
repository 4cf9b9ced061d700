"""Least-squares value-function baselines.

Counterpart of mjmpc_tpu/value_functions/vf.py, with the same features
and fit:
- linear: obs + normalised time (t+1)/H, plus a bias column; one weight
  vector for all steps;
- quadratic: obs + the upper-triangular products obs_i obs_j + time;
- linear_time_varying / quadratic_time_varying: no time feature, one
  weight vector per step, fit as a batch over the horizon;
- fit: the regularised normal equations; where a solution is not finite,
  the regularisation escalates x10 (from 0 to 1e-8), up to 10 times.

A ValueFunction is a frozen spec; its parameters are a VFParams of
tensors: predict(params, obs) -> values, fit(params, obs, returns,
delta_reg) -> params (and the relative errors before and after).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.control import capturable_linalg

# Escalations after the first attempt (JAX vf.py _solve_retry).
N_RETRIES = 10


@dataclasses.dataclass(frozen=True)
class VFParams:
    weights: torch.Tensor  # [d_feat] or [H, d_feat]
    bias: torch.Tensor     # [] or [H]


def reg_ladder(delta_reg: float) -> np.ndarray:
    """The N_RETRIES + 1 regularisations the fit tries, in order, as the
    JAX loop computes them in f32: delta_reg, then x10 each time (1e-8
    first when delta_reg is 0)."""
    regs = [np.float32(delta_reg)]
    for _ in range(N_RETRIES):
        regs.append(np.float32(1e-8) if regs[-1] == 0.0 else regs[-1] * np.float32(10.0))
    return np.asarray(regs, np.float32)


@functools.lru_cache(maxsize=None)
def _ladder_tensor(delta_reg: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(reg_ladder(delta_reg), device=device)


def solve_retry(gram: torch.Tensor, moment: torch.Tensor, delta_reg: float):
    """(x, k): the solution of (gram + reg_k I) x = moment [..., d] with k
    the first rung of reg_ladder(delta_reg) whose solution is finite, or
    the last rung; batched over leading dims.

    The JAX version is a data-dependent while loop; a host loop here would
    sync on every test. The ladder is known in advance, so all its systems
    are solved in one batched solve_ex (no info check on the host) and the
    first finite solution is picked on the device."""
    d = gram.shape[-1]
    regs = _ladder_tensor(float(delta_reg), gram.device).to(gram.dtype)
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    systems = gram[..., None, :, :] + regs[:, None, None] * eye          # [..., K, d, d]
    rhs = moment[..., None, :, None].expand(*moment.shape[:-1], regs.shape[0], d, 1)
    with capturable_linalg(gram.device):
        xs = torch.linalg.solve_ex(systems, rhs, check_errors=False).result[..., 0]
    finite = torch.isfinite(xs).all(-1)                                   # [..., K]
    k = torch.where(finite.any(-1), torch.argmax(finite.to(torch.int32), -1),
                    torch.full_like(finite[..., 0], N_RETRIES, dtype=torch.int64))
    x = torch.gather(xs, -2, k[..., None, None].expand(*k.shape, 1, d))[..., 0, :]
    return x, k


@dataclasses.dataclass(frozen=True)
class ValueFunction:
    """A baseline spec: which features, and whether weights vary with
    time."""
    name: str
    d_obs: int
    horizon: int
    quadratic: bool
    time_varying: bool
    device: object = "cuda"

    @property
    def d_feat(self) -> int:
        d = self.d_obs
        return d + (d * (d + 1) // 2 if self.quadratic else 0) + (0 if self.time_varying else 1)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        """obs [N, H, d_obs] -> [N, H, d_feat]."""
        parts = [obs]
        if self.quadratic:
            iu = torch.triu_indices(self.d_obs, self.d_obs, device=obs.device)
            parts.append(obs[..., iu[0]] * obs[..., iu[1]])
        if not self.time_varying:
            n, h = obs.shape[0], obs.shape[1]
            t = torch.arange(1, h + 1, dtype=obs.dtype, device=obs.device) / self.horizon
            parts.append(t[None, :, None].expand(n, h, 1))
        return torch.cat(parts, -1)

    def init_params(self) -> VFParams:
        if self.time_varying:
            return VFParams(weights=torch.zeros((self.horizon, self.d_feat), device=self.device),
                            bias=torch.zeros((self.horizon,), device=self.device))
        return VFParams(weights=torch.zeros((self.d_feat,), device=self.device),
                        bias=torch.zeros((), device=self.device))

    def build_constants(self, delta_reg: float) -> None:
        """Put the fit's regularisation ladder on the device now, outside
        any solve, so that a fit copies nothing from the host."""
        _ladder_tensor(float(delta_reg), torch.empty(0, device=self.device).device)

    def predict(self, params: VFParams, obs: torch.Tensor) -> torch.Tensor:
        """obs [N, H, d_obs] -> values [N, H]."""
        feat = self.features(obs)
        if self.time_varying:
            return torch.einsum("nhf,hf->nh", feat, params.weights) + params.bias
        return feat @ params.weights + params.bias

    def fit(self, params: VFParams, obs: torch.Tensor, returns: torch.Tensor,
            delta_reg: float = 0.0, return_errors: bool = False):
        """Closed-form regularised least squares (with a bias column)."""
        feat = self.features(obs)
        feat = torch.cat([feat, torch.ones_like(feat[..., :1])], -1)
        d = feat.shape[-1]
        if return_errors:
            err_before = (torch.sum((returns - self.predict(params, obs)) ** 2)
                          / torch.sum(returns ** 2))
        if self.time_varying:   # the horizon as the batch dim
            f = feat.transpose(0, 1)                                  # [H, N, d]
            gram = f.transpose(1, 2) @ f
            moment = torch.einsum("hnf,hn->hf", f, returns.transpose(0, 1))
            x, _ = solve_retry(gram, moment, delta_reg)
            new = VFParams(weights=x[:, :-1], bias=x[:, -1])
        else:
            f = feat.reshape(-1, d)
            x, _ = solve_retry(f.T @ f, f.T @ returns.reshape(-1), delta_reg)
            new = VFParams(weights=x[:-1], bias=x[-1])
        if return_errors:
            err_after = (torch.sum((returns - self.predict(new, obs)) ** 2)
                         / torch.sum(returns ** 2))
            return new, err_before, err_after
        return new


_KINDS = {   # name -> (quadratic, time_varying)
    "linear": (False, False),
    "quadratic": (True, False),
    "linear_time_varying": (False, True),
    "time_varying_linear": (False, True),
    "quadratic_time_varying": (True, True),
    "time_varying_quadratic": (True, True),
}

REGISTRY = sorted(_KINDS)


def make_vf(kind: str, d_obs: int, horizon: int, device="cuda") -> ValueFunction:
    if kind not in _KINDS:
        raise ValueError(f"unknown baseline {kind!r}; known: {REGISTRY}")
    quadratic, time_varying = _KINDS[kind]
    return ValueFunction(name=kind, d_obs=d_obs, horizon=horizon, quadratic=quadratic,
                         time_varying=time_varying, device=device)
