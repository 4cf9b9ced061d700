"""Env wrappers: observation normalisation and frame stacking as state
transforms.

Counterpart of mjmpc_tpu/envs/wrappers.py (the reference's VecNormalize and
VecFrameStack). A wrapper returns a new Env whose state carries the extra
statistics or the frame buffer as device tensors beside the inner env's
state, so a wrapped env composes with the rollouts, the solvers and the
captured episode like any other: every function takes the same leading
batch dimensions, and a step reads nothing back to the host. The running
statistics update with Chan's parallel merge, the reference's
RunningMeanStd.update.

Neither wrapper changes the reward unless norm_reward is on, so a wrapped
env keeps its inner env's costs-only fused rollout (the kernel reads the
inner state); the obs and closed-loop kernels see raw observations and are
dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .base import Env


@dataclasses.dataclass(frozen=True)
class RMSState:
    mean: torch.Tensor    # [..., *shape]
    var: torch.Tensor     # [..., *shape]
    count: torch.Tensor   # [...]


def rms_init(shape, epsilon: float = 1e-4, device="cuda") -> RMSState:
    return RMSState(mean=torch.zeros(shape, device=device), var=torch.ones(shape, device=device),
                    count=torch.full((), float(epsilon), device=device))


def rms_update(rms: RMSState, x: torch.Tensor, batch: bool = False) -> RMSState:
    """Chan's parallel merge of samples into the running statistics
    (reference running_mean_std.py). batch=False: x is one sample for each
    statistic (the env step's update; with a batch count of 1 the merge is
    the JAX package's rms_update, operation for operation); batch=True: x
    holds a batch of samples on its leading axis, merged at once."""
    if batch:
        b = float(x.shape[0])
        b_mean = x.mean(0)
        m_b = x.var(0, unbiased=False) * b
    else:
        b, b_mean, m_b = 1.0, x, None
    count = rms.count
    if rms.mean.dim() > count.dim():    # one count for each vector of statistics
        count = count.reshape(count.shape + (1,) * (rms.mean.dim() - count.dim()))
    delta = b_mean - rms.mean
    tot = count + b
    m_a = rms.var * count
    m_2 = m_a + (delta ** 2) * count * b / tot
    if m_b is not None:
        m_2 = m_2 + m_b
    return RMSState(mean=rms.mean + delta * b / tot, var=m_2 / tot, count=rms.count + b)


@dataclasses.dataclass(frozen=True)
class NormalizedState:
    inner: Any
    rms: RMSState
    ret: torch.Tensor       # discounted return accumulator (reward normalisation)
    ret_rms: RMSState


def _costs_kernel(env: Env) -> dict:
    """The inner env's costs-only fused rollout on the wrapped state."""
    kernel = env.fused_rollout
    if kernel is None:
        return {}

    def fused(p, state, mean, noise):
        return kernel(p, state.inner, mean, noise)

    if hasattr(kernel, "dynamic_fields"):
        fused.dynamic_fields = kernel.dynamic_fields
    return dict(fused_rollout=fused)


def _wrap(env: Env, keep_kernel: bool = True, **changes) -> Env:
    """env with the wrapper's functions; with_params rebinds the inner
    env's params (its kernel built anew)."""
    fused = _costs_kernel(env) if keep_kernel else {}
    return dataclasses.replace(
        env, fused_obs_rollout=None, fused_cl_rollout=None, fused_rollout=fused.get("fused_rollout"),
        build_fused=(lambda p: _costs_kernel(env.with_params(p))) if keep_kernel else None,
        **changes)


def normalize_obs(env: Env, clip_obs: float = 10.0, norm_reward: bool = False,
                  clip_reward: float = 10.0, gamma: float = 0.99,
                  epsilon: float = 1e-8) -> Env:
    """VecNormalize's counterpart: observations normalised by running
    statistics that every step updates, clipped to +-clip_obs; with
    norm_reward the reward is divided by the running std of the discounted
    return."""

    def norm(rms: RMSState, x):
        return torch.clamp((x - rms.mean) / torch.sqrt(rms.var + epsilon), -clip_obs, clip_obs)

    def init(params, seed):
        inner = env.init(params, seed)
        zero = torch.zeros((), device=env.device)
        return NormalizedState(inner=inner, rms=rms_init((env.d_obs,), device=env.device),
                               ret=zero, ret_rms=rms_init((), device=env.device))

    def observe(params, state):
        return norm(state.rms, env.observe(params, state.inner))

    def step(params, state, action):
        inner, obs, reward, done = env.step(params, state.inner, action)
        rms = rms_update(state.rms, obs)
        ret = state.ret * gamma + reward
        ret_rms = rms_update(state.ret_rms, ret)
        if norm_reward:
            reward = torch.clamp(reward / torch.sqrt(ret_rms.var + epsilon),
                                 -clip_reward, clip_reward)
        new = NormalizedState(inner=inner, rms=rms, ret=ret, ret_rms=ret_rms)
        return new, norm(rms, obs), reward, done

    success = None
    if env.success is not None:
        success = lambda params, state: env.success(params, state.inner)
    return _wrap(env, keep_kernel=not norm_reward, name=env.name + "+norm", init=init,
                 step=step, observe=observe, success=success)


@dataclasses.dataclass(frozen=True)
class StackedState:
    inner: Any
    frames: torch.Tensor   # [..., k, d_obs]


def frame_stack(env: Env, k: int = 4) -> Env:
    """VecFrameStack's counterpart: the observation is the concatenation of
    the last k raw observations, oldest first, zero-padded at the start."""

    def init(params, seed):
        inner = env.init(params, seed)
        first = env.observe(params, inner)
        pad = torch.zeros(first.shape[:-1] + (k - 1, env.d_obs), device=first.device)
        return StackedState(inner=inner, frames=torch.cat([pad, first[..., None, :]], -2))

    def flat(frames):
        return frames.reshape(frames.shape[:-2] + (k * env.d_obs,))

    def observe(params, state):
        return flat(state.frames)

    def step(params, state, action):
        inner, obs, reward, done = env.step(params, state.inner, action)
        frames = torch.cat([state.frames[..., 1:, :], obs[..., None, :]], -2)
        return StackedState(inner=inner, frames=frames), flat(frames), reward, done

    success = None
    if env.success is not None:
        success = lambda params, state: env.success(params, state.inner)
    return _wrap(env, name=env.name + f"+stack{k}", d_obs=env.d_obs * k,
                 init=init, step=step, observe=observe, success=success)
