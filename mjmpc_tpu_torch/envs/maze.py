"""maze-v0 and continual_maze-v0: a planar point mass among circular
obstacles.

Counterpart of mjmpc_tpu/envs/maze.py: a velocity-damped point robot in
the box [-2, 2]^2, vel += dt (4 u - vel), pos = clip(pos + dt vel, -2, 2)
(u clipped to [-1, 1], dt = 0.05); reward = -|pos - goal| - 20 * the
summed obstacle penetration - 0.01 |u|^2 at the post-step state; obs =
[pos, vel, goal - pos]; success: |pos - goal| < 0.15. continual_maze-v0
redraws the goal every 50 steps.

A goal (and the start) is the first of 16 candidates, uniform in [-1.8,
1.8]^2, that clears every obstacle by 0.2 (candidate 0 when none does).
The candidates come from Philox4x32-10 (ops/noise.py) under the state's
`key`, a host integer fixed at init, with the timestep, a 0-d int64
tensor, as a counter word: the draw is a function of (key, timestep), the
same for every particle of a batched state, made with tensor operations
that read nothing back to the host, and chosen by torch.where, so a
rollout or a solve through the step stays sync-free and capturable. The
JAX package's threefry draws differ, so tests inject the goal.

State = MazeState(pos [..., 2], vel [..., 2], goal [..., 2], timestep,
key); `timestep` is an int64 tensor, `key` a host integer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from ..ops.noise import _key_words, _uniform01, philox4x32_10
from .base import Env

_DT = 0.05
_DAMPING = 1.0
_BOUND = 2.0
GOAL_RADIUS = 0.15
N_CANDIDATES = 16
CLEARANCE = 0.2
PERIOD = 50

# (x, y, radius) circular obstacles
OBSTACLES = np.array([
    [0.0, 0.0, 0.45],
    [-1.0, 1.0, 0.35],
    [1.0, -1.0, 0.35],
    [1.0, 1.0, 0.3],
    [-1.0, -1.0, 0.3],
], np.float32)

_MASK32 = 0xFFFFFFFF
_GOAL_WORD = 0x6D617A65   # the draws' third counter word, apart from the noise streams'


@dataclasses.dataclass(frozen=True)
class MazeParams:
    obstacles: torch.Tensor   # [K, 3]
    continual_period: int     # 0: the goal never moves


@dataclasses.dataclass(frozen=True)
class MazeState:
    pos: torch.Tensor
    vel: torch.Tensor
    goal: torch.Tensor
    timestep: torch.Tensor    # int64, [] or the batch's leading dims
    key: int                  # the Philox key of the goal draws


def candidates(key: int, t: torch.Tensor) -> torch.Tensor:
    """The 16 candidate points [..., 16, 2] of the draw (key, t), for every
    entry of the int64 tensor t: Philox counter (q, t, word, 0) for q < 8
    gives four uniforms each."""
    q = torch.arange(N_CANDIDATES // 2, dtype=torch.int64, device=t.device)
    shape = t.shape + q.shape
    words = philox4x32_10((q.expand(shape), (t & _MASK32)[..., None].expand(shape),
                           torch.full(shape, _GOAL_WORD, dtype=torch.int64, device=t.device),
                           torch.zeros(shape, dtype=torch.int64, device=t.device)),
                          _key_words(key))
    u = _uniform01(torch.stack(words, -1)).reshape(t.shape + (N_CANDIDATES, 2))
    return 0.9 * _BOUND * (2.0 * u - 1.0)


def first_clear(cands: torch.Tensor, obstacles: torch.Tensor) -> torch.Tensor:
    """The first candidate [..., 2] of cands [..., 16, 2] that clears every
    obstacle by CLEARANCE; candidate 0 when none does."""
    d = torch.linalg.vector_norm(cands[..., :, None, :] - obstacles[:, :2], dim=-1)
    clear = torch.all(d > obstacles[:, 2] + CLEARANCE, -1)
    idx = torch.argmax(clear.to(torch.uint8), -1)     # the first maximum
    return torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 2)))[..., 0, :]


def sample_free_point(params: MazeParams, key: int, t: torch.Tensor) -> torch.Tensor:
    return first_clear(candidates(key, t), params.obstacles)


def _init(params: MazeParams, seed: int) -> MazeState:
    zero = rng.step_tensor(0, params.obstacles.device)
    return MazeState(pos=sample_free_point(params, rng.derive_seed(seed, 0), zero),
                     vel=torch.zeros(2, device=zero.device),
                     goal=sample_free_point(params, rng.derive_seed(seed, 1), zero),
                     timestep=zero, key=rng.derive_seed(seed, 2))


def _observe(params: MazeParams, state: MazeState) -> torch.Tensor:
    return torch.cat([state.pos, state.vel, state.goal - state.pos], -1)


def penetration(params: MazeParams, pos: torch.Tensor) -> torch.Tensor:
    d = torch.linalg.vector_norm(pos[..., None, :] - params.obstacles[:, :2], dim=-1)
    return torch.sum(torch.clamp(params.obstacles[:, 2] - d, min=0.0), -1)


def _step(params: MazeParams, state: MazeState, action: torch.Tensor):
    u = torch.clamp(action, -1.0, 1.0)
    vel = state.vel + _DT * (u * 4.0 - _DAMPING * state.vel)
    pos = torch.clamp(state.pos + _DT * vel, -_BOUND, _BOUND)
    t = state.timestep + 1
    goal = state.goal
    period = params.continual_period
    if period > 0:
        fire = (t % period == 0)[..., None]
        goal = torch.where(fire, sample_free_point(params, state.key, t), goal)
    new = MazeState(pos=pos, vel=vel, goal=goal, timestep=t, key=state.key)
    reward = (-torch.linalg.vector_norm(pos - goal, dim=-1) - 20.0 * penetration(params, pos)
              - 0.01 * torch.sum(u * u, -1))
    return new, _observe(params, new), reward, torch.zeros_like(reward, dtype=torch.bool)


def _success(params: MazeParams, state: MazeState) -> torch.Tensor:
    return torch.linalg.vector_norm(state.pos - state.goal, dim=-1) < GOAL_RADIUS


def _make(period: int, name: str, device) -> Env:
    device = torch.device(device)
    params = MazeParams(obstacles=torch.as_tensor(OBSTACLES, device=device),
                        continual_period=int(period))
    return Env(name=name, d_obs=6, d_action=2,
               action_lows=torch.full((2,), -1.0, device=device),
               action_highs=torch.full((2,), 1.0, device=device),
               params=params, init=_init, step=_step, observe=_observe, device=device,
               success=_success, max_episode_steps=200)


def make(device="cuda") -> Env:
    return _make(0, "maze-v0", device)


def make_continual(device="cuda") -> Env:
    """continual_maze-v0: the goal is redrawn every 50 steps."""
    return _make(PERIOD, "continual_maze-v0", device)
