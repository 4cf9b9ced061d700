"""Environment protocol: a bundle of plain functions over explicit state.

Counterpart of mjmpc_tpu/envs/base.py. Every function takes leading batch
dimensions on its state and action tensors, so a rollout advances all N
particles with one call per step:

    env.init(params, seed)               -> state (episode start)
    env.step(params, state, action)      -> (next_state, obs, reward, done)
    env.observe(params, state)           -> obs

`params` is the dynamics model (tensors on the env's device), passed
explicitly as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

StepFn = Callable[[Any, Any, torch.Tensor],
                  Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Env:
    """An environment as a bundle of plain functions plus static metadata.

    `action_lows` / `action_highs` are [dA] tensors on `device`, built
    once so that clipping an action copies nothing from the host.
    """
    name: str
    d_obs: int
    d_action: int
    action_lows: torch.Tensor
    action_highs: torch.Tensor
    params: Any
    init: Callable[[Any, int], Any]
    step: StepFn
    observe: Callable[[Any, Any], torch.Tensor]
    device: torch.device
    # Optional per-step success predicate: (params, state) -> bool tensor.
    success: Optional[Callable[[Any, Any], torch.Tensor]] = None
    max_episode_steps: int = 1000
    # Optional fused rollout: (params, state, mean [H, dA], noise [N, H, dA])
    # -> costs [N, H], equal to the costs of rollout_open_loop but computed
    # by one kernel (ops/chain_rollout.py, ops/forest_rollout.py). Model
    # constants are baked at build time, so planning against other params
    # must bypass it (build_solve_fn's `fused` flag), except params the
    # kernel lists in its `dynamic_fields` attribute, which it reads at
    # call time (harness/episode.py _fused_mode). Its `batched` attribute,
    # where the kernel has a batched entry, takes B states (fields with a
    # leading [B]), means [B, H, dA] and noise [B, N, H, dA] in one launch
    # (solvers.build_batched_solve_fn): every env with a fused rollout has
    # one (kernels #1, #5, #6 and #7) but the continual reacher, which has
    # no fused rollout.
    fused_rollout: Optional[Callable[[Any, Any, torch.Tensor, torch.Tensor],
                                     torch.Tensor]] = None
    # Optional fused rollout with observations: (params, state, mean [H, dA],
    # noise [N, H, dA]) -> (obs [N, H, d_obs], costs [N, H]), obs taken at
    # the pre-step state as rollout_open_loop records them: the path of
    # solvers that read observations (MPPIQ with a plugged Q). Actions are
    # mean + noise, built by the caller.
    fused_obs_rollout: Optional[Callable[[Any, Any, torch.Tensor, torch.Tensor],
                                         Tuple[torch.Tensor, torch.Tensor]]] = None
    # Optional fused closed-loop-linear rollout: (params, state, weights
    # [d_obs + 1, dA], noise [N, H, dA]) -> (obs [N, H, d_obs], actions
    # [N, H, dA], costs [N, H]), the records of rollout_closed_loop_linear
    # (pre-step obs, pre-clip actions, post-step costs): Reinforce's path.
    fused_cl_rollout: Optional[Callable[[Any, Any, torch.Tensor, torch.Tensor],
                                        Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]]] = None
    # Optional: params -> {fused field: rollout} built from those params (a
    # new generated header and kernel build for another model, cached by
    # content hash): what with_params uses to keep the kernels on a
    # perturbed model.
    build_fused: Optional[Callable[[Any], dict]] = None

    def with_params(self, params) -> "Env":
        """This env on other dynamics params (dynamics randomization; JAX
        base.py with_params). The fused rollouts bake the model they were
        built from, so they are built anew from `params` (build_fused); an
        env without build_fused drops them and plans on the general
        rollout. Call it outside a solve: building reads the model to the
        host."""
        fused = (self.build_fused(params) if self.build_fused is not None else {})
        return dataclasses.replace(self, params=params, **{
            k: fused.get(k) for k in ("fused_rollout", "fused_obs_rollout", "fused_cl_rollout")})

    def clip_action(self, action: torch.Tensor) -> torch.Tensor:
        return torch.clamp(action, self.action_lows, self.action_highs)


def forest_fused(roll, extras: Callable[[Any, Any], torch.Tensor],
                 dynamic_fields: Tuple[str, ...] = ()):
    """A forest env's fused rollout on kernel #6 (ops/forest_rollout.py
    ForestRollout `roll`) and its batched hook, from the env's
    extras(params, state) -> the kernel's extras ([n_extras]; [B, n_extras]
    for B stacked states where they read the state). The hook gives each
    of the B states its row of extras, contiguous. dynamic_fields: the
    params the kernel reads at call time, through the extras
    (harness/episode.py _fused_mode)."""
    def fused(p, state, mean, noise):
        return roll(state.qpos, state.qvel, extras(p, state), mean, noise)

    def batched(p, states, means, noises):
        """B states (each field with a leading [B]), means [B, H, dA] and
        noise [B, N, H, dA] -> costs [B, N, H] in one launch of #6."""
        x = extras(p, states)
        rows = x.expand(states.qpos.shape[:-1] + x.shape[-1:]).contiguous()
        return roll.batch(states.qpos, states.qvel, rows, means, noises)

    fused.dynamic_fields = tuple(dynamic_fields)
    fused.kernel = roll   # the wrapper, for checks against its plain version
    fused.batched = batched
    return fused
