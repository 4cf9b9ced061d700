"""Soft actor-critic on tensors, with a functional Adam.

Counterpart of mjmpc_tpu/rl/sac.py (reference softqmpc/algs/sac/): a
tanh-squashed diagonal-Gaussian actor, twin Q networks with Polyak target
updates and automatic entropy-temperature tuning. Parameters are pytrees
(lists and NamedTuples of tensors); each gradient is torch.func.grad of a
pure loss, and each of the three optimisers is Adam with optax's defaults
(b1 0.9, b2 0.999, eps 1e-8 added outside the square root of the
bias-corrected second moment), so one update is a fixed sequence of
device operations with no host read.

The actor's normals come from an explicit torch.Generator, or are given
(`eps`), which lets the tests feed the draws of the JAX package's keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..models.mlp import MLPPolicy

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0
_EPS = 1e-6


class AdamState(NamedTuple):
    count: torch.Tensor   # [] int64: steps taken
    mu: Any               # first moments, the params' structure
    nu: Any               # second moments


def adam_init(params) -> AdamState:
    zeros = lambda x: torch.zeros_like(x)
    leaf = pytree.tree_leaves(params)[0]
    return AdamState(count=torch.zeros((), dtype=torch.int64, device=leaf.device),
                     mu=pytree.tree_map(zeros, params), nu=pytree.tree_map(zeros, params))


def adam_step(grads, state: AdamState, params, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8):
    """(new params, new state): optax.adam's update applied to params."""
    count = state.count + 1
    mu = pytree.tree_map(lambda m, g: (1.0 - b1) * g + b1 * m, state.mu, grads)
    nu = pytree.tree_map(lambda v, g: (1.0 - b2) * g * g + b2 * v, state.nu, grads)
    c = count.to(torch.float32)
    bc1, bc2 = 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)
    new = pytree.tree_map(
        lambda p, m, v: p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + eps)), params, mu, nu)
    return new, AdamState(count=count, mu=mu, nu=nu)


def _clone(tree):
    return pytree.tree_map(lambda x: x.clone(), tree)


@dataclasses.dataclass(frozen=True)
class GaussianPolicy:
    """Squashed diagonal-Gaussian actor (reference policy_network.py)."""
    d_obs: int
    d_action: int
    hidden: Sequence[int] = (256, 256)

    @property
    def _net(self) -> MLPPolicy:
        return MLPPolicy(self.d_obs, 2 * self.d_action, tuple(self.hidden), activation="relu",
                         squash=False)

    def init_params(self, generator: torch.Generator, device="cuda"):
        return self._net.init_params(generator, device)

    def dist(self, params, obs):
        mean, log_std = torch.chunk(self._net(params, obs), 2, dim=-1)
        return mean, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)

    def sample(self, params, obs, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None):
        """(action, log_prob, tanh(mean)) with the tanh-squash correction;
        eps ~ N(0, 1) of the mean's shape from `generator` unless given."""
        mean, log_std = self.dist(params, obs)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        action = torch.tanh(mean + torch.exp(log_std) * eps)
        log_prob = torch.sum(-0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)
                             - torch.log(1.0 - action ** 2 + _EPS), dim=-1)
        return action, log_prob, torch.tanh(mean)


@dataclasses.dataclass(frozen=True)
class QNetwork:
    """Twin Q (reference q_network.py): two MLPs on [obs, act]."""
    d_obs: int
    d_action: int
    hidden: Sequence[int] = (256, 256)

    @property
    def _net(self) -> MLPPolicy:
        return MLPPolicy(self.d_obs + self.d_action, 1, tuple(self.hidden), activation="relu",
                         squash=False)

    def init_params(self, generator: torch.Generator, device="cuda"):
        return (self._net.init_params(generator, device),
                self._net.init_params(generator, device))

    def __call__(self, params, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self._net(params[0], x)[..., 0], self._net(params[1], x)[..., 0]

    def min_q(self, params, obs, act):
        return torch.minimum(*self(params, obs, act))


class SACParams(NamedTuple):
    policy: Any
    q: Any
    q_target: Any
    log_alpha: torch.Tensor
    policy_opt: AdamState
    q_opt: AdamState
    alpha_opt: AdamState


@dataclasses.dataclass(frozen=True)
class SAC:
    d_obs: int
    d_action: int
    hidden: Sequence[int] = (256, 256)
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    auto_entropy: bool = True
    init_alpha: float = 0.2

    @property
    def actor(self) -> GaussianPolicy:
        return GaussianPolicy(self.d_obs, self.d_action, self.hidden)

    @property
    def critic(self) -> QNetwork:
        return QNetwork(self.d_obs, self.d_action, self.hidden)

    @property
    def target_entropy(self) -> float:
        return -float(self.d_action)

    def init_params(self, generator: torch.Generator, device="cuda") -> SACParams:
        """Actor and critic weights drawn on the CPU from `generator`; the
        target a copy of the critic; fresh optimiser states."""
        policy = self.actor.init_params(generator, device)
        q = self.critic.init_params(generator, device)
        log_alpha = torch.full((), math.log(self.init_alpha), device=device)
        return SACParams(policy=policy, q=q, q_target=_clone(q), log_alpha=log_alpha,
                         policy_opt=adam_init(policy), q_opt=adam_init(q),
                         alpha_opt=adam_init(log_alpha))

    def act(self, params: SACParams, obs, generator: Optional[torch.Generator] = None,
            deterministic: bool = False):
        if deterministic:
            return torch.tanh(self.actor.dist(params.policy, obs)[0])
        return self.actor.sample(params.policy, obs, generator)[0]

    def update(self, params: SACParams, batch, generator: Optional[torch.Generator] = None,
               eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """One SAC step (reference sac.py update_parameters): the critic,
        then the actor against the new Q, then the temperature on
        logp + target_entropy (a constant), then the Polyak target.

        batch: obs [B, dO], action [B, dA], reward [B] (rewards: SAC
        maximises), next_obs [B, dO], done [B]. eps: the (next-action,
        actor) normals [B, dA] each, else drawn from `generator`.
        Returns (new params, info of 0-d tensors)."""
        obs, next_obs = batch["obs"], batch["next_obs"]
        if eps is None:
            shape = (obs.shape[0], self.d_action)
            eps = tuple(torch.randn(shape, generator=generator, device=obs.device)
                        for _ in range(2))
        eps_next, eps_pi = eps
        alpha = torch.exp(params.log_alpha)

        # critic
        next_a, next_logp, _ = self.actor.sample(params.policy, next_obs, eps=eps_next)
        target_q = self.critic.min_q(params.q_target, next_obs, next_a) - alpha * next_logp
        target = batch["reward"] + (1.0 - batch["done"]) * self.gamma * target_q

        def q_loss_fn(qp):
            q1, q2 = self.critic(qp, obs, batch["action"])
            return torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

        q_grad, q_loss = torch.func.grad_and_value(q_loss_fn)(params.q)
        new_q, q_opt = adam_step(q_grad, params.q_opt, params.q, self.lr)

        # actor, against the new Q
        def pi_loss_fn(pp):
            a, logp, _ = self.actor.sample(pp, obs, eps=eps_pi)
            return torch.mean(alpha * logp - self.critic.min_q(new_q, obs, a)), logp

        pi_grad, (pi_loss, logp) = torch.func.grad_and_value(pi_loss_fn, has_aux=True)(
            params.policy)
        new_policy, policy_opt = adam_step(pi_grad, params.policy_opt, params.policy, self.lr)

        # temperature
        if self.auto_entropy:
            held = (logp + self.target_entropy).detach()

            def alpha_loss_fn(la):
                return -torch.mean(torch.exp(la) * held)

            a_grad, a_loss = torch.func.grad_and_value(alpha_loss_fn)(params.log_alpha)
            new_log_alpha, alpha_opt = adam_step(a_grad, params.alpha_opt, params.log_alpha,
                                                 self.lr)
        else:
            a_loss = torch.zeros((), device=obs.device)
            new_log_alpha, alpha_opt = params.log_alpha, params.alpha_opt

        # Polyak target
        new_target = pytree.tree_map(lambda t, s: (1.0 - self.tau) * t + self.tau * s,
                                     params.q_target, new_q)
        new = SACParams(policy=new_policy, q=new_q, q_target=new_target,
                        log_alpha=new_log_alpha, policy_opt=policy_opt, q_opt=q_opt,
                        alpha_opt=alpha_opt)
        info = dict(q_loss=q_loss, pi_loss=pi_loss, alpha_loss=a_loss,
                    alpha=torch.exp(new_log_alpha))
        return new, info
