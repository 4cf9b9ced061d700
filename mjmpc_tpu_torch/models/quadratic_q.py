"""Quadratic Q function with a Cholesky-parameterised PSD curvature.

Counterpart of mjmpc_tpu/models/quadratic_q.py: Q(s, a) = 0.5 z^T P z +
J^T z + c with z = [s; a] and P = L L^T, L lower-triangular and packed as
a vector. P is PSD, so Q is convex in a and induces the soft-Q policy
    mu(s) = Paa^-1 (-Ja - Pas s),   Sigma = lam Paa^-1,
and grow_cov works in moment space. Every factorisation is cholesky_ex
(no host-side info check: a solve that uses it stays sync-free; a matrix
that is not PD gives NaN, as jnp.linalg.cholesky does, not an exception),
and every index or identity is made on the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


class QuadraticQParams(NamedTuple):
    l_packed: torch.Tensor   # [d_total (d_total + 1) / 2] lower-triangular entries of L
    j: torch.Tensor          # [d_total]
    c: torch.Tensor          # []


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _chol(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky_ex(a).L


@dataclasses.dataclass(frozen=True)
class QuadraticQFunc:
    d_obs: int
    d_action: int
    jitter: float = 1e-6   # PSD guard when inverting Paa

    @property
    def d_total(self) -> int:
        return self.d_obs + self.d_action

    def _tril(self, device) -> torch.Tensor:
        """(rows, cols) of the lower triangle in row-major order, as
        np.tril_indices gives them."""
        return torch.tril_indices(self.d_total, self.d_total, device=device)

    def init_params(self, generator: torch.Generator, device="cuda") -> QuadraticQParams:
        """L, J ~ N(0, 1) drawn on the CPU from `generator`, c = 0."""
        d_l = self.d_total * (self.d_total + 1) // 2
        l_packed = torch.randn((d_l,), generator=generator)
        j = torch.randn((self.d_total,), generator=generator)
        return QuadraticQParams(l_packed=l_packed.to(device), j=j.to(device),
                                c=torch.zeros((), device=device))

    def l_matrix(self, params: QuadraticQParams) -> torch.Tensor:
        rows, cols = self._tril(params.l_packed.device)
        lmat = params.l_packed.new_zeros((self.d_total, self.d_total))
        return lmat.index_put((rows, cols), params.l_packed)

    def p_matrix(self, params: QuadraticQParams) -> torch.Tensor:
        lmat = self.l_matrix(params)
        return lmat @ lmat.T

    def __call__(self, params: QuadraticQParams, obs: torch.Tensor,
                 actions: torch.Tensor) -> torch.Tensor:
        """Q values for batched (obs [..., dO], actions [..., dA])."""
        z = torch.cat([obs, actions], dim=-1)
        quad = 0.5 * torch.sum((z @ self.p_matrix(params)) * z, dim=-1)
        return quad + z @ params.j + params.c

    def loss(self, params: QuadraticQParams, obs, actions, targets,
             reg: float = 0.0) -> torch.Tensor:
        """0.5 MSE, plus 0.5 reg (|L|^2 + |J|^2): the reference SGD's
        weight decay."""
        out = self(params, obs, actions)
        err = out - targets.reshape(out.shape)
        l2 = torch.sum(params.l_packed ** 2) + torch.sum(params.j ** 2)
        return 0.5 * torch.mean(err ** 2) + 0.5 * reg * l2

    def conditional(self, params: QuadraticQParams):
        """(chol(Paa + jitter I), Pas, Ja): what the conditional action
        Gaussian needs of the parameters, factorised once."""
        p = self.p_matrix(params)
        paa = p[self.d_obs:, self.d_obs:] + self.jitter * _eye(self.d_action, p)
        return _chol(paa), p[self.d_obs:, :self.d_obs], params.j[self.d_obs:]

    def conditional_mean(self, conditional, obs: torch.Tensor) -> torch.Tensor:
        """mu(s) [..., dA] at observations obs [..., dO]: one
        cholesky_solve for every observation of the batch."""
        chol, pas, j_a = conditional
        rhs = -j_a - obs @ pas.T
        mu = torch.cholesky_solve(rhs.reshape(-1, self.d_action).T, chol).T
        return mu.reshape(rhs.shape)

    def act_mean_sigma(self, params: QuadraticQParams, obs: torch.Tensor,
                       lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu [..., dA], Sigma [dA, dA]): the conditional soft-Q action
        Gaussian at observations obs [..., dO]."""
        cond = self.conditional(params)
        sigma = lam * torch.cholesky_solve(_eye(self.d_action, cond[0]), cond[0])
        return self.conditional_mean(cond, obs), sigma

    def grow_cov(self, params: QuadraticQParams, beta: float, lam: float) -> QuadraticQParams:
        """Sigma <- lam P^-1 + beta I in moment space, mapped back with the
        self-consistent P_new = lam Sigma^-1 (the identity at beta = 0) and
        repacked."""
        eye = _eye(self.d_total, params.l_packed)
        chol = _chol(self.p_matrix(params) + self.jitter * eye)
        sigma = lam * torch.cholesky_solve(eye, chol) + beta * eye
        p_new = lam * torch.cholesky_solve(eye, _chol(sigma))
        rows, cols = self._tril(p_new.device)
        return params._replace(l_packed=_chol(p_new)[rows, cols])
