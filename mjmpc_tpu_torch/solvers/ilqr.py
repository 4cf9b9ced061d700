"""Iterative LQR on the differentiable envs.

Counterpart of mjmpc_tpu/solvers/ilqr.py. Each of n_iters iterations:

- forward pass: the nominal rollout of the action sequence from the
  current env state;
- linearise: A_t = df/dx, B_t = df/du of the flattened state and the cost's
  gradient and Hessian in (x, u) along the trajectory, by torch.func
  (jacfwd, grad, hessian), vmapped over the horizon; the cost is the env's
  own negated reward;
- backward Riccati pass with the Levenberg-Marquardt term mu I on Quu
  (plus a 1e-6 jitter), each step's cost derivatives scaled by gamma^t so
  that the quadratic model matches the discounted objective;
- line search: the feedforward gain scaled by each of _ALPHAS, all
  rolled out as one batch; the cheapest candidate replaces the plan if it
  beats the nominal cost (argmin and torch.where, no host branch).

The solve reads nothing back to the host: the Cholesky factor comes from
cholesky_ex (cholesky checks its info on the host and raises where the JAX
code goes on), the pick from argmin and index_select, the step advances by
a device add. So a solve can be captured as a CUDA graph. Only the
floating fields of the env state are flattened into the differentiable
state vector; integer and host fields (a timestep, the maze's key) are
held fixed during planning, as the JAX `_ravel_spec` does.

Scope, as in the JAX package: smooth analytic envs (LQR, where one
iteration is exact against finite-horizon DP, the pendulum, cartpole,
point_mass, maze). On the engine envs the Hessian nests over the engine's
own torch.func bias, which is slow; the sampling controllers are what the
configs run there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Union

import torch

from .. import ops, rng
from ..envs.base import Env

_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)   # the parallel line-search set
_TAG_INIT = 40


@dataclasses.dataclass(frozen=True)
class ILQRState:
    mean: torch.Tensor   # [H, dA] nominal action sequence
    step: torch.Tensor   # [] int64 on the device: solves taken so far
    seed: int            # base seed of the solver's streams


def _ravel_spec(state):
    """(ravel, unravel) between a state dataclass and the flat vector
    [..., dx] of its floating tensor fields; other fields (integer tensors,
    host values) are frozen at their values in `state`. unravel keeps the
    vector's leading dimensions."""
    fields = [(f.name, getattr(state, f.name)) for f in dataclasses.fields(state)]
    diff = [(name, v.shape, v.dtype) for name, v in fields
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    frozen = {name: v for name, v in fields if name not in {d[0] for d in diff}}

    def ravel(s) -> torch.Tensor:
        parts = [getattr(s, name) for name, _, _ in diff]
        lead = parts[0].shape[:parts[0].dim() - len(diff[0][1])]
        return torch.cat([p.reshape(lead + (-1,)).to(torch.float32) for p in parts], -1)

    def unravel(vec: torch.Tensor):
        out, off = dict(frozen), 0
        for name, shape, dtype in diff:
            size = shape.numel()
            out[name] = vec[..., off:off + size].reshape(vec.shape[:-1] + shape).to(dtype)
            off += size
        return dataclasses.replace(state, **out)

    return ravel, unravel


@dataclasses.dataclass(frozen=True)
class ILQR:
    d_action: int
    horizon: int
    num_particles: int = 1          # the config schema's; iLQR samples nothing
    gamma: float = 1.0
    n_iters: int = 5
    mu: float = 1e-3                # Levenberg-Marquardt term on Quu
    init_std: float = 0.01          # scale of the initial sequence
    action_lows: Optional[Any] = None
    action_highs: Optional[Any] = None
    device: Union[str, torch.device] = "cuda"

    @functools.cached_property
    def gamma_pow(self) -> torch.Tensor:
        """gamma^t [H] on the solver's device, built once."""
        return torch.as_tensor(ops.gamma_sequence(self.gamma, self.horizon).ravel(),
                               dtype=torch.float32, device=self.device)

    @functools.cached_property
    def alphas(self) -> torch.Tensor:
        return torch.tensor(_ALPHAS, dtype=torch.float32, device=self.device)

    @functools.cached_property
    def bounds(self):
        """(lows, highs) [dA] tensors on the device, or None."""
        if self.action_lows is None:
            return None
        as_t = lambda b: torch.as_tensor(b, dtype=torch.float32).to(self.device)
        return as_t(self.action_lows), as_t(self.action_highs)

    def build_constants(self) -> None:
        """Build the solve's device constants now, outside any solve."""
        self.gamma_pow, self.alphas, self.bounds

    def init_state(self, seed: int) -> ILQRState:
        """A mean of init_std * N(0, 1) draws from the stream (seed, 40) at
        step 0."""
        step = rng.step_tensor(0, self.device)
        mean = self.init_std * ops.standard_normals(rng.stream_key(seed, _TAG_INIT), step,
                                                    (self.horizon, self.d_action))
        return ILQRState(mean=mean, step=step, seed=int(seed))

    def act(self, state: ILQRState) -> torch.Tensor:
        return state.mean[0]

    def shift(self, state: ILQRState) -> ILQRState:
        mean = torch.roll(state.mean, -1, 0)
        mean[-1] = 0.0
        return dataclasses.replace(state, mean=mean)


def build_solve_fn(solver: ILQR, env: Env):
    """solve(env_params, env_state, ILQRState) -> (action [dA], the plan's
    discounted cost, new state)."""
    h, da = solver.horizon, solver.d_action
    solver.build_constants()
    eye_da = torch.eye(da, device=solver.device)

    def solve(env_params, env_state, state: ILQRState):
        ravel, unravel = _ravel_spec(env_state)
        x0 = ravel(env_state)
        dx = x0.shape[-1]
        gamma_pow = solver.gamma_pow

        def f(x, u):
            new_state, _, reward, _ = env.step(env_params, unravel(x), u)
            return ravel(new_state), -reward

        def rollout(us):
            """States entering each step [H, dx] and costs [H] of us [H, dA]."""
            xs, cs, x = [], [], x0
            for t in range(h):
                xs.append(x)
                x, c = f(x, us[t])
                cs.append(c)
            return torch.stack(xs), torch.stack(cs)

        def linearize(x, u):
            z = torch.cat([x, u])
            fz = lambda zz: f(zz[:dx], zz[dx:])[0]
            cz = lambda zz: f(zz[:dx], zz[dx:])[1]
            jac = torch.func.jacfwd(fz)(z)
            return (jac[:, :dx], jac[:, dx:], torch.func.grad(cz)(z),
                    torch.func.hessian(cz)(z))

        us = state.mean
        for _ in range(solver.n_iters):
            xs, cs = rollout(us)
            # float32: a tangent of a 0-d tensor beside a Python float can come
            # out float64 (engine/chain.py _sincc)
            a_s, b_s, g_s, h_s = (v.to(x0.dtype) for v in torch.func.vmap(linearize)(xs, us))
            gc, hc = gamma_pow[:, None] * g_s, gamma_pow[:, None, None] * h_s
            cx, cu = gc[:, :dx], gc[:, dx:]
            cxx, cuu, cux = hc[:, :dx, :dx], hc[:, dx:, dx:], hc[:, dx:, :dx]

            vx = x0.new_zeros(dx)
            vxx = x0.new_zeros(dx, dx)
            k_ff, k_fb = [None] * h, [None] * h
            for t in reversed(range(h)):
                a, b = a_s[t], b_s[t]
                qx = cx[t] + a.T @ vx
                qu = cu[t] + b.T @ vx
                qxx = cxx[t] + a.T @ vxx @ a
                quu = cuu[t] + b.T @ vxx @ b + solver.mu * eye_da
                qux = cux[t] + b.T @ vxx @ a
                chol = torch.linalg.cholesky_ex(quu + 1e-6 * eye_da).L
                kf = -torch.cholesky_solve(qu[:, None], chol)[:, 0]
                kb = -torch.cholesky_solve(qux, chol)
                vx = qx + kb.T @ quu @ kf + kb.T @ qu + qux.T @ kf
                vxx = qxx + kb.T @ quu @ kb + kb.T @ qux + qux.T @ kb
                vxx = 0.5 * (vxx + vxx.T)
                k_ff[t], k_fb[t] = kf, kb

            # every alpha's forward pass as one batch of len(_ALPHAS)
            alphas = solver.alphas[:, None]
            x = x0.expand(len(_ALPHAS), dx)
            cand_us, cand_cs = [], []
            for t in range(h):
                u = us[t] + alphas * k_ff[t] + (x - xs[t]) @ k_fb[t].T
                x, c = f(x, u)
                cand_us.append(u)
                cand_cs.append(c)
            cand_us = torch.stack(cand_us, 1)                     # [A, H, dA]
            costs = torch.stack(cand_cs, 1) @ gamma_pow           # [A]
            base = cs @ gamma_pow
            best = torch.argmin(costs)
            best_cost = torch.index_select(costs, 0, best.reshape(1))[0]
            best_us = torch.index_select(cand_us, 0, best.reshape(1))[0]
            us = torch.where(best_cost < base, best_us, us)
            plan_cost = torch.minimum(best_cost, base)
        action = us[0]
        if solver.bounds is not None:
            action = torch.clamp(action, *solver.bounds)
        new_state = solver.shift(ILQRState(mean=us, step=state.step + 1, seed=state.seed))
        return action, plan_cost, new_state

    return solve
