"""Instrumented SoftQMPC run on sawyer_reacher-v0 (counterpart of
mjmpc_tpu/harness/softq_diag.py).

Per solve it records what a plateau of the soft-Q controller could hide
behind:
- q_mse_pre / q_mse_post: the Q fit's residual on the solve's own targets
  before and after the n_grad_steps SGD block (does the Q fit at all?);
- grad_norm: the gradient norm before the clip (does the clip bind on
  every step, which makes the configured lr meaningless?);
- entropy, sigma_eig_min / sigma_eig_max: the induced action Gaussian;
- mu_sat: the share of policy-mean components outside the action bounds
  at the visited states;
- target_std / target_mean: the scale of the soft-Bellman targets.

Two arms: the stock config block, and the same block with per-feature
observation whitening (SoftQMPC.obs_shift / obs_scale) from a short
random-action episode.

Usage: python -m mjmpc_tpu_torch.harness.softq_diag [--whiten] [--steps N] [--device cuda]
Prints one JSON line every 15 solves and a summary line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from .. import envs, rng, solvers
from ..ops.control import capturable_linalg
from ..rollout.engine import _scan_rollout


def obs_stats_from_random(env, n_steps: int = 200, seed: int = 0):
    """Per-feature (mean, std + 1e-3) of the observations under uniform
    random actions in [-1, 1] (the whitening statistics; nothing is
    learned)."""
    state = env.init(env.params, seed)
    g = rng.generator(seed, "cpu")
    obs_list = []
    for _ in range(n_steps):
        a = (2.0 * torch.rand((env.d_action,), generator=g) - 1.0).to(env.device)
        state, obs, _, _ = env.step(env.params, state, a)
        obs_list.append(obs.cpu().numpy())
    arr = np.stack(obs_list)
    return arr.mean(0), arr.std(0) + 1e-3


def diagnose(whiten: bool = False, steps: int = 75, seed: int = 123, lr: float = 0.1,
             lam: float = 0.05, n_grad_steps: int = 8, num_particles: int = 64,
             horizon: int = 16, device="cuda"):
    env = envs.make("sawyer_reacher-v0", device=device)
    kw = {}
    if whiten:
        shift, scale = obs_stats_from_random(env)
        kw = dict(obs_shift=shift, obs_scale=scale)
    solver = solvers.SoftQMPC(
        d_obs=env.d_obs, d_action=env.d_action, horizon=horizon, num_particles=num_particles,
        lam=lam, gamma=0.99, lr=lr, n_grad_steps=n_grad_steps, grad_clip=10.0,
        device=env.device, **kw)
    solver.build_constants()
    model = solver.model

    def instrumented_solve(env_params, env_state, s):
        mean_fn, chol, entropy = solver._policy(s.q_params)
        traj = _scan_rollout(env, env_params, env_state, solver.white_noise(s) @ chol.T,
                             lambda t, obs: mean_fn(obs))
        obs_in, act_in, tgt_in = solver.fit_inputs(
            traj, solver.targets(s.q_params, traj, entropy))
        mse_pre = model.loss(s.q_params, obs_in, act_in, tgt_in)
        _, gnorm = solver.clipped_gradient(s.q_params, obs_in, act_in, tgt_in)
        s2 = solver.update(s, traj, entropy)
        mse_post = model.loss(s2.q_params, obs_in, act_in, tgt_in)
        _, sigma = model.act_mean_sigma(s2.q_params, obs_in.new_zeros(solver.d_obs), lam)
        eigs = torch.linalg.eigvalsh(sigma)
        mus, _ = model.act_mean_sigma(s2.q_params, obs_in[:256], lam)
        mu_sat = torch.mean((torch.abs(mus) > 1.0).to(torch.float32))
        action = solver.act(s2, env.observe(env_params, env_state))
        s2 = dataclasses.replace(s2, step=s2.step + 1)
        diag = dict(q_mse_pre=mse_pre, q_mse_post=mse_post, grad_norm=gnorm, entropy=entropy,
                    sigma_eig_min=eigs[0], sigma_eig_max=eigs[-1], mu_sat=mu_sat,
                    target_std=torch.std(tgt_in, correction=0), target_mean=torch.mean(tgt_in))
        return action, diag, s2

    s = solver.init_state(seed)
    est = env.init(env.params, rng.derive_seed(seed, 1))
    total_r, rows = 0.0, []
    for t in range(steps):
        with capturable_linalg(torch.device(env.device)):
            a, diag, s = instrumented_solve(env.params, est, s)
        est, _, r, _ = env.step(env.params, est, torch.clamp(a, -1.0, 1.0))
        total_r += float(r)
        row = {k: round(float(v), 5) for k, v in diag.items()}
        row["t"] = t
        rows.append(row)
        if t % 15 == 0 or t == steps - 1:
            print(json.dumps(row), flush=True)
    success = bool(env.success(env.params, est)) if env.success else None
    summary = dict(metric="softq_diag[sawyer_reacher-v0]", whiten=whiten,
                   reward=round(total_r, 1), success=success,
                   clip_bound_frac=round(float(np.mean([r["grad_norm"] > 10.0 for r in rows])), 3),
                   final_mse=rows[-1]["q_mse_post"])
    print(json.dumps(summary), flush=True)
    return rows, summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--whiten", action="store_true")
    p.add_argument("--steps", type=int, default=75)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lam", type=float, default=0.05)
    p.add_argument("--grad-steps", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    diagnose(whiten=args.whiten, steps=args.steps, lr=args.lr, lam=args.lam,
             n_grad_steps=args.grad_steps, device=args.device)


if __name__ == "__main__":
    main()
