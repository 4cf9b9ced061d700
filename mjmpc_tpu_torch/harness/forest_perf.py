"""The forest kernel's (the hand suite's) accounting: operations and timings.

Counterpart of mjmpc_tpu/harness/forest_perf.py, with its rows and names,
for kernel #6 (csrc/forest_rollout.cu) on one CUDA card unless --device
cpu:

1. **Operations per particle-substep** (substep_flops), counted from the
   kernel's source, csrc/forest_rollout.cuh (ops/forest_rollout.py
   _substep_flops: a multiply, an add, a compare, a division or a
   transcendental is one, each operation the function needs counted once),
   where the JAX package counts the primitives of its lane function's
   jaxpr. The two counts differ by a few percent (pen-v0 22,784 against
   the jaxpr's 22,853, door-v0 28,821 against 27,373): the jaxpr counts the
   selects and compares of the TPU kernel's lane code, its lane-masked
   forms of what the CUDA kernel branches on, and the port counts from its
   own source.
2. **Read-verified rollout timings** at the reference config's N=100 and
   at N=1024, H=32: the minimum over windows after one discarded window.
3. The roofline position: particle-substeps/s x operations a substep =
   sustained FLOP/s, as a share of the H100's f32 rate
   (bounds.PEAK_F32_PER_S, 67 TFLOP/s; `f32_peak_pct_N*` in place of the
   TPU's `vpu_peak_pct_N*`), and the HBM traffic of a rollout (noise in,
   costs out), which shows that the kernel is bound by neither.

Usage:
  python -m mjmpc_tpu_torch.harness.forest_perf [--envs pen-v0,...] [--flops-only]
      [--horizon 32] [--device cuda]
Prints one JSON line per row (the contract of harness.benchmark). With
--flops-only it times nothing and runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bounds, envs
from ..ops import forest_rollout
from .benchmark import device_name


def substep_flops(env) -> dict:
    """Operations of one particle's substep in env's forest kernel: the FK
    pass and the substep (flops_per_particle_substep), and the task's cost
    after each control step (cost_flops_per_particle_step)."""
    roll = getattr(env.fused_rollout, "kernel", None)
    if not isinstance(roll, forest_rollout.ForestRollout):
        raise ValueError(f"{env.name}: fused_rollout is not the forest kernel")
    fk, sub = forest_rollout._substep_flops(roll.consts, roll.task)
    return dict(flops_per_particle_substep=round(float(fk + sub), 1),
                cost_flops_per_particle_step=round(float(roll.task.cost_ops), 1),
                n_substeps=roll.n_substeps)


def time_rollout(env, n: int, horizon: int, iters: int = 20,
                 windows: int = 3) -> float:
    """Read-verified seconds per fused rollout call: the minimum over
    `windows` windows after a first, discarded one (warm-up)."""
    rs = np.random.default_rng(0)
    d = env.d_action
    mean = torch.as_tensor(np.asarray(rs.normal(size=(horizon, d)) * 0.1, np.float32),
                           device=env.device)
    noise = torch.as_tensor(np.asarray(rs.normal(size=(n, horizon, d)) * 0.2, np.float32),
                            device=env.device)
    state = env.init(env.params, 0)
    roll = env.fused_rollout
    best = None
    for w in range(windows + 1):   # window 0 is the warm-up, discarded
        acc = None
        start = time.perf_counter()
        for _ in range(iters):
            out = roll(env.params, state, mean, noise)
            acc = out if acc is None else acc + out
        val = float(torch.sum(acc))   # depends on every call
        dt = (time.perf_counter() - start) / iters
        if not np.isfinite(val):
            raise RuntimeError(f"{env.name}: non-finite rollout costs")
        if w > 0:
            best = dt if best is None else min(best, dt)
    return best


_DEFAULT_ENVS = ("pen-v0", "relocate-v0", "hammer-v0", "door-v0")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--envs", default=",".join(_DEFAULT_ENVS))
    p.add_argument("--flops-only", action="store_true",
                   help="skip the timings (runs on the CPU)")
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="the device to time on (default: the card)")
    args = p.parse_args(argv)
    device = "cpu" if args.flops_only else args.device

    rows = []
    for name in args.envs.split(","):
        name = name.strip()
        env = envs.make(name, device=device)
        row = dict(metric=f"forest_kernel[{name}]", unit="report", device=device_name(device))
        try:
            row.update(substep_flops(env))
        except Exception as e:
            row["flops_error"] = str(e)[:200]
        if not args.flops_only:
            for n in (100, 1024):
                dt = time_rollout(env, n, args.horizon)
                ps = n * args.horizon * row.get("n_substeps", 5)
                rate = ps / dt
                fl = row.get("flops_per_particle_substep", 0.0)
                row[f"rollout_ms_N{n}"] = round(dt * 1e3, 3)
                row[f"particle_substeps_per_s_N{n}"] = round(rate, 0)
                row[f"sustained_tflops_N{n}"] = round(rate * fl / 1e12, 3)
                row[f"f32_peak_pct_N{n}"] = round(
                    100.0 * rate * fl / bounds.PEAK_F32_PER_S, 2)
                # HBM traffic: noise in [N, H, dA] f32 + costs out [N, H]
                nbytes = 4.0 * (n * args.horizon * (env.d_action + 1))
                row[f"hbm_gb_per_s_N{n}"] = round(nbytes / dt / 1e9, 3)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
