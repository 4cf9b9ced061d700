"""Benchmark runner of the PyTorch port: solves/s and op microbenchmarks.

Counterpart of mjmpc_tpu/harness/benchmark.py: the same functions,
arguments, suite and metric strings, so that a row of each package can be
matched, on one CUDA card unless the caller passes device="cpu" (each
function's `device`; the CLI's --device). Two fields are renamed because
they name a device: bench_ops' `filtered_noise_pallas_us` is
`filtered_noise_kernel_us` (kernel #2, csrc/filtered_noise.cu), and
bench_roofline's `mfu_pct_bf16` against the TPU's bf16 peak is
`mfu_pct_f32` against the H100's f32 rate (bounds.PEAK_F32_PER_S; TF32 is
off package-wide). A row run on the CPU times the kernels' plain versions;
main() writes the device it ran on beside every row.

Timers, shared with chip_smoke.py and tools/: every timing window ends by
reading to the host a value that depends on every call in it, and a
non-finite value raises (_finite_read, _time, solves_per_s), so a window
never times the host's enqueue rate alone; cuda_call_ms / cuda_ms time
calls on the card by CUDA events behind a spin kernel that holds the
stream while the host enqueues them.

Usage: python -m mjmpc_tpu_torch.harness.benchmark [--quick] [--json PATH]
    [--profile DIR] [--weak-scaling] [--cpu-mesh] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import bounds, envs, ops, parallel, rng, solvers
from ..ops import chain_rollout, noise, pendulum

HOLD_CYCLES = 100_000_000   # about 50 ms of spinning at the H100's clock
CPU_MESH = 8                # --cpu-mesh: a mesh of this many "cpu" devices


def _finite_read(out) -> float:
    """Read to the host the sum of `out`'s first tensor (a tensor, or a
    tuple or state of them) and check that it is finite: a window that
    ends here depends on the calls that made it."""
    leaf = next(iter(solvers.tensor_leaves(out).values()))
    val = float(torch.sum(leaf.to(torch.float32)))
    if not np.isfinite(val):
        raise RuntimeError(f"non-finite benchmark output: {val}")
    return val


def _time(fn, *args, iters: int = 50, warmup: int = 2) -> float:
    """Steady-state seconds a call by the host clock. Each call's first
    output tensor is accumulated and the window ends by reading the
    accumulator, so the span depends on every timed call (the small add a
    call is included in the rate)."""
    for _ in range(warmup):
        out = fn(*args)
    _finite_read(out)
    acc = None
    start = time.perf_counter()
    for _ in range(iters):
        leaf = next(iter(solvers.tensor_leaves(fn(*args)).values()))
        acc = leaf if acc is None else acc + leaf
    _finite_read(acc)
    return (time.perf_counter() - start) / iters


def cuda_call_ms(fn, reps: int = 1):
    """(fn()'s last result, the mean time of `reps` calls in ms by CUDA
    events), with no warm-up. A spin kernel queued first holds the stream
    while the host enqueues the calls, so a kernel shorter than its own
    host-side launch is timed on the device, not at the host's enqueue
    rate; a plain version that takes seconds a call is timed as it runs."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls (cuda_call_ms) after one
    warm-up call."""
    fn()
    return cuda_call_ms(fn, reps)[1]


def solves_per_s(solve, env, env_state, state, k: int, windows: int):
    """Median read-verified rate over `windows` windows of k chained
    solves; each window ends by reading the last action."""
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(k):
            action, _, state = solve(env.params, env_state, state)
        value = float(action[0])
        rates.append(k / (time.perf_counter() - t0))
        if not np.isfinite(value):
            raise RuntimeError("solve chain produced a non-finite action")
    return statistics.median(rates), rates, state


def _mppi(env, horizon: int, num_particles: int, device) -> solvers.MPPI:
    """The suite's MPPI (the JAX module's configuration)."""
    return solvers.MPPI(
        d_action=env.d_action, horizon=horizon, num_particles=num_particles,
        lam=0.01, init_cov=3.0, step_size=0.55, gamma=1.0,
        filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat", device=device)


def bench_solver(env_name: str, controller: str, horizon: int,
                 num_particles: int, iters: int = 50, device="cuda",
                 **solver_kwargs) -> Dict[str, Any]:
    env = envs.make(env_name, device=device)
    defaults = dict(d_action=env.d_action, horizon=horizon,
                    num_particles=num_particles, gamma=1.0,
                    filter_coeffs=(0.25, 0.8, 0.0))
    if controller == "mppi":
        defaults.update(lam=0.01, init_cov=3.0, step_size=0.55,
                        base_action="repeat")
    elif controller == "cem":
        defaults.update(elite_frac=0.2, beta=0.3, step_size=0.9)
    elif controller == "pfmpc":
        defaults = dict(d_action=env.d_action, horizon=horizon,
                        num_particles=num_particles, lam=0.1,
                        cov_shift=0.1, cov_resample=1.0)
    solver = solvers.make_solver(controller, **{**defaults, "device": device, **solver_kwargs})

    solve = solvers.make_solve_fn(solver, env)
    sstate = solver.init_state(0)
    estate = env.init(env.params, 1)

    # chained-state timing: the production control loop. The final action
    # depends on every solve through the chained solver state, so one read
    # at the end verifies the whole window.
    for _ in range(2):
        a, _, sstate = solve(env.params, estate, sstate)
    _finite_read(a)
    start = time.perf_counter()
    s = sstate
    for _ in range(iters):
        a, _, s = solve(env.params, estate, s)
    _finite_read(a)
    dt = (time.perf_counter() - start) / iters

    return dict(metric=f"{controller}_solves_per_s"
                       f"[{env_name},H={horizon},N={num_particles}]",
                value=round(1.0 / dt, 2), unit="solves/s")


def bench_ops(num_particles: int = 4096, horizon: int = 32,
              d_action: int = 7, device="cuda") -> List[Dict[str, Any]]:
    """The plain sampler (the JAX package's "xla" noise), kernel #2 alone
    (filtered, not coloured, as the TPU kernel's row) and the cost-to-go."""
    rows = []
    key, step = rng.stream_key(0, 0), rng.step_tensor(0, device)
    cov = torch.eye(d_action, device=device)
    coeffs = (0.25, 0.8, 0.0)

    dt = _time(lambda: ops.filtered_noise(key, step, cov, (num_particles, horizon), coeffs))
    rows.append(dict(metric="filtered_noise_xla_us", value=round(dt * 1e6, 1),
                     unit="us"))

    sampler = ops.FilteredNoise()
    try:
        dt = _time(lambda: sampler.white(key, step, num_particles, horizon, d_action, coeffs))
        rows.append(dict(metric="filtered_noise_kernel_us",
                         value=round(dt * 1e6, 1), unit="us"))
    except Exception as e:   # an error row, which main() turns into a failure
        rows.append(dict(metric="filtered_noise_kernel_us", value=-1,
                         unit="error", error=f"{type(e).__name__}: {e}"[:500]))

    costs = torch.rand((num_particles, horizon), generator=rng.generator(0, device),
                       device=device)
    discount = ops.discount_matrix(ops.gamma_sequence(0.99, horizon), device=device)
    dt = _time(lambda: ops.cost_to_go(costs, discount))
    rows.append(dict(metric="cost_to_go_us", value=round(dt * 1e6, 1),
                     unit="us"))
    return rows


DEFAULT_SUITE = [
    ("reacher_7dof-v0", "mppi", 32, 4096),
    ("reacher_7dof-v0", "mppi", 32, 16384),
    ("SimplePendulum-v0", "mppi", 32, 4096),
    ("SimplePendulum-v0", "random_shooting", 32, 4096),
    ("SimplePendulum-v0", "cem", 32, 4096),
    ("reacher_7dof-v0", "cem", 16, 4096),
    ("SimplePendulum-v0", "pfmpc", 32, 4096),
    # contact-rich hand suite: the forest rollout (kernel #6)
    ("pen-v0", "mppi", 32, 1024),
    # locomotion family through the external-force rollout (kernel #5)
    ("Swimmer-v0", "mppi", 32, 4096),
    ("HalfCheetah-v0", "mppi", 32, 1024),
]


def bench_latency(env_name: str = "reacher_7dof-v0", horizon: int = 32,
                  num_particles: int = 4096, iters: int = 30, device="cuda"):
    """Blocked per-solve latency, the real-time control metric (one MPC
    solve per control step): the median over `iters` solves of the host
    time from the call to the action read back."""
    if env_name not in envs.available():
        env_name = "SimplePendulum-v0"
    env = envs.make(env_name, device=device)
    solver = _mppi(env, horizon, num_particles, device)
    solve = solvers.make_solve_fn(solver, env)
    s = solver.init_state(0)
    est = env.init(env.params, 1)
    out = solve(env.params, est, s)
    _finite_read(out)
    lats = []
    for _ in range(iters):
        start = time.perf_counter()
        out = solve(env.params, est, s)
        _finite_read(out)   # the action read back is part of the latency
        lats.append(time.perf_counter() - start)
    med = float(np.median(lats))
    return dict(metric=f"mppi_solve_latency_ms"
                       f"[{env_name},H={horizon},N={num_particles}]",
                value=round(med * 1e3, 3), unit="ms")


def _devices(device) -> list:
    """The devices of a mesh on `device`'s type: every card, or the CPU."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"]


def bench_sharded(horizon: int = 32, particles_per_device: int = 4096,
                  iters: int = 30, device="cuda", devices=None):
    """Weak-scaling probe: the sharded solve (parallel.build_sharded_solve_fn)
    with N scaled by the device count, over `devices` (default: every card
    of `device`'s type)."""
    devices = list(devices) if devices is not None else _devices(device)
    n_dev = len(devices)
    mesh = parallel.make_mesh(devices=devices)
    env = envs.make("reacher_7dof-v0" if "reacher_7dof-v0"
                    in envs.available() else "SimplePendulum-v0", device=devices[0])
    n = particles_per_device * n_dev
    solver = _mppi(env, horizon, n, devices[0])
    solve = parallel.build_sharded_solve_fn(solver, env, mesh)
    s = solver.init_state(0)
    est = env.init(env.params, 1)
    a, _, s = solve(env.params, est, s)
    _finite_read(a)
    start = time.perf_counter()
    for _ in range(iters):
        a, _, s = solve(env.params, est, s)
    _finite_read(a)
    dt = (time.perf_counter() - start) / iters
    return dict(metric=f"sharded_mppi_solves_per_s"
                       f"[{env.name},H={horizon},N={n},devices={n_dev}]",
                value=round(1.0 / dt, 2), unit="solves/s")


def bench_aggregate(env_name: str = "reacher_7dof-v0", horizon: int = 32,
                    num_particles: int = 4096, batches=(1, 2, 4, 8),
                    iters: int = 10, device="cuda") -> List[Dict[str, Any]]:
    """Aggregate throughput: B independent MPC solves at once
    (solvers.build_batched_solve_fn: one launch of kernel #2 and one of
    kernel #1 for all B each iteration). The single-card utilization probe:
    if B doubles aggregate solves/s, the single-stream headline is bound
    by dispatch or occupancy, not by compute."""
    if env_name not in envs.available():
        env_name = "SimplePendulum-v0"
    env = envs.make(env_name, device=device)
    solver = _mppi(env, horizon, num_particles, device)
    vsolve = solvers.build_batched_solve_fn(solver, env)
    rows = []
    for b in batches:
        est = solvers.stack_states([env.init(env.params, rng.derive_seed(1, i))
                                    for i in range(b)])
        s = solver.init_batch([rng.derive_seed(0, i) for i in range(b)])
        for _ in range(2):
            a, _, s = vsolve(env.params, est, s)
        _finite_read(a)
        start = time.perf_counter()
        for _ in range(iters):
            a, _, s = vsolve(env.params, est, s)
        _finite_read(a)   # chained solver state: one read covers all
        dt = (time.perf_counter() - start) / iters
        rows.append(dict(
            metric=f"aggregate_mppi_solves_per_s"
                   f"[{env_name},H={horizon},N={num_particles},B={b}]",
            value=round(b / dt, 2), unit="solves/s",
            ms_per_dispatch=round(dt * 1e3, 3)))
    return rows


def solve_work(solver: solvers.MPPI, env) -> Dict[str, Any]:
    """Operations and bytes of one MPPI solve (one iteration) on env's
    fused rollout, counted from the port's sources (there is no XLA
    cost_analysis): the kernels it launches as bounds.py counts them (the
    noise kernel, noise_flops; the rollout, kernel #1's rollout_flops on a
    chain env or kernel #7's on the pendulum), the plain sampler's colouring
    (2 dA a noise element) where it colours outside the kernel, and the
    update: mean + noise and its delta (2 an element), the control cost
    (4 an element, its sum over dA, mean cov^-1: 2 H dA^2 + dA^3), two
    discount-matrix products (2 N H^2 each: the costs' and the control
    costs' cost-to-go), the softmax over N (4 a particle), the weighted
    mean (2 N H dA) and the step-size blend (3 H dA). Bytes: each kernel's
    inputs read once and outputs written once, and the update's read of
    the noise and the costs."""
    n, h, da = solver.num_particles, solver.horizon, solver.d_action
    noise_bytes, noise_ops = 4 * n * h * da, noise.noise_flops(n, h, da)
    kernel = getattr(env.fused_rollout, "kernel", None)
    if isinstance(kernel, chain_rollout.ChainRollout) and kernel.mode == "costs":
        roll_bytes, roll_ops = bounds.chain_work(kernel.model, n, h, "costs", kernel.task,
                                                 kernel.n_substeps)
        rollout = "kernel #1 (ops/chain_rollout.py rollout_flops)"
    elif env.fused_rollout is pendulum.pendulum_rollout:
        roll_bytes = pendulum.rollout_bytes(n, h)
        roll_ops = pendulum.rollout_flops(n, h)
        rollout = "kernel #7 (ops/pendulum.py rollout_flops)"
    else:
        raise ValueError(f"no operation count for {env.name!r}'s rollout")
    elem = n * h * da
    colour = 0 if solver.noise_impl == "kernel" else 2 * da * elem
    update = (2 * elem + 4 * elem + elem + 2 * h * da * da + da ** 3 + 2 * 2 * n * h * h
              + 4 * n + 2 * elem + 3 * h * da)
    return dict(flops=float(noise_ops + colour + roll_ops + update),
                bytes=float(noise_bytes + roll_bytes + 4 * (elem + n * h)),
                counted_from=f"ops/noise.py noise_flops, {rollout}, MPPI update")


def bench_roofline(env_name: str = "reacher_7dof-v0", horizon: int = 32,
                   num_particles: int = 4096, iters: int = 50,
                   peak_flops: float = bounds.PEAK_F32_PER_S, device="cuda"):
    """Operation and byte accounting of the headline solve: solve_work's
    counts over the measured rate place the solve on the roofline:
    achieved FLOP/s, the share of the card's f32 rate (67 TFLOP/s on the
    H100 SXM; the solve is small-matrix f32 physics, so the share is a
    position statement, not a matmul-efficiency target) and the
    arithmetic intensity."""
    if env_name not in envs.available():
        env_name = "SimplePendulum-v0"
    env = envs.make(env_name, device=device)
    solver = _mppi(env, horizon, num_particles, device)
    solve = solvers.make_solve_fn(solver, env)
    s = solver.init_state(0)
    est = env.init(env.params, 1)
    work = solve_work(solver, env)
    flops, nbytes = work["flops"], work["bytes"]
    dt = _time(lambda: solve(env.params, est, s), iters=iters)
    achieved = flops / dt
    return dict(
        metric=f"roofline[{env_name},H={horizon},N={num_particles}]",
        value=round(achieved / 1e12, 4), unit="TFLOP/s",
        flops_per_solve=flops, bytes_per_solve=nbytes,
        mfu_pct_f32=round(100.0 * achieved / peak_flops, 3),
        ai_flops_per_byte=round(flops / nbytes, 3) if nbytes else None,
        analytic_bytes_gb_per_s=round(nbytes / dt / 1e9, 2),
        counted_from=work["counted_from"])


def bench_weak_scaling(horizon: int = 32, particles_per_device: int = 512,
                       iters: int = 20, device="cuda", devices=None):
    """Weak-scaling trend over 1/2/4/8-device sub-meshes with fixed
    particles per device. On a mesh of CPU devices (--cpu-mesh) this
    measures the sharding's overhead only: every shard runs on the same
    host cores."""
    all_dev = list(devices) if devices is not None else _devices(device)
    rows = []
    base_rate = None
    for nd in (1, 2, 4, 8):
        if nd > len(all_dev):
            break
        mesh = parallel.make_mesh(episodes=1, particles=nd, devices=all_dev[:nd])
        env = envs.make("reacher_7dof-v0" if "reacher_7dof-v0"
                        in envs.available() else "SimplePendulum-v0", device=all_dev[0])
        n = particles_per_device * nd
        solver = _mppi(env, horizon, n, all_dev[0])
        solve = parallel.build_sharded_solve_fn(solver, env, mesh)
        s = solver.init_state(0)
        est = env.init(env.params, 1)
        dt = _time(lambda: solve(env.params, est, s), iters=iters)
        rate = 1.0 / dt
        if base_rate is None:
            base_rate = rate
        rows.append(dict(
            metric=f"weak_scaling[devices={nd},N={n}]",
            value=round(rate, 2), unit="solves/s",
            efficiency_pct=round(100.0 * rate / base_rate, 1)))
    return rows


def device_name(device) -> str:
    """The name of the card `device` runs on, or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="fewer iterations / smaller suite")
    parser.add_argument("--json", type=str, default=None,
                        help="also write results to this file")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler chrome trace of bench_latency "
                             "to this dir")
    parser.add_argument("--weak-scaling", action="store_true",
                        help="only run the 1/2/4/8-device weak-scaling trend")
    parser.add_argument("--cpu-mesh", action="store_true",
                        help=f"run on the CPU, with a mesh of {CPU_MESH} cpu devices")
    parser.add_argument("--device", default="cuda",
                        help="the device to run on (default: the card)")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu_mesh else args.device
    devices = ["cpu"] * CPU_MESH if args.cpu_mesh else _devices(device)
    name = device_name(device)

    rows = []

    def emit(row):
        row = dict(row, device=name)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def _run(label, fn, *a, **kw):
        # one failing row (a kernel that fails on one env) must not lose the
        # rest of the suite; main fails at the end
        try:
            out = fn(*a, **kw)
        except Exception as e:
            out = dict(metric=label, value=-1, unit="error",
                       error=f"{type(e).__name__}: {e}"[:500])
        for row in (out if isinstance(out, list) else [out]):
            emit(row)

    if args.weak_scaling:
        _run("weak_scaling", bench_weak_scaling, device=device, devices=devices)
    else:
        suite = DEFAULT_SUITE[:3] if args.quick else DEFAULT_SUITE
        iters = 10 if args.quick else 50
        for env_name, controller, horizon, n in suite:
            if env_name not in envs.available():
                continue
            _run(f"{controller}[{env_name},H={horizon},N={n}]",
                 bench_solver, env_name, controller, horizon, n, iters=iters, device=device)
        _run("latency", bench_latency, device=device)
        _run("roofline", bench_roofline, iters=iters, device=device)
        _run("aggregate", bench_aggregate,
             batches=(1, 2) if args.quick else (1, 2, 4, 8),
             iters=iters // 5 or 2, device=device)
        if len(devices) > 1:
            _run("sharded", bench_sharded, device=device, devices=devices)
        _run("ops", bench_ops, device=device)

        if args.profile:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(args.profile, exist_ok=True)
            with torch.profiler.profile(activities=activities) as prof:
                bench_latency(iters=5, device=device)
            prof.export_chrome_trace(os.path.join(args.profile, "bench_latency.json"))
            emit(dict(metric="profile_trace", value=args.profile, unit="path"))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    errors = [r["metric"] for r in rows if r["unit"] == "error"]
    if errors:
        raise SystemExit(f"benchmark rows failed: {errors}")
    return rows


if __name__ == "__main__":
    main()
