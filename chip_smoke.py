"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each; any failure ends the script with a nonzero
exit and no final line:

1. device   -- the card's name and power limit (nvidia-smi).
2. build    -- nvcc builds the chain-rollout kernel from csrc/.
3. kernel   -- the kernel against its plain PyTorch version on the card,
               at (N=37, H=5) to atol 5e-5 and at the main path's
               (N=4096, H=32) to max abs error 1e-3 (costs are O(1); the
               longer horizon accumulates f32 reordering).
4. main     -- envs.make("reacher_7dof-v0") -> solvers.MPPI(...) ->
               solvers.make_solve_fn on device="cuda": 10 chained solves
               under torch.cuda.set_sync_debug_mode("error") (no host sync
               inside a solve), a finite action read once at the end, the
               kernel's launch count rising by exactly 10; then a 10-step
               evaluate_episode with finite rewards.
5. timing   -- read-verified solves/s with the fused kernel and with the
               plain rollout on the card (each window ends by reading a
               value that depends on every solve in it), one rollout call
               of each timed with CUDA events, and a per-stage breakdown.
               Printed, not asserted.

The last lines are the kernels' summary, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
HORIZON = 32
NUM_PARTICLES = 4096
N_SOLVES = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def reacher_inputs(n: int, h: int, seed: int, device):
    """Inputs drawn as in tests/test_pallas_chain.py."""
    import torch
    rng = np.random.default_rng(seed)
    mean = np.asarray(rng.normal(size=(h, 7)) * 0.3, np.float32)
    noise = np.asarray(rng.normal(size=(n, h, 7)) * 0.5, np.float32)
    q0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    qd0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    target = np.array([0.2, -0.1, 0.15], np.float32)
    return [torch.as_tensor(a, device=device)
            for a in (q0, qd0, target, mean, noise)]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from mjmpc_tpu_torch import envs, solvers
        from mjmpc_tpu_torch.ops.chain_rollout import ChainRollout
        from mjmpc_tpu_torch.rollout import Trajectories
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    device = torch.device(DEVICE)
    env = envs.make("reacher_7dof-v0", device=device)
    roll = ChainRollout(env.params.model, n_substeps=2)
    t0 = time.perf_counter()
    lib = roll.library()
    ptxas = [ln.strip() for ln in lib.ptxas.splitlines()
             if re.search(r"registers|spill", ln)]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(lib.build_seconds, 3), library=str(lib.path.name),
         ptxas=ptxas)

    # 3. kernel against its plain version, on the card
    errors = {}
    for n, h, tol, seed in ((37, 5, 5e-5, 1), (NUM_PARTICLES, HORIZON, 1e-3, 0)):
        args = reacher_inputs(n, h, seed, device)
        got = roll(*args)
        want = roll.plain(*args)
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"kernel output bad at N={n} H={h}")
        err = float((got - want).abs().max())
        errors[(n, h)] = err
        emit("kernel", name="chain_rollout", n=n, h=h, max_abs_err=err, atol=tol,
             costs_min=float(want.min()), costs_max=float(want.max()))
        if not err <= tol:
            raise RuntimeError(f"kernel disagrees with its plain version at "
                               f"N={n} H={h}: {err} > {tol}")

    # 4. main path
    solver = solvers.MPPI(
        d_action=env.d_action, horizon=HORIZON, num_particles=NUM_PARTICLES,
        lam=0.01, init_cov=3.0, step_size=0.55, gamma=1.0,
        filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat", device=device)
    solve = solvers.make_solve_fn(solver, env)
    env_state = env.init(env.params, 1)
    state = solver.init_state(0)
    torch.cuda.synchronize()
    ChainRollout.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    for _ in range(N_SOLVES):
        action, _, state = solve(env.params, env_state, state)
    torch.cuda.set_sync_debug_mode(0)
    launches = ChainRollout.launches
    action_host = action.cpu().numpy()
    emit("main", solves=N_SOLVES, launches=launches, action=action_host.tolist(),
         step=state.step)
    if not np.isfinite(action_host).all():
        raise RuntimeError("main path produced a non-finite action")
    if launches != N_SOLVES:
        raise RuntimeError(f"kernel launched {launches} times in {N_SOLVES} solves")

    episode = solvers.evaluate_episode(solver, env, 10)(env.params, 2)
    rewards = episode["reward"].cpu().numpy()
    emit("episode", steps=10, rewards=rewards.tolist())
    if rewards.shape != (10,) or not np.isfinite(rewards).all():
        raise RuntimeError("episode rewards not finite")

    # 5. timing (printed, not asserted)
    args = reacher_inputs(NUM_PARTICLES, HORIZON, 0, device)
    kernel_ms = cuda_ms(lambda: roll(*args), 20)
    plain_ms = cuda_ms(lambda: roll.plain(*args), 2)
    emit("rollout_time", kernel_ms=kernel_ms, plain_ms=plain_ms, card=smi)

    plain_env = dataclasses.replace(
        env, fused_rollout=lambda p, s, mean, noise: roll.plain(
            s.qpos, s.qvel, s.target, mean, noise))
    plain_solve = solvers.make_solve_fn(solver, plain_env)
    rates = {"kernel": [], "plain": []}
    for order in (("kernel", "plain"), ("plain", "kernel")):
        for which in order:
            fn = solve if which == "kernel" else plain_solve
            k, windows = (20, 5) if which == "kernel" else (2, 2)
            _, window_rates, state = solves_per_s(fn, env, env_state, state, k, windows)
            rates[which] += window_rates
    emit("solves_per_s", kernel=statistics.median(rates["kernel"]),
         plain=statistics.median(rates["plain"]), kernel_windows=rates["kernel"],
         plain_windows=rates["plain"], n=NUM_PARTICLES, h=HORIZON, card=smi)

    # where a solve's time goes: host clock per stage, synchronised
    stages = {"noise": [], "rollout": [], "update": [], "act_shift": []}
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        noise = solver.sample_noise(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        costs = env.fused_rollout(env.params, env_state, state.mean, noise)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        traj = Trajectories(None, state.mean[None] + noise, costs, None, None, None)
        s2 = solver.update(state, traj)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        solver.act(s2)
        state = solver.shift(dataclasses.replace(s2, step=s2.step + 1))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    emit("breakdown_ms", card=smi,
         **{k: statistics.median(v) for k, v in stages.items()})

    print(json.dumps({"kernels": [{
        "name": "chain_rollout", "route": "cuda",
        "source": "mjmpc_tpu_torch/csrc/chain_rollout.cu",
        "replaces": "mjmpc_tpu/ops/pallas_chain.py:381",
        "launches": launches,
        "max_abs_err": errors[(NUM_PARTICLES, HORIZON)],
        "ms": kernel_ms, "plain_ms": plain_ms}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
