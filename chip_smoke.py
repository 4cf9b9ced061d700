"""Smoke run of the PyTorch port's paths on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each; any failure ends the script with a nonzero
exit and no final line:

1. device   -- the card's name and power limit (nvidia-smi).
2. build    -- nvcc builds, all at once, the reacher's chain-rollout
               library (costs-only, obs-emitting and closed-loop entries),
               the peg task's (the same three entries, peg's site and
               obs/cost), the swimmer's and the half cheetah's (the
               external-force entry), the filtered-noise library, the
               forest-rollout libraries of pen-v0 and the sawyer peg and
               the pendulum library (kernels #7 and #8) from csrc/; ptxas
               register, stack and spill lines.
3. kernel   -- each kernel against its plain PyTorch version on the card:
               chain and obs rollouts at (N=37, H=5) to atol 5e-5 and at
               the main path's (N=4096, H=32) to max abs error 1e-3 (costs
               are O(1); the longer horizon accumulates f32 reordering);
               the closed-loop rollout (obs, actions, costs) for the
               reacher at (37, 5) to 5e-5 and (4096, 32) to 1e-3, for the
               peg at (37, 5) to 5e-5 and at its config's (64, 32) to 1e-3;
               peg's obs rollout at (37, 5) to 5e-5; the noise kernel at
               (37, 5, 7) and (4096, 32, 7), filter (0.25, 0.8, 0), cov 3 I,
               to 1e-4 (identical uniforms; libm ulps and sum order differ,
               scaled by the filter's gain of about 1.25 and by sqrt(3));
               the pendulum rollout (kernel #7) from a start that crosses
               -pi (th0 = -3.0, thdot0 = -8) at (37, 5), (4096, 32), the
               pendulum config's N = 24 and 64 and at N = 2048, H = 32, to
               atol 1e-5, the
               plain version with the noise zeroed failing the (37, 5)
               check by more than 10x; the one-kernel MPPI solve (kernel
               #8) at N = 1024 and 2048, H = 32, lam 0.01 and 1.0, to atol
               1e-5 on the new mean, the plain version under another seed
               failing by more than 10x.
4. main     -- envs.make("reacher_7dof-v0") -> solvers.MPPI(...) ->
               solvers.make_solve_fn on device="cuda": 10 chained solves
               under torch.cuda.set_sync_debug_mode("error") (no host sync
               inside a solve), a finite action read once at the end, the
               chain kernel's launch count rising by exactly 10; then a
               10-step evaluate_episode with finite rewards. Run with the
               plain noise sampler (main) and again with noise_impl="kernel"
               (main_kernel_noise: the chain and noise counts each rise by
               exactly 10).
5. zoo      -- RandomShooting, CEM (diagonal, full), DMD (update_cov),
               MPPIQ without Q, PFMPC and MPPIQ with a torch q_fn, N=4096
               H=32, noise_impl="kernel": 3 chained sync-free solves each,
               a finite action read at the end. MPPIQ with a Q moves only
               the obs kernel's count, the others only the chain kernel's.
6. guard    -- solvers.guard_finite around a solve whose rollout returns
               NaN costs: a zero action and a reset mean, no host sync.
7. closed_loop -- Reinforce (quadratic baseline, KL line search) on the
               reacher at N=4096, H=32, one iteration: 3 chained sync-free
               solves, the closed-loop count rising by exactly 3 and the
               chain and obs counts by 0, and the line search shown to
               halve; make_solver("reinforce") with the closed-loop peg
               config (PEG_CL) on sawyer_peg_insertion-v0: 3 sync-free
               solves, the count rising by exactly 12 (4 iterations); then
               a 10-step peg closed loop (solve, env.clip_action, env.step)
               with finite rewards and a finite baseline fit error.
8. loco_kernel -- the external-force rollout (kernel #5) against its plain
               version for the swimmer (atol 5e-5 at N=37 H=5, 1e-3 at its
               config's N=512 H=32) and the half cheetah (5e-4 and 1e-2 of
               max(1, |cost|) at N=37 H=5 and its config's N=512 H=16).
9. loco     -- configs/Swimmer-v0.yml and configs/HalfCheetah-v0.yml through
               harness.config.make_solver_for_env at their full sizes: 3
               chained sync-free MPPI solves each, kernel #5's count rising
               by exactly 3 and every other count by 0, finite actions.
10. forest_kernel -- the forest rollout (kernel #6) against its plain
               version: the peg to atol 5e-5 at N=37 H=5 and 1e-3 at its
               config's N=256 H=16; pen-v0 from a pinch in which every
               fingertip presses on the pen (so that the costs follow the
               hand's dynamics through contact) to 1e-4 at N=37 H=5 and,
               at its mppi block's N=256 H=16 (80 substeps of contact), at
               least 99% of the costs within 1e-3 and every other one off
               by a bonus step of the gated pen cost (a signed sum of 5, 10
               and 50) to within 1e-3; the count of such entries is
               printed. The plain version with the actions zeroed must
               fail both pen checks, at N=37 H=5 by more than 10x the
               tolerance (the check's power against a kernel that ignores
               the actions).
11. hand    -- configs/hand/pen-v0.yml and
               configs/sawyer/sawyer_peg_insertion-v0.yml (mppi) through
               harness.config.make_solver_for_env at their full sizes: 3
               chained sync-free solves each, kernel #6's count rising by
               exactly 3 and every other count by 0, finite actions.
12. pendulum -- configs/SimplePendulum-v0.yml through
               harness.config.make_solver_for_env at full size, each of its
               five controllers: 3 chained sync-free solves, kernel #7's
               count rising by exactly 3 and every other count by 0, finite
               actions. Then the JAX package's closed loop on kernel #8
               (tests/test_pallas_kernels.py): 100 steps of one-kernel
               solves at N=1024, filter (0.25, 0.8, 0), sigma sqrt(3.5),
               lam 0.01, step size 0.55, sync-free, kernel #8's count
               rising by exactly 100 and the total reward above -400.
13. harness -- harness.episode.run_episodes with each locomotion config's
               own solver and with every controller of
               configs/reacher_7dof-v0.yml, one episode of 10 steps, and
               with every controller of configs/hand/pen-v0.yml and the peg
               config's mppi, one episode of 3 steps (the real pen step is
               the eager AD engine), all overridden in memory: finite
               rewards; every pendulum controller for one episode of 200
               steps, its reward printed beside the JAX package's records
               (RESULTS.md:207; no gate: the RNG streams differ).
14. timing  -- read-verified solves/s (each window ends by reading a value
               that depends on every solve in it) for MPPI with the plain
               and with the kernel noise, for MPPI with the plain rollout,
               for each solver of the zoo, for Reinforce on the reacher
               and the peg and for MPPI on both locomotion configs and both
               forest configs; MPPI on the pendulum through kernel #7 at
               the config's N=24 and at N=2048 (the config's plain sampler,
               and the kernel sampler) against kernel #8's one-launch solve
               at N=2048; the real env step's ms per control step on
               the locomotion configs and on pen-v0; each kernel
               and its plain version timed with CUDA events; a per-stage
               breakdown with each noise sampler and of the Reinforce
               solves; a torch.profiler count of kernels and device time
               per solve, with the six kernels that take the most device
               time. Printed, not asserted.

Every launch count is set to 0 just before a path runs and read just after.
The last lines are the kernels' summary (kernel #5 with the swimmer's
numbers, its cheetah instance on the `kernel_loco` line before it; kernel
#6 with pen-v0's, its peg instance on the `kernel_forest` line; #7 at
the pendulum mppi block's N=24, #8 at the closed loop's N=1024, each size
on a `kernel_pendulum` line), the nvidia-smi line and {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
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
D_ACTION = 7
N_SOLVES = 10
ZOO_SOLVES = 3
FILTER = (0.25, 0.8, 0.0)
# The closed-loop peg config, configs/sawyer/sawyer_peg_insertion-v0_cl.yml,
# as mjmpc_tpu/harness/run_mpc_cl.py maps it onto Reinforce: num_cpu x
# particles_per_cpu = 8 x 8 particles, init_cov = exp(2 init_log_std), the
# critic as the baseline (held against the YAML by tests/test_torch_reinforce.py).
RF_DELTA_KL = 1e-3   # small enough that the reacher's first step halves lr
PEG_CL = dict(horizon=32, gamma=1.0, n_iters=4, lr=1.0, beta=0.0, filter_coeffs=FILTER,
              num_particles=64, delta_kl=15.0, delta_reg=0.001, baseline_type="quadratic",
              init_cov=1.0)
HOLD_CYCLES = 100_000_000   # about 50 ms of spinning at the H100's clock
# The locomotion configs, run as written, at full size.
LOCO_CONFIGS = {"Swimmer-v0": "configs/Swimmer-v0.yml",
                "HalfCheetah-v0": "configs/HalfCheetah-v0.yml"}
# kernel #5 against its plain version: (N, H, atol, scaled by max(1, |cost|))
LOCO_CHECKS = {"Swimmer-v0": ((37, 5, 5e-5, False), (512, 32, 1e-3, False)),
               "HalfCheetah-v0": ((37, 5, 5e-4, True), (512, 16, 1e-2, True))}
HARNESS_STEPS = 10
# The forest configs, run as written, at full size (mppi blocks: 8 x 32
# particles, H=16), and the pen's controllers for the harness phase.
FOREST_CONFIGS = {"pen-v0": "configs/hand/pen-v0.yml",
                  "sawyer_peg_insertion-v0": "configs/sawyer/sawyer_peg_insertion-v0.yml"}
PEN_CONTROLLERS = ("mppi", "mppiq", "pfmpc", "random_shooting", "cem", "dmd")
PEN_STEPS = 3
# The pendulum config, run as written, at full size (mppi 4 x 6 particles,
# the others 4 x 16; H=32), and the JAX package's closed loop on kernel #8
# (tests/test_pallas_kernels.py test_one_kernel_mppi_solve_controls).
PENDULUM_CONFIG = "configs/SimplePendulum-v0.yml"
PENDULUM_CONTROLLERS = ("mppi", "random_shooting", "cem", "dmd", "pfmpc")
PENDULUM_STEPS = 200
ONE_KERNEL = dict(num_particles=1024, filter_coeffs=FILTER, sigma=float(np.sqrt(3.5)),
                  lam=0.01, step_size=0.55, gamma=1.0)
ONE_KERNEL_STEPS = 100
# th0, thdot0: th + pi turns negative along the rollouts (a truncating
# modulo goes wrong) and the new thdot passes -8 before its clamp
CROSSING = (-3.0, -8.0)
# The JAX package's pendulum rewards over 200 steps (RESULTS.md:207).
JAX_PENDULUM_REWARDS = {"mppi": -173.0, "cem": -131.0, "pfmpc": -122.0}


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


def cl_inputs(d_obs: int, extras, n: int, h: int, seed: int, device):
    """Closed-loop inputs: q0, qd0 as reacher_inputs draws them, the task's
    extras, W [d_obs + 1, 7] * 0.05 and noise * 0.3, as
    tests/test_pallas_cl.py draws them."""
    import torch
    rng = np.random.default_rng(seed)
    q0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    qd0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    w = np.asarray(rng.normal(size=(d_obs + 1, 7)) * 0.05, np.float32)
    noise = np.asarray(rng.normal(size=(n, h, 7)) * 0.3, np.float32)
    q0, qd0, w, noise = (torch.as_tensor(a, device=device) for a in (q0, qd0, w, noise))
    return q0, qd0, extras, w, noise


def loco_inputs(nv: int, n: int, h: int, seed: int, device):
    """q0, qd0 * 0.1, mean * 0.3 and noise * 0.5 with the three unactuated
    base dofs zero, as the locomotion envs pad them (tests/test_torch_cuda.py)."""
    import torch
    rng = np.random.default_rng(seed)
    q0, qd0 = (np.asarray(rng.normal(size=nv) * 0.1, np.float32) for _ in range(2))
    mean = np.asarray(rng.normal(size=(h, nv)) * 0.3, np.float32)
    noise = np.asarray(rng.normal(size=(n, h, nv)) * 0.5, np.float32)
    mean[:, :3], noise[..., :3] = 0.0, 0.0
    return [torch.as_tensor(a, device=device) for a in (q0, qd0, mean, noise)]


def forest_inputs(env, roll, n: int, h: int, seed: int, device):
    """Kernel #6's inputs: mean * 0.2 and noise * 0.3 as
    tests/test_pallas_forest.py draws them; for pen-v0 the pinch (every
    fingertip pressing on the resting pen) with the hand's joints
    perturbed by U(-0.05, 0.05), for the peg q0, qd0 * 0.1."""
    import torch
    from mjmpc_tpu_torch.envs import pen, sawyer_tasks
    rng = np.random.default_rng(seed)
    if env.name == "pen-v0":
        st = env.init(env.params, seed)
        q0 = pen.pinch_qpos(st.qpos)
        q0[:24] += torch.as_tensor(rng.uniform(-0.05, 0.05, 24), dtype=torch.float32,
                                   device=device)
        head = [q0, st.qvel, pen.pen_extras(env.params, st)]
    else:
        head = [torch.as_tensor(np.asarray(rng.normal(size=7) * 0.1, np.float32), device=device)
                for _ in range(2)] + [sawyer_tasks.peg_extras(env.params)]
    d = len(roll.act_bodies)
    return head + [torch.as_tensor(np.asarray(rng.normal(size=shape) * scale, np.float32),
                                   device=device)
                   for shape, scale in (((h, d), 0.2), ((n, h, d), 0.3))]


def pendulum_inputs(env, n: int, h: int, seed: int, device):
    """Kernel #7's inputs: the crossing start, mean * 0.3 and unit noise."""
    import torch
    state = dataclasses.replace(env.init(env.params, 0),
                                **{k: torch.tensor(v, device=device)
                                   for k, v in zip(("th", "thdot"), CROSSING)})
    rng = np.random.default_rng(seed)
    mean = torch.as_tensor(np.asarray(rng.normal(size=(h, 1)) * 0.3, np.float32), device=device)
    noise = torch.as_tensor(np.asarray(rng.normal(size=(n, h, 1)), np.float32), device=device)
    return [env.params, state, mean, noise]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events. A spin
    kernel queued first holds the stream while the host enqueues the calls,
    so a kernel shorter than its own host-side launch is timed on the
    device, not at the host's enqueue rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
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


def device_time_us(event) -> float:
    """A profiler kernel event's device time (the attribute's name changed
    across PyTorch versions)."""
    t = getattr(event, "device_time_total", None)
    return float(event.cuda_time_total if t is None else t)


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def sync_free(solve, env, env_state, state, k: int):
    """k chained solves under set_sync_debug_mode("error"); the action is
    read once, after the mode is off."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(k):
            action, _, state = solve(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    action_host = action.cpu().numpy()
    if not np.isfinite(action_host).all():
        raise RuntimeError("solve produced a non-finite action")
    return action_host, state


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from mjmpc_tpu_torch import bounds, envs, ops, solvers
        from mjmpc_tpu_torch.envs import half_cheetah, pen, sawyer_tasks, swimmer
        from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
        from mjmpc_tpu_torch.harness import config as hconfig
        from mjmpc_tpu_torch.harness.episode import run_episodes
        from mjmpc_tpu_torch.ops.chain_rollout import (ChainClRollout, ChainExtRollout,
                                                       ChainObsRollout, ChainRollout)
        from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout, gated_cost_agreement
        from mjmpc_tpu_torch.ops import pendulum as pend
        from mjmpc_tpu_torch.ops.noise import FilteredNoise
        from mjmpc_tpu_torch.rollout import Trajectories
        from mjmpc_tpu_torch.solvers.reinforce import closed_loop_rollout
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    counters = (ChainRollout, ChainObsRollout, ChainClRollout, ChainExtRollout, FilteredNoise,
                ForestRollout, pend.PendulumRollout, pend.MppiPendulumSolve)

    def counts():
        return {"chain": ChainRollout.launches, "obs": ChainObsRollout.launches,
                "cl": ChainClRollout.launches, "ext": ChainExtRollout.launches,
                "noise": FilteredNoise.launches, "forest": ForestRollout.launches,
                "pendulum": pend.PendulumRollout.launches,
                "one_kernel_solve": pend.MppiPendulumSolve.launches}

    def expected(**nonzero):
        """Every count 0 but those given."""
        return dict(dict.fromkeys(counts(), 0), **nonzero)

    # 1. device
    card_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name=card_name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: one nvcc per source, started together
    device = torch.device(DEVICE)
    env = envs.make("reacher_7dof-v0", device=device)
    model = env.params.model
    roll = ChainRollout(model, n_substeps=2)
    roll_obs = ChainObsRollout(model, n_substeps=2)
    roll_cl = ChainClRollout(model, n_substeps=2)
    peg_env = envs.make("sawyer_peg_insertion-v0", device=device)
    peg_model = peg_env.params.model
    peg_cl = ChainClRollout(peg_model, n_substeps=2, task="peg")
    peg_obs = ChainObsRollout(peg_model, n_substeps=2, task="peg")
    sampler = FilteredNoise()
    loco_envs = {name: envs.make(name, device=device) for name in LOCO_CONFIGS}
    loco_rolls = {name: module.build_rollout(loco_envs[name].params)
                  for name, module in (("Swimmer-v0", swimmer),
                                       ("HalfCheetah-v0", half_cheetah))}
    forest_envs = {"pen-v0": envs.make("pen-v0", device=device), "sawyer_peg_insertion-v0": peg_env}
    forest_rolls = {"pen-v0": pen.build_rollout(forest_envs["pen-v0"].params.model),
                    "sawyer_peg_insertion-v0": sawyer_tasks.build_rollout(peg_model)}
    pend_env = envs.make("SimplePendulum-v0", device=device)
    t0 = time.perf_counter()
    builders = [w.library for w in (roll, peg_cl, sampler, *loco_rolls.values(),
                                    *forest_rolls.values())] + [pend.library]
    with concurrent.futures.ThreadPoolExecutor(len(builders)) as pool:
        futures = [pool.submit(b) for b in builders]
        libs = [f.result() for f in futures]
    for r in (roll_obs, roll_cl, peg_obs):
        r.library()     # the same libraries, loaded
    for lib, task in zip(libs, ("reacher", "peg", None, "swimmer", "cheetah", "forest_pen",
                                "forest_peg", "pendulum")):
        emit("build", task=task, seconds=round(time.perf_counter() - t0, 3),
             nvcc_seconds=round(lib.build_seconds, 3), library=str(lib.path.name),
             ptxas=[ln.strip() for ln in lib.ptxas.splitlines()
                    if re.search(r"registers|spill|stack|Compiling entry", ln)])

    # 3. each kernel against its plain version, on the card
    errors = {}
    for n, h, tol, seed in ((37, 5, 5e-5, 1), (NUM_PARTICLES, HORIZON, 1e-3, 0)):
        args = reacher_inputs(n, h, seed, device)
        got = roll(*args)
        want = roll.plain(*args)
        obs, obs_costs = roll_obs(*args)
        want_obs, want_obs_costs = roll_obs.plain(*args)
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"chain kernel output bad at N={n} H={h}")
        if obs.shape != (n, h, roll_obs.d_obs) or not bool(torch.isfinite(obs).all()):
            raise RuntimeError(f"obs kernel output bad at N={n} H={h}")
        err = float((got - want).abs().max())
        err_obs = max(float((obs - want_obs).abs().max()),
                      float((obs_costs - want_obs_costs).abs().max()))
        errors[("chain", n, h)], errors[("obs", n, h)] = err, err_obs
        emit("kernel", name="chain_rollout", n=n, h=h, max_abs_err=err, atol=tol,
             costs_min=float(want.min()), costs_max=float(want.max()))
        emit("kernel", name="chain_obs_rollout", n=n, h=h, max_abs_err=err_obs, atol=tol,
             obs_abs_max=float(want_obs.abs().max()))
        for which, e in (("chain", err), ("obs", err_obs)):
            if not e <= tol:
                raise RuntimeError(f"{which} kernel disagrees with its plain version at "
                                   f"N={n} H={h}: {e} > {tol}")
    reacher_target = reacher_inputs(1, 1, 0, device)[2]
    cl_args = {}
    for task, r, extras, n, h, tol, seed in (
            ("reacher", roll_cl, reacher_target, 37, 5, 5e-5, 3),
            ("reacher", roll_cl, reacher_target, NUM_PARTICLES, HORIZON, 1e-3, 4),
            ("peg", peg_cl, peg_extras(peg_env.params), 37, 5, 5e-5, 5),
            ("peg", peg_cl, peg_extras(peg_env.params), PEG_CL["num_particles"],
             PEG_CL["horizon"], 1e-3, 6)):
        args = cl_args[(task, n, h)] = cl_inputs(r.d_obs, extras, n, h, seed, device)
        got, want = r(*args), r.plain(*args)
        torch.cuda.synchronize()
        shapes = ((n, h, r.d_obs), (n, h, D_ACTION), (n, h))
        if tuple(tuple(x.shape) for x in got) != shapes or not all(
                bool(torch.isfinite(x).all()) for x in got):
            raise RuntimeError(f"closed-loop kernel output bad for {task} at N={n} H={h}")
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        errors[("cl", task, n, h)] = err
        emit("kernel", name="chain_cl_rollout", task=task, n=n, h=h, max_abs_err=err, atol=tol,
             max_abs_err_obs_actions_costs=[float((x - y).abs().max())
                                            for x, y in zip(got, want)],
             actions_abs_max=float(want[1].abs().max()),
             costs_min=float(want[2].min()), costs_max=float(want[2].max()))
        if not err <= tol:
            raise RuntimeError(f"closed-loop kernel disagrees with its plain version for "
                               f"{task} at N={n} H={h}: {err} > {tol}")
    q0, qd0, _, mean, noise = reacher_inputs(37, 5, 9, device)
    args = (q0, qd0, peg_extras(peg_env.params), mean, noise)
    got, want = peg_obs(*args), peg_obs.plain(*args)
    torch.cuda.synchronize()
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    emit("kernel", name="chain_obs_rollout", task="peg", n=37, h=5, max_abs_err=err, atol=5e-5)
    if not err <= 5e-5:
        raise RuntimeError(f"peg obs kernel disagrees with its plain version: {err} > 5e-5")

    cov3 = 3.0 * torch.eye(D_ACTION, device=device)
    for n, h, seed in ((37, 5, 7), (NUM_PARTICLES, HORIZON, 8)):
        got = sampler(seed, cov3, (n, h), FILTER)
        want = sampler.plain(seed, cov3, (n, h), FILTER)
        white = sampler.white(seed, n, h, D_ACTION, FILTER, device)
        want_white = sampler.white_plain(seed, n, h, D_ACTION, FILTER, device)
        torch.cuda.synchronize()
        if got.shape != (n, h, D_ACTION) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"noise kernel output bad at N={n} H={h}")
        err = float((got - want).abs().max())
        err_white = float((white - want_white).abs().max())
        errors[("noise", n, h)] = err
        emit("kernel", name="filtered_noise", n=n, h=h, d_action=D_ACTION, max_abs_err=err,
             max_abs_err_uncoloured=err_white, atol=1e-4, std=float(want.std()))
        if not max(err, err_white) <= 1e-4:
            raise RuntimeError(f"noise kernel disagrees with its plain version at "
                               f"N={n} H={h}: {err} > 1e-4")

    # kernel #7 from the crossing start; its check's power: the plain
    # version with the noise zeroed
    pend_args = {}
    for n, h, seed in ((37, 5, 30), (NUM_PARTICLES, HORIZON, 31), (24, HORIZON, 32),
                       (64, HORIZON, 33), (2048, HORIZON, 35)):
        args = pend_args[(n, h)] = pendulum_inputs(pend_env, n, h, seed, device)
        got, want = pend.pendulum_rollout(*args), pend.pendulum_rollout.plain(*args)
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"pendulum kernel output bad at N={n} H={h}")
        err = float((got - want).abs().max())
        errors[("pendulum", n, h)] = err
        fields = dict(name="pendulum_rollout", n=n, h=h, max_abs_err=err, atol=1e-5,
                      costs_min=float(want.min()), costs_max=float(want.max()))
        if (n, h) == (37, 5):
            zeroed = pend.pendulum_rollout.plain(*args[:3], torch.zeros_like(args[3]))
            fields["zeroed_noise_err"] = float((zeroed - got).abs().max())
            if not fields["zeroed_noise_err"] > 10 * 1e-5:
                raise RuntimeError(f"pendulum check too weak: {fields}")
        emit("kernel", **fields)
        if not err <= 1e-5:
            raise RuntimeError(f"pendulum kernel disagrees with its plain version at N={n} "
                               f"H={h}: {err} > 1e-5")
    # kernel #8 on the same seed; its check's power: another seed
    solve8_args = {}
    for n, lam in ((1024, 0.01), (1024, 1.0), (2048, 0.01), (2048, 1.0)):
        params, state, mean, _ = pendulum_inputs(pend_env, 1, HORIZON, 34, device)
        cfg8 = dict(ONE_KERNEL, num_particles=n, lam=lam)
        args = solve8_args[(n, lam)] = (params, state, mean, 77)
        got = pend.mppi_pendulum_solve(*args, **cfg8)
        want = pend.mppi_pendulum_solve.plain(*args, **cfg8)
        other = pend.mppi_pendulum_solve.plain(*args[:3], 78, **cfg8)
        torch.cuda.synchronize()
        if got.shape != (HORIZON, 1) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"one-kernel solve output bad at N={n}")
        err = float((got - want).abs().max())
        other_err = float((other - got).abs().max())
        errors[("solve8", n, lam)] = err
        emit("kernel", name="mppi_pendulum_solve", n=n, h=HORIZON, lam=lam, max_abs_err=err,
             atol=1e-5, other_seed_err=other_err, mean_abs_max=float(want.abs().max()))
        if not err <= 1e-5 or not other_err > 10 * 1e-5:
            raise RuntimeError(f"one-kernel solve check failed at N={n} lam={lam}: {err}, "
                               f"another seed {other_err}")

    # 4. main path, with the plain and with the kernel noise sampler
    cfg = dict(d_action=env.d_action, horizon=HORIZON, num_particles=NUM_PARTICLES,
               init_cov=3.0, filter_coeffs=FILTER, base_action="repeat", device=device)
    mppi = dict(lam=0.01, step_size=0.55, gamma=1.0)
    solver = solvers.MPPI(**cfg, **mppi)
    solver_k = solvers.MPPI(**cfg, **mppi, noise_impl="kernel")
    solver_k.noise_sampler.library()
    env_state = env.init(env.params, 1)
    main_counts = {}
    for phase, s in (("main", solver), ("main_kernel_noise", solver_k)):
        solve = solvers.make_solve_fn(s, env)
        state = s.init_state(0)
        reset_counts(*counters)
        action_host, state = sync_free(solve, env, env_state, state, N_SOLVES)
        main_counts[phase] = got = counts()
        emit(phase, solves=N_SOLVES, launches=got, action=action_host.tolist(),
             step=state.step)
        want = expected(chain=N_SOLVES, noise=N_SOLVES if s.noise_impl == "kernel" else 0)
        if got != want:
            raise RuntimeError(f"{phase}: launches {got}, expected {want}")

    episode = solvers.evaluate_episode(solver_k, env, 10)(env.params, 2)
    rewards = episode["reward"].cpu().numpy()
    emit("episode", steps=10, rewards=rewards.tolist())
    if rewards.shape != (10,) or not np.isfinite(rewards).all():
        raise RuntimeError("episode rewards not finite")

    # 5. the zoo, kernel noise
    zcfg = dict(cfg, noise_impl="kernel")
    w_obs = torch.full((roll_obs.d_obs,), 0.05, device=device)
    w_act = torch.full((D_ACTION,), 0.1, device=device)

    def q_fn(obs, acts):
        return (obs * obs) @ w_obs + (acts * acts) @ w_act

    zoo = {
        "random_shooting": solvers.RandomShooting(**zcfg, step_size=0.55),
        "cem_diagonal": solvers.CEM(**zcfg, step_size=0.55, elite_frac=0.1, beta=0.1),
        "cem_full": solvers.CEM(**zcfg, step_size=0.55, elite_frac=0.1, beta=0.1,
                                cov_type="full"),
        "dmd": solvers.DMDMPC(**zcfg, step_size=0.55, lam=0.01, beta=0.1, update_cov=True),
        "mppiq": solvers.MPPIQ(**zcfg, step_size=0.55, beta=0.01, td_lam=0.9, gamma=0.99),
        "pfmpc": solvers.PFMPC(d_action=D_ACTION, horizon=HORIZON,
                               num_particles=NUM_PARTICLES, lam=0.01, cov_shift=0.05,
                               cov_resample=1.0, filter_coeffs=FILTER,
                               noise_impl="kernel", device=device),
        "mppiq_q": solvers.MPPIQ(**zcfg, step_size=0.55, beta=0.01, td_lam=0.9, gamma=0.99,
                                 q_fn=q_fn),
    }
    zoo_solves, zoo_counts = {}, {}
    for key, s in zoo.items():
        solve = solvers.make_solve_fn(s, env)
        state = s.init_state(0)
        reset_counts(*counters)
        action_host, state = sync_free(solve, env, env_state, state, ZOO_SOLVES)
        zoo_counts[key] = got = counts()
        zoo_solves[key] = (solve, state)
        emit("zoo", solver=key, solves=ZOO_SOLVES, launches=got, action=action_host.tolist())
        roll_key = "obs" if key == "mppiq_q" else "chain"
        want = expected(noise=ZOO_SOLVES, **{roll_key: ZOO_SOLVES})
        if got != want:
            raise RuntimeError(f"zoo {key}: launches {got}, expected {want}")

    # 6. guard_finite around a solve that goes non-finite
    nan_env = dataclasses.replace(env, fused_rollout=lambda p, s, mean, noise: torch.full(
        noise.shape[:2], float("nan"), device=noise.device))
    guarded = solvers.guard_finite(solvers.make_solve_fn(solver_k, nan_env), solver_k)
    state = dataclasses.replace(solver_k.init_state(0), step=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, value, state = guarded(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fresh = solver_k.init_state(0)
    ok = (bool((action == 0).all()) and float(value) == 0.0 and state.step == 4
          and bool(torch.equal(state.mean, fresh.mean))
          and bool(torch.equal(state.cov, fresh.cov)))
    emit("guard", action=action.cpu().numpy().tolist(), value=float(value), step=state.step,
         reset=ok)
    if not ok:
        raise RuntimeError("guard_finite did not reset the non-finite solve")

    # 7. the closed loop: Reinforce on the reacher and with the peg config
    rf = solvers.Reinforce(d_obs=env.d_obs, d_action=D_ACTION, horizon=HORIZON,
                           num_particles=NUM_PARTICLES, lr=1.0, n_iters=1, init_cov=1.0,
                           baseline_type="quadratic", delta_reg=1e-3, delta_kl=RF_DELTA_KL,
                           filter_coeffs=FILTER, device=device)
    rf_peg = solvers.make_solver("reinforce", d_obs=peg_env.d_obs, d_action=D_ACTION,
                                 device=device, **PEG_CL)
    cl_runs, cl_counts = {}, {}
    for key, s, e in (("reacher", rf, env), ("peg", rf_peg, peg_env)):
        es = e.init(e.params, 1)
        solve = solvers.make_solve_fn(s, e)
        reset_counts(*counters)
        action_host, state = sync_free(solve, e, es, s.init_state(0), ZOO_SOLVES)
        cl_counts[key] = got = counts()
        cl_runs[key] = (solve, s, e, es, state)
        emit("closed_loop", env=e.name, n=s.num_particles, h=s.horizon, n_iters=s.n_iters,
             baseline=s.baseline_type, solves=ZOO_SOLVES, launches=got,
             action=action_host.tolist(), fit_error=float(state.fit_error), step=state.step)
        want = expected(cl=ZOO_SOLVES * s.n_iters)
        if got != want:
            raise RuntimeError(f"closed_loop {key}: launches {got}, expected {want}")
    s0 = rf.init_state(0)       # the first reacher solve's step, re-derived
    traj = closed_loop_rollout(env)(env.params, cl_runs["reacher"][3], s0.mean_weights,
                                    rf.sample_noise(s0))
    returns = ops.cost_to_go(traj.costs, rf.discount)
    obs_cat, grad = rf.gradient(s0, traj, returns - rf.baseline(s0, traj, returns)[0])
    lr = float(rf.step_size(s0, obs_cat, grad))
    emit("closed_loop_linesearch", env=env.name, lr0=rf.lr, delta_kl=rf.delta_kl, lr=lr,
         halvings=int(round(np.log2(rf.lr / lr))))
    if not lr < rf.lr:
        raise RuntimeError(f"the KL line search did not halve: lr {lr}")
    solve_peg = cl_runs["peg"][0]
    es, state, rewards = peg_env.init(peg_env.params, 2), rf_peg.init_state(5), []
    for _ in range(10):
        action, _, state = solve_peg(peg_env.params, es, state)
        es, _, reward, _ = peg_env.step(peg_env.params, es, peg_env.clip_action(action))
        rewards.append(reward)
    rewards, fit_error = torch.stack(rewards).cpu().numpy(), float(state.fit_error)
    emit("peg_episode", steps=10, rewards=rewards.tolist(), fit_error=fit_error)
    if rewards.shape != (10,) or not np.isfinite(rewards).all() or not np.isfinite(fit_error):
        raise RuntimeError("peg closed loop: rewards or fit error not finite")

    # 8. kernel #5 against its plain version, both tasks
    loco_args = {}
    for name, checks in LOCO_CHECKS.items():
        r = loco_rolls[name]
        for seed, (n, h, tol, scaled) in enumerate(checks):
            args = loco_args[(name, n, h)] = loco_inputs(r.model.nv, n, h, 10 + seed, device)
            got, want = r(*args), r.plain(*args)
            torch.cuda.synchronize()
            if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"ext kernel output bad for {name} at N={n} H={h}")
            scale = torch.clamp(want.abs(), min=1.0) if scaled else 1.0
            err = float(((got - want) / scale).abs().max())
            errors[("ext", name, n, h)] = err
            emit("loco_kernel", env=name, n=n, h=h, max_abs_err=err, atol=tol,
                 scaled_by_cost=scaled, max_abs_err_unscaled=float((got - want).abs().max()),
                 costs_min=float(want.min()), costs_max=float(want.max()))
            if not err <= tol:
                raise RuntimeError(f"ext kernel disagrees with its plain version for {name} "
                                   f"at N={n} H={h}: {err} > {tol}")

    # 9. the locomotion configs through harness.config, full size
    loco_runs, loco_counts = {}, {}
    for name, path in LOCO_CONFIGS.items():
        exp = hconfig.load_config(path)
        e = loco_envs[name]
        s = hconfig.make_solver_for_env(exp, "mppi", e)
        es = e.init(e.params, 1)
        solve = solvers.make_solve_fn(s, e)
        reset_counts(*counters)
        action_host, state = sync_free(solve, e, es, s.init_state(0), ZOO_SOLVES)
        loco_counts[name] = got = counts()
        loco_runs[name] = (solve, s, e, es, state, exp)
        emit("loco", env=name, config=path, n=s.num_particles, h=s.horizon,
             solves=ZOO_SOLVES, launches=got, action=action_host.tolist(), step=state.step)
        want = expected(ext=ZOO_SOLVES)
        if got != want or action_host.shape != (e.d_action,):
            raise RuntimeError(f"loco {name}: launches {got}, expected {want}")

    # 10. kernel #6 against its plain version, both tasks
    forest_args = {}
    for name, n, h, tol, seed in (("sawyer_peg_insertion-v0", 37, 5, 5e-5, 20),
                                  ("sawyer_peg_insertion-v0", 256, 16, 1e-3, 21),
                                  ("pen-v0", 37, 5, 1e-4, 22), ("pen-v0", 256, 16, None, 23)):
        r = forest_rolls[name]
        args = forest_args[(name, n, h)] = forest_inputs(forest_envs[name], r, n, h, seed, device)
        got, want = r(*args), r.plain(*args)
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"forest kernel output bad for {name} at N={n} H={h}")
        err = float((got - want).abs().max())
        errors[("forest", name, n, h)] = err
        fields = dict(env=name, n=n, h=h, max_abs_err=err, costs_min=float(want.min()),
                      costs_max=float(want.max()))

        def check(costs):
            """(passes, fields): tol at (37, 5), the gated-cost rule at the
            config's size."""
            if tol is not None:
                return float((costs - want).abs().max()) <= tol, dict(atol=tol)
            agree = gated_cost_agreement(costs, want, 1e-3)
            return agree["share_within"] >= 0.99 and agree["other"] == 0, dict(
                atol=1e-3, share_within=agree["share_within"],
                entries_off_by_a_bonus_step=agree["bonus_steps"],
                entries_off_otherwise=agree["other"])

        ok, more = check(got)
        if name == "pen-v0":     # the check's power: a kernel that ignores the actions fails it
            zeroed = r.plain(*args[:3], torch.zeros_like(args[3]), torch.zeros_like(args[4]))
            zeroed_ok, zeroed_fields = check(zeroed)
            fields.update(zeroed_actions_err=float((zeroed - want).abs().max()),
                          zeroed_actions=zeroed_fields)
            if zeroed_ok or (tol is not None and not fields["zeroed_actions_err"] > 10 * tol):
                raise RuntimeError(f"pen check too weak at N={n} H={h}: {fields}")
        emit("forest_kernel", **fields, **more)
        if not ok:
            raise RuntimeError(f"forest kernel disagrees with its plain version for {name} "
                               f"at N={n} H={h}: {err}, {more}")

    # 11. the forest configs through harness.config, full size
    hand_runs, hand_counts = {}, {}
    for name, path in FOREST_CONFIGS.items():
        exp = hconfig.load_config(path)
        e = forest_envs[name]
        s = hconfig.make_solver_for_env(exp, "mppi", e)
        es = e.init(e.params, 1)
        solve = solvers.make_solve_fn(s, e)
        reset_counts(*counters)
        action_host, state = sync_free(solve, e, es, s.init_state(0), ZOO_SOLVES)
        hand_counts[name] = got = counts()
        hand_runs[name] = (solve, s, e, es, state, exp)
        emit("hand", env=name, config=path, n=s.num_particles, h=s.horizon, solves=ZOO_SOLVES,
             launches=got, action=action_host.tolist(), step=state.step)
        want = expected(forest=ZOO_SOLVES)
        if got != want or action_host.shape != (e.d_action,):
            raise RuntimeError(f"hand {name}: launches {got}, expected {want}")

    # 12. the pendulum config through harness.config, full size, and the
    # closed loop on kernel #8
    pend_exp = hconfig.load_config(PENDULUM_CONFIG)
    pend_runs, pend_counts = {}, {}
    for controller in PENDULUM_CONTROLLERS:
        s = hconfig.make_solver_for_env(pend_exp, controller, pend_env)
        es = pend_env.init(pend_env.params, 1)
        solve = solvers.make_solve_fn(s, pend_env)
        reset_counts(*counters)
        action_host, state = sync_free(solve, pend_env, es, s.init_state(0), ZOO_SOLVES)
        pend_counts[controller] = got = counts()
        pend_runs[controller] = (solve, s, es, state)
        emit("pendulum", controller=controller, config=PENDULUM_CONFIG, n=s.num_particles,
             h=s.horizon, solves=ZOO_SOLVES, launches=got, action=action_host.tolist())
        if got != expected(pendulum=ZOO_SOLVES) or action_host.shape != (1,):
            raise RuntimeError(f"pendulum {controller}: launches {got}, expected "
                               f"{expected(pendulum=ZOO_SOLVES)}")

    def one_kernel_loop(es, steps: int):
        """The JAX package's closed loop on kernel #8: solve, step with the
        clipped first action, shift the mean with a zero last row; the
        rewards stay on the device."""
        mean, rewards = torch.zeros(HORIZON, 1, device=device), []
        for t in range(steps):
            mean = pend.mppi_pendulum_solve(pend_env.params, es, mean, 1000 + t, **ONE_KERNEL)
            es, _, reward, _ = pend_env.step(pend_env.params, es, pend_env.clip_action(mean[0]))
            rewards.append(reward)
            mean = torch.cat([mean[1:], torch.zeros_like(mean[:1])])
        return torch.stack(rewards), mean

    loop_start = pend_env.init(pend_env.params, 1)
    reset_counts(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop_rewards, _ = one_kernel_loop(loop_start, ONE_KERNEL_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loop_rewards = loop_rewards.cpu().numpy()
    loop_seconds = time.perf_counter() - t0
    loop_counts = counts()
    total = float(loop_rewards.sum())
    emit("pendulum_one_kernel_loop", steps=ONE_KERNEL_STEPS, **ONE_KERNEL, launches=loop_counts,
         total_reward=total, gate=-400.0, seconds=loop_seconds)
    if loop_counts != expected(one_kernel_solve=ONE_KERNEL_STEPS) or not total > -400.0:
        raise RuntimeError(f"one-kernel closed loop: launches {loop_counts}, total reward {total}")

    # 13. the episode runner with each config's own solver(s)
    reacher_exp = hconfig.load_config("configs/reacher_7dof-v0.yml")
    harness_runs = [(name, "mppi", run[5], run[2]) for name, run in loco_runs.items()]
    harness_runs += [("reacher_7dof-v0", c, reacher_exp, env)
                     for c in ("mppi", "random_shooting", "cem", "dmd", "pfmpc")]
    harness_runs = [run + (HARNESS_STEPS,) for run in harness_runs]
    pen_exp = hand_runs["pen-v0"][5]
    harness_runs += [("pen-v0", c, pen_exp, forest_envs["pen-v0"], PEN_STEPS)
                     for c in PEN_CONTROLLERS]
    harness_runs.append(("sawyer_peg_insertion-v0", "mppi", hand_runs["sawyer_peg_insertion-v0"][5],
                         peg_env, PEN_STEPS))
    harness_runs += [("SimplePendulum-v0", c, pend_exp, pend_env, PENDULUM_STEPS)
                     for c in PENDULUM_CONTROLLERS]
    for name, controller, exp, e, steps in harness_runs:
        s = hconfig.make_solver_for_env(exp, controller, e)
        t0 = time.perf_counter()
        out = run_episodes(s, e, n_episodes=1, episode_length=steps, base_seed=exp["seed"])
        seconds = time.perf_counter() - t0
        extra = (dict(jax_reward=JAX_PENDULUM_REWARDS.get(controller))
                 if name == "SimplePendulum-v0" else dict(rewards=out["rewards"][0].tolist()))
        emit("harness", env=name, controller=controller, n=s.num_particles, h=s.horizon,
             steps=steps, ep_reward=float(out["ep_rewards"][0]), seconds=seconds, **extra)
        if out["rewards"].shape != (1, steps) or not np.isfinite(out["rewards"]).all():
            raise RuntimeError(f"harness {name} {controller}: rewards not finite")

    # 14. timing (printed, not asserted)
    args = reacher_inputs(NUM_PARTICLES, HORIZON, 0, device)
    times = {
        "chain_rollout": (cuda_ms(lambda: roll(*args), 20), cuda_ms(lambda: roll.plain(*args), 2)),
        "chain_obs_rollout": (cuda_ms(lambda: roll_obs(*args), 20),
                              cuda_ms(lambda: roll_obs.plain(*args), 2)),
        "filtered_noise": (
            cuda_ms(lambda: sampler.white(5, NUM_PARTICLES, HORIZON, D_ACTION, FILTER, device),
                    50),
            cuda_ms(lambda: sampler.white_plain(5, NUM_PARTICLES, HORIZON, D_ACTION, FILTER,
                                                device), 5)),
    }
    for kname, r, key in (("chain_cl_rollout", roll_cl, ("reacher", NUM_PARTICLES, HORIZON)),
                          ("chain_cl_rollout_peg", peg_cl,
                           ("peg", PEG_CL["num_particles"], PEG_CL["horizon"]))):
        times[kname] = (cuda_ms(lambda: r(*cl_args[key]), 20),
                        cuda_ms(lambda: r.plain(*cl_args[key]), 2))
    sampler_ms = (cuda_ms(lambda: sampler(5, cov3, (NUM_PARTICLES, HORIZON), FILTER), 50),
                  cuda_ms(lambda: solver.sample_noise(solver.init_state(5)), 5))
    emit("kernel_time", card=smi, sampler_with_colouring_ms=sampler_ms[0],
         plain_sampler_ms=sampler_ms[1],
         **{k: {"ms": v[0], "plain_ms": v[1]} for k, v in times.items()})

    plain_env = dataclasses.replace(
        env, fused_rollout=lambda p, s, mean, noise: roll.plain(
            s.qpos, s.qvel, s.target, mean, noise))
    variants = {"plain_noise": (solvers.make_solve_fn(solver, env), solver),
                "kernel_noise": (solvers.make_solve_fn(solver_k, env), solver_k)}
    rates = {k: [] for k in variants}
    states = {k: s.init_state(0) for k, (_, s) in variants.items()}
    for order in (("plain_noise", "kernel_noise"), ("kernel_noise", "plain_noise")):
        for which in order:
            _, window_rates, states[which] = solves_per_s(
                variants[which][0], env, env_state, states[which], 20, 5)
            rates[which] += window_rates
    plain_rate, plain_windows, _ = solves_per_s(
        solvers.make_solve_fn(solver, plain_env), env, env_state, solver.init_state(0), 2, 2)
    emit("solves_per_s", card=smi, n=NUM_PARTICLES, h=HORIZON,
         **{k: statistics.median(v) for k, v in rates.items()},
         **{k + "_windows": v for k, v in rates.items()},
         plain_rollout=plain_rate, plain_rollout_windows=plain_windows)
    zoo_rates = {}
    for key, (solve, state) in zoo_solves.items():
        zoo_rates[key], _, _ = solves_per_s(solve, env, env_state, state, 10, 5)
    emit("zoo_solves_per_s", card=smi, n=NUM_PARTICLES, h=HORIZON, **zoo_rates)
    for key, (solve, s, e, es, state) in cl_runs.items():
        rate, windows, _ = solves_per_s(solve, e, es, state, 10, 5)
        emit("reinforce_solves_per_s", card=smi, env=e.name, n=s.num_particles, h=s.horizon,
             n_iters=s.n_iters, solves_per_s=rate, windows=windows)

    # the locomotion configs: kernel #5 per call, solves/s, the real env step
    loco_times = {}
    for name, (solve, s, e, es, state, _) in loco_runs.items():
        r = loco_rolls[name]
        args = loco_args[(name, s.num_particles, s.horizon)]
        loco_times[name] = (cuda_ms(lambda: r(*args), 10), cuda_ms(lambda: r.plain(*args), 1))
        rate, windows, _ = solves_per_s(solve, e, es, state, 10, 5)
        step_ms, st = [], es
        zero = torch.zeros(e.d_action, device=device)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _, _, _ = e.step(e.params, st, zero)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        emit("loco_time", env=name, card=smi, n=s.num_particles, h=s.horizon,
             kernel_ms=loco_times[name][0], plain_ms=loco_times[name][1], solves_per_s=rate,
             windows=windows, env_step_ms=statistics.median(step_ms), env_step_ms_all=step_ms)

    # the forest configs: kernel #6 per call, solves/s, pen's real env step
    forest_times = {}
    for name, (solve, s, e, es, state, _) in hand_runs.items():
        r = forest_rolls[name]
        args = forest_args[(name, s.num_particles, s.horizon)]
        forest_times[name] = (cuda_ms(lambda: r(*args), 10), cuda_ms(lambda: r.plain(*args), 1))
        rate, windows, _ = solves_per_s(solve, e, es, state, 10, 5)
        fields = {}
        if name == "pen-v0":
            step_ms, st = [], es
            zero = torch.zeros(e.d_action, device=device)
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _, _, _ = e.step(e.params, st, zero)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            fields = dict(env_step_ms=statistics.median(step_ms), env_step_ms_all=step_ms)
        emit("forest_time", env=name, card=smi, n=s.num_particles, h=s.horizon,
             kernel_ms=forest_times[name][0], plain_ms=forest_times[name][1], solves_per_s=rate,
             windows=windows, **fields)

    # the pendulum: kernels #7 and #8 per call; MPPI through kernel #7 (the
    # config's plain sampler, and the kernel sampler) against kernel #8's
    # one-launch solve
    def one_kernel_solve_fn(n: int):
        """Kernel #8 as a chained solve: (params, env state, (mean, step))
        -> (action, None, (shifted mean, step + 1))."""
        cfg8 = dict(ONE_KERNEL, num_particles=n)

        def solve(params, es, carry):
            mean, step = carry
            mean = pend.mppi_pendulum_solve(params, es, mean, 1000 + step, **cfg8)
            return mean[0], None, (torch.cat([mean[1:], torch.zeros_like(mean[:1])]), step + 1)

        return solve

    pend_times = {}
    for n, h in bounds.PENDULUM_SIZES[7]:
        args = pend_args[(n, h)]
        pend_times[(7, n)] = (cuda_ms(lambda: pend.pendulum_rollout(*args), 50),
                              cuda_ms(lambda: pend.pendulum_rollout.plain(*args), 5))
    for n, _ in bounds.PENDULUM_SIZES[8]:
        args, cfg8 = solve8_args[(n, 0.01)], dict(ONE_KERNEL, num_particles=n)
        pend_times[(8, n)] = (cuda_ms(lambda: pend.mppi_pendulum_solve(*args, **cfg8), 50),
                              cuda_ms(lambda: pend.mppi_pendulum_solve.plain(*args, **cfg8), 3))
    _, mppi_cfg, pend_es, _ = pend_runs["mppi"]
    pend_rates = {}
    for key, s in (("mppi_n24", mppi_cfg),
                   ("mppi_n2048", dataclasses.replace(mppi_cfg, num_particles=2048)),
                   ("mppi_n2048_kernel_noise", dataclasses.replace(
                       mppi_cfg, num_particles=2048, noise_impl="kernel"))):
        pend_rates[key], _, _ = solves_per_s(solvers.make_solve_fn(s, pend_env), pend_env,
                                             pend_es, s.init_state(0), 20, 5)
    one_kernel_state = (torch.zeros(HORIZON, 1, device=device), 0)
    pend_rates["one_kernel_n2048"], _, _ = solves_per_s(one_kernel_solve_fn(2048), pend_env,
                                                        pend_es, one_kernel_state, 20, 5)
    emit("pendulum_time", card=smi,
         kernel_ms={f"#{k} N={n}": v[0] for (k, n), v in pend_times.items()},
         plain_ms={f"#{k} N={n}": v[1] for (k, n), v in pend_times.items()},
         solves_per_s=pend_rates, one_kernel_loop_seconds=loop_seconds)

    # where a solve's time goes: host clock per stage, synchronised
    for which, s in (("plain_noise", solver), ("kernel_noise", solver_k)):
        state = s.init_state(0)
        stages = {"noise": [], "rollout": [], "update": [], "act_shift": []}
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            noise = s.sample_noise(state)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            costs = env.fused_rollout(env.params, env_state, state.mean, noise)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            traj = Trajectories(None, state.mean[None] + noise, costs, None, None, None)
            s2 = s.update(state, traj)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            s.act(s2)
            state = s.shift(dataclasses.replace(s2, step=s2.step + 1))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[key].append(dt * 1e3)
        emit("breakdown_ms", noise_impl=which, card=smi,
             **{k: statistics.median(v) for k, v in stages.items()})

    # the Reinforce solves' stages per solve (summed over its iterations)
    for key, (_, s, e, es, _) in cl_runs.items():
        roll_fn = closed_loop_rollout(e)
        state = s.init_state(0)
        stages = {"noise": [], "rollout": [], "baseline_fit": [], "gradient_linesearch": [],
                  "act": []}
        for _ in range(10):
            spent = dict.fromkeys(stages, 0.0)
            for _ in range(s.n_iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                noise = s.sample_noise(state)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                traj = roll_fn(e.params, es, state.mean_weights, noise)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                returns = ops.cost_to_go(traj.costs, s.discount)
                baselines, vw, vb, fit_err = s.baseline(state, traj, returns)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                obs_cat, grad = s.gradient(state, traj, returns - baselines)
                lr = s.step_size(state, obs_cat, grad)
                state = dataclasses.replace(state, mean_weights=state.mean_weights - lr * grad,
                                            vf_weights=vw, vf_bias=vb, fit_error=fit_err)
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    spent[k] += dt * 1e3
            t0 = time.perf_counter()
            s.act(state, e.observe(e.params, es))
            state = dataclasses.replace(state, step=state.step + 1)
            torch.cuda.synchronize()
            spent["act"] = (time.perf_counter() - t0) * 1e3
            for k, v in spent.items():
                stages[k].append(v)
        emit("breakdown_ms", solver="reinforce", env=e.name, n_iters=s.n_iters, card=smi,
             **{k: statistics.median(v) for k, v in stages.items()})

    # kernels and device time per solve (torch.profiler over 10 solves)
    def profile(solve, e, es, state, **labels):
        for _ in range(3):
            _, _, state = solve(e.params, es, state)
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(N_SOLVES):
                _, _, state = solve(e.params, es, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(device_time_us(ev) for ev in kernels)
        by_name = {}
        for ev in kernels:
            us, count = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + device_time_us(ev), count + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        emit("profile", **labels, card=smi, solves=N_SOLVES,
             top_kernels=[{"kernel": k[:90], "ms_per_solve": us / 1e3 / N_SOLVES,
                           "launches_per_solve": count / N_SOLVES}
                          for k, (us, count) in top],
             device_kernels_per_solve=len(kernels) / N_SOLVES,
             device_ms_per_solve=device_us / 1e3 / N_SOLVES,
             wall_ms_per_solve=wall * 1e3 / N_SOLVES,
             device_busy_share=(device_us / 1e6) / wall if wall > 0 else None)

    for which, (solve, s) in variants.items():
        profile(solve, env, env_state, s.init_state(0), noise_impl=which)
    for key, (solve, s, e, es, _) in cl_runs.items():
        profile(solve, e, es, s.init_state(0), solver="reinforce", env=e.name)
    for name, (solve, s, e, es, _, _) in loco_runs.items():
        profile(solve, e, es, s.init_state(0), solver="mppi", env=name)
    for name, (solve, s, e, es, _, _) in hand_runs.items():
        profile(solve, e, es, s.init_state(0), solver="mppi", env=name)
    profile(pend_runs["mppi"][0], pend_env, pend_es, mppi_cfg.init_state(0), solver="mppi",
            env="SimplePendulum-v0", n=mppi_cfg.num_particles)
    profile(one_kernel_solve_fn(2048), pend_env, pend_es, one_kernel_state,
            solver="one_kernel_mppi", env="SimplePendulum-v0", n=2048)

    # the kernels' summary: launches from the paths' runs, bounds from
    # this run's shapes (the work does not depend on the data)
    n, h = NUM_PARTICLES, HORIZON
    bound = {r["number"]: (r["bound_ms"], r["bound_by"])
             for r in bounds.kernel_table(model, n, h)}
    rows = [
        ("chain_rollout", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
         "mjmpc_tpu/ops/pallas_chain.py:381", main_counts["main_kernel_noise"]["chain"],
         errors[("chain", n, h)], bound[1]),
        ("filtered_noise", "mjmpc_tpu_torch/csrc/filtered_noise.cu",
         "mjmpc_tpu/ops/pallas_kernels.py:73", main_counts["main_kernel_noise"]["noise"],
         errors[("noise", n, h)], bound[2]),
        ("chain_obs_rollout", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
         "mjmpc_tpu/ops/pallas_chain.py:572", zoo_counts["mppiq_q"]["obs"],
         errors[("obs", n, h)], bound[3]),
        ("chain_cl_rollout", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
         "mjmpc_tpu/ops/pallas_chain.py:520", cl_counts["reacher"]["cl"],
         errors[("cl", "reacher", n, h)], bound[4]),
    ]
    peg = bounds.peg_instance(peg_model, PEG_CL["num_particles"], PEG_CL["horizon"])
    emit("kernel_peg", name="chain_cl_rollout", task="peg", n=peg["n"], h=peg["h"],
         launches_per_solve=cl_counts["peg"]["cl"] / ZOO_SOLVES,
         max_abs_err=errors[("cl", "peg", peg["n"], peg["h"])],
         ms=times["chain_cl_rollout_peg"][0], plain_ms=times["chain_cl_rollout_peg"][1],
         bound_ms=peg["bound_ms"], bound_by=peg["bound_by"], card=smi)
    for name, r in loco_rolls.items():
        n, h = bounds.LOCO_SIZES[name]
        inst = bounds.ext_instance(r, n, h)
        ptxas = [ln.strip() for ln in r.library().ptxas.splitlines()
                 if re.search(r"registers|spill", ln)]
        emit("kernel_loco", name="chain_ext_rollout", env=name, n=n, h=h,
             launches_per_solve=loco_counts[name]["ext"] / ZOO_SOLVES,
             max_abs_err=errors[("ext", name, n, h)], ms=loco_times[name][0],
             plain_ms=loco_times[name][1], bound_ms=inst["bound_ms"], bound_by=inst["bound_by"],
             operations=inst["operations"], bytes=inst["bytes"], ptxas=ptxas, card=smi)
    swim = bounds.ext_instance(loco_rolls["Swimmer-v0"], *bounds.LOCO_SIZES["Swimmer-v0"])
    rows.append(("chain_ext_rollout", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
                 "mjmpc_tpu/ops/pallas_chain.py:872", loco_counts["Swimmer-v0"]["ext"],
                 errors[("ext", "Swimmer-v0", *bounds.LOCO_SIZES["Swimmer-v0"])],
                 (swim["bound_ms"], swim["bound_by"])))
    times["chain_ext_rollout"] = loco_times["Swimmer-v0"]
    for name, r in forest_rolls.items():
        n, h = bounds.FOREST_SIZES[name]
        inst = bounds.forest_instance(r, n, h)
        ptxas = [ln.strip() for ln in r.library().ptxas.splitlines()
                 if re.search(r"registers|spill|stack", ln)]
        emit("kernel_forest", name="forest_rollout", env=name, n=n, h=h,
             launches_per_solve=hand_counts[name]["forest"] / ZOO_SOLVES,
             max_abs_err=errors[("forest", name, n, h)], ms=forest_times[name][0],
             plain_ms=forest_times[name][1], bound_ms=inst["bound_ms"], bound_by=inst["bound_by"],
             operations=inst["operations"], bytes=inst["bytes"], ptxas=ptxas, card=smi)
    pen_inst = bounds.forest_instance(forest_rolls["pen-v0"], *bounds.FOREST_SIZES["pen-v0"])
    rows.append(("forest_rollout", "mjmpc_tpu_torch/csrc/forest_rollout.cu",
                 "mjmpc_tpu/ops/pallas_forest.py:667", hand_counts["pen-v0"]["forest"],
                 errors[("forest", "pen-v0", *bounds.FOREST_SIZES["pen-v0"])],
                 (pen_inst["bound_ms"], pen_inst["bound_by"])))
    times["forest_rollout"] = forest_times["pen-v0"]
    pend_ptxas = [ln.strip() for ln in pend.library().ptxas.splitlines()
                  if re.search(r"registers|spill|stack", ln)]
    for number, sizes in bounds.PENDULUM_SIZES.items():
        for n, h in sizes:
            inst = bounds.pendulum_instance(number, n, h)
            fields = (dict(max_abs_err=errors[("pendulum", n, h)],
                           launches_per_solve=pend_counts["mppi"]["pendulum"] / ZOO_SOLVES)
                      if number == 7 else
                      dict(sampled=pend.sampled_particles(n), launches_per_solve=1.0,
                           max_abs_err=max(errors[("solve8", n, lam)] for lam in (0.01, 1.0))))
            emit("kernel_pendulum", number=number, kernel=inst["kernel"], n=n, h=h,
                 ms=pend_times[(number, n)][0], plain_ms=pend_times[(number, n)][1],
                 bound_ms=inst["bound_ms"], bound_by=inst["bound_by"],
                 operations=inst["operations"], bytes=inst["bytes"], ptxas=pend_ptxas, card=smi,
                 **fields)
    mppi_n = mppi_cfg.num_particles
    b7 = bounds.pendulum_instance(7, mppi_n, HORIZON)
    b8 = bounds.pendulum_instance(8, ONE_KERNEL["num_particles"], HORIZON)
    rows += [("pendulum_rollout", "mjmpc_tpu_torch/csrc/pendulum.cu",
              "mjmpc_tpu/ops/pallas_kernels.py:130", pend_counts["mppi"]["pendulum"],
              errors[("pendulum", mppi_n, HORIZON)], (b7["bound_ms"], b7["bound_by"])),
             ("mppi_pendulum_solve", "mjmpc_tpu_torch/csrc/pendulum.cu",
              "mjmpc_tpu/ops/pallas_kernels.py:201", loop_counts["one_kernel_solve"],
              max(errors[("solve8", ONE_KERNEL["num_particles"], lam)] for lam in (0.01, 1.0)),
              (b8["bound_ms"], b8["bound_by"]))]
    times["pendulum_rollout"] = pend_times[(7, mppi_n)]
    times["mppi_pendulum_solve"] = pend_times[(8, ONE_KERNEL["num_particles"])]
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times[kname][0],
        "plain_ms": times[kname][1], "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None} for kname, source, replaces, launches, err, bound in rows]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
