"""The hand-written kernels (the team-of-lanes rollouts, the one-kernel
pendulum solve and the filtered noise) and the solves that run them, timed
on one CUDA card for one or more checkouts of this repository, in turns, so
that versions are compared on the same card in the same run.

    python3 tools/kernel_ab.py --checkout OLD --checkout . [--family chain] [--rounds 2]

Each round runs every checkout once in order and once in reverse (A B B A
for two), each in a process of its own from its root, importing that
checkout's mjmpc_tpu_torch, this checkout's chip_smoke.py for the inputs
and this checkout's timers (mjmpc_tpu_torch/harness/benchmark.py, loaded
from its file, load_timers), so that every version is timed the same way
on the inputs that chip_smoke.py's gates hold. A family is the kernels of one
source:

- forest: kernel #6 (csrc/forest_rollout.cu), pen-v0 at N = 64, 256, 1024
  and 4096 and the sawyer peg at N = 256, all H = 16, and every other task
  at its config's size (relocate-v0, hammer-v0, the sawyer door, the
  pusher, the three tray-glass models, door-v0: bounds.FOREST_SIZES); then
  the MPPI solves of every forest config (chip_smoke.FOREST_CONFIGS). A
  checkout that lacks a task skips it;
- chain: csrc/chain_rollout.cu, #1 (costs) on the reacher at N=4096 H=32
  and at the run_mpc reacher configs' N=128 H=16 and N=256 H=32, #3 (obs)
  on the reacher at N=4096 H=32 and with the peg task at the peg config's
  N=256 H=16, #4 (closed loop) on the reacher at N=4096 H=32 and on the
  peg at its config's N=64 H=32, #5 (locomotion) on the swimmer at N=512
  H=32 and the cheetah at N=512 H=16; then MPPI on the main path (the
  reacher at N=4096 H=32, kernel noise), on configs/reacher_7dof-v0.yml
  (N=128 H=16) and on both locomotion configs, and Reinforce on the
  reacher and the peg config;
- pendulum: kernel #7 (csrc/pendulum.cu, the pendulum rollout) at N = 24,
  64, 2048 and 4096, H=32, and kernel #8 (the one-kernel MPPI solve) at
  N = 128, 1024, 2048 and 8192, H=32, on chip_smoke.py's inputs, with the
  particles a block and cluster size its checkout picks;
- noise: kernel #2 (csrc/filtered_noise.cu, uncoloured) at (N, H, dA) =
  (37, 5, 7), (4096, 32, 7) and (512, 32, 30); then MPPI on the main path
  with the kernel noise.
Both call each checkout's API as it is: a seed by value, or a key and a
step tensor (at step 0, which draws the same normals as the seed did).

A run builds its family's libraries (one nvcc each, in parallel), prints
their ptxas lines, nvcc seconds and SASS instructions (cuobjdump), times
each kernel by CUDA events (cuda_ms of this checkout's
mjmpc_tpu_torch/harness/benchmark.py: the mean of 20 calls on a held
stream), then each solve's read-verified solves/s (its solves_per_s, the
median of 5 windows of 10) and device time
and busy share per solve (chip_smoke.profile). It keeps the kernels'
outputs, and the script prints each checkout's largest difference from the
first checkout's. One JSON line per measurement and one per comparison;
the card's name and power limit first. Needs a CUDA card.

    python3 tools/kernel_ab.py --phases [--family chain]

instead builds this checkout's team kernels with their phase clocks
(clocked(): -DFOREST_PHASE_CLOCKS or -DCHAIN_PHASE_CLOCKS) and prints the
cycles of each kind of phase along one particle's chain, per substep, and
their shares, and the SM clock (nvidia-smi) beside them: forest for pen
and the peg at N=256 H=16, chain for #1, #3, #4 and #5 at the sizes above.
It fails unless every kind of phase that the kernel runs counted cycles
and the outputs are the plain build's, bit for bit.

    python3 tools/kernel_ab.py --cluster-sweep

instead times this checkout's kernel #8 at every cluster size it can take
(1, 2, 4, 8 and 16 CTAs; those whose CTA does not fit are reported as
such) at N = 128, 1024, 2048 and 8192, H=32, then one line per N with the
fastest size and the one ops/pendulum.py solve_cluster picks. It fails
unless every size gives the plain version's mean to 1e-5.

    python3 tools/kernel_ab.py --pendulum-sweep

instead times this checkout's kernel #7 at 1, 2, 4, 8, 16, 32, 64 and
128 particles a block and its default at N = 24, 64, 256, 1024, 2048,
4096 and 8192, H=32, one line per time and one per N with the fastest size and the
one csrc/pendulum.cu pendulum_rollout_per_block picks. It fails unless
every size gives the default's costs bit for bit.

    python3 tools/kernel_ab.py --noise-sweep

instead times this checkout's kernel #2 (uncoloured) at the noise shapes
above with 1, 2, 4, 8, 16 and 32 particles a block and its default, one line
per time and one per shape with the fastest. It fails unless every
partition gives the default's output bit for bit.

    python3 tools/kernel_ab.py --sweep

instead times this checkout's costs and obs rollouts (#1, #3) at every
team size the kernel takes (4, 8, 16 and 32 lanes per particle) over N =
64 to 8192 (SWEEP_N): the reacher's costs at H=32 and H=16 and the
peg's obs at H=32. One line per time, then one per (case, N) with the
fastest team and the one that ops/chain_rollout.py open_loop_team picks
on this card. It fails unless every team size gives the same outputs, bit
for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ("forest", "chain", "pendulum", "noise")
NOISE_SHAPES = ((37, 5, 7), (4096, 32, 7), (512, 32, 30))
PENDULUM_N = (128, 1024, 2048, 8192)
PENDULUM_ROLLOUT_N = (24, 64, 2048, 4096)
PENDULUM_SWEEP_N = (24, 64, 256, 1024, 2048, 4096, 8192)
NOISE_PER_BLOCK = (0, 1, 2, 4, 8, 16, 32)    # 0: the kernel's default
FOREST_SIZES = (("pen-v0", 64, 16), ("pen-v0", 256, 16), ("pen-v0", 1024, 16),
                ("pen-v0", 4096, 16), ("sawyer_peg_insertion-v0", 256, 16),
                ("relocate-v0", 512, 32), ("hammer-v0", 512, 20), ("sawyer_door-v0", 256, 16),
                ("sawyer_pusher-v0", 512, 24), ("panda_tray_glass-v0", 1024, 20),
                ("panda_tray_glass-v1", 256, 16), ("panda_tray_glass_fixed-v1", 256, 16),
                ("door-v0", 256, 48))
# kernel #6's check starts (chip_smoke.forest_inputs) of the tasks that have one
FOREST_STARTS = {"relocate-v0": "grasp", "hammer-v0": "held", "sawyer_door-v0": "grab",
                 "sawyer_pusher-v0": "contact", "panda_tray_glass-v0": "fallen",
                 "panda_tray_glass-v1": "fallen", "panda_tray_glass_fixed-v1": "arm",
                 "door-v0": "hook"}
# chain kernels: name -> (wrapper key, N, H)
CHAIN_SIZES = {"chain_costs_reacher": ("costs", 4096, 32),
               "chain_costs_reacher_n128_h16": ("costs", 128, 16),
               "chain_costs_reacher_n256_h32": ("costs", 256, 32),
               "chain_obs_reacher": ("obs", 4096, 32), "chain_obs_peg": ("obs_peg", 256, 16),
               "chain_cl_reacher": ("cl_reacher", 4096, 32), "chain_cl_peg": ("cl_peg", 64, 32),
               "chain_ext_swimmer": ("Swimmer-v0", 512, 32),
               "chain_ext_cheetah": ("HalfCheetah-v0", 512, 16)}
# the wrappers that share one library (per team size): the task's
LIBRARY_OF = {"costs": "reacher", "obs": "reacher", "cl_reacher": "reacher", "obs_peg": "peg",
              "cl_peg": "peg"}
# --sweep: case -> (wrapper key, H), over SWEEP_N particles
SWEEP = {"reacher_costs_h32": ("costs", 32), "reacher_costs_h16": ("costs", 16),
         "peg_obs_h32": ("obs_peg", 32)}
SWEEP_N = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 5120, 6144, 7168, 8192)
# The kinds of phase of csrc/forest_rollout.cuh and csrc/chain_team.cuh
# (PhaseKind), in their order.
PHASE_KINDS = {"forest": ("init", "fk", "points", "forces", "sums", "mass", "chol", "forward",
                          "back", "cost"),
               "chain": ("init", "dofs", "fk", "body", "task", "act", "slots", "entries",
                         "solve")}
CLOCK_FLAGS = {"forest": "-DFOREST_PHASE_CLOCKS", "chain": "-DCHAIN_PHASE_CLOCKS"}


TIMERS = "mjmpc_tpu_torch.harness.benchmark"


def load_timers():
    """This checkout's timers (mjmpc_tpu_torch/harness/benchmark.py), also
    where the checkout under test has none: loaded from this checkout's
    file under their module's name, so that chip_smoke.py's import of them
    finds this copy (its package imports resolve in the checkout under
    test)."""
    if TIMERS not in sys.modules:
        import mjmpc_tpu_torch.harness   # the checkout under test's package
        spec = importlib.util.spec_from_file_location(
            TIMERS, ROOT / "mjmpc_tpu_torch" / "harness" / "benchmark.py")
        timers = importlib.util.module_from_spec(spec)
        sys.modules[TIMERS] = timers
        spec.loader.exec_module(timers)
    return sys.modules[TIMERS]


def load_smoke():
    """This checkout's chip_smoke.py as a module, with this checkout's
    timers (load_timers)."""
    load_timers()
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def clocked(roll, family):
    """(a copy of the rollout wrapper `roll` whose kernel is built with its
    family's phase clocks, read): read() returns {kind: cycles} for each
    kind of phase along the first particle's chain, summed over the kernel
    calls since the last read, and zeroes them."""
    cls = type("Clocked", (type(roll),), {"nvcc_flags": (CLOCK_FLAGS[family],)})
    copy = object.__new__(cls)
    copy.__dict__.update(roll.__dict__)
    if hasattr(copy, "_libs"):      # one library per team size
        copy._libs = {}
    else:
        copy._lib = None
    kinds = PHASE_KINDS[family]
    prefix = "forest_rollout" if family == "forest" else "chain_rollout"

    def read():
        libs = (list(copy._libs.values()) if hasattr(copy, "_libs")   # every team size launched
                else [copy.library()])
        total = dict.fromkeys(kinds, 0)
        for lib in (x.lib for x in libs):
            entry = getattr(lib, f"{prefix}_phase_cycles")
            entry.argtypes, entry.restype = [ctypes.c_void_p], ctypes.c_int
            out = (ctypes.c_ulonglong * len(kinds))()
            rc = entry(out)
            if rc != 0:
                raise RuntimeError("reading the phase cycles failed: "
                                   + getattr(lib, f"{prefix}_error_string")(rc).decode())
            for k, x in zip(kinds, out):
                total[k] += int(x)
        return total

    return copy, read


def team_of(roll, n):
    """The lanes per particle of the wrapper's launch over n particles: its
    rule's (team_for) where it has one, else its `team` attribute."""
    return roll.team_for(n) if hasattr(roll, "team_for") else getattr(roll, "team", None)


def library_of(roll, team):
    """The wrapper's library at `team` lanes where it has one per team size,
    else its one library."""
    return roll.library(team) if hasattr(roll, "team_for") else roll.library()


def build_all(builds):
    """Build the libraries {name: (wrapper, team)} at once (one nvcc each)
    and print their build lines."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda b: library_of(*b), builds.values())))
    for name, lib in libs.items():
        sass = subprocess.run(["cuobjdump", "-sass", str(lib.path)], capture_output=True,
                              text=True).stdout
        print(json.dumps({"build": name, "team": builds[name][1],
                          "nvcc_seconds": lib.build_seconds,
                          "sass_instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass)),
                          "ptxas": [ln.strip() for ln in lib.ptxas.splitlines()
                                    if re.search(r"registers|spill|stack|smem", ln)]}),
              flush=True)


def forest_setup(device, names):
    """(envs, rollouts) of kernel #6's tasks among the env `names` that this
    checkout has (one from before bounds.forest_builder: pen-v0 and the
    sawyer peg)."""
    from mjmpc_tpu_torch import bounds, envs
    from mjmpc_tpu_torch.envs import pen, sawyer_tasks
    builders = {"pen-v0": pen.build_rollout, "sawyer_peg_insertion-v0": sawyer_tasks.build_rollout}
    if hasattr(bounds, "forest_builder"):
        builders = {name: bounds.forest_builder(name) for name in bounds.FOREST_SIZES}
    made = {name: envs.make(name, device=device) for name in names if name in builders}
    rolls = {name: builders[name](e.params.model) for name, e in made.items()}
    return made, rolls


def chain_setup(device):
    """(envs, wrappers) of the chain kernels: the reacher's costs, obs and
    closed-loop rollouts (one library per team size), the peg's obs and
    closed loop, the swimmer's and the cheetah's locomotion rollouts."""
    from mjmpc_tpu_torch import envs
    from mjmpc_tpu_torch.envs import half_cheetah, swimmer
    from mjmpc_tpu_torch.ops import chain_rollout as cr
    made = {name: envs.make(name, device=device)
            for name in ("reacher_7dof-v0", "sawyer_peg_insertion-v0", "Swimmer-v0",
                         "HalfCheetah-v0")}
    reacher = made["reacher_7dof-v0"].params.model
    peg = made["sawyer_peg_insertion-v0"].params.model
    rolls = {"costs": cr.ChainRollout(reacher, 2), "obs": cr.ChainObsRollout(reacher, 2),
             "cl_reacher": cr.ChainClRollout(reacher, 2),
             "obs_peg": cr.ChainObsRollout(peg, 2, task="peg"),
             "cl_peg": cr.ChainClRollout(peg, 2, task="peg"),
             "Swimmer-v0": swimmer.build_rollout(made["Swimmer-v0"].params),
             "HalfCheetah-v0": half_cheetah.build_rollout(made["HalfCheetah-v0"].params)}
    return made, rolls


def chain_inputs(smoke, made, rolls, key, n, h, device):
    """chip_smoke.py's inputs of the chain kernel `key` at (n, h), with the
    seeds of its config-size checks."""
    from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
    roll = rolls[key]
    if key in ("costs", "obs"):
        return smoke.reacher_inputs(n, h, 0, device)
    if key == "obs_peg":
        args = smoke.reacher_inputs(n, h, 0, device)
        return args[:2] + [peg_extras(made["sawyer_peg_insertion-v0"].params)] + args[3:]
    if key == "cl_reacher":
        target = smoke.reacher_inputs(1, 1, 0, device)[2]
        return smoke.cl_inputs(roll.d_obs, target, n, h, 4, device)
    if key == "cl_peg":
        return smoke.cl_inputs(roll.d_obs, peg_extras(made["sawyer_peg_insertion-v0"].params),
                               n, h, 6, device)
    return smoke.loco_inputs(roll.model.nv, n, h, 11, device)


def forest_timings(smoke, smi, device, outputs):
    timers = load_timers()
    from mjmpc_tpu_torch import solvers
    from mjmpc_tpu_torch.harness import config as hconfig
    import torch
    made, rolls = forest_setup(device, list(smoke.FOREST_CONFIGS))
    build_all({name: (r, r.team) for name, r in rolls.items()})
    for name, n, h in FOREST_SIZES:
        if name not in rolls:
            continue
        roll = rolls[name]
        args = smoke.forest_inputs(made[name], roll, n, h, 23, device, FOREST_STARTS.get(name))
        got = roll(*args)
        torch.cuda.synchronize()
        outputs[f"{name}_{n}_{h}"] = got.cpu().numpy()
        print(json.dumps({"env": name, "n": n, "h": h,
                          "ms": timers.cuda_ms(lambda: roll(*args), 20),
                          "finite": bool(torch.isfinite(got).all())}), flush=True)
    for name, path in smoke.FOREST_CONFIGS.items():
        if name not in made:
            continue
        e = made[name]
        s = hconfig.make_solver_for_env(hconfig.load_config(path), "mppi", e)
        solve_rate(smoke, smi, solvers.make_solve_fn(s, e), s, e, solver="mppi", env=name,
                   config=path)


def chain_timings(smoke, smi, device, outputs):
    timers = load_timers()
    from mjmpc_tpu_torch import solvers
    from mjmpc_tpu_torch.harness import config as hconfig
    import torch
    made, rolls = chain_setup(device)
    builds = {}
    for key, n, _ in CHAIN_SIZES.values():
        team = team_of(rolls[key], n)
        builds.setdefault(f"{LIBRARY_OF.get(key, key)} team={team}", (rolls[key], team))
    build_all(builds)
    for name, (key, n, h) in CHAIN_SIZES.items():
        roll = rolls[key]
        args = chain_inputs(smoke, made, rolls, key, n, h, device)
        got = roll(*args)
        torch.cuda.synchronize()
        for k, x in enumerate(got if isinstance(got, tuple) else (got,)):
            outputs[f"{name}_{k}"] = x.cpu().numpy()
        print(json.dumps({"kernel": name, "n": n, "h": h, "team": team_of(roll, n),
                          "ms": timers.cuda_ms(lambda: roll(*args), 20)}), flush=True)
    e = made["reacher_7dof-v0"]     # the main path: MPPI with the kernel noise, #1
    s = solvers.MPPI(d_action=e.d_action, horizon=smoke.HORIZON,
                     num_particles=smoke.NUM_PARTICLES, init_cov=3.0,
                     filter_coeffs=smoke.FILTER, base_action="repeat", device=device, lam=0.01,
                     step_size=0.55, gamma=1.0, noise_impl="kernel")
    solve_rate(smoke, smi, solvers.make_solve_fn(s, e), s, e, solver="mppi", env=e.name,
               noise_impl="kernel")
    configs = dict(smoke.LOCO_CONFIGS, **{"reacher_7dof-v0": "configs/reacher_7dof-v0.yml"})
    for name, path in configs.items():
        e = made[name]
        s = hconfig.make_solver_for_env(hconfig.load_config(path), "mppi", e)
        solve_rate(smoke, smi, solvers.make_solve_fn(s, e), s, e, solver="mppi", env=name,
                   config=path)
    for name, s in (("reacher_7dof-v0", solvers.Reinforce(
                        d_obs=made["reacher_7dof-v0"].d_obs, d_action=smoke.D_ACTION,
                        device=device, **smoke.RF_REACHER)),
                    ("sawyer_peg_insertion-v0", solvers.make_solver(
                        "reinforce", d_obs=made["sawyer_peg_insertion-v0"].d_obs,
                        d_action=smoke.D_ACTION, device=device, **smoke.PEG_CL))):
        e = made[name]
        solve_rate(smoke, smi, solvers.make_solve_fn(s, e), s, e, solver="reinforce", env=name)


def solve_rate(smoke, smi, solve, s, e, **labels):
    """A solve's read-verified solves/s and its profile line."""
    timers = load_timers()
    es = e.init(e.params, 1)
    _, state = smoke.sync_free(solve, e, es, s.init_state(0), 3)
    rate, windows, _ = timers.solves_per_s(solve, e, es, state, 10, 5)
    print(json.dumps({**labels, "n": s.num_particles, "h": s.horizon, "solves_per_s": rate,
                      "windows": windows}), flush=True)
    smoke.profile(solve, e, es, s.init_state(0), smi, **labels)


def _takes_step(fn) -> bool:
    """Whether a noise or #8 entry point takes a step tensor (else a seed)."""
    return "step" in inspect.signature(fn).parameters


def _print_build(name, lib):
    print(json.dumps({"build": name, "nvcc_seconds": lib.build_seconds,
                      "ptxas": [ln.strip() for ln in lib.ptxas.splitlines()
                                if re.search(r"registers|spill|stack|smem", ln)]}), flush=True)


def pendulum_timings(smoke, smi, device, outputs):
    timers = load_timers()
    import torch
    from mjmpc_tpu_torch import envs
    from mjmpc_tpu_torch.ops import pendulum as pend
    _print_build("pendulum", pend.library())
    keyed = _takes_step(type(pend.mppi_pendulum_solve).__call__)
    step = torch.zeros((), dtype=torch.int64, device=device)
    pend_env = envs.make("SimplePendulum-v0", device=device)
    for n in PENDULUM_ROLLOUT_N:       # kernel #7
        args = smoke.pendulum_inputs(pend_env, n, smoke.HORIZON, 36, device)
        got = pend.pendulum_rollout(*args)
        torch.cuda.synchronize()
        outputs[f"pendulum_rollout_{n}"] = got.cpu().numpy()
        print(json.dumps({"kernel": "pendulum_rollout", "n": n, "h": smoke.HORIZON, "card": smi,
                          "ms": timers.cuda_ms(lambda: pend.pendulum_rollout(*args), 50)}),
              flush=True)
    params, state, mean, _ = smoke.pendulum_inputs(pend_env, 1, smoke.HORIZON, 34, device)
    for n in PENDULUM_N:
        cfg = dict(smoke.ONE_KERNEL, num_particles=n)
        head = (params, state, mean, 77) + ((step,) if keyed else ())
        got = pend.mppi_pendulum_solve(*head, **cfg)
        torch.cuda.synchronize()
        outputs[f"mppi_pendulum_solve_{n}"] = got.cpu().numpy()
        ctas = pend.solve_cluster(pend.sampled_particles(n)) if keyed else 1
        print(json.dumps({"kernel": "mppi_pendulum_solve", "n": n, "h": smoke.HORIZON,
                          "ctas": ctas, "card": smi,
                          "ms": timers.cuda_ms(lambda: pend.mppi_pendulum_solve(*head, **cfg),
                                              50)}), flush=True)


def noise_timings(smoke, smi, device, outputs):
    timers = load_timers()
    import torch
    from mjmpc_tpu_torch import envs, solvers
    from mjmpc_tpu_torch.ops.noise import FilteredNoise
    sampler = FilteredNoise()
    _print_build("filtered_noise", sampler.library())
    keyed = _takes_step(sampler.white)
    step = torch.zeros((), dtype=torch.int64, device=device)
    for n, h, d in NOISE_SHAPES:
        args = ((5, step, n, h, d, smoke.FILTER) if keyed
                else (5, n, h, d, smoke.FILTER, device))
        got = sampler.white(*args)
        torch.cuda.synchronize()
        outputs[f"filtered_noise_{n}_{h}_{d}"] = got.cpu().numpy()
        print(json.dumps({"kernel": "filtered_noise", "n": n, "h": h, "d_action": d,
                          "card": smi, "ms": timers.cuda_ms(lambda: sampler.white(*args), 50)}),
              flush=True)
    e = envs.make("reacher_7dof-v0", device=device)     # the main path, kernel noise
    s = solvers.MPPI(d_action=e.d_action, horizon=smoke.HORIZON,
                     num_particles=smoke.NUM_PARTICLES, init_cov=3.0,
                     filter_coeffs=smoke.FILTER, base_action="repeat", device=device, lam=0.01,
                     step_size=0.55, gamma=1.0, noise_impl="kernel")
    solve_rate(smoke, smi, solvers.make_solve_fn(s, e), s, e, solver="mppi", env=e.name,
               noise_impl="kernel")


def run_timings(out_path: str, smi: str, families) -> None:
    """One checkout's run (from its root): each family's kernels, then its
    solves; the kernels' outputs saved to out_path."""
    import numpy as np
    import torch
    smoke, device, outputs = load_smoke(), torch.device("cuda"), {}
    if "forest" in families:
        forest_timings(smoke, smi, device, outputs)
    if "chain" in families:
        chain_timings(smoke, smi, device, outputs)
    if "pendulum" in families:
        pendulum_timings(smoke, smi, device, outputs)
    if "noise" in families:
        noise_timings(smoke, smi, device, outputs)
    np.savez(out_path, **outputs)


def run_phases(families) -> None:
    """This checkout's phase clocks: two calls (a warm-up and a timed one)
    after the counts are read once and so zeroed."""
    timers = load_timers()
    import torch
    smoke, device = load_smoke(), torch.device("cuda")
    cases = []
    if "forest" in families:
        made, rolls = forest_setup(device, ("pen-v0", "sawyer_peg_insertion-v0"))
        cases += [("forest", name, rolls[name], n, h,
                   smoke.forest_inputs(made[name], rolls[name], n, h, 23, device))
                  for name, n, h in (("pen-v0", 256, 16), ("sawyer_peg_insertion-v0", 256, 16))]
    if "chain" in families:
        made, rolls = chain_setup(device)
        cases += [("chain", name, rolls[key], n, h,
                   chain_inputs(smoke, made, rolls, key, n, h, device))
                  for name, (key, n, h) in CHAIN_SIZES.items()]
    clocks = [clocked(roll, family) for family, _, roll, *_ in cases]
    build_all({name: (c, team_of(c, n)) for (_, name, _, n, *_), (c, _) in zip(cases, clocks)})
    for (family, name, base, n, h, args), (roll, read) in zip(cases, clocks):
        roll(*args)
        torch.cuda.synchronize()
        read()
        ms = timers.cuda_ms(lambda: roll(*args), 1)
        cycles = read()
        total = sum(cycles.values())
        substeps = 2 * h * base.n_substeps      # two calls
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        print(json.dumps({"family": family, "kernel": name, "n": n, "h": h,
                          "team": team_of(base, n), "ms_per_call": ms,
                          "sm_clock_after": clock,
                          "cycles_per_substep": total / substeps,
                          "share": {k: round(v / total, 4) for k, v in cycles.items()},
                          "cycles_per_substep_by_kind": {k: v / substeps
                                                         for k, v in cycles.items()}}),
              flush=True)
        same = [torch.equal(x, y) for x, y in zip(*(
            out if isinstance(out, tuple) else (out,) for out in (roll(*args), base(*args))))]
        if not all(same):
            raise RuntimeError(f"the phase-clock build's outputs differ for {name}")
        # the forest peg has no contact; every chain kernel runs every kind
        idle = {"peg": ("forces", "sums")}.get(base.task.name, ()) if family == "forest" else ()
        if any((cycles[k] > 0) == (k in idle) for k in PHASE_KINDS[family]):
            raise RuntimeError(f"phase cycles for {name} not as its phases: {cycles}")


def run_sweep() -> None:
    """This checkout's costs and obs rollouts at every team size (SWEEP)."""
    timers = load_timers()
    import torch
    smoke, device = load_smoke(), torch.device("cuda")
    from mjmpc_tpu_torch.ops.chain_rollout import TEAM_SIZES, open_loop_team
    made, rolls = chain_setup(device)
    build_all({f"{LIBRARY_OF[key]} team={t}": (rolls[key], t)
               for key in ("costs", "obs_peg") for t in TEAM_SIZES})
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    for case, (key, h) in SWEEP.items():
        roll = rolls[key]
        for n in SWEEP_N:
            args = chain_inputs(smoke, made, rolls, key, n, h, device)
            outs, times = [], {}
            for team in TEAM_SIZES:
                got = roll(*args, team=team)
                torch.cuda.synchronize()
                outs.append(got if isinstance(got, tuple) else (got,))
                times[team] = timers.cuda_ms(lambda: roll(*args, team=team), 20)
                print(json.dumps({"sweep": case, "n": n, "h": h, "team": team,
                                  "ms": times[team]}), flush=True)
            if not all(torch.equal(x, y) for other in outs[1:] for x, y in zip(outs[0], other)):
                raise RuntimeError(f"team sizes disagree for {case} at N={n}")
            print(json.dumps({"sweep": case, "n": n, "h": h, "sm_count": sm_count,
                              "fastest": min(times, key=times.get),
                              "rule": open_loop_team(n, sm_count), "ms": times,
                              "identical": True}), flush=True)


def run_cluster_sweep() -> None:
    """This checkout's kernel #8 at every cluster size (CLUSTER_SIZES)."""
    timers = load_timers()
    import torch
    from mjmpc_tpu_torch import envs, rng
    from mjmpc_tpu_torch.ops import pendulum as pend
    smoke, device = load_smoke(), torch.device("cuda")
    _print_build("pendulum", pend.library())
    step = rng.step_tensor(0, device)
    params, state, mean, _ = smoke.pendulum_inputs(envs.make("SimplePendulum-v0", device=device),
                                                   1, smoke.HORIZON, 34, device)
    for n in PENDULUM_N:
        cfg = dict(smoke.ONE_KERNEL, num_particles=n)
        args = (params, state, mean, 77, step)
        want = pend.mppi_pendulum_solve.plain(*args, **cfg)
        sampled, times = pend.sampled_particles(n), {}
        for ctas in pend.CLUSTER_SIZES:
            try:
                threads, smem = pend.solve_shape(sampled, smoke.HORIZON, ctas)
            except ValueError as e:
                print(json.dumps({"cluster_sweep": n, "ctas": ctas, "fits": False,
                                  "why": str(e)}), flush=True)
                continue
            active = pend.max_active_clusters(sampled, smoke.HORIZON, ctas)
            if active < 1:
                print(json.dumps({"cluster_sweep": n, "ctas": ctas, "fits": False,
                                  "max_active_clusters": active}), flush=True)
                continue
            got = pend.mppi_pendulum_solve(*args, **cfg, ctas=ctas)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= 1e-5:
                raise RuntimeError(f"kernel #8 at {ctas} CTAs disagrees at N={n}: {err}")
            times[ctas] = timers.cuda_ms(lambda: pend.mppi_pendulum_solve(*args, **cfg,
                                                                         ctas=ctas), 50)
            print(json.dumps({"cluster_sweep": n, "ctas": ctas, "threads": threads,
                              "smem_bytes": smem, "max_active_clusters": active,
                              "max_abs_err": err, "ms": times[ctas]}), flush=True)
        print(json.dumps({"cluster_sweep": n, "fastest": min(times, key=times.get),
                          "rule": pend.solve_cluster(sampled), "ms": times}), flush=True)


def run_pendulum_sweep() -> None:
    """This checkout's kernel #7 at every particles-a-block size."""
    timers = load_timers()
    import torch
    from mjmpc_tpu_torch import envs
    from mjmpc_tpu_torch.ops import pendulum as pend
    smoke, device = load_smoke(), torch.device("cuda")
    _print_build("pendulum", pend.library())
    pend_env = envs.make("SimplePendulum-v0", device=device)
    for n in PENDULUM_SWEEP_N:
        args = smoke.pendulum_inputs(pend_env, n, smoke.HORIZON, 37, device)
        want = pend.pendulum_rollout(*args)
        times = {}
        for per_block in (0,) + pend.ROLLOUT_PER_BLOCK:
            got = pend.pendulum_rollout(*args, per_block=per_block)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"kernel #7 at {per_block} particles a block differs at N={n}")
            times[per_block] = timers.cuda_ms(
                lambda: pend.pendulum_rollout(*args, per_block=per_block), 50)
            print(json.dumps({"pendulum_sweep": n, "h": smoke.HORIZON, "per_block": per_block,
                              "ms": times[per_block]}), flush=True)
        print(json.dumps({"pendulum_sweep": n, "h": smoke.HORIZON,
                          "fastest": min(times, key=times.get),
                          "rule": pend.rollout_per_block(n, smoke.HORIZON), "ms": times,
                          "identical": True}), flush=True)


def run_noise_sweep() -> None:
    """This checkout's kernel #2 at several particles per block."""
    timers = load_timers()
    import torch
    from mjmpc_tpu_torch import rng
    from mjmpc_tpu_torch.ops.noise import FilteredNoise
    smoke, device = load_smoke(), torch.device("cuda")
    sampler = FilteredNoise()
    _print_build("filtered_noise", sampler.library())
    step = rng.step_tensor(0, device)
    for n, h, d in NOISE_SHAPES:
        want = sampler.white(5, step, n, h, d, smoke.FILTER)
        times = {}
        for per_block in NOISE_PER_BLOCK:
            args = (5, step, n, h, d, smoke.FILTER, per_block)
            got = sampler.white(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"kernel #2 at {per_block} particles a block differs at "
                                   f"{(n, h, d)}")
            times[per_block] = timers.cuda_ms(lambda: sampler.white(*args), 50)
            print(json.dumps({"noise_sweep": [n, h, d], "per_block": per_block,
                              "ms": times[per_block]}), flush=True)
        print(json.dumps({"noise_sweep": [n, h, d], "fastest": min(times, key=times.get),
                          "ms": times, "identical": True}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", action="append", default=None,
                        help="a checkout's root (repeatable; default: this one)")
    parser.add_argument("--family", choices=FAMILIES, action="append", default=None,
                        help="the kernels to run (repeatable; default: all)")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--phases", action="store_true",
                        help="this checkout's phase clocks instead of the timings")
    parser.add_argument("--sweep", action="store_true",
                        help="this checkout's costs and obs rollouts at every team size")
    parser.add_argument("--cluster-sweep", action="store_true",
                        help="this checkout's kernel #8 at every cluster size")
    parser.add_argument("--noise-sweep", action="store_true",
                        help="this checkout's kernel #2 at several particles per block")
    parser.add_argument("--pendulum-sweep", action="store_true",
                        help="this checkout's kernel #7 at several particles per block")
    parser.add_argument("--run", nargs=3, metavar=("OUTPUTS_NPZ", "CARD", "FAMILIES"),
                        help=argparse.SUPPRESS)    # one checkout's run, from its root
    args = parser.parse_args()
    families = tuple(args.family or FAMILIES)
    if args.run:
        run_timings(args.run[0], args.run[1], args.run[2].split(","))
        return 0
    if args.phases or args.sweep or args.cluster_sweep or args.noise_sweep or args.pendulum_sweep:
        sys.path.insert(0, str(ROOT))
        if args.cluster_sweep:
            run_cluster_sweep()
        elif args.noise_sweep:
            run_noise_sweep()
        elif args.pendulum_sweep:
            run_pendulum_sweep()
        elif args.sweep:
            run_sweep()
        else:
            run_phases(tuple(f for f in families if f in CLOCK_FLAGS))
        return 0
    checkouts = [Path(c).resolve() for c in (args.checkout or [str(ROOT)])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    order = []
    for _ in range(args.rounds):
        order += list(range(len(checkouts))) + list(reversed(range(len(checkouts))))
    import numpy as np
    with tempfile.TemporaryDirectory() as out:
        saved = {}
        for run, k in enumerate(order):
            path = Path(out) / f"outputs_{k}_{run}.npz"
            env = dict(os.environ, PYTHONPATH=str(checkouts[k]))
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run",
                                   str(path), smi, ",".join(families)], cwd=checkouts[k],
                                  env=env, capture_output=True, text=True)
            for line in proc.stdout.splitlines():
                print(json.dumps({"checkout": str(checkouts[k]), "run": run,
                                  **json.loads(line)}), flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            saved.setdefault(k, path)
        first = np.load(saved[0])
        for k, path in saved.items():
            other = np.load(path)
            print(json.dumps({"checkout": str(checkouts[k]), "max_abs_diff_from_first": {
                key: float(np.abs(other[key] - first[key]).max()) for key in first.files
                if key in other.files}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
