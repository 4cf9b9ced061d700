"""Kernel #6 (the forest rollout) and the MPPI solves that run it, timed on
one CUDA card for one or more checkouts of this repository, in turns, so
that versions are compared on the same card in the same run.

    python3 tools/forest_ab.py --checkout OLD --checkout . [--rounds 2]

Each round runs every checkout once in order and once in reverse (A B B A
for two), each in a process of its own from its root, importing that
checkout's mjmpc_tpu_torch and this checkout's chip_smoke.py for the
inputs and the timers, so that every version is timed the same way on the
inputs that chip_smoke.py's gates hold. A run builds pen-v0's and the
sawyer peg's libraries (one nvcc each, in parallel), prints their ptxas
lines and nvcc seconds and the kernel's SASS instructions (cuobjdump),
and times the kernel by CUDA events (chip_smoke.cuda_ms: the mean of 20
calls on a held stream) at pen N = 64, 256, 1024 and 4096 and the peg N =
256, all H = 16. Then, for configs/hand/pen-v0.yml and the sawyer peg
config's mppi (N=256 H=16), the read-verified solves/s
(chip_smoke.solves_per_s, the median of 5 windows of 10) and the device
time and busy share per solve (chip_smoke.profile). It keeps the costs,
and the script prints each checkout's largest difference from the first
checkout's costs. One JSON line per measurement and one per comparison;
the card's name and power limit first. Needs a CUDA card.

    python3 tools/forest_ab.py --phases

instead builds this checkout's kernel with its phase clocks (clocked():
-DFOREST_PHASE_CLOCKS) and prints, for pen and the peg at N=256 H=16, the
cycles of each kind of phase along one particle's chain and their
shares, and the SM clock (nvidia-smi) beside them. It fails unless every
kind of phase that the task runs counted cycles and the costs are the
plain build's, bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SIZES = (("pen-v0", 64, 16), ("pen-v0", 256, 16), ("pen-v0", 1024, 16), ("pen-v0", 4096, 16),
         ("sawyer_peg_insertion-v0", 256, 16))
# The kinds of phase of csrc/forest_rollout.cuh (PhaseKind), in its order.
PHASE_KINDS = ("init", "fk", "points", "forces", "sums", "mass", "chol", "forward", "back",
               "cost")


def load_smoke():
    """This checkout's chip_smoke.py as a module (its top level imports
    only the standard library and numpy)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def clocked(roll):
    """(a copy of the forest rollout `roll` whose kernel is built with
    -DFOREST_PHASE_CLOCKS, read): read() returns {kind: cycles} for each
    kind of phase (PHASE_KINDS) along the first particle's chain, summed
    over the kernel calls since the last read, and zeroes them."""
    from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout

    class Clocked(ForestRollout):
        nvcc_flags = ("-DFOREST_PHASE_CLOCKS",)

    copy = Clocked(roll.model, roll.n_substeps, roll.act_bodies, roll.task, roll.ulow,
                   roll.uhigh)

    def read():
        lib = copy.library().lib
        lib.forest_rollout_phase_cycles.argtypes = [ctypes.c_void_p]
        lib.forest_rollout_phase_cycles.restype = ctypes.c_int
        out = (ctypes.c_ulonglong * len(PHASE_KINDS))()
        rc = lib.forest_rollout_phase_cycles(out)
        if rc != 0:
            raise RuntimeError("reading the phase cycles failed: "
                               + lib.forest_rollout_error_string(rc).decode())
        return dict(zip(PHASE_KINDS, (int(x) for x in out)))

    return copy, read


def setup(device):
    """(envs, rollouts) of pen-v0 and the sawyer peg; both libraries built
    at once, their build lines printed."""
    import concurrent.futures

    from mjmpc_tpu_torch import envs
    from mjmpc_tpu_torch.envs import pen, sawyer_tasks
    made = {name: envs.make(name, device=device) for name in ("pen-v0", "sawyer_peg_insertion-v0")}
    rolls = {"pen-v0": pen.build_rollout(made["pen-v0"].params.model),
             "sawyer_peg_insertion-v0": sawyer_tasks.build_rollout(
                 made["sawyer_peg_insertion-v0"].params.model)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = dict(zip(rolls, pool.map(lambda r: r.library(), rolls.values())))
    for name, lib in libs.items():
        sass = subprocess.run(["cuobjdump", "-sass", str(lib.path)], capture_output=True,
                              text=True).stdout
        print(json.dumps({"build": name, "nvcc_seconds": lib.build_seconds,
                          "sass_instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/", sass)),
                          "ptxas": [ln.strip() for ln in lib.ptxas.splitlines()
                                    if re.search(r"registers|spill|stack|smem", ln)]}),
              flush=True)
    return made, rolls


def run_timings(out_path: str, smi: str) -> None:
    """One checkout's run (from its root): the kernel at SIZES, then each
    forest config's MPPI solve; the costs saved to out_path."""
    import numpy as np
    import torch

    from mjmpc_tpu_torch import solvers
    from mjmpc_tpu_torch.harness import config as hconfig
    smoke, device = load_smoke(), torch.device("cuda")
    made, rolls = setup(device)
    costs = {}
    for name, n, h in SIZES:
        roll = rolls[name]
        args = smoke.forest_inputs(made[name], roll, n, h, 23, device)
        got = roll(*args)
        torch.cuda.synchronize()
        costs[f"{name}_{n}_{h}"] = got.cpu().numpy()
        print(json.dumps({"env": name, "n": n, "h": h,
                          "ms": smoke.cuda_ms(lambda: roll(*args), 20),
                          "finite": bool(torch.isfinite(got).all())}), flush=True)
    np.savez(out_path, **costs)
    for name, path in smoke.FOREST_CONFIGS.items():
        e = made[name]
        s = hconfig.make_solver_for_env(hconfig.load_config(path), "mppi", e)
        solve, es = solvers.make_solve_fn(s, e), e.init(e.params, 1)
        _, state = smoke.sync_free(solve, e, es, s.init_state(0), 3)
        rate, windows, _ = smoke.solves_per_s(solve, e, es, state, 10, 5)
        print(json.dumps({"env": name, "config": path, "n": s.num_particles, "h": s.horizon,
                          "solves_per_s": rate, "windows": windows}), flush=True)
        smoke.profile(solve, e, es, s.init_state(0), smi, solver="mppi", env=name)


def run_phases() -> None:
    """This checkout's phase clocks for pen and the peg at N=256 H=16: two
    calls (a warm-up and a timed one) after the counts are read once and
    so zeroed."""
    import torch
    smoke, device = load_smoke(), torch.device("cuda")
    made, rolls = setup(device)
    for name, n, h in (("pen-v0", 256, 16), ("sawyer_peg_insertion-v0", 256, 16)):
        base = rolls[name]
        roll, read = clocked(base)
        args = smoke.forest_inputs(made[name], base, n, h, 23, device)
        roll(*args)
        torch.cuda.synchronize()
        read()
        ms = smoke.cuda_ms(lambda: roll(*args), 1)
        cycles = read()
        total = sum(cycles.values())
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        print(json.dumps({"env": name, "n": n, "h": h, "team": roll.team, "ms_per_call": ms,
                          "sm_clock_after": clock,
                          "cycles_per_substep": total / 2 / (h * base.n_substeps),
                          "share": {k: round(v / total, 4) for k, v in cycles.items()},
                          "cycles_per_call": {k: v / 2 for k, v in cycles.items()}}),
              flush=True)
        idle = {"peg": ("forces", "sums")}.get(base.task.name, ())
        if not torch.equal(roll(*args), base(*args)):
            raise RuntimeError(f"the phase-clock build's costs differ for {name}")
        if any((cycles[k] > 0) == (k in idle) for k in PHASE_KINDS):
            raise RuntimeError(f"phase cycles for {name} not as the task's phases: {cycles}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", action="append", default=None,
                        help="a checkout's root (repeatable; default: this one)")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--phases", action="store_true",
                        help="this checkout's phase clocks instead of the timings")
    parser.add_argument("--run", nargs=2, metavar=("COSTS_NPZ", "CARD"),
                        help=argparse.SUPPRESS)    # one checkout's run, from its root
    args = parser.parse_args()
    if args.run:
        run_timings(*args.run)
        return 0
    if args.phases:
        sys.path.insert(0, str(ROOT))
        run_phases()
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
            path = Path(out) / f"costs_{k}_{run}.npz"
            env = dict(os.environ, PYTHONPATH=str(checkouts[k]))
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run",
                                   str(path), smi], cwd=checkouts[k], env=env,
                                  capture_output=True, text=True)
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
                key: float(np.abs(other[key] - first[key]).max()) for key in first.files}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
