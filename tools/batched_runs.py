"""The batched entries of kernels #5, #6 and #7 and B episodes as one
batched episode, on the card: chip_smoke.py's phase 30 (batch_episodes)
alone, then the batched episode's rate against B at each B of --batches.

    python3 tools/batched_runs.py [--batches 1 2 4 8] [--steps T]

Builds the libraries the phase runs (the swimmer's and the cheetah's #5,
the forest tasks' #6, the pendulum library, the reacher's #1 and the noise
library) one nvcc each, all at once, then prints chip_smoke.py's
`kernel_batched_entry`, `kernel_batched_entry_time` and `batch_episode`
lines; with --batches, one `batch_scaling` line per config and B: one
replay's device time of a batched episode of B episodes (T steps, the
config's mppi block and seeds) against B replayed single episodes, each
beside the card's name and power limit (nvidia-smi). Last line {"ok":
true}. Without CUDA it exits 1.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batches", type=int, nargs="*", default=[],
                   help="B of the batched episodes' rate sweep (none: no sweep)")
    p.add_argument("--steps", type=int, default=6, help="T of the sweep's episodes")
    p.add_argument("--configs", nargs="*", default=["reacher_7dof-v0", "pen-v0"],
                   help="the sweep's configs (chip_smoke.BATCH_EPISODE_CONFIGS' names)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("batched_runs: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from mjmpc_tpu_torch import envs, ops
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness.episode import build_batched_episode_fn, build_episode_fn
    from mjmpc_tpu_torch.ops import pendulum as pend
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    names = set(smoke.BATCH_ENTRY_CHECKS) | set(smoke.BATCH_EPISODE_CONFIGS)
    kernels = [getattr(e.fused_rollout, "kernel", None) for e in
               (envs.make(n, device=device) for n in sorted(names))]
    builders = [k.library for k in kernels if k is not None and not hasattr(k, "team_for")]
    reacher = envs.make("reacher_7dof-v0", device=device).fused_rollout.kernel
    builders += [lambda t=t: reacher.library(t) for t in (8, 16, 32)]
    builders += [pend.library, ops.FilteredNoise().library]
    with concurrent.futures.ThreadPoolExecutor(len(builders)) as pool:
        for f in [pool.submit(b) for b in builders]:
            f.result()
    counters, counts, expected = smoke.launch_counters()
    smoke.batch_episodes_phase(device, counters, counts, expected, smi)
    for name in args.configs:
        exp = hconfig.load_config(smoke.BATCH_EPISODE_CONFIGS[name])
        e = envs.make(exp["env_name"], device=device)
        s = hconfig.make_solver_for_env(exp, "mppi", e)
        single = build_episode_fn(s, e, args.steps)
        single(e.params, e.params, exp["seed"])       # warm
        single(e.params, e.params, exp["seed"])
        single_ms = single.replay_ms
        for b in args.batches:
            run = build_batched_episode_fn(s, e, args.steps)
            seeds = [exp["seed"] + i * 12345 for i in range(b)]
            run(e.params, e.params, seeds)            # warm
            run(e.params, e.params, seeds)
            print(json.dumps({"phase": "batch_scaling", "env": name, "b": b,
                              "n": s.num_particles, "h": s.horizon, "steps": args.steps,
                              "batched_replay_ms": run.replay_ms,
                              "batched_replay_host_ms": run.replay_host_ms,
                              "single_replay_ms": single_ms,
                              "batched_episode_steps_per_s": b * 1e3 / run.replay_ms,
                              "single_episode_steps_per_s": 1e3 / single_ms,
                              "card": smi}), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
