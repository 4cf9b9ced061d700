"""Episode results of the learned-model family on the card, for comparison
with the JAX package's records (RESULTS.md:133-193, 221).

    python3 tools/learned_runs.py [--device cuda] [--only NAME ...] \
        [--softq-episodes N] [--diag-steps N]

One JSON line per result, each beside the card's name and power limit
(nvidia-smi), then a last line {"ok": true}:

- softq_sawyer: run_mpc on configs/sawyer/sawyer_reacher-v0.yml with its
  softq block (N=64, H=16, lam 0.05, lr 0.1, 8 gradient steps, clip 10),
  --softq-episodes of the config's 75 steps (3 by default, as the config):
  each episode's reward, the average and the success metric (JAX -332 +-
  12, 0%);
- softq_diag: harness/softq_diag.py's two arms (stock, observation-
  whitened) cut to --diag-steps solves: the share of solves whose gradient
  the clip binds and the last fit MSE (JAX: 100% in both arms);
- sacq_eval: a reduced protocol of RESULTS.md:133-168 on reacher_7dof-v0:
  10 training episodes of 75 steps (750 steps, 4 SAC updates a step, the
  first after 500 transitions), then the three arms (mppi, mppiq without a
  Q, mppiq with the SAC Q) at H=4, N=512 over 3 episodes from the same
  seeds (JAX, 100 training episodes and 5 evaluation episodes: -400.9 /
  -424.3 / -251.6). A capability check, not a gate;
- profile: softq on the sawyer reacher with the config's block, the
  learned-model run of chip_smoke.py whose solve makes tens of thousands
  of launches (chip_smoke.LEARNED_HEAVY): read-verified solves/s over one
  window of 2 solves after a warm-up solve and chip_smoke.profile over one
  solve after one warm-up (`profile` line: kernels and device ms per
  solve, busy share).

Without CUDA (and no --device cpu) it exits 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RESULTS = ("softq_sawyer", "softq_diag", "sacq_eval", "profile")
SACQ_PROTOCOL = ["--env", "reacher_7dof-v0", "--train_steps", "750", "--episode_length", "75",
                 "--updates_per_step", "4", "--horizon", "4", "--num_particles", "512",
                 "--episodes", "3"]


def emit(result: str, card: str, **fields) -> None:
    print(json.dumps({"result": result, "card": card, **fields}), flush=True)


def profile_softq_sawyer(device, card: str) -> None:
    """The `profile` result (module docstring)."""
    import chip_smoke
    from mjmpc_tpu_torch import envs, solvers
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness.benchmark import solves_per_s
    path = chip_smoke.SOFTQ_CONFIGS["sawyer_reacher-v0"]
    exp = hconfig.load_config(str(ROOT / path))
    e = envs.make(exp["env_name"], device=device)
    s = hconfig.make_solver_for_env(exp, "softq", e)
    solve, es = solvers.make_solve_fn(s, e), e.init(e.params, 1)
    # a warm-up solve first: the noise kernel's build and torch.func's first
    # traces stay out of the rate
    float(solve(e.params, es, s.init_state(0))[0][0])
    rate, windows, _ = solves_per_s(solve, e, es, s.init_state(0), 2, 1)
    emit("profile_rate", card, config=path, env=e.name, controller="softq",
         n=s.num_particles, h=s.horizon, solves_per_s=rate, windows=windows)
    chip_smoke.profile(solve, e, es, s.init_state(0), card, 1, 1, solver="softq", env=e.name,
                       config=path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--only", nargs="*", choices=RESULTS, default=list(RESULTS))
    p.add_argument("--softq-episodes", type=int, default=3)
    p.add_argument("--diag-steps", type=int, default=15)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("learned_runs: no CUDA device", file=sys.stderr)
        return 1
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import run_mpc, sacq_eval, softq_diag
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip() if args.device == "cuda" else "cpu")

    if "softq_sawyer" in args.only:
        exp = hconfig.load_config(str(ROOT / "configs/sawyer/sawyer_reacher-v0.yml"))
        exp["n_episodes"] = args.softq_episodes
        with tempfile.TemporaryDirectory() as out_dir:
            path = f"{out_dir}/sawyer_reacher.json"
            with open(path, "w") as f:
                json.dump(exp, f)
            t0 = time.perf_counter()
            out = run_mpc.main(["--config", path, "--controller", "softq", "--device",
                                args.device, "--save_dir", out_dir])["softq"]
        emit("softq_sawyer", card, episodes=args.softq_episodes, steps=exp["max_ep_length"],
             ep_rewards=out["ep_rewards"].tolist(), average_reward=out["average_reward"],
             reward_std=out["reward_std"], success_metric=out["success_metric"],
             seconds=time.perf_counter() - t0, jax_reward="-332 +- 12 (RESULTS.md:221)")

    if "softq_diag" in args.only:
        for whiten in (False, True):
            t0 = time.perf_counter()
            rows, summary = softq_diag.diagnose(whiten=whiten, steps=args.diag_steps,
                                                device=args.device)
            emit("softq_diag", card, **summary, steps=args.diag_steps,
                 grad_norm_median=sorted(r["grad_norm"] for r in rows)[len(rows) // 2],
                 target_mean_last=rows[-1]["target_mean"], seconds=time.perf_counter() - t0)

    if "sacq_eval" in args.only:
        t0 = time.perf_counter()
        rows = sacq_eval.main(SACQ_PROTOCOL + ["--device", args.device])
        emit("sacq_eval", card, protocol=SACQ_PROTOCOL, rows=rows,
             seconds=time.perf_counter() - t0,
             jax_h4="-400.9 / -424.3 / -251.6 (RESULTS.md:156-165, 100 training episodes)")

    if "profile" in args.only:
        profile_softq_sawyer(args.device, card)

    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
