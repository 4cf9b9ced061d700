"""Episode results of the hand and arm tasks and the randomized configs on
the card, every episode a replayed captured control step
(harness/episode.py), for comparison with the JAX package's records.

    python3 tools/episode_refs.py [--device cuda] [--only NAME ...] \
        [--episodes N] [--rate-replays R]

One JSON line per result, each beside the card's name and power limit
(nvidia-smi), then a last line {"ok": true}. For each task, run_mpc on its
config with mppi (the config's episodes, steps, N and H; --episodes cuts
the episodes): each episode's reward, the average, the spread and the
success metric beside the JAX record; and the control-step rate eager
(a 3-step episode with replay=False, timed on the host) and replayed (one
replay of the captured step over R replays, timed on the device), both
after a warm-up episode that builds the kernels; --rates-only skips the
episodes of the protocol.

- relocate, hammer, door (H=48, n_iters=2), pusher, sawyer_door, tray_v0:
  the configs of configs/hand/ and configs/ sawyer|panda/, JAX records
  RESULTS.md:99, 104, 109 and 210-213;
- reacher_dyn: configs/reacher_7dof-v0.yml with --dyn_randomize_config
  configs/dyn_randomize/reacher_7dof.yml (JAX -101 +- 22, RESULTS.md:209);
- pen_dyn: configs/hand/pen-v0.yml with --dyn_randomize_config
  configs/dyn_randomize/hand_pen.yml (the planner on the perturbed pen's own
  kernel; the JAX record of nominal pen mppi +3,942 +- 1,124,
  RESULTS.md:93, for scale: no JAX record of this spec).

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

# name: (config, dyn_randomize spec or None, JAX record)
TASKS = {
    "relocate": ("configs/hand/relocate-v0.yml", None, "+2,826 (RESULTS.md:99)"),
    "hammer": ("configs/hand/hammer-v0.yml", None, "+9,122 +- 1,456 (RESULTS.md:104)"),
    "door": ("configs/hand/door-v0.yml", None, "+615 +- 21 (RESULTS.md:109)"),
    "pusher": ("configs/sawyer/sawyer_pusher-v0.yml", None, "-58 (RESULTS.md:210)"),
    "sawyer_door": ("configs/sawyer/sawyer_door-v0.yml", None, "-117 +- 3 (RESULTS.md:211)"),
    "tray_v0": ("configs/panda/tray_glass-v0.yml", None, "-29.1 +- 3.0 (RESULTS.md:213)"),
    "reacher_dyn": ("configs/reacher_7dof-v0.yml", "configs/dyn_randomize/reacher_7dof.yml",
                    "-101 +- 22 (RESULTS.md:209)"),
    "pen_dyn": ("configs/hand/pen-v0.yml", "configs/dyn_randomize/hand_pen.yml",
                "no record of this spec; nominal pen mppi +3,942 +- 1,124 (RESULTS.md:93)"),
}


def emit(result: str, card: str, **fields) -> None:
    print(json.dumps({"result": result, "card": card, **fields}), flush=True)


def step_rates(exp: dict, spec, device, replays: int) -> dict:
    """Control steps/s of the config's mppi episode, eager (the host clock
    around a synchronised episode) and replayed (one replay's device time,
    episode.replay_ms, beside episode.replay_host_ms, the host clock's
    over the same replays), each after a warm-up episode that builds the
    kernels (module docstring)."""
    import torch
    import yaml
    from mjmpc_tpu_torch import envs
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness.episode import build_episode_fn
    env = envs.make(exp["env_name"], device=device)
    sim = None
    if spec is not None:
        with open(ROOT / spec) as f:
            sim = envs.randomize_dynamics(env, yaml.safe_load(f), base_seed=exp["seed"])[0]
    solver = hconfig.make_solver_for_env(exp, "mppi", env)
    sim_params = (sim or env).params
    cuda = device != "cpu"
    build_episode_fn(solver, env, 2, sim_env=sim, replay=cuda)(env.params, sim_params,
                                                                exp["seed"])   # warm-up
    eager = build_episode_fn(solver, env, 3, sim_env=sim, replay=False)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(eager(env.params, sim_params, exp["seed"])[0]["reward"].sum())
    rates = dict(eager_steps_per_s=3 / (time.perf_counter() - t0))
    if cuda:
        replayed = build_episode_fn(solver, env, 1 + replays, sim_env=sim, replay=True)
        replayed(env.params, sim_params, exp["seed"])
        rates.update(replayed_steps_per_s=1e3 / replayed.replay_ms,
                     replay_ms=replayed.replay_ms, replay_host_ms=replayed.replay_host_ms)
    return rates


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--only", nargs="*", choices=list(TASKS), default=list(TASKS))
    p.add_argument("--episodes", type=int, default=None,
                   help="episodes per task (default: the config's)")
    p.add_argument("--rate-replays", type=int, default=10)
    p.add_argument("--rates-only", action="store_true",
                   help="only the control-step rates, not the config's episodes")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("episode_refs: no CUDA device", file=sys.stderr)
        return 1
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import run_mpc
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip() if args.device == "cuda" else "cpu")
    for name in args.only:
        config, spec, record = TASKS[name]
        exp = hconfig.load_config(str(ROOT / config))
        if args.episodes:
            exp["n_episodes"] = args.episodes
        rates = step_rates(exp, spec, args.device, args.rate_replays)
        if args.rates_only:
            emit(name + "_rates", card, config=config, spec=spec, **rates)
            continue
        with tempfile.TemporaryDirectory() as out_dir:
            path = f"{out_dir}/{name}.json"
            with open(path, "w") as f:
                json.dump(exp, f)
            argv_ = ["--config", path, "--controller", "mppi", "--device", args.device,
                     "--save_dir", out_dir]
            if spec is not None:
                argv_ += ["--dyn_randomize_config", str(ROOT / spec)]
            t0 = time.perf_counter()
            out = run_mpc.main(argv_)["mppi"]
        emit(name, card, config=config, spec=spec, episodes=exp["n_episodes"],
             steps=exp["max_ep_length"], n=exp["mppi"]["num_cpu"] * exp["mppi"]["particles_per_cpu"],
             h=exp["mppi"]["horizon"], n_iters=exp["mppi"].get("n_iters", 1),
             ep_rewards=out["ep_rewards"].tolist(), average_reward=out["average_reward"],
             reward_std=out["reward_std"], success_metric=out["success_metric"],
             seconds=time.perf_counter() - t0, jax_record=record, **rates)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
