"""Smoke run of the PyTorch port's paths on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each; any failure ends the script with a nonzero
exit and no final line:

1. device   -- the card's name and power limit (nvidia-smi).
2. build    -- nvcc builds, all at once, the reacher's chain-rollout
               libraries (costs-only, obs-emitting and closed-loop entries)
               at every team size the costs and obs rollouts can pick (4,
               8, 16 and 32 lanes per particle), the peg task's (the same
               three entries, peg's site and obs/cost) likewise, the
               swimmer's and the half cheetah's (the external-force entry),
               the filtered-noise library, the forest-rollout libraries of
               pen-v0, the sawyer peg, relocate-v0, hammer-v0, the sawyer
               door, the pusher, tray-glass v0, v1 and fixed-v1 and door-v0
               and the pendulum library (kernels #7 and #8) from csrc/; ptxas
               register, stack, spill and shared-memory lines.
3. kernel   -- each kernel against its plain PyTorch version on the card:
               chain and obs rollouts (kernels #1 and #3, a team of
               team_for(N) lanes per particle) at (N=37, H=5) and N=1 to
               atol 5e-5 and at the main path's (N=4096, H=32) to max abs
               error 1e-3 (costs are O(1); the longer horizon accumulates
               f32 reordering), two launches and all four team sizes
               agreeing bit for bit and, at (37, 5), the plain version
               with the mean and the noise zeroed failing by more than 10x;
               the closed-loop rollout (kernel #4, a team of lanes per
               particle: obs, actions, costs) for the reacher at (37, 5)
               and N=1 to 5e-5 and (4096, 32) to 1e-3, for the peg at
               (37, 5) and N=1 to 5e-5 and at its config's (64, 32) to
               1e-3, two launches agreeing bit for bit and, at (37, 5), the
               plain version with W and the noise zeroed failing by more
               than 10x on obs and costs;
               peg's obs rollout at (37, 5) and N=1 to 5e-5, with the same
               checks; the noise kernel (#2) at
               (N, H, dA) = (37, 5, 7), (4096, 32, 7) and (512, 32, 30),
               filter (0.25, 0.8, 0), cov 3 I, to 1e-4 (identical uniforms;
               libm ulps and sum order differ, scaled by the filter's gain
               of about 1.25 and by sqrt(3)) at step 5 (a device tensor),
               two launches agreeing bit for bit and the plain version at
               step 6 failing by more than 10x; the uniforms kernel bit for
               bit;
               the pendulum rollout (kernel #7, a block owning whole
               particles) from a start that crosses -pi (th0 = -3.0,
               thdot0 = -8) at (37, 5), (4096, 32), the pendulum config's
               N = 24 and 64 and at N = 2048, H = 32, to atol 1e-5, two
               launches and every particles-a-block size the sweep times
               (1-128) bit for bit with the default, the plain version with
               the noise zeroed failing the (37, 5) check by more than 10x;
               the one-kernel MPPI solve (kernel
               #8, one thread-block cluster) at N = 128, 1024, 2048 and
               8192, H = 32, lam 0.01 and 1.0, to atol 1e-5 on the new mean,
               two launches bit for bit, every cluster size it can take
               within the same atol, the plain version at another step
               failing by more than 10x.
4. main     -- envs.make("reacher_7dof-v0") -> solvers.MPPI(...) ->
               solvers.make_solve_fn on device="cuda": 10 chained solves
               under torch.cuda.set_sync_debug_mode("error") (no host sync
               inside a solve), a finite action read once at the end, the
               chain kernel's and the noise kernel's launch counts rising by
               exactly 10; then a 10-step evaluate_episode with finite
               rewards. Run with the plain noise sampler (main: the noise
               kernel's normals with the filter off, then the filter in
               tensor operations) and again with noise_impl="kernel"
               (main_kernel_noise). Every count below counts the noise
               kernel's launches too: each noise draw of a solve is one
               (noise_launches), and each PFMPC update one of the uniforms
               kernel.
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
8. loco_kernel -- the external-force rollout (kernel #5, a team of lanes
               per particle) against its plain version for the swimmer
               (atol 5e-5 at N=37 H=5 and N=1, 1e-3 at its config's N=512
               H=32) and the half cheetah (5e-4 of max(1, |cost|) at N=37
               H=5 and N=1, 1e-2 at its config's N=512 H=16), two launches
               agreeing bit for bit and, at N=37 H=5, the plain version
               with the mean and the noise zeroed failing by more than 10x.
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
               printed. relocate-v0 from a grasp (the fingertips and the
               palm pressing the ball, lifted 0.1 above the table) and
               hammer-v0 from a hold (the fingers pressing the handle, the
               head pressing on the nail's head, so that the contact,
               strike and dry-friction laws act) to 1e-4
               at N=37 H=4 and N=1, and at their mppi blocks' N=512 H=32
               and N=512 H=20 by the same gated rule with their bonuses
               (10 and 20; 25 and 75). The plain version with the actions
               zeroed must fail every pen, relocate and hammer check but
               N=1, at N=37 by more than 10x the tolerance (the check's
               power against a kernel that ignores the actions). hammer-v0
               also with the hammer spinning in the air at N=37 H=4, to
               1e-4, where the plain version with the hammer's coupled 6x6
               solve replaced by the decoupled one misses the kernel by
               more than 10x; its header has the coupled branch on. The
               tasks added since, each from a start where its force law,
               hook and gates act (forest_inputs): the sawyer door with its
               grab spring live, the pusher's block against the hand,
               tray-glass v0 and v1 with the glass past the tray's edge (the
               fall penalty live), fixed-v1 from its start, door-v0 with the
               hand hooking the handle and the latch near its threshold and
               with the door past 0.2 rad: to 1e-4 at N=37 H=4 and N=1, and
               at their mppi blocks' sizes (the sawyer door 256x16 and the
               pusher 512x24 to 1e-3; tray-glass v0 1024x20, v1 and fixed-v1
               256x16 and door-v0 256x48 by the gated rule with the fall
               penalty's step and the door's bonuses, 2, 8 and 10); the
               plain version with the actions zeroed must fail each check
               but N=1, at N=37 by more than 10x. A second launch on the
               same inputs must give the same costs bit for bit (no
               atomics, a fixed order of every sum); the plain version's
               call at each config's size is timed here (plain_ms).
11. hand    -- every forest config (FOREST_CONFIGS: pen, the sawyer peg,
               relocate, hammer, the sawyer door, the pusher, tray-glass
               v0, v1 and fixed-v1, door-v0; mppi) through
               harness.config.make_solver_for_env at their full sizes: 3
               chained sync-free solves each, kernel #6's count rising by
               exactly 3 times the solver's iterations (2 for tray-glass v0
               and door-v0) and every other count by 0, finite actions.
12. pendulum -- configs/SimplePendulum-v0.yml through
               harness.config.make_solver_for_env at full size, each of its
               five controllers: 3 chained sync-free solves, kernel #7's
               count rising by exactly 3 and every other count by 0, finite
               actions. Then the JAX package's closed loop on kernel #8
               (tests/test_pallas_kernels.py): 100 steps of one-kernel
               solves at N=1024, filter (0.25, 0.8, 0), sigma sqrt(3.5),
               lam 0.01, step size 0.55, sync-free, kernel #8's count
               rising by exactly 100 and the total reward above -400.
13. analytic -- every controller the port runs of the analytic configs
               (ANALYTIC_CONFIGS: point_mass, trajopt_reacher, acrobot,
               cartpole with iLQR, the cartpole CL config's Reinforce with
               its critic) at the config's own N and H, and the maze's MPPI
               (N=256, H=24) on maze-v0 and continual_maze-v0 from t = 40,
               the continual goal's switch at t = 50 inside the horizon
               (shown on the real env: it moves at t = 50 exactly, maze-v0's
               never): 3 chained sync-free solves each, the noise kernel's
               count rising by each solve's draws (noise_launches) and iLQR
               launching none of the eight kernels.
14. ilqr_lqr -- iLQR (H=30, 3 iterations, mu 1e-6) on LQR-v0 from (1.5,
               -0.8), sync-free: the first action within rtol 1e-3 and the
               plan's cost within rtol 1e-4 of the finite-horizon dynamic
               program's (float64 numpy), no kernel launched.
15. checkpoint -- harness.checkpoint on MPPI (the main path with the kernel
               noise), iLQR on cartpole and Reinforce on the cartpole CL
               config, each after 2 solves: saved, loaded onto the card, the
               next solve's action, value and state equal bit for bit to the
               solve that continues without them; run_mpc --checkpoint with
               cartpole's iLQR for 3 control steps writes both files (under
               run_mpc's guard every solve draws init_state's mean: one
               noise launch a solve, and one at the episode's start).
16. graph   -- one solve of each family captured as a torch.cuda.CUDAGraph:
               MPPI on the main path with the kernel noise (under
               guard_finite, which rebuilds the fresh state inside the
               captured solve) and with the plain sampler, PFMPC (the zoo's),
               Reinforce with the peg closed-loop config, kernel #8's
               closed-loop step at N=1024 and MPPI on the relocate, hammer,
               sawyer door, pusher, tray-glass (v0, v1, fixed-v1) and
               door-v0 configs (kernel #6), iLQR on the cartpole config
               and MPPI on the acrobot config (the engine's general
               rollout), SoftQMPC with the cartpole config's softq block
               and RandomShootingNN on the pendulum (their Q's and MLP's
               nested parameters fed back with the rest of the state).
               Each graph is replayed 5 times,
               each replay's state fed to the next, and every replay's
               action, value and state tensors must equal 5 eager solves'
               from the same start bit for bit (the eager solves sync-free);
               then two replays from the same start but for the step (which
               the graph advances on the device) must differ: they drew
               different noise (iLQR, which draws none, must agree).
17. harness -- harness.episode.run_episodes with each locomotion config's
               own solver and with every controller of
               configs/reacher_7dof-v0.yml, one episode of 3 steps, and
               with every controller of configs/hand/pen-v0.yml and the peg
               config's mppi, one episode of 3 steps (the real pen step is
               the eager AD engine), all overridden in memory: finite
               rewards; every pendulum controller for one episode of 200
               steps, its reward printed beside the JAX package's records
               (RESULTS.md:207; no gate: the RNG streams differ); then
               run_mpc.main on the mppi of the relocate, hammer, sawyer door,
               pusher, tray-glass v0, v1 and fixed-v1, door-v0 and
               tray-glass-v1-biased-model (planning on fixed-v1) configs at
               full size, one episode cut to 3 control steps: finite
               rewards, kernel #6's batched entry's count rising by exactly
               2 times the solver's iterations and its single entry's by 0
               (run_episodes runs the episodes of a solver and env that the
               batched solve covers as one batched episode, here of one).
               Every episode here and below is a captured control step
               replayed (harness/episode.py): the host launches its first
               step, run eagerly, and the captured one; the graph's replays
               launch the rest (episode_solves).
18. run_mpc_cl -- run_mpc_cl.main on configs/cartpole-v0_cl.yml and
               configs/sawyer/sawyer_peg_insertion-v0_cl.yml, one episode
               cut to 3 control steps: finite rewards and baseline fit
               error, the noise kernel's count rising by 2 x n_iters and, on
               the peg, kernel #4's by 2 x n_iters (4 a solve): the
               replayed episode's host launches.
19. jobs    -- jobs.main in tune mode on configs/tune/tray_glass-v0.yml
               cut to 2 cells (lam 0.02 and 0.05 at N=512, H=20) x 1
               episode x 2 steps, kernel #6's batched entry's count and
               the batched noise draws' rising by 4; in sweep
               mode on configs/point_mass-v0.yml as it is (1 cell, 5
               episodes x 25 steps, the noise kernel's count rising by 2 an
               episode).
21. softq   -- SoftQMPC with the softq blocks of
               configs/classic_control/cartpole-v0.yml (N=64, H=16, lam 0.2,
               lr 0.01) and configs/sawyer/sawyer_reacher-v0.yml (N=64,
               H=16, lam 0.05, lr 0.1, 8 gradient steps, clip 10; the
               engine's general rollout, as the JAX package's) through
               harness.config: one warm-up solve, then 3 chained sync-free
               solves, the noise kernel's count rising by exactly 3 (one
               draw of white noise a solve) and every other count by 0, the
               Q parameters moved and finite.
22. rsnn    -- RandomShootingNN on SimplePendulum-v0 (N=64, H=32, MLP
               (64, 64)): 3 sync-free solves after a warm-up, the noise
               kernel's count rising by exactly 3 and every other by 0.
23. sac_mpc -- SACMPC on reacher_7dof-v0 at its defaults (H=16, N=256, SAC
               (256, 256), batch 128): 3 sync-free solves of its MPPIQ with
               the SAC Q (kernel #3 and the noise kernel once a solve);
               train for 200 control steps in episodes of 100, SAC updates
               from 100 transitions on: #3 and the noise kernel exactly 200
               times, 101 updates, the mean of the last 10 Q-losses below the
               first 10's; then harness/sacq_eval.main on the reacher (40
               training steps, one 20-step episode per arm, H=16, N=256,
               each replayed): #3 42 times (training and the mppiq+sacq
               arm), #1 2 (the mppiq arm) and #1's batched entry 2 (the
               mppi arm, a batched episode of one), the noise kernel 44 and
               its batched entry 2.
               Phases 21-23 run after phase 15, before the graph phase.
24. dyn_kernel -- kernels built from perturbed models (envs.
               randomize_dynamics from seed 123, each env's kernels rebuilt
               from its own model by Env.with_params; their libraries built
               with the others in phase 2): #1 for the reacher
               (configs/dyn_randomize/reacher_7dof.yml) at (37, 5) and N=1,
               #6 for pen-v0 (hand_pen.yml, from the pinch) and hammer-v0
               (hand_hammer.yml, held on the nail; the arm-mounted hand, its
               ptxas smem line printed) at (37, 3) and N=1: each against
               its plain version (5e-5 for #1, 1e-4 for #6, the nominal
               checks' tolerances), two launches bit for bit, and against
               the general rollout (the eager engine) on the perturbed
               params at the kernel-against-engine tolerance 5e-5; the
               header differs from the nominal model's, the nominal
               model's kernel misses the general rollout by more than 10x
               the tolerance, and the plain version with the actions zeroed
               misses by more than 10x its tolerance; then the perturbed
               reacher at the main path's size (1e-3) and both rows' times.
25. dyn_run_mpc -- run_mpc.main --dyn_randomize_config
               configs/dyn_randomize/reacher_7dof.yml on the reacher config
               cut to one 3-step episode: the planner's params are the
               spec's draw from the config's seed, the real env's are
               nominal, the perturbed model's #1 (its batched entry: a
               batched episode of one) launched by every solve the host
               launches (2) and nothing else but the batched noise draws.
26. episode_replay -- build_episode_fn eager (replay=False) and replayed:
               the main path (reacher_7dof-v0, MPPI H=32 N=4096, 12 steps)
               and pen-v0's mppi (4 steps) planning on the perturbed pen:
               the records, the stacked env states and the final solver
               state equal bit for bit; control steps/s eager (host clock)
               and replayed (one replay's device time by CUDA events), with
               the card's name and power limit.
27. parallel -- parallel.make_mesh() (the card alone): 3 solves of
               build_sharded_solve_fn on the main path equal the plain
               solves bit for bit (#1 once a solve each); the records of
               build_batch_episode_fn (the reacher config's mppi, seeds 1
               and 2, 4 steps: one batched episode on the row, #1's batched
               entry once a solve the host launches) equal those of the
               unsharded env's batched episode bit for bit, and each
               episode's actions and rewards on the first 3 steps lie
               within 1e-4 (phase 30's rule) of the single episode of its
               seed.
28. render  -- run_mpc.main --dump_vids on configs/reacher_7dof-v0.yml and
               configs/hand/door-v0.yml, each cut to 1 episode of
               RENDER_STEPS steps (a replayed batched episode of one): one
               GIF in the log
               dir whose image descriptors (render.gif.read_gif) number
               RENDER_STEPS, the records equal to the same run without the
               flag bit for bit, the launches of the run with the flag as
               run_mpc's (zeroed just before it), and the frames drawn from
               the states on the card equal to those drawn from the same
               states on the CPU; render and GIF-encode ms per frame over
               RENDER_TIMING_FRAMES frames; parallel.initialize_multihost
               with NCCL at world size 1 and one all_reduce of a CUDA
               tensor, then destroy_process_group.
               Phases 24-28 run after phase 19, before the timing.
29. benchmark -- the batched entries of kernels #1 and #2 (ChainRollout.
               batch, FilteredNoise.white_batch: B elements in one launch)
               for the reacher at N=4096, H=32 and B = 1, 2, 4 and 8: the
               outputs equal B single launches bit for bit and their plain
               versions (the plain version per element) to atol 5e-5; the
               checks' power at B=2: element 1's mean and noise zeroed in
               the plain version, and element 1's noise at another step,
               must miss by more than 10x; each timed against B single
               launches in the same call (`kernel_batched_time`). Then
               solvers.build_batched_solve_fn on the main path's MPPI
               (kernel noise) at B=4 from means drawn away from zero: the
               actions and new means within 2.3e-6 (the MPPI update's
               tolerance: the vmapped reductions may sum in another order)
               of four single solves; 10 chained sync-free batched solves,
               exactly one launch of each batched entry a solve and no other
               launch; the batched solve captured as a CUDA graph and
               replayed 5 times, each replay equal to an eager solve bit for
               bit. Then harness/benchmark.py's main(["--quick"]) and
               harness/forest_perf.py's main([]) on the card, their rows
               printed: no error row, no flops_error, every number finite.
               Phase 29 runs after phase 28, before the timing.
30. batch_episodes -- the batched entries of kernels #5, #6 and #7
               (ChainExtRollout.batch, ForestRollout.batch,
               PendulumRollout.batch) at B = 1, 2 and 4 from the single
               checks' inputs (BATCH_ENTRY_CHECKS: the swimmer and the
               cheetah at (37, 5); pen from the pinch at (37, 5);
               relocate, hammer, door-v0, the pusher and tray-glass v0 from
               phase 10's starts at (37, 4); the pendulum from the crossing
               start and B - 1 others at (37, 5)): equal to B single
               launches bit for bit, exactly one batched launch each and no
               single one; at B=2 to the plain version per element at the
               single kernel's tolerance, and the check's power: element
               1's actions zeroed in the plain version must miss by more
               than 10x. The swimmer, the cheetah, pen and the pendulum
               again at their configs' sizes (BATCH_TIMED) at B = 1, 2, 4:
               equal to B single launches bit for bit, at B=2 to the plain
               version at the single kernel's check at that size (the
               `kernels` line's max_abs_err, ms and plain_ms all from this
               B=2 run), and timed against B single launches
               (`kernel_batched_entry_time`, with B x the single bound and
               the ptxas lines). Then B = 3 episodes (BATCH_EPISODES, the
               config's seeds) of each config's mppi block, cut to 10
               steps, as one batched episode (build_batched_episode_fn) on
               the reacher, Swimmer, pen-v0 and the pendulum: the replay
               equal to the batched eager loop bit for bit (records, states
               and the final batch), the env's batched entry and the
               batched noise draws launched once a solve the host launches
               and no single kernel, each element's actions and rewards on
               the first 3 steps within 1e-4 (the closed loops' tolerance;
               rewards of max(1, |reward|)) of its single episode; control
               steps/s of the batch against B replayed single episodes
               (one replay's device time each), with the card's name and
               power limit.
               Phase 30 runs after phase 29, before the timing.
20. timing  -- read-verified solves/s (each window ends by reading a value
               that depends on every solve in it) for MPPI with the plain
               and with the kernel noise, for MPPI with the plain rollout,
               for each solver of the zoo, for Reinforce on the reacher
               and the peg and for MPPI on both locomotion configs and every
               forest config; MPPI on the pendulum through kernel #7 at
               the config's N=24 and at N=2048 (the config's plain sampler,
               and the kernel sampler) against kernel #8's one-launch solve
               at N=2048; the real env step's ms per control step on
               the locomotion configs and on every forest config's env but
               the peg's; each kernel
               and its plain version timed with CUDA events (kernel #1 also
               at the reacher configs' N=128 H=16 and N=256 H=32; #1 and #3
               on a `kernel_open_loop` line per size with its team, bound
               and ptxas; #2 on a `kernel_noise` line per shape); solves/s
               of the main path's MPPI eager and replayed as a CUDA graph
               (`graph_solves_per_s`); a per-stage
               breakdown with each noise sampler and of the Reinforce
               solves; a torch.profiler count of kernels and device time
               per solve, with the six kernels that take the most device
               time; solves/s of every run of phases 13 and 14 but the
               engine envs' (acrobot, trajopt_reacher: their `analytic`
               lines carry the rate of their 3 sync-free solves), a profile
               of the light ones (`analytic_solves_per_s`; the heavy ones in
               tools/analytic_episodes.py --only profile) and the real env
               step of every analytic env (`analytic_env_step`); solves/s
               and a profile of each run of phases 21-23 but softq on
               the sawyer reacher (`learned_solves_per_s`; that run's
               `softq` line carries the rate of its 3 sync-free solves, and
               tools/learned_runs.py --only profile profiles it). Printed,
               not asserted.

Every launch count is set to 0 just before a path runs and read just after.
The last lines are the kernels' summary (kernel #5 with the swimmer's
numbers, its cheetah instance on the `kernel_loco` line before it; kernel
#6 with pen-v0's and once more for each of its other instances (the peg,
relocate-v0, hammer-v0, the sawyer door, the pusher, tray-glass v0, v1 and
fixed-v1, door-v0), each also on a `kernel_forest` line; #7 at the
pendulum mppi block's N=24, #8 at the closed loop's N=1024, each size on a
`kernel_pendulum` line, with #7's particles a block and #8's cluster
size; then the two kernels built from perturbed models that the
randomization and episode paths launch: #1 for the reacher, launched by phase 25, and #6 for pen,
launched by phase 26's replayed episode; then the batched entries of #1 and #2 at phase 29's B=4,
launched by its batched solve, and of #5 (the swimmer), #6 (pen) and #7 at
phase 30's B=2 and their configs' sizes, launched by its batched episodes),
the nvidia-smi line and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from mjmpc_tpu_torch.harness.benchmark import cuda_call_ms, cuda_ms, solves_per_s

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
# Reinforce on the reacher: one iteration at the main path's size.
RF_REACHER = dict(horizon=HORIZON, num_particles=NUM_PARTICLES, lr=1.0, n_iters=1, init_cov=1.0,
                  baseline_type="quadratic", delta_reg=1e-3, delta_kl=RF_DELTA_KL,
                  filter_coeffs=FILTER)
PEG_CL = dict(horizon=32, gamma=1.0, n_iters=4, lr=1.0, beta=0.0, filter_coeffs=FILTER,
              num_particles=64, delta_kl=15.0, delta_reg=0.001, baseline_type="quadratic",
              init_cov=1.0)
# Kernel #1's other timed sizes: the run_mpc reacher configs' N = num_cpu x
# particles_per_cpu and H (configs/reacher_7dof-v0.yml; configs/panda/
# reacher-v0.yml and configs/sawyer/sawyer_reacher-v0.yml).
OPEN_LOOP_SIZES = ((128, 16), (256, 32))
# The locomotion configs, run as written, at full size.
LOCO_CONFIGS = {"Swimmer-v0": "configs/Swimmer-v0.yml",
                "HalfCheetah-v0": "configs/HalfCheetah-v0.yml"}
# kernel #5 against its plain version: (N, H, atol, scaled by max(1, |cost|),
# seed); N=1 the ragged case
LOCO_CHECKS = {"Swimmer-v0": ((37, 5, 5e-5, False, 10), (512, 32, 1e-3, False, 11),
                              (1, 5, 5e-5, False, 12)),
               "HalfCheetah-v0": ((37, 5, 5e-4, True, 10), (512, 16, 1e-2, True, 11),
                                  (1, 5, 5e-4, True, 12))}
HARNESS_STEPS = 3
# The forest configs, run as written, at full size (mppi blocks: pen, the
# peg and the sawyer door 8 x 32 particles, H=16; relocate 8 x 64, H=32;
# hammer 8 x 64, H=20; the pusher 8 x 64, H=24; tray-glass v0 8 x 128, H=20,
# two iterations; v1 and fixed-v1 8 x 32, H=16; door-v0 8 x 32, H=48, two
# iterations), the pen's controllers for the harness phase and the control
# steps of the cut run_mpc episodes (relocate, hammer and every config of
# the tasks added since: RUN_MPC_CONFIGS, the biased-model tray config among
# them, which plans on fixed-v1).
FOREST_CONFIGS = {"pen-v0": "configs/hand/pen-v0.yml",
                  "sawyer_peg_insertion-v0": "configs/sawyer/sawyer_peg_insertion-v0.yml",
                  "relocate-v0": "configs/hand/relocate-v0.yml",
                  "hammer-v0": "configs/hand/hammer-v0.yml",
                  "sawyer_door-v0": "configs/sawyer/sawyer_door-v0.yml",
                  "sawyer_pusher-v0": "configs/sawyer/sawyer_pusher-v0.yml",
                  "panda_tray_glass-v0": "configs/panda/tray_glass-v0.yml",
                  "panda_tray_glass-v1": "configs/panda/tray_glass-v1.yml",
                  "panda_tray_glass_fixed-v1": "configs/panda/tray_glass_fixed-v1.yml",
                  "door-v0": "configs/hand/door-v0.yml"}
RUN_MPC_CONFIGS = {name: FOREST_CONFIGS[name] for name in (
    "relocate-v0", "hammer-v0", "sawyer_door-v0", "sawyer_pusher-v0", "panda_tray_glass-v0",
    "panda_tray_glass-v1", "panda_tray_glass_fixed-v1", "door-v0")}
RUN_MPC_CONFIGS["panda_tray_glass-v1 (planning on fixed-v1)"] = (
    "configs/panda/tray_glass-v1_biased_model.yml")
HAND_ENVS = ("pen-v0", "relocate-v0", "hammer-v0", "door-v0")
ARM_ENVS = ("sawyer_door-v0", "sawyer_pusher-v0", "panda_tray_glass-v0", "panda_tray_glass-v1",
            "panda_tray_glass_fixed-v1")
# door-v0's check starts: (latch, door) with the hand hooking the handle
DOOR_STARTS = {"hook": (0.5, 0.0), "open": (0.6, 0.3)}
PEN_CONTROLLERS = ("mppi", "mppiq", "pfmpc", "random_shooting", "cem", "dmd")
PEN_STEPS = 3
RUN_MPC_STEPS = 3
# kernel #6's checks: (env, start, N, H, atol or None for the gated rule at
# the config's size, seed)
FOREST_CHECKS = (("sawyer_peg_insertion-v0", None, 37, 5, 5e-5, 20),
                 ("sawyer_peg_insertion-v0", None, 256, 16, 1e-3, 21),
                 ("pen-v0", None, 37, 5, 1e-4, 22), ("pen-v0", None, 256, 16, None, 23),
                 ("relocate-v0", "grasp", 37, 4, 1e-4, 24),
                 ("relocate-v0", "grasp", 1, 4, 1e-4, 25),
                 ("relocate-v0", "grasp", 512, 32, None, 26),
                 ("hammer-v0", "held", 37, 4, 1e-4, 27),
                 ("hammer-v0", "held", 1, 4, 1e-4, 28),
                 ("hammer-v0", "held", 512, 20, None, 29),
                 ("hammer-v0", "spin", 37, 4, 1e-4, 30),
                 ("sawyer_door-v0", "grab", 37, 4, 1e-4, 31),
                 ("sawyer_door-v0", "grab", 1, 4, 1e-4, 32),
                 ("sawyer_door-v0", "grab", 256, 16, 1e-3, 33),
                 ("sawyer_pusher-v0", "contact", 37, 4, 1e-4, 34),
                 ("sawyer_pusher-v0", "contact", 1, 4, 1e-4, 35),
                 ("sawyer_pusher-v0", "contact", 512, 24, 1e-3, 36),
                 ("panda_tray_glass-v0", "fallen", 37, 4, 1e-4, 37),
                 ("panda_tray_glass-v0", "fallen", 1, 4, 1e-4, 38),
                 ("panda_tray_glass-v0", "fallen", 1024, 20, None, 39),
                 ("panda_tray_glass-v1", "fallen", 37, 4, 1e-4, 40),
                 ("panda_tray_glass-v1", "fallen", 1, 4, 1e-4, 41),
                 ("panda_tray_glass-v1", "fallen", 256, 16, None, 42),
                 ("panda_tray_glass_fixed-v1", "arm", 37, 4, 1e-4, 43),
                 ("panda_tray_glass_fixed-v1", "arm", 1, 4, 1e-4, 44),
                 ("panda_tray_glass_fixed-v1", "arm", 256, 16, None, 45),
                 ("door-v0", "hook", 37, 4, 1e-4, 46),
                 ("door-v0", "hook", 1, 4, 1e-4, 47),
                 ("door-v0", "hook", 256, 48, None, 48),
                 ("door-v0", "open", 37, 4, 1e-4, 49))
# The pendulum config, run as written, at full size (mppi 4 x 6 particles,
# the others 4 x 16; H=32), and the JAX package's closed loop on kernel #8
# (tests/test_pallas_kernels.py test_one_kernel_mppi_solve_controls).
PENDULUM_CONFIG = "configs/SimplePendulum-v0.yml"
PENDULUM_CONTROLLERS = ("mppi", "random_shooting", "cem", "dmd", "pfmpc")
PENDULUM_STEPS = 200
ONE_KERNEL = dict(num_particles=1024, filter_coeffs=FILTER, sigma=float(np.sqrt(3.5)),
                  lam=0.01, step_size=0.55, gamma=1.0)
ONE_KERNEL_STEPS = 100
ONE_KERNEL_KEY = 1000       # kernel #8's stream key in the closed loop
GRAPH_REPLAYS = 5
# th0, thdot0: th + pi turns negative along the rollouts (a truncating
# modulo goes wrong) and the new thdot passes -8 before its clamp
CROSSING = (-3.0, -8.0)
# The JAX package's pendulum rewards over 200 steps (RESULTS.md:207).
JAX_PENDULUM_REWARDS = {"mppi": -173.0, "cem": -131.0, "pfmpc": -122.0}
# The analytic envs' configs and the controllers of each that the port runs
# (cartpole's softq is not ported).
ANALYTIC_CONFIGS = {
    "configs/point_mass-v0.yml": ("random_shooting", "mppi", "cem"),
    "configs/trajopt_reacher-v0.yml": ("mppi", "random_shooting", "cem"),
    "configs/classic_control/acrobot-v0.yml": ("random_shooting", "mppi"),
    "configs/classic_control/cartpole-v0.yml": ("ilqr", "random_shooting", "mppi", "mppiq",
                                                "dmd", "reinforce"),
    "configs/cartpole-v0_cl.yml": ("reinforce",),
}
# The maze's MPPI (the JAX package's tests/test_maze_and_guard.py), from a
# start at t = 40: the continual goal's switch at t = 50 falls inside H.
MAZE_MPPI = dict(horizon=24, num_particles=256, lam=0.05, init_cov=0.6, step_size=0.7,
                 gamma=1.0, filter_coeffs=FILTER, base_action="repeat")
MAZE_START = 40
# The analytic envs on the chain engine: their general rollout (eager AD
# steps) takes 1.7-4 s a solve on the card
ENGINE_ENVS = ("acrobot-v0", "trajopt_reacher-v0")
# (env, controller) of the analytic runs of a few thousand launches a
# solve or fewer, profiled in the timing phase
LIGHT_PROFILES = {("point_mass-v0", c) for c in ("random_shooting", "mppi", "cem")} | {
    ("cartpole-v0", c) for c in ("random_shooting", "mppi", "mppiq", "dmd")} | {
    ("maze-v0", "mppi")}
LQR_H, LQR_X0 = 30, (1.5, -0.8)
CL_CONFIGS = ("configs/cartpole-v0_cl.yml", "configs/sawyer/sawyer_peg_insertion-v0_cl.yml")
CL_STEPS = 3
JOBS_TUNE = "configs/tune/tray_glass-v0.yml"
JOBS_SWEEP = "configs/point_mass-v0.yml"
JOBS_STEPS = 2
# 21-23. the learned-model family: softq with the two configs' blocks, RSNN
# on the pendulum, SACMPC on the reacher at its defaults, sacq_eval cut short
SOFTQ_CONFIGS = {"cartpole-v0": "configs/classic_control/cartpole-v0.yml",
                 "sawyer_reacher-v0": "configs/sawyer/sawyer_reacher-v0.yml"}
RSNN = dict(horizon=32, num_particles=64, hidden=(64, 64))
SAC_TRAIN = dict(n_steps=200, episode_length=100, min_buffer=100)
SACQ_STEPS, SACQ_TRAIN = 20, 40
SACQ_EVAL = ["--env", "reacher_7dof-v0", "--train_steps", str(SACQ_TRAIN),
             "--episodes", "1", "--episode_length", str(SACQ_STEPS), "--horizon", "16",
             "--num_particles", "256"]
# 24-27. dynamics randomization, the captured episode and parallel/: the
# specs whose perturbed models get kernels of their own (the configs' seed),
# the checks of those kernels (N, H), the episodes replayed against eager
# ones and the mesh of one card's runs
DYN_SEED = 123
DYN_REACHER = ("reacher_7dof-v0", "configs/dyn_randomize/reacher_7dof.yml")
DYN_FOREST = {"pen-v0": ("configs/dyn_randomize/hand_pen.yml", None),
              "hammer-v0": ("configs/dyn_randomize/hand_hammer.yml", "held")}
DYN_CHECKS = ((37, 5), (1, 5))           # the reacher's kernel #1
DYN_FOREST_CHECKS = ((37, 3), (1, 3))    # kernel #6, from the forest checks' starts
# 28. render/: run_mpc --dump_vids on an arm and a hand config, a few steps
RENDER_CONFIGS = ("configs/reacher_7dof-v0.yml", "configs/hand/door-v0.yml")
RENDER_STEPS = 4
RENDER_TIMING_FRAMES = 100
KERNEL_ENGINE_ATOL = 5e-5                # a kernel against the general rollout
DYN_STEPS = 3                            # run_mpc --dyn_randomize_config's episode
EPISODE_STEPS = {"reacher_7dof-v0": 12, "pen-v0": 4, "reacher_7dof-v0 perturbed": 6}
PARALLEL_STEPS = 4
# 30. the batched entries of #5, #6 and #7: (N, H, atol) of each env's
# check (the single kernel's size and tolerance; the cheetah's of max(1,
# |cost|)), at B = 1, 2, 4; each timed at its config's size against B single
# launches; the `kernels` line's rows (kernel name, batched count); the
# batched episodes (B of them, T cut) at each config's mppi block, held to
# each element's single episode on the first steps
BATCH_ENTRY_CHECKS = {"Swimmer-v0": (37, 5, 5e-5), "HalfCheetah-v0": (37, 5, 5e-4),
                      "pen-v0": (37, 5, 1e-4), "relocate-v0": (37, 4, 1e-4),
                      "hammer-v0": (37, 4, 1e-4), "door-v0": (37, 4, 1e-4),
                      "sawyer_pusher-v0": (37, 4, 1e-4), "panda_tray_glass-v0": (37, 4, 1e-4),
                      "SimplePendulum-v0": (37, 5, 1e-5)}
BATCH_ENTRY_SIZES = (1, 2, 4)
BATCH_ROW_B = 2              # the `kernels` line's B (its plain version takes seconds a call)
# the configs' sizes, each checked again at the single kernel's tolerance
# there (LOCO_CHECKS, FOREST_CHECKS: None the gated-cost rule, the
# pendulum's 1e-5) and timed
BATCH_TIMED = {"Swimmer-v0": (512, 32, 1e-3), "HalfCheetah-v0": (512, 16, 1e-2),
               "pen-v0": (256, 16, None), "SimplePendulum-v0": (24, 32, 1e-5)}
BATCH_ROWS = {"Swimmer-v0": ("chain_ext_rollout_batched", "ext_batch"),
              "pen-v0": ("forest_rollout_batched", "forest_batch"),
              "SimplePendulum-v0": ("pendulum_rollout_batched", "pendulum_batch")}
BATCH_EPISODE_CONFIGS = {"reacher_7dof-v0": "configs/reacher_7dof-v0.yml",
                         "Swimmer-v0": "configs/Swimmer-v0.yml",
                         "pen-v0": "configs/hand/pen-v0.yml",
                         "SimplePendulum-v0": "configs/SimplePendulum-v0.yml"}
BATCH_EPISODES = 3
BATCH_EPISODE_STEPS = 10
BATCH_AGREE_STEPS = 3
BATCH_AGREE_ATOL = 1e-4      # the closed loops' tolerance (rewards of max(1, |reward|))
BATCHES = (1, 2, 4, 8)       # the batched entries' checks and times
BATCH_SOLVE = 4              # the batched MPPI solve's B
MPPI_UPDATE_ATOL = 2.3e-6    # the batched solve against single solves


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; `t` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "t": round(time.perf_counter() - _T0, 1)}),
          flush=True)


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


def forest_inputs(env, roll, n: int, h: int, seed: int, device, start=None):
    """Kernel #6's inputs: mean * 0.2 and noise * 0.3 as
    tests/test_pallas_forest.py draws them; for pen-v0 the pinch (every
    fingertip pressing on the resting pen) with the hand's joints
    perturbed by U(-0.05, 0.05); for relocate-v0 the grasp of the ball
    lifted 0.1 (start "grasp"), for hammer-v0 the hammer held with its head
    on the nail ("held") or spinning in the air ("spin"), for door-v0 the
    hand hooking the handle with the latch near its threshold ("hook") or
    with the door past 0.2 rad ("open"), the hand's joints perturbed by
    U(-0.03, 0.03); for the arm tasks the arm's joints perturbed by U(-0.1,
    0.1) (the tray's by U(-0.2, 0.2)) from the sawyer door's grab (the
    spring acting), the pusher's block against the hand ("contact") or the
    tray's glass past its edge ("fallen"; fixed-v1 from its start, "arm");
    for the peg q0, qd0 * 0.1. (Each task's module is imported where it is
    used: tools/kernel_ab.py calls this for checkouts that lack some.)"""
    import torch
    from mjmpc_tpu_torch.envs import hammer, pen, relocate, sawyer_tasks
    rng = np.random.default_rng(seed)
    if env.name in HAND_ENVS:
        st = env.init(env.params, seed)
        qd0 = st.qvel
        if env.name == "pen-v0":
            q0, extras, spread = pen.pinch_qpos(st.qpos), pen.pen_extras(env.params, st), 0.05
        elif env.name == "relocate-v0":
            q0, extras = relocate.grasp_qpos(st.qpos), relocate.relocate_extras(env.params, st)
            spread = 0.03
        elif env.name == "door-v0":
            from mjmpc_tpu_torch.envs import hand_door
            q0 = hand_door.hook_qpos(env.params.model, st.qpos, *DOOR_STARTS[start])
            extras, spread = hand_door.door_extras(env.params), 0.03
        elif start == "held":
            q0, extras, spread = hammer.held_qpos(st.qpos), hammer.hammer_extras(env.params), 0.03
        else:
            q0, qd0 = hammer.spin_state(st.qpos, st.qvel)
            extras, spread = hammer.hammer_extras(env.params), 0.03
        d = len(roll.act_bodies)       # the hand's 24 hinges are its last actions
        q0[d - 24:d] += torch.as_tensor(rng.uniform(-spread, spread, 24), dtype=torch.float32,
                                        device=device)
        head = [q0, qd0, extras]
    elif env.name in ARM_ENVS:
        st = env.init(env.params, seed)
        spread = 0.2 if env.name.startswith("panda") else 0.1
        q0 = st.qpos.clone()
        q0[:7] += torch.as_tensor(rng.uniform(-spread, spread, 7), dtype=torch.float32,
                                  device=device)
        if env.name == "sawyer_door-v0":
            params, q0 = sawyer_tasks.door_grab_state(env.params, q0)
            extras = sawyer_tasks.door_extras(params)
        elif env.name == "sawyer_pusher-v0":
            q0 = sawyer_tasks.pusher_contact_qpos(env.params.model, q0)
            extras = sawyer_tasks.pusher_extras(env.params, st)
        else:
            from mjmpc_tpu_torch.envs import panda_tasks
            q0 = panda_tasks.fallen_qpos(q0) if start == "fallen" else q0
            extras = panda_tasks.tray_extras(env.params, st)
        head = [q0, st.qvel, extras]
    else:
        head = [torch.as_tensor(np.asarray(rng.normal(size=7) * 0.1, np.float32), device=device)
                for _ in range(2)] + [sawyer_tasks.peg_extras(env.params)]
    d = len(roll.act_bodies)
    return head + [torch.as_tensor(np.asarray(rng.normal(size=shape) * scale, np.float32),
                                   device=device)
                   for shape, scale in (((h, d), 0.2), ((n, h, d), 0.3))]


def forest_row_name(env_name: str, task_name: str) -> str:
    """The `kernels` line's name of one of kernel #6's instances past pen's:
    forest_rollout_<task>, and for the tray's variants (one task on three
    models) the variant's suffix."""
    suffix = {"panda_tray_glass-v1": "_v1", "panda_tray_glass_fixed-v1": "_fixed_v1"}
    return f"forest_rollout_{task_name}{suffix.get(env_name, '')}"


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


def device_time_us(event) -> float:
    """A profiler kernel event's device time (the attribute's name changed
    across PyTorch versions)."""
    t = getattr(event, "device_time_total", None)
    return float(event.cuda_time_total if t is None else t)


def launch_counters():
    """(counters, counts, expected): every kernel wrapper class; counts()
    their launch counts by name (a batched entry's under <kernel>_batch);
    expected(**nonzero) every count 0 but those given."""
    from mjmpc_tpu_torch.ops import pendulum as pend
    from mjmpc_tpu_torch.ops.chain_rollout import (ChainClRollout, ChainExtRollout,
                                                   ChainObsRollout, ChainRollout)
    from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout
    from mjmpc_tpu_torch.ops.noise import FilteredNoise, PhiloxUniforms
    counters = (ChainRollout, ChainObsRollout, ChainClRollout, ChainExtRollout, FilteredNoise,
                PhiloxUniforms, ForestRollout, pend.PendulumRollout, pend.MppiPendulumSolve)

    def counts():
        return {"chain": ChainRollout.launches, "chain_batch": ChainRollout.batch_launches,
                "ext_batch": ChainExtRollout.batch_launches,
                "forest_batch": ForestRollout.batch_launches,
                "pendulum_batch": pend.PendulumRollout.batch_launches,
                "noise_batch": FilteredNoise.batch_launches, "obs": ChainObsRollout.launches,
                "cl": ChainClRollout.launches, "ext": ChainExtRollout.launches,
                "noise": FilteredNoise.launches, "uniforms": PhiloxUniforms.launches,
                "forest": ForestRollout.launches,
                "pendulum": pend.PendulumRollout.launches,
                "one_kernel_solve": pend.MppiPendulumSolve.launches}

    def expected(**nonzero):
        """Every count 0 but those given."""
        return dict(dict.fromkeys(counts(), 0), **nonzero)

    return counters, counts, expected


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "batch_launches"):
            w.batch_launches = 0


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


@dataclasses.dataclass(frozen=True)
class OneKernelState:
    """Kernel #8's closed loop as a solver state: the mean [H, 1] and the
    step, a 0-d int64 tensor on the device."""
    mean: "torch.Tensor"
    step: "torch.Tensor"


def one_kernel_solve_fn(n: int):
    """Kernel #8 as a chained solve: (params, env state, OneKernelState) ->
    (action, value 0, the mean shifted with a zero last row and step + 1),
    the JAX package's closed loop (tests/test_pallas_kernels.py)."""
    import torch
    from mjmpc_tpu_torch.ops import pendulum as pend
    cfg8 = dict(ONE_KERNEL, num_particles=n)

    def solve(params, es, state):
        mean = pend.mppi_pendulum_solve(params, es, state.mean, ONE_KERNEL_KEY, state.step,
                                        **cfg8)
        shifted = torch.cat([mean[1:], torch.zeros_like(mean[:1])])
        return mean[0], torch.zeros((), device=mean.device), OneKernelState(shifted,
                                                                            state.step + 1)

    return solve


def one_kernel_start(device) -> OneKernelState:
    import torch
    from mjmpc_tpu_torch import rng
    return OneKernelState(torch.zeros(HORIZON, 1, device=device), rng.step_tensor(0, device))


def noise_launches(s, solves: int) -> dict:
    """The noise kernel's and the uniforms kernel's launches in `solves`
    solves of solver `s` (every noise draw is one noise-kernel launch, the
    plain sampler's too): per iteration the rollout noise (Reinforce, the
    open-loop solvers) or, for PFMPC, the resampling offset (a uniforms
    launch); per solve one more for a sampled act and for a random base
    action, and PFMPC's shift noise."""
    iters = s.n_iters
    sampled = getattr(s, "sample_mode", "mean") == "sample"
    random_base = getattr(s, "base_action", None) == "random"
    if hasattr(s, "cov_shift"):          # PFMPC
        return dict(noise=solves * (1 + random_base), uniforms=solves * iters)
    return dict(noise=solves * (iters + random_base + sampled), uniforms=0)


def batched_launches(s, solves: int, key: str) -> dict:
    """The launches of `solves` batched solves of solver `s` (one batched
    episode's host launches): the env's batched rollout (`key`'s count)
    once an iteration and the batched noise draws noise_launches counts
    (the plain sampler's too)."""
    return {key: solves * s.n_iters, "noise_batch": noise_launches(s, solves)["noise"]}


def state_tensors(state) -> dict:
    """{path: tensor} of every tensor of a solver state, those nested in
    its parameters too (solvers.tensor_leaves)."""
    from mjmpc_tpu_torch import solvers
    return solvers.tensor_leaves(state)


def capture(solve, e, es, state):
    """(graph, out, feed): `solve` on a static copy of `state` captured as a
    torch.cuda.CUDAGraph after one warm-up solve on a side stream; `out` the
    captured solve's (action, value, state); feed() copies out's state
    tensors into the static state (the next replay's start), feed(start=
    tensors) the step alone and the other tensors from `start`.
    feed.static is the static state."""
    import torch

    from mjmpc_tpu_torch import solvers

    def fresh():
        return solvers.map_tensors(lambda v: v.clone(), state)

    static = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve(e.params, es, fresh())
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = solve(e.params, es, static)
    into = state_tensors(static)

    def feed(start=None):
        new = {k: v.clone() for k, v in state_tensors(out[2]).items()}
        for k, v in into.items():
            v.copy_(new[k] if start is None or k == "step" else start[k])

    feed.static = static
    return graph, out, feed


def graph_solves_per_s(solve, e, es, state, k: int, windows: int):
    """solves_per_s for `solve` captured as a CUDA graph: windows of k
    replays, each fed the last one's state, each window ending by reading
    the action."""
    graph, out, feed = capture(solve, e, es, state)
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(k):
            graph.replay()
            feed()
        value = float(out[0][0])
        rates.append(k / (time.perf_counter() - t0))
        if not np.isfinite(value):
            raise RuntimeError("graph replays produced a non-finite action")
    return statistics.median(rates), rates


def graph_check(name: str, solve, e, es, state, k: int = GRAPH_REPLAYS,
                draws_noise: bool = True) -> dict:
    """One solve captured as a CUDA graph, against eager solves.

    k eager solves from `state` (sync-free), then the solve captured on a
    static copy of `state` and replayed k times, each replay's state copied
    into the static one: every replay's action, value and state tensors
    must equal the eager solve's bit for bit. Then the static state is set
    back to `state` but for its step (which the replays advanced on the
    device) and the graph replayed twice, the step alone fed back between:
    the two results must differ (fresh noise each replay), unless the solve
    draws no noise (iLQR): then they must agree but for the step. Returns
    the fields of the `graph` line; raises on a failed check."""
    import torch
    start = {k_: v.clone() for k_, v in state_tensors(state).items()}

    def snapshot(action, value, s):
        return [action.clone(), value.clone()] + [v.clone() for v in state_tensors(s).values()]

    eager, s = [], state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(k):
            action, value, s = solve(e.params, es, s)
            eager.append(snapshot(action, value, s))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph, out, feed = capture(solve, e, es, state)
    fed = state_tensors(feed.static)
    replays = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(k):
            graph.replay()
            replays.append(snapshot(*out))
            feed()
        for k_, v in fed.items():       # the start again, at the advanced step
            if k_ != "step":
                v.copy_(start[k_])
        graph.replay()
        first = snapshot(*out)
        feed(start=start)
        graph.replay()
        second = snapshot(*out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    names = ["action", "value"] + list(start)
    diffs = dict.fromkeys(names, 0.0)
    for got, want in zip(replays, eager):
        for n_, a, b in zip(names, got, want):
            if a.numel():
                diffs[n_] = max(diffs[n_], float((a.double() - b.double()).abs().max()))
    identical = all(torch.equal(a, b) for got, want in zip(replays, eager)
                    for a, b in zip(got, want))
    steps = [int(x[names.index("step")]) for x in replays]
    fresh = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(first, second) if a.is_floating_point())
    fields = dict(family=name, replays=k, identical=identical, max_abs_diff=diffs,
                  steps=steps, replay_after_step=[int(first[names.index("step")]),
                                                  int(second[names.index("step")])],
                  max_abs_diff_next_step=fresh)
    emit("graph", **fields)
    if not identical:
        raise RuntimeError(f"graph {name}: replays differ from eager solves: {diffs}")
    if draws_noise and not fresh > 0.0:
        raise RuntimeError(f"graph {name}: two replays at successive steps drew the same noise")
    if not draws_noise and fresh != 0.0:
        raise RuntimeError(f"graph {name}: a solve that draws no noise depends on the step")
    return fields


def profile(solve, e, es, state, smi: str, solves: int = N_SOLVES, warmup: int = 3,
            **labels) -> None:
    """Kernels and device time per solve: torch.profiler over `solves`
    chained solves after `warmup` warm-up solves; one `profile` line beside
    the card's name and power limit `smi`."""
    import torch
    for _ in range(warmup):
        _, _, state = solve(e.params, es, state)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(solves):
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
    emit("profile", **labels, card=smi, solves=solves,
         top_kernels=[{"kernel": k[:90], "ms_per_solve": us / 1e3 / solves,
                       "launches_per_solve": count / solves}
                      for k, (us, count) in top],
         device_kernels_per_solve=len(kernels) / solves,
         device_ms_per_solve=device_us / 1e3 / solves,
         wall_ms_per_solve=wall * 1e3 / solves,
         device_busy_share=(device_us / 1e6) / wall if wall > 0 else None)


def episode_solves(steps: int) -> int:
    """The solves a replayed episode of `steps` control steps launches from
    the host: its first step, run eagerly, and the captured one (the
    replays launch the graph); a one-step episode runs eagerly."""
    return min(steps, 2)


def load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def tensors_equal(a, b) -> bool:
    """Whether two states (or records) hold the same tensors bit for bit."""
    import torch
    from mjmpc_tpu_torch import solvers
    la, lb = solvers.tensor_leaves(a), solvers.tensor_leaves(b)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def dyn_envs(device) -> dict:
    """The perturbed envs of the randomization phases: the reacher and the
    forest tasks of DYN_FOREST, each env.with_params(the spec's draw from
    DYN_SEED), with kernels built from the perturbed model."""
    from mjmpc_tpu_torch import envs
    out = {}
    for name, spec in [DYN_REACHER] + [(k, v[0]) for k, v in DYN_FOREST.items()]:
        out[name] = envs.randomize_dynamics(envs.make(name, device=device), load_yaml(spec),
                                            base_seed=DYN_SEED)[0]
    return out


def dyn_kernel_phase(device, dyn: dict, errors: dict) -> dict:
    """24. Kernels built from perturbed models against their plain
    versions and the general rollout on the perturbed params; returns the
    `kernels` rows' timings ({name: (ms, plain_ms)})."""
    import torch
    from mjmpc_tpu_torch import envs
    from mjmpc_tpu_torch.rollout.engine import rollout_open_loop
    cases = [(DYN_REACHER[0], None, n, h) for n, h in DYN_CHECKS]
    cases += [(name, start, n, h) for name, (_, start) in DYN_FOREST.items()
              for n, h in DYN_FOREST_CHECKS]
    for name, start, n, h in cases:
        e, nominal = dyn[name], envs.make(name, device=device)
        r, r0 = e.fused_rollout.kernel, nominal.fused_rollout.kernel
        if name == DYN_REACHER[0]:
            args = reacher_inputs(n, h, 3, device)
            state = dataclasses.replace(e.init(e.params, 3), qpos=args[0], qvel=args[1],
                                        target=args[2])
            tol = 5e-5
        else:
            args = forest_inputs(e, r, n, h, 3, device, start)
            state = dataclasses.replace(e.init(e.params, 3), qpos=args[0], qvel=args[1])
            tol = 1e-4      # kernel #6 against its plain version (the forest checks')
        mean, noise = args[3], args[4]
        got, again, want = r(*args), r(*args), r.plain(*args)
        general = rollout_open_loop(e, e.params, state, mean, noise).costs
        nominal_costs = r0(*args)
        zeroed = r.plain(*args[:3], torch.zeros_like(mean), torch.zeros_like(noise))
        torch.cuda.synchronize()
        diff = lambda a, b: float((a - b).abs().max())
        team = r.team_for(n, device) if hasattr(r, "team_for") else r.team
        fields = dict(env=name, n=n, h=h, team=team, max_abs_err=diff(got, want),
                      engine_err=diff(got, general), nominal_kernel_err=diff(nominal_costs, general),
                      zeroed_actions_err=diff(zeroed, want), launches_identical=torch.equal(got, again),
                      atol=tol, engine_atol=KERNEL_ENGINE_ATOL,
                      header_differs=r.header != r0.header)
        lib = r.library(team) if hasattr(r, "team_for") else r.library()
        ptxas = [ln.strip() for ln in lib.ptxas.splitlines()
                 if re.search(r"registers|spill|smem", ln)]
        emit("dyn_kernel", **fields, ptxas=ptxas)
        errors[("dyn", name, n, h)] = fields["max_abs_err"]
        if not (fields["launches_identical"] and fields["header_differs"]
                and fields["max_abs_err"] <= tol and fields["engine_err"] <= KERNEL_ENGINE_ATOL):
            raise RuntimeError(f"perturbed kernel check failed: {fields}")
        if n > 1 and not (fields["zeroed_actions_err"] > 10 * tol
                          and fields["nominal_kernel_err"] > 10 * KERNEL_ENGINE_ATOL):
            raise RuntimeError(f"perturbed kernel check too weak: {fields}")
    # the `kernels` rows: the reacher at the main path's size, pen at its config's
    times = {}
    r = dyn[DYN_REACHER[0]].fused_rollout.kernel
    args = reacher_inputs(NUM_PARTICLES, HORIZON, 0, device)
    got = r(*args)
    want, plain_ms = cuda_call_ms(lambda: r.plain(*args))
    errors[("dyn", DYN_REACHER[0], NUM_PARTICLES, HORIZON)] = float((got - want).abs().max())
    if not errors[("dyn", DYN_REACHER[0], NUM_PARTICLES, HORIZON)] <= 1e-3:
        raise RuntimeError("perturbed reacher kernel disagrees at the main path's size")
    times["chain_rollout_reacher_perturbed"] = (cuda_ms(lambda: r(*args), N_SOLVES), plain_ms)
    from mjmpc_tpu_torch import bounds
    from mjmpc_tpu_torch.ops import forest_rollout as fr
    r = dyn["pen-v0"].fused_rollout.kernel
    n, h = bounds.FOREST_SIZES["pen-v0"]
    args = forest_inputs(dyn["pen-v0"], r, n, h, 0, device)
    got = r(*args)
    want, plain_ms = cuda_call_ms(lambda: r.plain(*args))
    # the nominal pen's rule at this size (phase 10): entries within 1e-3
    # but for ones a bonus step apart, 99% of them within
    agree = fr.gated_cost_agreement(got, want, 1e-3, fr.PEN_BONUS_STEPS)
    errors[("dyn", "pen-v0", n, h)] = float((got - want).abs().max())
    emit("dyn_kernel", env="pen-v0", n=n, h=h, max_abs_err=errors[("dyn", "pen-v0", n, h)],
         atol=1e-3, share_within=agree["share_within"],
         entries_off_by_a_bonus_step=agree["bonus_steps"], entries_off_otherwise=agree["other"])
    if not (got.shape == (n, h) and agree["share_within"] >= 0.99 and agree["other"] == 0):
        raise RuntimeError(f"perturbed pen kernel disagrees at its path's size: {agree}")
    times["forest_rollout_pen_perturbed"] = (cuda_ms(lambda: r(*args), N_SOLVES), plain_ms)
    return times


def dyn_run_mpc_phase(device, counters, counts, expected) -> dict:
    """25. run_mpc --dyn_randomize_config on the reacher spec, the
    reacher config cut to one episode of DYN_STEPS steps: the planner's
    params are the spec's draw from the config's seed, the real env that
    run_mpc stepped is nominal and its rewards are those of a nominal real
    env planned on the perturbed one (run_episodes, the same seed), and
    the perturbed model's kernel #1 runs every solve the host launches."""
    import torch
    from mjmpc_tpu_torch import envs, solvers
    from mjmpc_tpu_torch.envs import randomize
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import run_mpc
    from mjmpc_tpu_torch.harness.episode import run_episodes
    name, spec = DYN_REACHER
    config = "configs/reacher_7dof-v0.yml"
    real = envs.make(name, device=device)
    with tempfile.TemporaryDirectory() as out_dir:
        exp = dict(hconfig.load_config(config), n_episodes=1, max_ep_length=DYN_STEPS)
        path = cut_config(exp, out_dir, "dyn.yml")
        s = hconfig.make_solver_for_env(exp, "mppi", real)
        reset_counts(*counters)
        t0 = time.perf_counter()
        out = run_mpc.main(["--config", path, "--controller", "mppi", "--dyn_randomize_config",
                            spec, "--save_dir", out_dir])["mppi"]
        seconds = time.perf_counter() - t0
        got = counts()
    # one episode: a batched episode of one (the batched solve covers MPPI on #1)
    want = expected(**batched_launches(s, episode_solves(DYN_STEPS), "chain_batch"))
    drawn = randomize.perturbed_params(real, load_yaml(spec), base_seed=exp["seed"])[0]
    sim = out["sim_params"]
    sim_ok = (all(torch.equal(getattr(sim.model, f), getattr(drawn.model, f))
                  for f in ("mass", "inertia", "damping"))
              and not torch.equal(sim.model.mass, real.params.model.mass))
    nominal, stepped = (solvers.tensor_leaves(p) for p in (real.params, out["real_params"]))
    ref = run_episodes(s, real, 1, DYN_STEPS, base_seed=exp["seed"],
                       sim_env=randomize.randomize_dynamics(real, load_yaml(spec),
                                                            base_seed=exp["seed"])[0])
    real_ok = (stepped.keys() == nominal.keys()
               and all(torch.equal(stepped[k], nominal[k]) for k in nominal)
               and np.array_equal(out["rewards"], ref["rewards"]))
    emit("dyn_run_mpc", env=name, config=config, spec=spec, steps=DYN_STEPS,
         rewards=out["rewards"][0].tolist(), sim_params_drawn=sim_ok, real_params_nominal=real_ok,
         launches=got, expected=want, seconds=seconds)
    if got != want or not (sim_ok and real_ok) or not np.isfinite(out["rewards"]).all():
        raise RuntimeError(f"run_mpc --dyn_randomize_config: launches {got}, expected {want}, "
                           f"sim {sim_ok}, real {real_ok}")
    return got


def episode_replay_phase(device, counters, counts, smi: str, main_solver, dyn: dict) -> dict:
    """26. The captured episode against the eager one, bit for bit: the
    main path (reacher_7dof-v0, MPPI H=32 N=4096), the main path planning
    on the perturbed reacher (its own kernel #1) and pen-v0's mppi
    planning on the perturbed pen (its own kernel #6), each eager
    (replay=False) and replayed; records, stacked states and the final
    solver state equal; the control-step rates of both (eager by the host
    clock, replayed from one replay's device time, episode.replay_ms,
    beside the host clock's over the same replays), after a warm-up
    episode. Returns each episode's kernel launches: {name: {"eager":
    the eager run's, one a kernel execution, "replayed": the replayed
    run's host launches, its first step's and the capture's (a replay
    executes the captured ones again without counting)}}."""
    import torch
    from mjmpc_tpu_torch import envs
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness.episode import build_episode_fn
    pen_exp = hconfig.load_config(FOREST_CONFIGS["pen-v0"])
    pen = envs.make("pen-v0", device=device)
    reacher = envs.make("reacher_7dof-v0", device=device)
    runs = {"reacher_7dof-v0": (main_solver, reacher, None),
            "reacher_7dof-v0 perturbed": (main_solver, reacher, dyn["reacher_7dof-v0"]),
            "pen-v0": (hconfig.make_solver_for_env(pen_exp, "mppi", pen), pen, dyn["pen-v0"])}
    launches = {}
    for name, (s, e, sim) in runs.items():
        steps = EPISODE_STEPS[name]
        sim_params = (sim or e).params
        out, seconds, launches[name] = {}, {}, {}
        # a first 2-step replayed episode warms what a capture makes once
        for key, replay, length in (("warm", True, 2), ("eager", False, steps),
                                    ("replayed", True, steps)):
            run = build_episode_fn(s, e, length, sim_env=sim, replay=replay)
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.perf_counter()
            out[key] = run(e.params, sim_params, 7)
            torch.cuda.synchronize()
            seconds[key] = time.perf_counter() - t0
            launches[name][key] = counts()
            if key == "replayed":
                replay_ms, replay_host_ms = run.replay_ms, run.replay_host_ms
        (rec_e, st_e, fin_e), (rec_r, st_r, fin_r) = out["eager"], out["replayed"]
        identical = (tensors_equal(rec_e, rec_r) and tensors_equal(st_e, st_r)
                     and tensors_equal(fin_e, fin_r))
        kernel = "forest" if name == "pen-v0" else "chain"
        # one execution a solver iteration, eager; the replayed run's host
        # launches are its first step's and the capture's
        launches_ok = (launches[name]["eager"][kernel] == steps * s.n_iters
                       and launches[name]["replayed"][kernel] == episode_solves(steps) * s.n_iters)
        fields = dict(env=name, planner=(sim or e).name + (" (perturbed)" if sim else ""),
                      n=s.num_particles, h=s.horizon, steps=steps, identical=identical,
                      ep_reward=float(rec_r["reward"].sum()),
                      eager_steps_per_s=steps / seconds["eager"],
                      replayed_steps_per_s=1e3 / replay_ms, replay_ms=replay_ms,
                      replay_host_ms=replay_host_ms,
                      replayed_episode_s=seconds["replayed"], eager_episode_s=seconds["eager"],
                      kernel_executions_eager=launches[name]["eager"],
                      host_launches_replayed=launches[name]["replayed"], card=smi)
        emit("episode_replay", **fields)
        if not identical or not bool(torch.isfinite(rec_r["reward"]).all()):
            raise RuntimeError(f"episode replay of {name} differs from the eager episode")
        if not launches_ok:
            raise RuntimeError(f"episode replay of {name}: launches {launches[name]}")
    return launches


def parallel_phase(device, counters, counts, expected, main_solver) -> dict:
    """27. parallel/ on a mesh of one card: build_sharded_solve_fn's solves
    (the main path) against the plain solves bit for bit, #1 once a solve;
    build_batch_episode_fn's records (the reacher config's mppi, one
    batched episode on the row) against the batched episode of the
    unsharded env with the same seeds bit for bit, #1's batched entry once
    a solve the host launches."""
    import torch
    from mjmpc_tpu_torch import envs, parallel, solvers
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness.episode import build_batched_episode_fn
    env = envs.make("reacher_7dof-v0", device=device)
    mesh = parallel.make_mesh()
    es = env.init(env.params, 1)
    plain = solvers.make_solve_fn(main_solver, env)
    sharded = parallel.build_sharded_solve_fn(main_solver, env, mesh)
    a = b = main_solver.init_state(0)
    same = True
    reset_counts(*counters)
    for _ in range(ZOO_SOLVES):
        b_out = sharded(env.params, es, b)
        a_out = plain(env.params, es, a)
        same &= tensors_equal(a_out, b_out)
        a, b = a_out[2], b_out[2]
    got = counts()
    want = expected(chain=2 * ZOO_SOLVES, **{k: 2 * v for k, v in
                                           noise_launches(main_solver, ZOO_SOLVES).items()})
    exp = hconfig.load_config("configs/reacher_7dof-v0.yml")
    s = hconfig.make_solver_for_env(exp, "mppi", env)
    seeds = [1, 2]
    reset_counts(*counters)
    batch = parallel.build_batch_episode_fn(s, env, PARALLEL_STEPS, mesh)(env.params, seeds)
    batch_launches = counts()
    unsharded = build_batched_episode_fn(s, env, PARALLEL_STEPS)(env.params, env.params, seeds)[0]
    batch_same = all(torch.equal(batch[k], unsharded[k]) for k in unsharded)
    # an independent path: each episode against the single episode of its seed
    diffs = single_episode_diffs(s, env, batch, seeds)[0]
    batch_want = episode_solves(PARALLEL_STEPS) * s.n_iters
    emit("parallel", mesh=[[str(d) for d in row] for row in mesh.devices],
         sharded_solves=ZOO_SOLVES, sharded_identical=same, launches=got,
         batch_shape={k: list(v.shape) for k, v in batch.items()}, batch_identical=batch_same,
         first_steps=BATCH_AGREE_STEPS, single_episode_max_diff=diffs, atol=BATCH_AGREE_ATOL,
         batch_launches=batch_launches)
    if (not (same and batch_same) or got != want or batch_launches["chain_batch"] != batch_want
            or batch_launches["chain"] != 0 or not max(diffs.values()) <= BATCH_AGREE_ATOL):
        raise RuntimeError(f"parallel: sharded {same}, batch {batch_same}, launches {got}, "
                           f"expected {want}, batch launches {batch_launches}, single-episode "
                           f"differences {diffs}")
    return batch_launches


def render_phase(device, counters, counts, smi: str) -> None:
    """28. render/ and initialize_multihost on the card (see the module
    docstring)."""
    import socket
    import torch
    import torch.distributed as dist
    from mjmpc_tpu_torch import envs, parallel, render
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import run_mpc
    from mjmpc_tpu_torch.render import gif
    for config in RENDER_CONFIGS:
        exp = dict(hconfig.load_config(config), n_episodes=1, max_ep_length=RENDER_STEPS)
        env = envs.make(exp["env_name"], device=device)
        s = hconfig.make_solver_for_env(exp, "mppi", env)
        with tempfile.TemporaryDirectory() as out_dir:
            path = cut_config(exp, out_dir, "render.yml")
            runs, launches = {}, {}
            for key, extra in (("with", ["--dump_vids"]), ("without", [])):
                reset_counts(*counters)
                runs[key] = run_mpc.main(["--config", path, "--controller", "mppi", "--device",
                                          str(device), "--save_dir", f"{out_dir}/{key}",
                                          *extra])["mppi"]
                launches[key] = counts()
            gifs = sorted(f for f in os.listdir(runs["with"]["log_dir"]) if f.endswith(".gif"))
            info = [gif.read_gif(os.path.join(runs["with"]["log_dir"], f)) for f in gifs]
        identical = all(np.array_equal(runs["with"][k], runs["without"][k])
                        for k in ("rewards", "actions", "values", "dones", "successes"))
        solves = episode_solves(RENDER_STEPS) * s.n_iters   # a batched episode of one
        kernel = "forest_batch" if exp["env_name"] == "door-v0" else "chain_batch"
        launches_ok = (launches["with"] == launches["without"]
                       and launches["with"][kernel] == solves)
        host = runs["with"]["states"][0]
        on_card = dataclasses.replace(host, **{
            f.name: torch.as_tensor(getattr(host, f.name), device=device)
            for f in dataclasses.fields(host) if isinstance(getattr(host, f.name), np.ndarray)})
        frames_cpu = render.render_trajectory(env, [host])
        frames_card = render.render_trajectory(env, [on_card])
        same_frames = len(frames_cpu) == RENDER_STEPS and all(
            np.array_equal(a, b) for a, b in zip(frames_cpu, frames_card))
        # render and encode times over a longer episode: the states tiled
        reps = -(-RENDER_TIMING_FRAMES // RENDER_STEPS)
        long = dataclasses.replace(on_card, **{
            f.name: getattr(on_card, f.name).repeat(reps, *[1] * (getattr(on_card, f.name).dim()
                                                                  - 1))[:RENDER_TIMING_FRAMES]
            for f in dataclasses.fields(on_card)
            if isinstance(getattr(on_card, f.name), torch.Tensor)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = render.render_trajectory(env, [long])
        render_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            gif.write_gif(f"{out_dir}/timing.gif", frames)
            encode_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
            gif_bytes = os.path.getsize(f"{out_dir}/timing.gif")
        emit("render", config=config, env=exp["env_name"], steps=RENDER_STEPS, gifs=gifs,
             gif_frames=[len(i["delays"]) for i in info], records_identical=identical,
             card_frames_equal_cpu=same_frames, launches=launches["with"],
             timing_frames=len(frames), render_ms_per_frame=render_ms,
             encode_ms_per_frame=encode_ms, gif_kb_per_frame=gif_bytes / 1e3 / len(frames),
             card=smi)
        if (gifs != ["vid_traj_0.gif"] or [len(i["delays"]) for i in info] != [RENDER_STEPS]
                or not (identical and same_frames and launches_ok)
                or not np.isfinite(runs["with"]["rewards"]).all()):
            raise RuntimeError(f"render {config}: gifs {gifs}, records {identical}, frames "
                               f"{same_frames}, launches {launches}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    parallel.initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        backend, world = dist.get_backend(), dist.get_world_size()
        x = torch.arange(4.0, device=device)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        reduced = torch.equal(x, torch.arange(4.0, device=device))
    finally:
        dist.destroy_process_group()
    emit("multihost", backend=backend, world_size=world, all_reduce_ok=reduced,
         destroyed=not dist.is_initialized())
    if backend != "nccl" or world != 1 or not reduced or dist.is_initialized():
        raise RuntimeError(f"initialize_multihost: {backend}, world {world}, reduce {reduced}")


def batch_inputs(b: int, n: int, h: int, seed: int, device):
    """B elements of reacher_inputs (seeds seed, seed + 1, ...) stacked:
    q0, qd0 [B, 7], target [B, 3], mean [B, H, 7], noise [B, N, H, 7]."""
    import torch
    rows = [reacher_inputs(n, h, seed + i, device) for i in range(b)]
    return [torch.stack(xs).contiguous() for xs in zip(*rows)]


def benchmark_phase(device, counters, counts, expected, smi: str, env, roll, sampler) -> dict:
    """29. the batched entries of kernels #1 and #2, the batched MPPI solve,
    its graph, benchmark --quick and forest_perf (see the module
    docstring). Returns the batched kernels' rows for the `kernels` line:
    {name: (launches, max_abs_err, (ms, plain_ms), (bound_ms, bound_by))}."""
    import torch
    from mjmpc_tpu_torch import bounds, ops, rng, solvers
    from mjmpc_tpu_torch.harness import benchmark, forest_perf
    n, h, tol = NUM_PARTICLES, HORIZON, 5e-5
    model = env.params.model
    out, errs, times = {}, {}, {}
    for b in BATCHES:
        args = batch_inputs(b, n, h, 100 + 10 * b, device)
        got = roll.batch(*args)
        singles = torch.stack([roll(*(x[i] for x in args)) for i in range(b)])
        want, plain_ms = cuda_call_ms(lambda: roll.batch_plain(*args))
        keys = ops.key_tensor([rng.stream_key(7, 100 + i) for i in range(b)], device)
        steps = torch.arange(5, 5 + b, dtype=torch.int64, device=device)
        white = sampler.white_batch(keys, steps, n, h, D_ACTION, FILTER)
        white_singles = torch.stack([sampler.white(rng.stream_key(7, 100 + i), steps[i], n, h,
                                                   D_ACTION, FILTER) for i in range(b)])
        white_want, white_plain_ms = cuda_call_ms(
            lambda: sampler.white_batch_plain(keys, steps, n, h, D_ACTION, FILTER))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        white_err = float((white - white_want).abs().max())
        fields = dict(b=b, n=n, h=h, max_abs_err=err, noise_max_abs_err=white_err, atol=tol,
                      identical_to_singles=torch.equal(got, singles),
                      noise_identical_to_singles=torch.equal(white, white_singles),
                      team=roll.team_for(b * n, device))
        if b == 2:   # the checks' power: element 1 with zeroed actions, at another step
            zeroed = [x.clone() for x in args]
            zeroed[3][1], zeroed[4][1] = 0.0, 0.0
            fields["zeroed_actions_err"] = float((got - roll.batch_plain(*zeroed)).abs().max())
            other = sampler.white_batch_plain(keys, steps + torch.tensor([0, 1], device=device),
                                              n, h, D_ACTION, FILTER)
            fields["other_step_err"] = float((white - other).abs().max())
            if not min(fields["zeroed_actions_err"], fields["other_step_err"]) > 10 * tol:
                raise RuntimeError(f"batched checks too weak: {fields}")
        emit("kernel_batched", **fields)
        if got.shape != (b, n, h) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"batched chain kernel output bad at B={b}")
        if not (fields["identical_to_singles"] and fields["noise_identical_to_singles"]):
            raise RuntimeError(f"batched kernels differ from {b} single launches: {fields}")
        if not max(err, white_err) <= tol:
            raise RuntimeError(f"batched kernels disagree with their plain versions at B={b}: "
                               f"{err}, {white_err} > {tol}")
        times[b] = dict(
            chain=cuda_ms(lambda: roll.batch(*args), 20),
            chain_singles=cuda_ms(lambda: [roll(*(x[i] for x in args)) for i in range(b)], 20),
            chain_plain=plain_ms,
            noise=cuda_ms(lambda: sampler.white_batch(keys, steps, n, h, D_ACTION, FILTER), 50),
            noise_singles=cuda_ms(lambda: [sampler.white(rng.stream_key(7, 100 + i), steps[i], n,
                                                         h, D_ACTION, FILTER)
                                           for i in range(b)], 50),
            noise_plain=white_plain_ms)
        chain_work = [b * w for w in bounds.chain_work(model, n, h, "costs", n_substeps=2)]
        noise_inst = bounds.noise_instance(n, h, D_ACTION)
        bound = dict(chain=bounds.bound_ms(*chain_work),
                     noise=bounds.bound_ms(b * noise_inst["bytes"], b * noise_inst["operations"]))
        emit("kernel_batched_time", card=smi, b=b, n=n, h=h, **times[b],
             chain_bound=bound["chain"], noise_bound=bound["noise"])
        errs[b] = (err, white_err, bound)

    # the batched MPPI solve (the main path's MPPI, kernel noise) against B
    # single solves from the same states, mean drawn away from zero
    solver = solvers.MPPI(d_action=env.d_action, horizon=h, num_particles=n, init_cov=3.0,
                          filter_coeffs=FILTER, base_action="repeat", lam=0.01, step_size=0.55,
                          gamma=1.0, noise_impl="kernel", device=device)
    bsolve = solvers.build_batched_solve_fn(solver, env)
    single = solvers.make_solve_fn(solver, env)
    seeds = [rng.derive_seed(0, i) for i in range(BATCH_SOLVE)]
    env_states = [env.init(env.params, rng.derive_seed(1, i)) for i in range(BATCH_SOLVE)]
    es = solvers.stack_states(env_states)
    start = solver.init_batch(seeds)
    means = torch.as_tensor(np.asarray(np.random.default_rng(3).normal(
        size=tuple(start.mean.shape)) * 0.3, np.float32), device=device)
    start = dataclasses.replace(start, mean=means)
    action, _, new = bsolve(env.params, es, start)
    action_err = mean_err = 0.0
    for i, st in enumerate(start.unstack()):
        a_i, _, s_i = single(env.params, env_states[i], st)
        action_err = max(action_err, float((a_i - action[i]).abs().max()))
        mean_err = max(mean_err, float((s_i.mean - new.mean[i]).abs().max()))
    reset_counts(*counters)
    action_host, state = sync_free(bsolve, env, es, start, N_SOLVES)
    launches = counts()
    emit("batched_solve", b=BATCH_SOLVE, n=n, h=h, action_max_abs_diff=action_err,
         mean_max_abs_diff=mean_err, atol=MPPI_UPDATE_ATOL, solves=N_SOLVES, launches=launches,
         steps=state.step.tolist(), action=action_host.tolist())
    if not max(action_err, mean_err) <= MPPI_UPDATE_ATOL:
        raise RuntimeError(f"batched solve differs from single solves: {action_err}, {mean_err}")
    if launches != expected(chain_batch=N_SOLVES, noise_batch=N_SOLVES):
        raise RuntimeError(f"batched solve: launches {launches}")

    # its CUDA graph: replays against eager solves, bit for bit
    eager, s = [], start
    for _ in range(GRAPH_REPLAYS):
        a, v, s = bsolve(env.params, es, s)
        eager.append([a.clone(), v.clone()] + list(state_tensors(s).values()))
    graph, got_out, feed = capture(bsolve, env, es, start)
    identical = True
    for want in eager:
        graph.replay()
        got = [got_out[0], got_out[1]] + list(state_tensors(got_out[2]).values())
        identical &= all(torch.equal(x, y) for x, y in zip(got, want))
        feed()
    torch.cuda.synchronize()
    emit("graph", family="batched_mppi", b=BATCH_SOLVE, replays=GRAPH_REPLAYS, identical=identical)
    if not identical:
        raise RuntimeError("batched solve: graph replays differ from eager solves")

    # the benchmark module and the forest accounting on the card
    try:
        bench_rows = benchmark.main(["--quick"])
    except SystemExit as e:
        raise RuntimeError(f"benchmark --quick: {e}") from None
    forest_rows = forest_perf.main([])
    for row in bench_rows + forest_rows:
        numbers = [v for v in row.values() if isinstance(v, (int, float))]
        if "flops_error" in row or not all(np.isfinite(numbers)):
            raise RuntimeError(f"benchmark row bad: {row}")
    emit("benchmark", rows=len(bench_rows), forest_rows=len(forest_rows), card=smi)

    b = BATCH_SOLVE
    return {"chain_rollout_batched": (launches["chain_batch"], errs[b][0],
                                      (times[b]["chain"], times[b]["chain_plain"]),
                                      errs[b][2]["chain"]),
            "filtered_noise_batched": (launches["noise_batch"], errs[b][1],
                                       (times[b]["noise"], times[b]["noise_plain"]),
                                       errs[b][2]["noise"])}


def _batched_entry_inputs(name, e, roll, n, h, b, device):
    """The batched entry's arguments for B elements of one env: the forest
    and locomotion checks' inputs (forest_inputs, loco_inputs) at seeds
    60, 61, ..., stacked; for the pendulum B starts from the crossing one
    (th0 - 0.4 b, thdot0 + 2 b) with per-element means and noise."""
    import torch
    from mjmpc_tpu_torch import solvers
    if name == "SimplePendulum-v0":
        rows = [pendulum_inputs(e, n, h, 60 + i, device) for i in range(b)]
        states = solvers.stack_states([dataclasses.replace(
            r[1], th=r[1].th - 0.4 * i, thdot=r[1].thdot + 2.0 * i) for i, r in enumerate(rows)])
        return [e.params, states] + [torch.stack([r[k] for r in rows]).contiguous()
                                     for k in (2, 3)]
    if name in LOCO_CONFIGS:
        rows = [loco_inputs(roll.model.nv, n, h, 60 + i, device) for i in range(b)]
    else:
        start = {c[0]: c[1] for c in reversed(FOREST_CHECKS)}.get(name)   # its first check's
        rows = [forest_inputs(e, roll, n, h, 60 + i, device, start) for i in range(b)]
    return [torch.stack(xs).contiguous() for xs in zip(*rows)]


def _batched_entry_err(name, got, want) -> float:
    """max |got - want|, for the cheetah of max(1, |want|) (its stiff
    contact, as its single checks read it)."""
    scale = want.abs().clamp(min=1.0) if name == "HalfCheetah-v0" else 1.0
    return float(((got - want).abs() / scale).max())


def _batched_entry_agree(name, got, want, tol):
    """(passes, fields) of a batched entry against its plain version: its
    error (_batched_entry_err) within tol, or for tol None the gated-cost
    rule of pen's single check at the config's size (phase 10: entries
    within 1e-3 but for ones a bonus step apart, 99% of them within)."""
    from mjmpc_tpu_torch.ops import forest_rollout as fr
    if tol is not None:
        return _batched_entry_err(name, got, want) <= tol, dict(atol=tol)
    agree = fr.gated_cost_agreement(got, want, 1e-3, fr.PEN_BONUS_STEPS)
    return agree["share_within"] >= 0.99 and agree["other"] == 0, dict(
        atol=1e-3, share_within=agree["share_within"],
        entries_off_by_a_bonus_step=agree["bonus_steps"], entries_off_otherwise=agree["other"])


def single_episode_diffs(solver, env, records, seeds, steps: int = BATCH_AGREE_STEPS):
    """Each episode of a batch's records ([B, T, ...]) against the single
    episode of its seed (build_episode_fn, replayed) on the first `steps`
    steps: ({action, reward: the largest difference, a reward's over
    max(1, |reward|)}, the single episodes' replay_ms)."""
    from mjmpc_tpu_torch.harness.episode import build_episode_fn
    diffs, single_ms = dict(action=0.0, reward=0.0), []
    for i, seed in enumerate(seeds):
        run = build_episode_fn(solver, env, records["action"].shape[1])
        rec = run(env.params, env.params, seed)[0]
        single_ms.append(run.replay_ms)
        for k in diffs:
            a, b = rec[k][:steps], records[k][i, :steps]
            scale = b.abs().clamp(min=1.0) if k == "reward" else 1.0
            diffs[k] = max(diffs[k], float(((a - b).abs() / scale).max()))
    return diffs, single_ms


def batch_episodes_phase(device, counters, counts, expected, smi: str) -> dict:
    """30. The batched entries of kernels #5, #6 and #7 and the batched
    episode (see the module docstring). Returns the batched entries' rows
    for the `kernels` line: {name: (launches, max_abs_err, (ms, plain_ms),
    (bound_ms, bound_by))}."""
    import torch
    from mjmpc_tpu_torch import bounds, envs
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness.episode import build_batched_episode_fn
    from mjmpc_tpu_torch.ops.chain_rollout import ChainExtRollout
    from mjmpc_tpu_torch.ops import pendulum as pend
    from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout
    from mjmpc_tpu_torch.ops.pendulum import PendulumRollout
    batch_count = {ChainExtRollout: "ext_batch", ForestRollout: "forest_batch",
                   PendulumRollout: "pendulum_batch"}
    errs, times, bound = {}, {}, {}
    for name, (n, h, tol) in BATCH_ENTRY_CHECKS.items():
        e = envs.make(name, device=device)
        roll = getattr(e.fused_rollout, "kernel", e.fused_rollout)
        cls = type(roll)
        pend_like = name == "SimplePendulum-v0"
        for b in BATCH_ENTRY_SIZES:
            args = _batched_entry_inputs(name, e, roll, n, h, b, device)
            reset_counts(*counters)
            got = roll.batch(*args)
            launched = counts()
            if pend_like:
                st = args[1]
                singles = [roll(args[0], type(st)(th=st.th[i], thdot=st.thdot[i]), args[2][i],
                                args[3][i]) for i in range(b)]
            else:
                singles = [roll(*(x[i] for x in args)) for i in range(b)]
            identical = torch.equal(got, torch.stack(singles))
            fields = dict(env=name, b=b, n=n, h=h, identical_to_singles=identical,
                          launches=launched)
            if b == 2:
                # the plain version (each element's single plain rollout; B = 1
                # and 4 equal B single launches, which phases 8, 10 and 3 hold
                # to it), and the check's power: element 1's actions zeroed
                err = _batched_entry_err(name, got, roll.batch_plain(*args))
                fields.update(max_abs_err=err, atol=tol)
                zeroed = list(args)
                zeroed[-2], zeroed[-1] = args[-2].clone(), args[-1].clone()
                zeroed[-2][1], zeroed[-1][1] = 0.0, 0.0
                fields["zeroed_actions_err"] = _batched_entry_err(name, got,
                                                                  roll.batch_plain(*zeroed))
                if not fields["zeroed_actions_err"] > 10 * tol:
                    raise RuntimeError(f"batched {name} check too weak: {fields}")
            emit("kernel_batched_entry", **fields)
            if got.shape != (b, n, h) or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"batched {name} kernel output bad at B={b}")
            if not identical:
                raise RuntimeError(f"batched {name} kernel differs from {b} single launches")
            if b == 2 and not err <= tol:
                raise RuntimeError(f"batched {name} kernel disagrees with its plain version: "
                                   f"{err} > {tol}")
            if launched != expected(**{batch_count[cls]: 1}):
                raise RuntimeError(f"batched {name} kernel: launches {launched}")
        if name in BATCH_TIMED:       # at the config's size: checked again, and timed
            n_c, h_c, tol_c = BATCH_TIMED[name]
            inst = (bounds.pendulum_instance(7, n_c, h_c) if pend_like else
                    bounds.ext_instance(roll, n_c, h_c) if name in LOCO_CONFIGS else
                    bounds.forest_instance(roll, n_c, h_c))
            lib = pend.library() if pend_like else roll.library()
            for b in BATCH_ENTRY_SIZES:
                args = _batched_entry_inputs(name, e, roll, n_c, h_c, b, device)
                if pend_like:
                    st = args[1]
                    one = [(args[0], type(st)(th=st.th[i], thdot=st.thdot[i]), args[2][i],
                            args[3][i]) for i in range(b)]
                else:
                    one = [[x[i] for x in args] for i in range(b)]
                got = roll.batch(*args)
                identical = torch.equal(got, torch.stack([roll(*a) for a in one]))
                fields, ok, plain_ms = dict(identical_to_singles=identical), True, None
                if b == BATCH_ROW_B:
                    # the plain version (seconds a call on the forest): held to
                    # the single kernel's check at this size, and timed
                    want, plain_ms = cuda_call_ms(lambda: roll.batch_plain(*args))
                    errs[name] = _batched_entry_err(name, got, want)
                    ok, more = _batched_entry_agree(name, got, want, tol_c)
                    fields.update(max_abs_err=errs[name], **more)
                batched_ms = cuda_ms(lambda: roll.batch(*args), 10)
                singles_ms = cuda_ms(lambda: [roll(*a) for a in one], 10)
                bound[(name, b)] = bounds.bound_ms(b * inst["bytes"], b * inst["operations"])
                times[(name, b)] = (batched_ms, plain_ms)
                emit("kernel_batched_entry_time", env=name, card=smi, b=b, n=n_c, h=h_c,
                     ms=batched_ms, singles_ms=singles_ms, plain_ms=plain_ms,
                     bound_ms=bound[(name, b)][0], bound_by=bound[(name, b)][1],
                     single_bound_ms=inst["bound_ms"],
                     ptxas=[ln.strip() for ln in lib.ptxas.splitlines()
                            if re.search(r"registers|spill|smem", ln)], **fields)
                if got.shape != (b, n_c, h_c) or not bool(torch.isfinite(got).all()):
                    raise RuntimeError(f"batched {name} kernel output bad at B={b} N={n_c}")
                if not identical:
                    raise RuntimeError(f"batched {name} kernel differs from {b} single launches "
                                       f"at N={n_c} H={h_c}")
                if not ok:
                    raise RuntimeError(f"batched {name} kernel disagrees with its plain version "
                                       f"at N={n_c} H={h_c}: {fields}")

    # B episodes as one batched episode at each config's solver block
    launches = {}
    for name, config in BATCH_EPISODE_CONFIGS.items():
        exp = hconfig.load_config(config)
        e = envs.make(exp["env_name"], device=device)
        s = hconfig.make_solver_for_env(exp, "mppi", e)
        seeds = [exp["seed"] + i * 12345 for i in range(BATCH_EPISODES)]
        kernel = getattr(e.fused_rollout, "kernel", e.fused_rollout)
        key = batch_count.get(type(kernel), "chain_batch")
        out, seconds = {}, {}
        for mode, replay in (("eager", False), ("replayed", True)):
            run = build_batched_episode_fn(s, e, BATCH_EPISODE_STEPS, replay=replay)
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.perf_counter()
            out[mode] = run(e.params, e.params, seeds)
            torch.cuda.synchronize()
            seconds[mode] = time.perf_counter() - t0
            got = counts()
            if mode == "replayed":
                batch_ms, batch_host_ms = run.replay_ms, run.replay_host_ms
                hosted = episode_solves(BATCH_EPISODE_STEPS)
                want = expected(**{key: hosted * s.n_iters,
                                   "noise_batch": noise_launches(s, hosted)["noise"]})
                launches[name] = got
                if got != want:
                    raise RuntimeError(f"batched episode {name}: launches {got}, expected {want}")
        (rec_e, st_e, fin_e), (rec_r, st_r, fin_r) = out["eager"], out["replayed"]
        identical = (tensors_equal(rec_e, rec_r) and tensors_equal(fin_e, fin_r)
                     and all(tensors_equal(a, b) for a, b in zip(st_e, st_r)))
        diffs, single_ms = single_episode_diffs(s, e, rec_r, seeds)
        fields = dict(env=name, config=config, b=BATCH_EPISODES, n=s.num_particles, h=s.horizon,
                      steps=BATCH_EPISODE_STEPS, replay_identical_to_eager=identical,
                      first_steps=BATCH_AGREE_STEPS, single_episode_max_diff=diffs,
                      atol=BATCH_AGREE_ATOL, launches=launches[name],
                      ep_rewards=rec_r["reward"].sum(1).tolist(),
                      batched_replay_ms=batch_ms, batched_replay_host_ms=batch_host_ms,
                      single_replay_ms=single_ms,
                      batched_episode_steps_per_s=BATCH_EPISODES * 1e3 / batch_ms,
                      single_episode_steps_per_s=BATCH_EPISODES * 1e3 / sum(single_ms),
                      eager_batched_s=seconds["eager"], replayed_batched_s=seconds["replayed"],
                      card=smi)
        emit("batch_episode", **fields)
        if not identical or not bool(torch.isfinite(rec_r["reward"]).all()):
            raise RuntimeError(f"batched episode {name}: the replay differs from the eager loop")
        if not max(diffs.values()) <= BATCH_AGREE_ATOL:
            raise RuntimeError(f"batched episode {name}: the elements differ from their single "
                               f"episodes: {diffs}")

    b = BATCH_ROW_B
    return {kname: (launches[name][key], errs[name], times[(name, b)], bound[(name, b)])
            for name, (kname, key) in BATCH_ROWS.items()}


def lqr_dp(params, h: int, x0):
    """(first optimal action, optimal cost) of the finite-horizon LQR from
    x0 with zero terminal cost, in float64 numpy."""
    a_m, b_m, q_m, r_m = (getattr(params, k).double().cpu().numpy() for k in "ABQR")
    pp, ks = np.zeros_like(a_m), []
    for _ in range(h):
        k = np.linalg.solve(r_m + b_m.T @ pp @ b_m, b_m.T @ pp @ a_m)
        pp = q_m + k.T @ r_m @ k + (a_m - b_m @ k).T @ pp @ (a_m - b_m @ k)
        ks.append(k)
    ks = ks[::-1]
    x, cost = np.asarray(x0, np.float64), 0.0
    for t in range(h):
        u = -ks[t] @ x
        cost += x @ q_m @ x + u @ r_m @ u
        x = a_m @ x + b_m @ u
    return float((-ks[0] @ np.asarray(x0))[0]), cost


def cut_config(exp: dict, out_dir: str, name: str, **top) -> str:
    """exp with its top-level keys updated by `top`, written as YAML (JSON)
    to out_dir/name; its path."""
    path = f"{out_dir}/{name}"
    with open(path, "w") as f:
        json.dump(dict(exp, **top), f)
    return path


def analytic_phases(device, counters, counts, expected, smi: str):
    """Phases 13-15 of the docstring: the analytic envs, iLQR on LQR,
    checkpoints. Returns (runs, graph solves): runs maps (config or env
    name, controller) to (solve, solver, env, env state, state) for the
    timings (analytic_timing); the graph solves are iLQR on cartpole and
    MPPI on acrobot (phase 16)."""
    import torch
    from mjmpc_tpu_torch import envs, rng, solvers
    from mjmpc_tpu_torch.envs.lqr import LQRState
    from mjmpc_tpu_torch.harness import checkpoint, jobs, run_mpc, run_mpc_cl
    from mjmpc_tpu_torch.harness import config as hconfig

    def launches_of(s, solves):
        """iLQR launches none of the eight kernels; every other solver its
        noise draws."""
        return expected() if isinstance(s, solvers.ILQR) else expected(
            **noise_launches(s, solves))

    # 13. every analytic config's controllers at the config's own N and H;
    # the maze's MPPI across the continual goal's switch
    runs = {}
    for path, controllers in ANALYTIC_CONFIGS.items():
        exp = hconfig.load_config(path)
        e = envs.make(exp["env_name"], device=device)
        es = e.init(e.params, 1)
        for c in controllers:
            s = (run_mpc_cl.build_cl_solver(exp, c, e) if "actor_params" in exp
                 else hconfig.make_solver_for_env(exp, c, e))
            solve, state = solvers.make_solve_fn(s, e), s.init_state(0)
            reset_counts(*counters)
            t0 = time.perf_counter()
            action_host, state = sync_free(solve, e, es, state, ZOO_SOLVES)
            seconds = time.perf_counter() - t0
            got = counts()
            runs[(path, c)] = (solve, s, e, es, state)
            emit("analytic", config=path, env=e.name, controller=c,
                 n=getattr(s, "num_particles", 1), h=s.horizon, n_iters=s.n_iters,
                 solves=ZOO_SOLVES, launches=got, action=action_host.tolist(),
                 step=int(state.step), seconds=seconds, solves_per_s=ZOO_SOLVES / seconds,
                 card=smi)
            if got != launches_of(s, ZOO_SOLVES) or action_host.shape != (e.d_action,):
                raise RuntimeError(f"analytic {path} {c}: launches {got}, expected "
                                   f"{launches_of(s, ZOO_SOLVES)}")
    for name in ("maze-v0", "continual_maze-v0"):
        e = envs.make(name, device=device)
        es = dataclasses.replace(e.init(e.params, 1),
                                 timestep=rng.step_tensor(MAZE_START, device))
        st, goals = es, []
        for _ in range(2 * (50 - MAZE_START)):       # the real env across t = 50
            st, _, _, _ = e.step(e.params, st, torch.zeros(2, device=device))
            goals.append(st.goal)
        moved = [bool((g != es.goal).any()) for g in goals]
        switch_at = MAZE_START + 1 + moved.index(True) if any(moved) else None
        s = solvers.MPPI(d_action=2, device=device, **MAZE_MPPI)
        solve = solvers.make_solve_fn(s, e)
        reset_counts(*counters)
        action_host, state = sync_free(solve, e, es, s.init_state(0), ZOO_SOLVES)
        got = counts()
        runs[(name, "mppi")] = (solve, s, e, es, state)
        emit("analytic", env=name, controller="mppi", n=s.num_particles, h=s.horizon,
             start_step=MAZE_START, goal_switch_at=switch_at, solves=ZOO_SOLVES,
             launches=got, action=action_host.tolist())
        want_switch = 50 if name == "continual_maze-v0" else None
        if (got != launches_of(s, ZOO_SOLVES) or switch_at != want_switch
                or not MAZE_START < 50 < MAZE_START + s.horizon):
            raise RuntimeError(f"analytic {name}: launches {got}, goal switch at {switch_at}")

    # 14. iLQR on LQR against the finite-horizon dynamic program
    lqr_env = envs.make("LQR-v0", device=device)
    u0_opt, cost_opt = lqr_dp(lqr_env.params, LQR_H, LQR_X0)
    ilqr = solvers.ILQR(d_action=1, horizon=LQR_H, n_iters=3, mu=1e-6, device=device)
    lqr_solve = solvers.make_solve_fn(ilqr, lqr_env)
    lqr_state = LQRState(x=torch.tensor(LQR_X0, dtype=torch.float32, device=device))
    state0 = ilqr.init_state(0)
    reset_counts(*counters)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, plan_cost, state = lqr_solve(lqr_env.params, lqr_state, state0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    a0, c0 = float(action[0]), float(plan_cost)
    fields = dict(h=LQR_H, n_iters=3, action=a0, action_dp=u0_opt, plan_cost=c0,
                  cost_dp=cost_opt, action_rel_err=abs(a0 - u0_opt) / abs(u0_opt),
                  cost_rel_err=abs(c0 - cost_opt) / abs(cost_opt), launches=counts())
    emit("ilqr_lqr", **fields)
    if (not fields["action_rel_err"] <= 1e-3 or not fields["cost_rel_err"] <= 1e-4
            or counts() != expected()):
        raise RuntimeError(f"iLQR on LQR misses the dynamic program: {fields}")
    runs[("LQR-v0", "ilqr")] = (lqr_solve, ilqr, lqr_env, lqr_state, state)

    # 15. checkpoints: save, load onto the card, the next solve bit for bit
    # (MPPI on the main path with the kernel noise, iLQR on cartpole,
    # Reinforce on the cartpole CL config); run_mpc --checkpoint
    reacher = envs.make("reacher_7dof-v0", device=device)
    mppi_k = solvers.MPPI(d_action=7, horizon=HORIZON, num_particles=NUM_PARTICLES,
                          init_cov=3.0, filter_coeffs=FILTER, base_action="repeat",
                          lam=0.01, step_size=0.55, noise_impl="kernel", device=device)
    cases = {"mppi_main_path": (solvers.make_solve_fn(mppi_k, reacher), mppi_k, reacher,
                                reacher.init(reacher.params, 1), mppi_k.init_state(0))}
    for key, path in (("ilqr_cartpole", "configs/classic_control/cartpole-v0.yml"),
                      ("reinforce_cartpole_cl", "configs/cartpole-v0_cl.yml")):
        solve, s, e, es, _ = runs[(path, key.split("_")[0])]
        cases[key] = (solve, s, e, es, s.init_state(0))
    with tempfile.TemporaryDirectory() as out_dir:
        for key, (solve, s, e, es, state) in cases.items():
            for _ in range(2):
                _, _, state = solve(e.params, es, state)
            ckpt = f"{out_dir}/{key}"
            checkpoint.save_solver_state(ckpt, state, metadata=dict(family=key))
            restored = checkpoint.load_solver_state(ckpt, s.init_state(1))
            cont, rest = solve(e.params, es, state), solve(e.params, es, restored)
            torch.cuda.synchronize()
            names = ["action", "value"] + list(state_tensors(cont[2]))
            pairs = list(zip(cont[:2], rest[:2])) + list(zip(
                state_tensors(cont[2]).values(), state_tensors(rest[2]).values()))
            differ = [n for n, (a, b) in zip(names, pairs) if not torch.equal(a, b)]
            on_card = all(v.device.type == torch.device(device).type
                          for v in state_tensors(restored).values())
            ok = not differ and restored.seed == state.seed and on_card
            emit("checkpoint", family=key, step=int(restored.step), seed=restored.seed,
                 restored_on_card=on_card, fields_differing=differ, identical=ok)
            if not ok:
                raise RuntimeError(f"checkpoint {key}: the restored state's solve differs")
        # under run_mpc's guard each solve draws init_state's mean (one noise
        # launch), and the episode's start one more; the replayed episode
        # launches its first step and the captured one
        exp = hconfig.load_config("configs/classic_control/cartpole-v0.yml")
        path = cut_config(exp, out_dir, "cartpole.yml", n_episodes=1, max_ep_length=CL_STEPS)
        reset_counts(*counters)
        out = run_mpc.main(["--config", path, "--controller", "ilqr", "--checkpoint",
                            "--save_dir", out_dir])["ilqr"]
        ckpt = os.path.join(out["log_dir"], "solver_state")
        written = [os.path.exists(ckpt + ext) for ext in (".npz", ".manifest.json")]
        emit("run_mpc", env="cartpole-v0", config="configs/classic_control/cartpole-v0.yml",
             controller="ilqr", steps=CL_STEPS, checkpoint=written,
             rewards=out["rewards"][0].tolist(), launches=counts())
        if (not all(written) or not np.isfinite(out["rewards"]).all()
                or counts() != expected(noise=episode_solves(CL_STEPS) + 1)):
            raise RuntimeError("run_mpc --checkpoint on cartpole's iLQR failed")

    graph = {"ilqr_cartpole": runs[("configs/classic_control/cartpole-v0.yml", "ilqr")],
             "mppi_acrobot": runs[("configs/classic_control/acrobot-v0.yml", "mppi")]}
    return runs, {k: (solve, e, es, s.init_state(0)) for k, (solve, s, e, es, _) in graph.items()}


def driver_phases(device, counters, counts, expected):
    """18. run_mpc_cl.main on both closed-loop configs, one episode cut to
    CL_STEPS control steps; 19. jobs.main in tune mode on the tray-glass
    tune config cut to 2 cells x 1 episode x JOBS_STEPS steps (kernel #6)
    and in sweep mode on the point-mass config as it is."""
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import jobs, run_mpc_cl
    with tempfile.TemporaryDirectory() as out_dir:
        for k, src in enumerate(CL_CONFIGS):
            exp = hconfig.load_config(src)
            path = cut_config(exp, out_dir, f"cl{k}.yml", n_episodes=1, max_ep_length=CL_STEPS)
            reset_counts(*counters)
            t0 = time.perf_counter()
            out = run_mpc_cl.main(["--config", path, "--save_dir", out_dir])["reinforce"]
            got, n_iters = counts(), exp["reinforce"]["n_iters"]
            fused = exp["env_name"] == "sawyer_peg_insertion-v0"
            solves = episode_solves(CL_STEPS)    # the replayed episode's host launches
            want = expected(noise=solves * n_iters, cl=solves * n_iters if fused else 0)
            emit("run_mpc_cl", config=src, env=exp["env_name"], steps=CL_STEPS, n_iters=n_iters,
                 ep_reward=float(out["ep_rewards"][0]), fit_error=float(out["fit_errors"][0]),
                 launches=got, seconds=time.perf_counter() - t0)
            if (got != want or not np.isfinite(out["ep_rewards"]).all()
                    or not np.isfinite(out["fit_errors"]).all()):
                raise RuntimeError(f"run_mpc_cl {src}: launches {got}, expected {want}, "
                                   f"{out}")
        exp = hconfig.load_config(JOBS_TUNE)
        section = dict(exp["mppi"], horizon=exp["mppi"]["horizon"][:1],
                       n_iters=exp["mppi"]["n_iters"][:1],
                       particles_per_cpu=exp["mppi"]["particles_per_cpu"][:1])
        path = cut_config(exp, out_dir, "tune.yml", n_episodes=1, max_ep_length=JOBS_STEPS,
                          mppi=section)
        reset_counts(*counters)
        t0 = time.perf_counter()
        best, history = jobs.main(["--config", path, "--controller", "mppi", "--job_mode",
                                   "tune", "--save_dir", out_dir])["mppi"]
        got, cells = counts(), len(history)
        solves = cells * episode_solves(JOBS_STEPS)   # a batched episode of one a cell
        want = expected(forest_batch=solves, noise_batch=solves)
        emit("jobs", mode="tune", config=JOBS_TUNE, cells=cells, steps=JOBS_STEPS, best=best,
             history=history, launches=got, seconds=time.perf_counter() - t0)
        if (cells != 2 or got != want
                or not all(np.isfinite(r["average_reward"]) for r in history)):
            raise RuntimeError(f"jobs tune: {cells} cells, launches {got}, expected {want}")
        exp = hconfig.load_config(JOBS_SWEEP)
        reset_counts(*counters)
        t0 = time.perf_counter()
        rows = jobs.main(["--config", JOBS_SWEEP, "--controller", "mppi", "--job_mode", "sweep",
                          "--save_dir", out_dir])["mppi"]
        solves = exp["n_episodes"] * episode_solves(exp["max_ep_length"])
        got = counts()
        emit("jobs", mode="sweep", config=JOBS_SWEEP, rows=rows, launches=got,
             seconds=time.perf_counter() - t0)
        if len(rows) != 1 or got != expected(noise=solves) or not np.isfinite(
                rows[0]["average_reward"]):
            raise RuntimeError(f"jobs sweep: {rows}, launches {got}")


def learned_phases(device, counters, counts, expected, smi: str):
    """Phases 21-23 of the docstring: softq, rsnn, sac_mpc (with
    sacq_eval). Returns (runs, graph solves): runs maps a label to (solve,
    solver, env, env state) for learned_timing; the graph solves are
    SoftQMPC on cartpole and RandomShootingNN on the pendulum (phase 16)."""
    import torch
    from mjmpc_tpu_torch import envs, solvers
    from mjmpc_tpu_torch.harness import config as hconfig
    from mjmpc_tpu_torch.harness import sacq_eval
    from mjmpc_tpu_torch.rl import SACMPC

    def sync_free_run(phase, solve, s, e, es, state0, **fields):
        """One warm-up solve (a new env's kernel wrappers load their
        libraries, torch.func traces), then ZOO_SOLVES sync-free solves
        from state0 with the counts from 0."""
        solve(e.params, es, state0)
        reset_counts(*counters)
        t0 = time.perf_counter()
        action_host, state = sync_free(solve, e, es, state0, ZOO_SOLVES)
        seconds = time.perf_counter() - t0
        got = counts()
        emit(phase, env=e.name, n=s.num_particles, h=s.horizon, solves=ZOO_SOLVES,
             launches=got, action=action_host.tolist(), step=int(state.step), seconds=seconds,
             solves_per_s=ZOO_SOLVES / seconds, card=smi, **fields)
        return got, state

    # 21. softq: each config's block, sync-free; its Q moves and stays finite
    runs = {}
    for name, path in SOFTQ_CONFIGS.items():
        exp = hconfig.load_config(path)
        e = envs.make(exp["env_name"], device=device)
        es = e.init(e.params, 1)
        s = hconfig.make_solver_for_env(exp, "softq", e)
        solve, state0 = solvers.make_solve_fn(s, e), s.init_state(0)
        got, state = sync_free_run("softq", solve, s, e, es, state0, config=path, lam=s.lam,
                                   lr=s.lr, n_grad_steps=s.n_grad_steps, grad_clip=s.grad_clip)
        moved = max(float((a - b).abs().max()) for a, b in zip(state.q_params, state0.q_params))
        finite = all(bool(torch.isfinite(x).all()) for x in state.q_params)
        emit("softq_q", env=name, q_moved=moved, q_finite=finite)
        if got != expected(noise=ZOO_SOLVES * s.n_iters) or not moved > 0 or not finite:
            raise RuntimeError(f"softq {name}: launches {got}, Q moved {moved}, finite {finite}")
        runs[f"softq_{name}"] = (solve, s, e, es)

    # 22. RandomShootingNN on the pendulum: one noise-kernel launch a solve
    pend = envs.make("SimplePendulum-v0", device=device)
    s = solvers.RandomShootingNN(d_obs=pend.d_obs, d_action=pend.d_action, device=device, **RSNN)
    solve, es = solvers.make_solve_fn(s, pend), pend.init(pend.params, 1)
    got, state = sync_free_run("rsnn", solve, s, pend, es, s.init_state(0),
                               hidden=list(RSNN["hidden"]))
    if got != expected(noise=ZOO_SOLVES) or not bool(torch.isfinite(state.mean).all()):
        raise RuntimeError(f"rsnn: launches {got}, expected {expected(noise=ZOO_SOLVES)}")
    runs["rsnn_SimplePendulum-v0"] = (solve, s, pend, es)

    # 23. SACMPC on the reacher at its defaults: MPPIQ with the SAC Q on
    # kernel #3, once a control step; the SAC Q-loss falls; then sacq_eval
    reacher = envs.make("reacher_7dof-v0", device=device)
    m = SACMPC(reacher, seed=0)
    es = reacher.init(reacher.params, 1)

    def sac_solve(params, env_state, state):
        return m.solve_with_q(params, env_state, state, m.sac_params.q)

    got, _ = sync_free_run("sac_mpc_solve", sac_solve, m.solver, reacher, es,
                           m.solver.init_state(0))
    if got != expected(obs=ZOO_SOLVES, noise=ZOO_SOLVES):
        raise RuntimeError(f"sac_mpc solve: launches {got}")
    reset_counts(*counters)
    t0 = time.perf_counter()
    rewards = m.train(**SAC_TRAIN)
    seconds = time.perf_counter() - t0
    got, steps = counts(), SAC_TRAIN["n_steps"]
    losses = [float(i["q_loss"]) for i in m.update_info]
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    emit("sac_mpc", env=reacher.name, h=m.horizon, n=m.num_particles, batch=m.batch_size,
         **SAC_TRAIN, launches=got, obs_launches_per_control_step=got["obs"] / steps,
         episode_rewards=rewards, updates=len(losses), q_loss_first10=first,
         q_loss_last10=last, alpha=float(m.update_info[-1]["alpha"]), seconds=seconds,
         control_steps_per_s=steps / seconds, card=smi)
    want = expected(obs=steps, noise=steps)
    if (got != want or len(rewards) != 2 or not np.isfinite(rewards).all()
            or len(losses) != steps - SAC_TRAIN["min_buffer"] + 1 or not last < first):
        raise RuntimeError(f"sac_mpc train: launches {got}, expected {want}, rewards {rewards}, "
                           f"Q-loss {first} -> {last}")
    runs["sac_mpc_reacher_7dof-v0"] = (sac_solve, m.solver, reacher, es)
    reset_counts(*counters)
    t0 = time.perf_counter()
    rows = sacq_eval.main(SACQ_EVAL)
    got = counts()
    # training's control steps and the MPPIQ+SAC-Q arm on #3, the other two
    # arms on #1, one noise launch every solve the host launches (each arm's
    # episode is replayed; the mppi arm's a batched episode of one, on the
    # batched entries)
    arm = episode_solves(SACQ_STEPS)
    want = expected(obs=SACQ_TRAIN + arm, chain=arm, chain_batch=arm, noise=SACQ_TRAIN + 2 * arm,
                    noise_batch=arm)
    emit("sacq_eval", args=SACQ_EVAL, rows=rows, launches=got, seconds=time.perf_counter() - t0)
    if got != want or [r["arm"] for r in rows] != ["mppi", "mppiq", "mppiq+sacq"] or not all(
            np.isfinite(r["avg_reward"]) for r in rows):
        raise RuntimeError(f"sacq_eval: launches {got}, expected {want}, rows {rows}")
    graph = {k: runs[k] for k in ("softq_cartpole-v0", "rsnn_SimplePendulum-v0")}
    return runs, {k: (solve, e, es, s.init_state(0)) for k, (solve, s, e, es) in graph.items()}


LEARNED_HEAVY = "softq_sawyer_reacher-v0"


def learned_timing(runs, smi: str) -> None:
    """Read-verified solves/s and the profiler's kernels, device ms and
    busy share per solve of the learned-model runs but LEARNED_HEAVY: its
    solve runs the engine's general rollout, tens of thousands of launches
    that take the profiler minutes to read back, so its rate is that of
    its 3 sync-free solves of phase 21 and tools/learned_runs.py --only
    profile profiles it. Printed, not asserted."""
    for key, (solve, s, e, es) in runs.items():
        if key == LEARNED_HEAVY:
            continue
        rate, windows, _ = solves_per_s(solve, e, es, s.init_state(0), 5, 3)
        emit("learned_solves_per_s", run=key, env=e.name, n=s.num_particles, h=s.horizon,
             card=smi, solves_per_s=rate, windows=windows)
        profile(solve, e, es, s.init_state(0), smi, 5, 1, run=key, env=e.name)


def analytic_timing(runs, smi: str, device) -> None:
    """Read-verified solves/s of every analytic run but the engine's (whose
    3 sync-free solves of phase 13 give theirs), the profiler's device ms
    per solve of the light runs (LIGHT_PROFILES; a solve of tens of
    thousands of launches takes the profiler minutes to read back, so the
    heavy runs are profiled by tools/analytic_episodes.py --only profile),
    and the real env step of every analytic env. Printed, not asserted."""
    import torch
    from mjmpc_tpu_torch import envs
    for (config, controller), (solve, s, e, es, state) in runs.items():
        if e.name in ENGINE_ENVS:
            continue
        light = (e.name, controller) in LIGHT_PROFILES
        rate, windows, _ = solves_per_s(solve, e, es, state, *((5, 3) if light else (2, 1)))
        emit("analytic_solves_per_s", config=config, env=e.name, controller=controller,
             n=getattr(s, "num_particles", 1), h=s.horizon, n_iters=s.n_iters, card=smi,
             solves_per_s=rate, windows=windows)
        if light:
            profile(solve, e, es, s.init_state(0), smi, 5, 1, solver=controller, env=e.name,
                    config=config)
    for name in ("LQR-v0", "point_mass-v0", "cartpole-v0", "acrobot-v0", "trajopt_reacher-v0",
                 "maze-v0", "continual_maze-v0"):
        e = envs.make(name, device=device)
        st, step_ms = e.init(e.params, 1), []
        zero = torch.zeros(e.d_action, device=e.device)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _, _, _ = e.step(e.params, st, zero)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        emit("analytic_env_step", env=name, card=smi, env_step_ms=statistics.median(step_ms),
             env_step_ms_all=step_ms)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from mjmpc_tpu_torch import bounds, envs, ops, rng, solvers
        from mjmpc_tpu_torch.envs import half_cheetah, hammer, swimmer
        from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
        from mjmpc_tpu_torch.harness import config as hconfig
        from mjmpc_tpu_torch.harness import run_mpc
        from mjmpc_tpu_torch.harness.episode import run_episodes
        from mjmpc_tpu_torch.ops.chain_rollout import (TEAM_SIZES, ChainClRollout,
                                                       ChainExtRollout, ChainObsRollout,
                                                       ChainRollout)
        from mjmpc_tpu_torch.ops import forest_rollout as fr
        from mjmpc_tpu_torch.ops.forest_rollout import ForestRollout, gated_cost_agreement
        from mjmpc_tpu_torch.ops import pendulum as pend
        from mjmpc_tpu_torch.ops.noise import FilteredNoise, PhiloxUniforms
        from mjmpc_tpu_torch.rollout import Trajectories
        from mjmpc_tpu_torch.solvers.reinforce import closed_loop_rollout
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    counters, counts, expected = launch_counters()

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
    forest_envs = {name: envs.make(name, device=device) for name in FOREST_CONFIGS}
    forest_rolls = {name: bounds.forest_builder(name)(forest_envs[name].params.model)
                    for name in FOREST_CONFIGS}
    pend_env = envs.make("SimplePendulum-v0", device=device)
    dyn = dyn_envs(device)      # the perturbed models' kernels, built with the rest
    dyn_reacher = dyn[DYN_REACHER[0]].fused_rollout.kernel
    t0 = time.perf_counter()
    # (task, team, builder): the chain libraries at every team size, then
    # one library each
    builders = [(task, t, functools.partial(r.library, t))
                for task, r in (("reacher", roll), ("peg", peg_cl)) for t in TEAM_SIZES]
    builders += [(task, None, build) for task, build in (
        (None, sampler.library), ("swimmer", loco_rolls["Swimmer-v0"].library),
        ("cheetah", loco_rolls["HalfCheetah-v0"].library),
        ("pendulum", pend.library))]
    builders += [(f"forest_{name}", None, r.library) for name, r in forest_rolls.items()]
    builders += [("reacher_perturbed", t, functools.partial(dyn_reacher.library, t))
                 for t in sorted({dyn_reacher.team_for(n, device)
                                  for n in [NUM_PARTICLES] + [c[0] for c in DYN_CHECKS]})]
    builders += [(f"forest_{name}_perturbed", None, dyn[name].fused_rollout.kernel.library)
                 for name in DYN_FOREST]
    with concurrent.futures.ThreadPoolExecutor(len(builders)) as pool:
        futures = [pool.submit(b) for _, _, b in builders]
        libs = [f.result() for f in futures]
    roll_cl.library()     # the same libraries, loaded
    for t in TEAM_SIZES:
        roll_obs.library(t)
        peg_obs.library(t)
    for lib, (task, team, _) in zip(libs, builders):
        emit("build", task=task, team=team, seconds=round(time.perf_counter() - t0, 3),
             nvcc_seconds=round(lib.build_seconds, 3), library=str(lib.path.name),
             ptxas=[ln.strip() for ln in lib.ptxas.splitlines()
                    if re.search(r"registers|spill|stack|smem|Compiling entry", ln)])

    # 3. each kernel against its plain version, on the card; kernels #1 and
    # #3 (the costs and obs rollouts) for the reacher and the peg's obs
    # rollout: two launches and every team size bit for bit, and the check's
    # power at (37, 5)
    errors = {}
    outputs = lambda x: x if isinstance(x, tuple) else (x,)
    for task, r, n, h, tol, seed in (
            ("reacher", roll, 37, 5, 5e-5, 1), ("reacher", roll, 1, 5, 5e-5, 2),
            ("reacher", roll, NUM_PARTICLES, HORIZON, 1e-3, 0),
            ("reacher", roll_obs, 37, 5, 5e-5, 1), ("reacher", roll_obs, 1, 5, 5e-5, 2),
            ("reacher", roll_obs, NUM_PARTICLES, HORIZON, 1e-3, 0),
            ("peg", peg_obs, 37, 5, 5e-5, 9), ("peg", peg_obs, 1, 5, 5e-5, 10)):
        args = reacher_inputs(n, h, seed, device)
        if task == "peg":
            args[2] = peg_extras(peg_env.params)
        got, again, want = outputs(r(*args)), outputs(r(*args)), outputs(r.plain(*args))
        by_team = [outputs(r(*args, team=t)) for t in TEAM_SIZES]
        torch.cuda.synchronize()
        name = "chain_rollout" if r.mode == "costs" else "chain_obs_rollout"
        shapes = ((n, h),) if r.mode == "costs" else ((n, h, r.d_obs), (n, h))
        if tuple(tuple(x.shape) for x in got) != shapes or not all(
                bool(torch.isfinite(x).all()) for x in got):
            raise RuntimeError(f"{name} kernel output bad for {task} at N={n} H={h}")
        if not all(torch.equal(x, y) for other in [again] + by_team for x, y in zip(got, other)):
            raise RuntimeError(f"{name} kernel: two launches or two team sizes differ for "
                               f"{task} at N={n} H={h}")
        errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        err = errors[(r.mode, task, n, h)] = max(errs)
        fields = dict(name=name, task=task, n=n, h=h, team=r.team_for(n), max_abs_err=err,
                      atol=tol, launches_identical=True, team_sizes_identical=list(TEAM_SIZES),
                      max_abs_err_per_output=errs, costs_min=float(want[-1].min()),
                      costs_max=float(want[-1].max()))
        if (n, h) == (37, 5):   # the check's power: a kernel that ignores the actions fails it
            zeroed = outputs(r.plain(*args[:3], torch.zeros_like(args[3]),
                                     torch.zeros_like(args[4])))
            fields["zeroed_actions_err"] = max(float((x - y).abs().max())
                                               for x, y in zip(got, zeroed))
            if not fields["zeroed_actions_err"] > 10 * tol:
                raise RuntimeError(f"{name} check too weak: {fields}")
        emit("kernel", **fields)
        if not err <= tol:
            raise RuntimeError(f"{name} kernel disagrees with its plain version for {task} at "
                               f"N={n} H={h}: {err} > {tol}")
    reacher_target = reacher_inputs(1, 1, 0, device)[2]
    cl_args = {}
    for task, r, extras, n, h, tol, seed in (
            ("reacher", roll_cl, reacher_target, 37, 5, 5e-5, 3),
            ("reacher", roll_cl, reacher_target, 1, 5, 5e-5, 7),
            ("reacher", roll_cl, reacher_target, NUM_PARTICLES, HORIZON, 1e-3, 4),
            ("peg", peg_cl, peg_extras(peg_env.params), 37, 5, 5e-5, 5),
            ("peg", peg_cl, peg_extras(peg_env.params), 1, 5, 5e-5, 8),
            ("peg", peg_cl, peg_extras(peg_env.params), PEG_CL["num_particles"],
             PEG_CL["horizon"], 1e-3, 6)):
        args = cl_args[(task, n, h)] = cl_inputs(r.d_obs, extras, n, h, seed, device)
        got, again, want = r(*args), r(*args), r.plain(*args)
        torch.cuda.synchronize()
        shapes = ((n, h, r.d_obs), (n, h, D_ACTION), (n, h))
        if tuple(tuple(x.shape) for x in got) != shapes or not all(
                bool(torch.isfinite(x).all()) for x in got):
            raise RuntimeError(f"closed-loop kernel output bad for {task} at N={n} H={h}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"closed-loop kernel: two launches differ for {task} at N={n}")
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        errors[("cl", task, n, h)] = err
        fields = dict(name="chain_cl_rollout", task=task, n=n, h=h, team=r.team_for(n),
                      max_abs_err=err, atol=tol, launches_identical=True,
                      max_abs_err_obs_actions_costs=[float((x - y).abs().max())
                                                     for x, y in zip(got, want)],
                      actions_abs_max=float(want[1].abs().max()),
                      costs_min=float(want[2].min()), costs_max=float(want[2].max()))
        if (n, h) == (37, 5):   # the check's power: a kernel that ignores the actions fails it
            zeroed = r.plain(*args[:3], torch.zeros_like(args[3]), torch.zeros_like(args[4]))
            fields["zeroed_actions_err_obs_costs"] = max(
                float((x - y).abs().max()) for x, y in ((got[0], zeroed[0]), (got[2], zeroed[2])))
            if not fields["zeroed_actions_err_obs_costs"] > 10 * tol:
                raise RuntimeError(f"closed-loop check too weak: {fields}")
        emit("kernel", **fields)
        if not err <= tol:
            raise RuntimeError(f"closed-loop kernel disagrees with its plain version for "
                               f"{task} at N={n} H={h}: {err} > {tol}")

    # kernel #2 at step 5 (a device tensor); its check's power: step 6
    step5, step6 = rng.step_tensor(5, device), rng.step_tensor(6, device)
    for n, h, d_action in bounds.NOISE_SIZES:
        key = rng.stream_key(7, n)
        cov3 = 3.0 * torch.eye(d_action, device=device)
        got, again = sampler(key, step5, cov3, (n, h), FILTER), sampler(key, step5, cov3, (n, h),
                                                                         FILTER)
        want = sampler.plain(key, step5, cov3, (n, h), FILTER)
        white = sampler.white(key, step5, n, h, d_action, FILTER)
        want_white = sampler.white_plain(key, step5, n, h, d_action, FILTER)
        other = sampler.plain(key, step6, cov3, (n, h), FILTER)
        torch.cuda.synchronize()
        if got.shape != (n, h, d_action) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"noise kernel output bad at {(n, h, d_action)}")
        err = float((got - want).abs().max())
        err_white = float((white - want_white).abs().max())
        other_err = float((other - got).abs().max())
        errors[("noise", n, h, d_action)] = err
        emit("kernel", name="filtered_noise", n=n, h=h, d_action=d_action, max_abs_err=err,
             max_abs_err_uncoloured=err_white, atol=1e-4, launches_identical=torch.equal(
                 got, again), other_step_err=other_err, std=float(want.std()))
        if not max(err, err_white) <= 1e-4 or not torch.equal(got, again):
            raise RuntimeError(f"noise kernel disagrees with its plain version at "
                               f"{(n, h, d_action)}: {err}, {err_white} > 1e-4")
        if not other_err > 10 * 1e-4:
            raise RuntimeError(f"noise check too weak at {(n, h, d_action)}: {other_err}")
    for n in (1, 7, 4096):
        got, want = ops.uniforms(11, step5, n), ops.uniforms.plain(11, step5, n)
        torch.cuda.synchronize()
        emit("kernel", name="philox_uniforms", n=n, identical=torch.equal(got, want))
        if not torch.equal(got, want):
            raise RuntimeError(f"uniforms kernel differs from its plain version at n={n}")

    # kernel #7 from the crossing start: two launches and every particles-a-
    # block size bit for bit; its check's power: the plain version with the
    # noise zeroed
    pend_args = {}
    for n, h, seed in ((37, 5, 30), (NUM_PARTICLES, HORIZON, 31), (24, HORIZON, 32),
                       (64, HORIZON, 33), (2048, HORIZON, 35)):
        args = pend_args[(n, h)] = pendulum_inputs(pend_env, n, h, seed, device)
        got, want = pend.pendulum_rollout(*args), pend.pendulum_rollout.plain(*args)
        again = pend.pendulum_rollout(*args)
        by_block = {b: pend.pendulum_rollout(*args, per_block=b) for b in pend.ROLLOUT_PER_BLOCK}
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"pendulum kernel output bad at N={n} H={h}")
        if not all(torch.equal(got, x) for x in [again, *by_block.values()]):
            raise RuntimeError(f"pendulum kernel: two launches or two partitions differ at "
                               f"N={n} H={h}")
        err = float((got - want).abs().max())
        errors[("pendulum", n, h)] = err
        fields = dict(name="pendulum_rollout", n=n, h=h, per_block=pend.rollout_per_block(n, h),
                      max_abs_err=err, atol=1e-5, launches_identical=True,
                      per_block_identical=list(by_block), costs_min=float(want.min()),
                      costs_max=float(want.max()))
        if (n, h) == (37, 5):
            zeroed = pend.pendulum_rollout.plain(*args[:3], torch.zeros_like(args[3]))
            fields["zeroed_noise_err"] = float((zeroed - got).abs().max())
            if not fields["zeroed_noise_err"] > 10 * 1e-5:
                raise RuntimeError(f"pendulum check too weak: {fields}")
        emit("kernel", **fields)
        if not err <= 1e-5:
            raise RuntimeError(f"pendulum kernel disagrees with its plain version at N={n} "
                               f"H={h}: {err} > 1e-5")
    # kernel #8 at step 3; its check's power: step 4; two launches bit for
    # bit; every cluster size the kernel can take at the same tolerance
    solve8_args = {}
    step3, step4 = rng.step_tensor(3, device), rng.step_tensor(4, device)
    for n, _ in bounds.PENDULUM_SIZES[8]:
        for lam in (0.01, 1.0):
            params, state, mean, _ = pendulum_inputs(pend_env, 1, HORIZON, 34, device)
            cfg8 = dict(ONE_KERNEL, num_particles=n, lam=lam)
            args = solve8_args[(n, lam)] = (params, state, mean, 77, step3)
            got, again = (pend.mppi_pendulum_solve(*args, **cfg8),
                          pend.mppi_pendulum_solve(*args, **cfg8))
            want = pend.mppi_pendulum_solve.plain(*args, **cfg8)
            other = pend.mppi_pendulum_solve.plain(*args[:4], step4, **cfg8)
            by_cluster = {}
            for ctas in pend.CLUSTER_SIZES:
                try:
                    pend.solve_shape(pend.sampled_particles(n), HORIZON, ctas)
                except ValueError:
                    continue
                if pend.max_active_clusters(pend.sampled_particles(n), HORIZON, ctas) < 1:
                    continue
                by_cluster[ctas] = pend.mppi_pendulum_solve(*args, **cfg8, ctas=ctas)
            torch.cuda.synchronize()
            if got.shape != (HORIZON, 1) or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"one-kernel solve output bad at N={n}")
            err = float((got - want).abs().max())
            other_err = float((other - got).abs().max())
            cluster_errs = {c: float((x - want).abs().max()) for c, x in by_cluster.items()}
            errors[("solve8", n, lam)] = err
            emit("kernel", name="mppi_pendulum_solve", n=n, h=HORIZON, lam=lam,
                 ctas=pend.solve_cluster(pend.sampled_particles(n)), max_abs_err=err, atol=1e-5,
                 launches_identical=torch.equal(got, again), other_step_err=other_err,
                 max_abs_err_by_cluster=cluster_errs, mean_abs_max=float(want.abs().max()))
            if (not err <= 1e-5 or not other_err > 10 * 1e-5 or not torch.equal(got, again)
                    or not all(e_ <= 1e-5 for e_ in cluster_errs.values())):
                raise RuntimeError(f"one-kernel solve check failed at N={n} lam={lam}: {err}, "
                                   f"another step {other_err}, clusters {cluster_errs}")

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
             step=int(state.step))
        want = expected(chain=N_SOLVES, **noise_launches(s, N_SOLVES))
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
        want = expected(**noise_launches(s, ZOO_SOLVES), **{roll_key: ZOO_SOLVES})
        if got != want:
            raise RuntimeError(f"zoo {key}: launches {got}, expected {want}")

    # 6. guard_finite around a solve that goes non-finite
    nan_env = dataclasses.replace(env, fused_rollout=lambda p, s, mean, noise: torch.full(
        noise.shape[:2], float("nan"), device=noise.device))
    guarded = solvers.guard_finite(solvers.make_solve_fn(solver_k, nan_env), solver_k)
    state = dataclasses.replace(solver_k.init_state(0), step=rng.step_tensor(3, device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, value, state = guarded(env.params, env_state, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fresh = solver_k.init_state(0)
    ok = (bool((action == 0).all()) and float(value) == 0.0 and int(state.step) == 4
          and bool(torch.equal(state.mean, fresh.mean))
          and bool(torch.equal(state.cov, fresh.cov)))
    emit("guard", action=action.cpu().numpy().tolist(), value=float(value),
         step=int(state.step), reset=ok)
    if not ok:
        raise RuntimeError("guard_finite did not reset the non-finite solve")

    # 7. the closed loop: Reinforce on the reacher and with the peg config
    rf = solvers.Reinforce(d_obs=env.d_obs, d_action=D_ACTION, device=device, **RF_REACHER)
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
             action=action_host.tolist(), fit_error=float(state.fit_error),
             step=int(state.step))
        want = expected(cl=ZOO_SOLVES * s.n_iters, **noise_launches(s, ZOO_SOLVES))
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
        for n, h, tol, scaled, seed in checks:
            args = loco_args[(name, n, h)] = loco_inputs(r.model.nv, n, h, seed, device)
            got, again, want = r(*args), r(*args), r.plain(*args)
            torch.cuda.synchronize()
            if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"ext kernel output bad for {name} at N={n} H={h}")
            if not torch.equal(got, again):
                raise RuntimeError(f"ext kernel: two launches differ for {name} at N={n} H={h}")
            scale = torch.clamp(want.abs(), min=1.0) if scaled else 1.0
            err = float(((got - want) / scale).abs().max())
            errors[("ext", name, n, h)] = err
            fields = dict(env=name, n=n, h=h, team=r.team, max_abs_err=err, atol=tol,
                          scaled_by_cost=scaled, launches_identical=True,
                          max_abs_err_unscaled=float((got - want).abs().max()),
                          costs_min=float(want.min()), costs_max=float(want.max()))
            if (n, h) == (37, 5):   # the check's power, as for the closed loop
                zeroed = r.plain(*args[:2], torch.zeros_like(args[2]), torch.zeros_like(args[3]))
                fields["zeroed_actions_err"] = float(((got - zeroed) / scale).abs().max())
                if not fields["zeroed_actions_err"] > 10 * tol:
                    raise RuntimeError(f"ext check too weak: {fields}")
            emit("loco_kernel", **fields)
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
             solves=ZOO_SOLVES, launches=got, action=action_host.tolist(),
             step=int(state.step))
        want = expected(ext=ZOO_SOLVES, **noise_launches(s, ZOO_SOLVES))
        if got != want or action_host.shape != (e.d_action,):
            raise RuntimeError(f"loco {name}: launches {got}, expected {want}")

    # 10. kernel #6 against its plain version, every task
    forest_args, forest_plain_ms = {}, {}
    bonus_steps = {"pen-v0": fr.PEN_BONUS_STEPS, "relocate-v0": fr.RELOCATE_BONUS_STEPS,
                   "hammer-v0": fr.HAMMER_BONUS_STEPS, "door-v0": fr.DOOR_BONUS_STEPS,
                   "panda_tray_glass-v0": fr.TRAY_FALL_STEPS,
                   "panda_tray_glass-v1": fr.TRAY_FALL_STEPS,
                   "panda_tray_glass_fixed-v1": fr.TRAY_FALL_STEPS}
    for name, start, n, h, tol, seed in FOREST_CHECKS:
        r = forest_rolls[name]
        args = forest_inputs(forest_envs[name], r, n, h, seed, device, start)
        got, again = r(*args), r(*args)
        # the plain version timed as it runs: at the config's size this is
        # the `kernels` line's plain_ms (a call takes up to seconds)
        want, forest_plain_ms[(name, n, h)] = cuda_call_ms(lambda: r.plain(*args))
        if start != "spin":
            forest_args[(name, n, h)] = args
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"forest kernel output bad for {name} at N={n} H={h}")
        if not torch.equal(got, again):
            raise RuntimeError(f"forest kernel: two launches differ for {name} at N={n} H={h}")
        err = float((got - want).abs().max())
        errors[("forest" if start != "spin" else "forest_spin", name, n, h)] = err
        fields = dict(env=name, start=start, n=n, h=h, team=r.team, max_abs_err=err,
                      launches_identical=True, costs_min=float(want.min()),
                      costs_max=float(want.max()))

        def check(costs):
            """(passes, fields): tol at (37, H) and N=1, the gated-cost rule
            at the config's size."""
            if tol is not None:
                return float((costs - want).abs().max()) <= tol, dict(atol=tol)
            agree = gated_cost_agreement(costs, want, 1e-3, bonus_steps[name])
            return agree["share_within"] >= 0.99 and agree["other"] == 0, dict(
                atol=1e-3, share_within=agree["share_within"],
                entries_off_by_a_bonus_step=agree["bonus_steps"],
                entries_off_otherwise=agree["other"])

        ok, more = check(got)
        if name != "sawyer_peg_insertion-v0" and n > 1 and start != "spin":
            # the check's power: a kernel that ignores the actions fails it
            zeroed = r.plain(*args[:3], torch.zeros_like(args[3]), torch.zeros_like(args[4]))
            zeroed_ok, zeroed_fields = check(zeroed)
            fields.update(zeroed_actions_err=float((zeroed - want).abs().max()),
                          zeroed_actions=zeroed_fields)
            if zeroed_ok or (tol is not None and not fields["zeroed_actions_err"] > 10 * tol):
                raise RuntimeError(f"{name} check too weak at N={n} H={h}: {fields}")
        if start == "spin":
            # the hammer's coupled 6x6 solve: its header has the branch on,
            # and the plain version with the decoupled branch in its place
            # misses the kernel by far
            header_on = ("constexpr bool HAS_COUPLED = true;" in r.header
                         and r.consts["free_consts"][hammer.HAMMER_BODY]["coupled"])
            consts = copy.deepcopy(r.consts)
            consts["free_consts"][hammer.HAMMER_BODY]["coupled"] = False
            decoupled = fr.rollout_forest_plain(r.model, r.n_substeps, r.act_bodies, r.task,
                                                r.ulow, r.uhigh, *args, consts=consts)
            fields.update(header_coupled=header_on,
                          decoupled_err=float((decoupled - got).abs().max()))
            if not header_on or not fields["decoupled_err"] > 10 * tol:
                raise RuntimeError(f"hammer coupled-branch check too weak: {fields}")
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
             launches=got, action=action_host.tolist(), step=int(state.step))
        want = expected(forest=ZOO_SOLVES * s.n_iters, **noise_launches(s, ZOO_SOLVES))
        if got != want or action_host.shape != (e.d_action,):
            raise RuntimeError(f"hand {name}: launches {got}, expected {want}")

    # 12. the pendulum config through harness.config, full size, and the
    # closed loop on kernel #8
    pend_exp = hconfig.load_config(PENDULUM_CONFIG)
    pend_runs, pend_counts = {}, {}
    for controller in PENDULUM_CONTROLLERS:
        s = hconfig.make_solver_for_env(pend_exp, controller, pend_env)
        es, state = pend_env.init(pend_env.params, 1), s.init_state(0)
        solve = solvers.make_solve_fn(s, pend_env)
        reset_counts(*counters)
        action_host, state = sync_free(solve, pend_env, es, state, ZOO_SOLVES)
        pend_counts[controller] = got = counts()
        pend_runs[controller] = (solve, s, es, state)
        emit("pendulum", controller=controller, config=PENDULUM_CONFIG, n=s.num_particles,
             h=s.horizon, solves=ZOO_SOLVES, launches=got, action=action_host.tolist())
        want = expected(pendulum=ZOO_SOLVES, **noise_launches(s, ZOO_SOLVES))
        if got != want or action_host.shape != (1,):
            raise RuntimeError(f"pendulum {controller}: launches {got}, expected {want}")

    def one_kernel_loop(es, steps: int):
        """The JAX package's closed loop on kernel #8: solve, step with the
        clipped first action, shift the mean with a zero last row, advance
        the step on the device; the rewards stay on the device."""
        solve = one_kernel_solve_fn(ONE_KERNEL["num_particles"])
        state, rewards = one_kernel_start(device), []
        for _ in range(steps):
            action, _, state = solve(pend_env.params, es, state)
            es, _, reward, _ = pend_env.step(pend_env.params, es, pend_env.clip_action(action))
            rewards.append(reward)
        return torch.stack(rewards), state.mean

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

    # 13-15. the analytic envs' configs, iLQR on LQR, checkpoints
    analytic_runs, analytic_graph = analytic_phases(device, counters, counts, expected, smi)

    # 21-23. the learned-model family: softq, RSNN, SACMPC and sacq_eval
    learned_runs, learned_graph = learned_phases(device, counters, counts, expected, smi)

    # 16. one solve of each family captured as a CUDA graph and replayed
    graph_solves = {
        "mppi_kernel_noise_guarded": (solvers.guard_finite(solvers.make_solve_fn(solver_k, env),
                                                           solver_k), env, env_state,
                                      solver_k.init_state(0)),
        "mppi_plain_noise": (solvers.make_solve_fn(solver, env), env, env_state,
                             solver.init_state(0)),
        "pfmpc": (zoo_solves["pfmpc"][0], env, env_state, zoo["pfmpc"].init_state(0)),
        "reinforce_peg_cl": (cl_runs["peg"][0], peg_env, cl_runs["peg"][3],
                             rf_peg.init_state(0)),
        "one_kernel_n1024": (one_kernel_solve_fn(ONE_KERNEL["num_particles"]), pend_env,
                             loop_start, one_kernel_start(device)),
    }
    for name in ("relocate-v0", "hammer-v0") + ARM_ENVS + ("door-v0",):
        solve, s, e, es, _, _ = hand_runs[name]
        graph_solves[f"mppi_{name}"] = (solve, e, es, s.init_state(0))
    graph_solves.update(analytic_graph)
    graph_solves.update(learned_graph)
    graph_results = {}
    for name, (solve, e, es, state) in graph_solves.items():
        reset_counts(*counters)
        graph_results[name] = graph_check(name, solve, e, es, state,
                                          draws_noise=not name.startswith("ilqr"))

    # 17. the episode runner with each config's own solver(s)
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
    # run_mpc itself on the relocate and hammer configs and on every config
    # of the tasks added since, full size, one episode cut to RUN_MPC_STEPS
    # control steps; the forest kernel's count rises by the solves' launches
    with tempfile.TemporaryDirectory() as out_dir:
        for k, (name, config) in enumerate(RUN_MPC_CONFIGS.items()):
            exp = dict(hconfig.load_config(config), n_episodes=1, max_ep_length=RUN_MPC_STEPS)
            path = cut_config(exp, out_dir, f"{k}.yml")
            reset_counts(*counters)
            t0 = time.perf_counter()
            out = run_mpc.main(["--config", path, "--controller", "mppi", "--save_dir", out_dir])
            rewards = out["mppi"]["rewards"]
            emit("run_mpc", env=name, config=config, controller="mppi",
                 n=exp["mppi"]["num_cpu"] * exp["mppi"]["particles_per_cpu"],
                 h=exp["mppi"]["horizon"], steps=RUN_MPC_STEPS, rewards=rewards[0].tolist(),
                 launches=counts(), seconds=time.perf_counter() - t0)
            # a replayed batched episode of one launches its first step and the captured one
            if (counts()["forest_batch"] != episode_solves(RUN_MPC_STEPS) * exp["mppi"]["n_iters"]
                    or counts()["forest"] != 0):
                raise RuntimeError(f"run_mpc {name}: launches {counts()}")
            if rewards.shape != (1, RUN_MPC_STEPS) or not np.isfinite(rewards).all():
                raise RuntimeError(f"run_mpc {name}: rewards not finite")

    # 18-19. run_mpc_cl on both closed-loop configs, jobs in tune and sweep mode
    driver_phases(device, counters, counts, expected)

    # 24-27. kernels built from perturbed models, run_mpc
    # --dyn_randomize_config, the captured episode, parallel/ on one card
    dyn_times = dyn_kernel_phase(device, dyn, errors)
    dyn_run_mpc_phase(device, counters, counts, expected)
    replay_counts = episode_replay_phase(device, counters, counts, smi, solver, dyn)
    # the perturbed kernels' rows count executions: the eager runs of
    # phase 26's episodes, counters zeroed just before each
    dyn_counts = {"reacher": replay_counts["reacher_7dof-v0 perturbed"]["eager"],
                  "pen": replay_counts["pen-v0"]["eager"]}
    parallel_phase(device, counters, counts, expected, solver)
    # 28. render/ through run_mpc --dump_vids, initialize_multihost on NCCL
    render_phase(device, counters, counts, smi)
    # 29. the batched kernels and solve, benchmark --quick and forest_perf
    batched = benchmark_phase(device, counters, counts, expected, smi, env, roll, sampler)
    # 30. the batched entries of #5, #6 and #7 and the batched episode
    batched.update(batch_episodes_phase(device, counters, counts, expected, smi))

    # 20. timing (printed, not asserted)
    args = reacher_inputs(NUM_PARTICLES, HORIZON, 0, device)
    times = {
        "chain_rollout": (cuda_ms(lambda: roll(*args), 20), cuda_ms(lambda: roll.plain(*args), 2)),
        "chain_obs_rollout": (cuda_ms(lambda: roll_obs(*args), 20),
                              cuda_ms(lambda: roll_obs.plain(*args), 2)),
    }
    for n, h, d_action in bounds.NOISE_SIZES:      # kernel #2, uncoloured
        times[f"filtered_noise_{n}_{h}_{d_action}"] = (
            cuda_ms(lambda: sampler.white(5, step5, n, h, d_action, FILTER), 50),
            cuda_ms(lambda: sampler.white_plain(5, step5, n, h, d_action, FILTER), 5))
    times["filtered_noise"] = times[f"filtered_noise_{NUM_PARTICLES}_{HORIZON}_{D_ACTION}"]
    for n, h in OPEN_LOOP_SIZES:     # kernel #1 at the reacher configs' sizes
        more = reacher_inputs(n, h, 0, device)
        times[f"chain_rollout_n{n}_h{h}"] = (cuda_ms(lambda: roll(*more), 20),
                                             cuda_ms(lambda: roll.plain(*more), 2))
    for kname, r, key in (("chain_cl_rollout", roll_cl, ("reacher", NUM_PARTICLES, HORIZON)),
                          ("chain_cl_rollout_peg", peg_cl,
                           ("peg", PEG_CL["num_particles"], PEG_CL["horizon"]))):
        times[kname] = (cuda_ms(lambda: r(*cl_args[key]), 20),
                        cuda_ms(lambda: r.plain(*cl_args[key]), 2))
    cov3 = 3.0 * torch.eye(D_ACTION, device=device)
    sampler_ms = (cuda_ms(lambda: sampler(5, step5, cov3, (NUM_PARTICLES, HORIZON), FILTER), 50),
                  cuda_ms(lambda: solver.sample_noise(solver.init_state(5)), 5))
    emit("kernel_time", card=smi, sampler_with_colouring_ms=sampler_ms[0],
         plain_sampler_ms=sampler_ms[1],
         **{k: {"ms": v[0], "plain_ms": v[1]} for k, v in times.items()})
    for n, h, d_action in bounds.NOISE_SIZES:
        inst = bounds.noise_instance(n, h, d_action)
        key = f"filtered_noise_{n}_{h}_{d_action}"
        emit("kernel_noise", name="filtered_noise", n=n, h=h, d_action=d_action,
             ms=times[key][0], plain_ms=times[key][1], bound_ms=inst["bound_ms"],
             bound_by=inst["bound_by"], max_abs_err=errors[("noise", n, h, d_action)],
             ptxas=[ln.strip() for ln in sampler.library().ptxas.splitlines()
                    if re.search(r"registers|spill|stack|smem", ln)], card=smi)
    for key, r, n, h in [("chain_rollout", roll, NUM_PARTICLES, HORIZON),
                         ("chain_obs_rollout", roll_obs, NUM_PARTICLES, HORIZON)] + [
            (f"chain_rollout_n{n}_h{h}", roll, n, h) for n, h in OPEN_LOOP_SIZES]:
        team = r.team_for(n)
        bound_ms, bound_by = bounds.bound_ms(*bounds.chain_work(model, n, h, r.mode))
        emit("kernel_open_loop", name=key, mode=r.mode, n=n, h=h, team=team,
             ms=times[key][0], plain_ms=times[key][1], bound_ms=bound_ms, bound_by=bound_by,
             ptxas=[ln.strip() for ln in r.library(team).ptxas.splitlines()
                    if re.search(r"registers|spill|stack|smem", ln)], card=smi)

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
    graph_rates = {which: graph_solves_per_s(solve, env, env_state, s.init_state(0), 20, 5)
                   for which, (solve, s) in variants.items()}
    emit("graph_solves_per_s", card=smi, n=NUM_PARTICLES, h=HORIZON,
         **{k: v[0] for k, v in graph_rates.items()},
         **{k + "_windows": v[1] for k, v in graph_rates.items()},
         **{"eager_" + k: statistics.median(v) for k, v in rates.items()})
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

    # the forest configs: kernel #6 per call, solves/s, the hand envs' real
    # env step
    forest_times = {}
    for name, (solve, s, e, es, state, _) in hand_runs.items():
        r = forest_rolls[name]
        args = forest_args[(name, s.num_particles, s.horizon)]
        forest_times[name] = (cuda_ms(lambda: r(*args), 10),
                              forest_plain_ms[(name, s.num_particles, s.horizon)])
        rate, windows, _ = solves_per_s(solve, e, es, state, 10, 5)
        fields = {}
        if name != "sawyer_peg_insertion-v0":
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
    one_kernel_state = one_kernel_start(device)
    pend_rates["one_kernel_n2048"], _, _ = solves_per_s(one_kernel_solve_fn(2048), pend_env,
                                                        pend_es, one_kernel_state, 20, 5)
    emit("pendulum_time", card=smi,
         kernel_ms={f"#{k} N={n}": v[0] for (k, n), v in pend_times.items()},
         plain_ms={f"#{k} N={n}": v[1] for (k, n), v in pend_times.items()},
         solves_per_s=pend_rates, one_kernel_loop_seconds=loop_seconds)

    # the analytic configs' solves, iLQR on LQR and the analytic env steps
    analytic_timing(analytic_runs, smi, device)
    # the learned-model runs
    learned_timing(learned_runs, smi)

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

    for which, (solve, s) in variants.items():
        profile(solve, env, env_state, s.init_state(0), smi, noise_impl=which)
    for key, (solve, s, e, es, _) in cl_runs.items():
        profile(solve, e, es, s.init_state(0), smi, solver="reinforce", env=e.name)
    for name, (solve, s, e, es, _, _) in loco_runs.items():
        profile(solve, e, es, s.init_state(0), smi, solver="mppi", env=name)
    for name, (solve, s, e, es, _, _) in hand_runs.items():
        profile(solve, e, es, s.init_state(0), smi, solver="mppi", env=name)
    profile(pend_runs["mppi"][0], pend_env, pend_es, mppi_cfg.init_state(0), smi,
            solver="mppi", env="SimplePendulum-v0", n=mppi_cfg.num_particles)
    profile(one_kernel_solve_fn(2048), pend_env, pend_es, one_kernel_state, smi,
            solver="one_kernel_mppi", env="SimplePendulum-v0", n=2048)

    # the kernels' summary: launches from the paths' runs, bounds from
    # this run's shapes (the work does not depend on the data)
    n, h = NUM_PARTICLES, HORIZON
    bound = {r["number"]: (r["bound_ms"], r["bound_by"])
             for r in bounds.kernel_table(model, n, h)}
    rows = [
        ("chain_rollout", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
         "mjmpc_tpu/ops/pallas_chain.py:381", main_counts["main_kernel_noise"]["chain"],
         errors[("costs", "reacher", n, h)], bound[1]),
        ("filtered_noise", "mjmpc_tpu_torch/csrc/filtered_noise.cu",
         "mjmpc_tpu/ops/pallas_kernels.py:73", main_counts["main_kernel_noise"]["noise"],
         errors[("noise", n, h, D_ACTION)], bound[2]),
        ("chain_obs_rollout", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
         "mjmpc_tpu/ops/pallas_chain.py:572", zoo_counts["mppiq_q"]["obs"],
         errors[("obs", "reacher", n, h)], bound[3]),
        ("chain_cl_rollout", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
         "mjmpc_tpu/ops/pallas_chain.py:520", cl_counts["reacher"]["cl"],
         errors[("cl", "reacher", n, h)], bound[4]),
    ]
    peg = bounds.peg_instance(peg_model, PEG_CL["num_particles"], PEG_CL["horizon"])
    emit("kernel_peg", name="chain_cl_rollout", task="peg", n=peg["n"], h=peg["h"],
         team=peg_cl.team_for(peg["n"]), launches_per_solve=cl_counts["peg"]["cl"] / ZOO_SOLVES,
         max_abs_err=errors[("cl", "peg", peg["n"], peg["h"])],
         ms=times["chain_cl_rollout_peg"][0], plain_ms=times["chain_cl_rollout_peg"][1],
         bound_ms=peg["bound_ms"], bound_by=peg["bound_by"], card=smi)
    for name, r in loco_rolls.items():
        n, h = bounds.LOCO_SIZES[name]
        inst = bounds.ext_instance(r, n, h)
        ptxas = [ln.strip() for ln in r.library().ptxas.splitlines()
                 if re.search(r"registers|spill", ln)]
        emit("kernel_loco", name="chain_ext_rollout", env=name, n=n, h=h, team=r.team,
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
                 if re.search(r"registers|spill|stack|smem", ln)]
        emit("kernel_forest", name="forest_rollout", env=name, n=n, h=h, team=r.team,
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
    for name in FOREST_CONFIGS:       # kernel #6's other instances, one row each
        if name == "pen-v0":
            continue
        inst = bounds.forest_instance(forest_rolls[name], *bounds.FOREST_SIZES[name])
        kname = forest_row_name(name, forest_rolls[name].task.name)
        rows.append((kname, "mjmpc_tpu_torch/csrc/forest_rollout.cu",
                     "mjmpc_tpu/ops/pallas_forest.py:667", hand_counts[name]["forest"],
                     errors[("forest", name, *bounds.FOREST_SIZES[name])],
                     (inst["bound_ms"], inst["bound_by"])))
        times[kname] = forest_times[name]
    pend_ptxas = [ln.strip() for ln in pend.library().ptxas.splitlines()
                  if re.search(r"registers|spill|stack|smem", ln)]
    for number, sizes in bounds.PENDULUM_SIZES.items():
        for n, h in sizes:
            inst = bounds.pendulum_instance(number, n, h)
            fields = (dict(max_abs_err=errors[("pendulum", n, h)],
                           per_block=pend.rollout_per_block(n, h),
                           launches_per_solve=pend_counts["mppi"]["pendulum"] / ZOO_SOLVES)
                      if number == 7 else
                      dict(sampled=pend.sampled_particles(n), launches_per_solve=1.0,
                           ctas=pend.solve_cluster(pend.sampled_particles(n)),
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
    # the kernels built from perturbed models, launched by phases 25 and 26
    times.update(dyn_times)
    dyn_pen = dyn["pen-v0"].fused_rollout.kernel
    bp = bounds.forest_instance(dyn_pen, *bounds.FOREST_SIZES["pen-v0"])
    rows += [("chain_rollout_reacher_perturbed", "mjmpc_tpu_torch/csrc/chain_rollout.cu",
              "mjmpc_tpu/ops/pallas_chain.py:381", dyn_counts["reacher"]["chain"],
              errors[("dyn", DYN_REACHER[0], NUM_PARTICLES, HORIZON)],
              bounds.bound_ms(*bounds.chain_work(dyn_reacher.model, NUM_PARTICLES, HORIZON,
                                                 "costs", n_substeps=2))),
             ("forest_rollout_pen_perturbed", "mjmpc_tpu_torch/csrc/forest_rollout.cu",
              "mjmpc_tpu/ops/pallas_forest.py:667", dyn_counts["pen"]["forest"],
              errors[("dyn", "pen-v0", *bounds.FOREST_SIZES["pen-v0"])],
              (bp["bound_ms"], bp["bound_by"]))]
    times["pendulum_rollout"] = pend_times[(7, mppi_n)]
    times["mppi_pendulum_solve"] = pend_times[(8, ONE_KERNEL["num_particles"])]
    # the batched entries of #1 and #2, launched by phase 29's batched solve,
    # and of #5, #6 and #7, launched by phase 30's batched episodes
    sources = {"chain_rollout_batched": ("chain_rollout.cu", "pallas_chain.py:381"),
               "filtered_noise_batched": ("filtered_noise.cu", "pallas_kernels.py:73"),
               "chain_ext_rollout_batched": ("chain_rollout.cu", "pallas_chain.py:872"),
               "forest_rollout_batched": ("forest_rollout.cu", "pallas_forest.py:667"),
               "pendulum_rollout_batched": ("pendulum.cu", "pallas_kernels.py:130")}
    for kname, (launches, err, kernel_times, bound) in batched.items():
        source, replaces = sources[kname]
        rows.append((kname, "mjmpc_tpu_torch/csrc/" + source, "mjmpc_tpu/ops/" + replaces,
                     launches, err, bound))
        times[kname] = kernel_times
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
