"""Kernels #1, #3, #4 and #5 of the port as a team of lanes per particle
(csrc/chain_team.cuh, the costs, obs, closed-loop and external-force
entries of csrc/chain_rollout.cu): the kernel source compiled as host C++,
where each phase runs its team's lanes one after another, so that the CPU
runs the kernel's own partition and order, against the plain versions
(ops/chain_rollout.py rollout_plain, rollout_ext_plain); at two team
sizes, which agree bit for bit; at ragged N; with the actions zeroed, where
the check must fail; the generated work tables; and the rule that picks
the costs and obs rollouts' team size from N. The kernel itself runs only
on a CUDA card (tests/test_torch_cuda.py).

Tolerance: atol 5e-5, the chain kernels' (f32 physics over H x n_substeps
substeps, sums in other orders; the cheetah's of max(1, |cost|), its stiff
contact amplifying the reordering, as tests/test_torch_loco.py holds it).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mjmpc_tpu_torch import envs
from mjmpc_tpu_torch.envs import half_cheetah, swimmer
from mjmpc_tpu_torch.envs.sawyer_tasks import peg_extras
from mjmpc_tpu_torch.kernels.build import CSRC
from mjmpc_tpu_torch.ops import chain_rollout as cr

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
ATOL = 5e-5
N = 37           # not a multiple of any team's particles per warp
# case: (env, the other team size tried beside the default warp; the
# cheetah's 8 lanes take its 9 dofs in two rounds). "reacher" and "peg" are
# the closed loop (#4), "swimmer" and "cheetah" the external forces (#5),
# "*_costs" and "*_obs" the open-loop costs (#1) and obs (#3) rollouts.
TASKS = {"reacher": ("reacher_7dof-v0", 8), "peg": ("sawyer_peg_insertion-v0", 16),
         "swimmer": ("Swimmer-v0", 4), "cheetah": ("HalfCheetah-v0", 8),
         "reacher_costs": ("reacher_7dof-v0", 4), "reacher_obs": ("reacher_7dof-v0", 16),
         "peg_obs": ("sawyer_peg_insertion-v0", 8)}
# the kernel's mode of each wrapper's mode (chain_rollout::Mode)
MODES = {"costs": "COSTS", "obs": "OBS", "cl": "CL", "ext": "EXT"}
# the line that sets an action, and a copy of it that zeroes the actions
ACTION_LINE = "    s.u[i] = fminf(fmaxf(a, model::ULOW), model::UHIGH);\n"
ACTIONS_ZEROED = "    s.u[i] = 0.0f * a;\n"
HOST_CPP = """#include "chain_team.cuh"
using namespace chain_team;
extern "C" void host_team(const float* q0, const float* qd0, const float* extras,
    const float* ctrl, const float* noise, float* costs, float* obs, float* acts,
    int n, int horizon) {
  static Particle s;   // one team, its lanes in turn in every phase
  for (int b = 0; b < n; ++b)
    rollout_team<chain_rollout::HOST_MODE, chain_rollout::BuildTask>(
        s, Team{}, q0, qd0, extras, ctrl, noise, costs, obs, acts, b, horizon);
}
"""
_ROLLS, _LIBS, _PLAIN = {}, {}, {}


def _roll(task):
    """The case's wrapper (ChainRollout, ChainObsRollout, ChainClRollout or
    ChainExtRollout), once."""
    if task not in _ROLLS:
        env = envs.make(TASKS[task][0], device=DEVICE)
        if task == "swimmer":
            roll = swimmer.build_rollout(env.params)
        elif task == "cheetah":
            roll = half_cheetah.build_rollout(env.params)
        else:
            name, _, mode = task.partition("_")
            build = {"": cr.build_chain_cl_rollout, "costs": cr.build_chain_rollout,
                     "obs": cr.build_chain_obs_rollout}[mode]
            roll = build(env.params.model, 2, task=name)
        _ROLLS[task] = (env, roll)
    return _ROLLS[task]


def _mode(roll):
    return getattr(roll, "mode", "ext")


def _header(roll, team):
    task = roll.task
    vel = getattr(roll, "vel_limit", None)
    vel = None if vel is None else vel.numpy()
    return cr._model_header(roll.model, roll.n_substeps, roll.ulow, roll.uhigh, task, vel, team)


def host_library(header, mode, tmp_path, zero_actions=False):
    """csrc/chain_team.cuh in `mode` ("costs", "obs", "cl" or "ext") for the
    task of `header` built with g++ (once per header and mode); with
    zero_actions, a copy whose actions are zeroed."""
    key = (header, mode, zero_actions)
    if key not in _LIBS:
        gxx = shutil.which("g++")
        assert gxx, "g++ is needed to build the host copy of the kernel source"
        (tmp_path / "chain_model.h").write_text(header)
        if zero_actions:
            src = (CSRC / "chain_team.cuh").read_text()
            assert src.count(ACTION_LINE) == 1
            (tmp_path / "chain_team.cuh").write_text(src.replace(ACTION_LINE, ACTIONS_ZEROED))
        (tmp_path / "host.cpp").write_text(HOST_CPP)
        lib_path = tmp_path / "libteamhost.so"
        # -O0: the build, not the run, takes the time here
        subprocess.run([gxx, "-std=c++17", "-O0", "-shared", "-fPIC",
                        "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                        f"-DHOST_MODE={MODES[mode]}",
                        "-I", str(tmp_path), "-I", str(CSRC), "-o", str(lib_path),
                        str(tmp_path / "host.cpp")], check=True, capture_output=True)
        _LIBS[key] = ctypes.CDLL(str(lib_path))
    return _LIBS[key]


def inputs(task, n, h, seed):
    """CL: q0, qd0 * 0.1, the task's extras, W [d_obs + 1, 7] * 0.05 and
    noise * 0.3 (tests/test_pallas_cl.py); costs and obs: q0, qd0 * 0.1,
    the extras, mean * 0.3 and noise * 0.5 (tests/test_pallas_chain.py);
    EXT: q0, qd0 * 0.1, mean * 0.3 and noise * 0.5 with the base dofs zero
    (the cheetah lowered into ground contact), as numpy."""
    env, roll = _roll(task)
    rs = np.random.default_rng(seed)
    nv = roll.model.nv
    q0, qd0 = (np.asarray(rs.normal(size=nv) * 0.1, np.float32) for _ in range(2))
    if _mode(roll) == "cl":
        w = np.asarray(rs.normal(size=(roll.d_obs + 1, nv)) * 0.05, np.float32)
        noise = np.asarray(rs.normal(size=(n, h, nv)) * 0.3, np.float32)
        return [q0, qd0, _extras(env, roll), w, noise]
    mean = np.asarray(rs.normal(size=(h, nv)) * 0.3, np.float32)
    noise = np.asarray(rs.normal(size=(n, h, nv)) * 0.5, np.float32)
    if _mode(roll) != "ext":
        return [q0, qd0, _extras(env, roll), mean, noise]
    mean[:, :3], noise[..., :3] = 0.0, 0.0
    if task == "cheetah":
        q0[1] = -0.15
    return [q0, qd0, mean, noise]


def _extras(env, roll):
    return (peg_extras(env.params).numpy() if roll.task.name == "peg"
            else np.array([0.2, -0.1, 0.15], np.float32))


def host_run(lib, roll, args):
    """The outputs in the plain version's order, from the host build:
    (obs, acts, costs) for CL, (obs, costs) for OBS, (costs,) for COSTS and
    EXT."""
    mode = _mode(roll)
    ext = mode == "ext"
    n, h, nv = args[-1].shape
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)
    costs = np.zeros((n, h), np.float32)
    obs = np.zeros((n, h, 1 if ext else roll.d_obs), np.float32)
    acts = np.zeros((n, h, nv), np.float32)
    head = args[:2] + ([np.zeros(1, np.float32)] if ext else [args[2]])
    lib.host_team(*(ptr(a) for a in head + args[-2:]), ptr(costs), ptr(obs), ptr(acts),
                  ctypes.c_int(n), ctypes.c_int(h))
    return {"cl": (obs, acts, costs), "obs": (obs, costs)}.get(mode, (costs,))


def plain(task, args):
    _, roll = _roll(task)
    got = roll.plain(*(torch.as_tensor(a) for a in args))
    return tuple(x.numpy() for x in (got if isinstance(got, tuple) else (got,)))


def agree(task, got, want, atol=ATOL):
    """max |got - want| over the outputs (the cheetah's of max(1, |want|))."""
    err = 0.0
    for x, y in zip(got, want):
        scale = np.maximum(1.0, np.abs(y)) if task == "cheetah" else 1.0
        err = max(err, float(np.max(np.abs(x - y) / scale)))
    return err


@pytest.mark.parametrize("task,other", [(t, False) for t in TASKS] + [(t, True) for t in TASKS])
@pytest.mark.parametrize("h", [5, 6])
def test_host_build_matches_plain(task, other, h, tmp_path):
    """The team code, at the default team and at another size, against the
    plain version at N=37."""
    _, roll = _roll(task)
    team = TASKS[task][1] if other else cr.DEFAULT_TEAM
    lib = host_library(_header(roll, team), _mode(roll), tmp_path)
    args = inputs(task, N, h, 3 + h)
    if (task, h) not in _PLAIN:     # shared by both team sizes
        _PLAIN[(task, h)] = plain(task, args)
    want = _PLAIN[(task, h)]
    got = host_run(lib, roll, args)
    assert all(np.isfinite(x).all() for x in got)
    assert agree(task, got, want) <= ATOL


@pytest.mark.parametrize("task", sorted(TASKS))
def test_team_sizes_agree_bit_for_bit(task, tmp_path):
    """No sum is split between lanes, so the lanes' partition of the work
    does not change a bit; N=1 and N=5 match the plain version as well."""
    _, roll = _roll(task)
    args = [inputs(task, n, 3, 11) for n in (1, 5)]
    got = []
    for k, team in enumerate((cr.DEFAULT_TEAM, TASKS[task][1])):
        (tmp_path / str(k)).mkdir()
        lib = host_library(_header(roll, team), _mode(roll), tmp_path / str(k))
        got.append([host_run(lib, roll, a) for a in args])
    for a, b, case in zip(got[0], got[1], args):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert agree(task, a, plain(task, case)) <= ATOL


@pytest.mark.parametrize("task", ["peg", "cheetah", "reacher_costs", "reacher_obs", "peg_obs"])
def test_check_fails_for_a_build_whose_actions_are_zeroed(task, tmp_path):
    """The check's power: a team kernel that ignores the actions fails it,
    by more than 10x the tolerance."""
    _, roll = _roll(task)
    lib = host_library(roll.header, _mode(roll), tmp_path, zero_actions=True)
    args = inputs(task, 9, 5, 4)
    assert agree(task, host_run(lib, roll, args), plain(task, args)) > 10 * ATOL


@pytest.mark.parametrize("task", sorted(TASKS))
def test_schedule_covers_every_item_once(task):
    """The work tables: every slot, mass entry and contact point on one
    lane once; the branches cover every body, each stored by one branch;
    the runs hold every body once, after the runs of its children."""
    _, roll = _roll(task)
    model = roll.model
    n = model.n_joints
    team = cr.DEFAULT_TEAM
    sched = cr.team_schedule(model, team, cr._point_bodies(roll.task))
    assert team == 32 and f"constexpr int TEAM = {team};" in roll.header
    anc = model.ancestor_mask()
    items = lambda table: [x for row in table for x in row if x[0] >= 0]
    assert sorted((i, d) for i, _, d in items(sched["slots"])) == sorted(
        (i, d) for i in range(n) for d in range(n) if anc[i, d])
    assert sorted((a, b) for a, b, *_ in items(sched["entries"])) == sorted(
        (a, b) for b in range(n) for a in range(n) if anc[b, a])
    assert [p for p, *_ in items(sched["points"])] == list(range(sched["n_points"]))
    stored = [b for br, st in zip(sched["fk_body"], sched["fk_store"])
              for b, s in zip(br, st) if s]
    assert sorted(stored) == list(range(n))
    seen = []
    for seg in sched["run_body"]:
        done = set(seen)
        for run in seg:
            for j, b in enumerate(x for x in run if x >= 0):
                kids = {c for c in range(n) if model.parent[c] == b}
                assert kids <= done | set(run[:j])
        seen += [b for run in seg for b in run if b >= 0]
    assert sorted(seen) == list(range(n))


def test_header_refuses_what_the_team_kernel_does_not_take():
    model = _roll("reacher")[1].model
    with pytest.raises(ValueError):
        cr.team_schedule(model, 12)
    with pytest.raises(ValueError):     # before any build
        _roll("reacher_costs")[1].library(12)
    with pytest.raises(ValueError):
        cr.team_schedule(model, 8, point_bodies=[0] * 33)


def test_open_loop_team_rule_picks_a_size_the_kernel_takes():
    """open_loop_team gives 4, 8, 16 or 32 lanes for every N from 1 to
    8192, on an H100's 132 SMs and on smaller and larger cards, and on the
    H100 the sizes its sweep found fastest: a whole warp at the reacher
    configs' and the peg's small N, 8 lanes at the main path's N=4096."""
    for sm_count in (1, 16, 78, 132, 144):
        assert {cr.open_loop_team(n, sm_count) for n in range(1, 8193)} <= set(cr.TEAM_SIZES)
    assert {cr.open_loop_team(n, 132) for n in (1, 64, 128, 256, 512)} == {32}
    assert cr.open_loop_team(1024, 132) == 16 and cr.open_loop_team(4096, 132) == 8
