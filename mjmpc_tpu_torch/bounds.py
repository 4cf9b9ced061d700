"""The least time one H100 could take for each TPU kernel's work.

    python -m mjmpc_tpu_torch.bounds        # one JSON line per TPU kernel

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, and the operations it does over the card's f32 rate (NVIDIA's data
sheet for the H100 SXM at 700 W: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside
the tensor cores). Operations are counted from the kernels' sources (a
multiply, an add, a compare or a transcendental is one). This is
arithmetic on shapes, not a measurement; it runs anywhere. chip_smoke.py
reports the same bounds for the kernels beside their measured times,
kernel #4's peg instance at the closed-loop peg config's size, kernel #5
at the swimmer's and the half cheetah's config sizes, kernel #6 at
pen-v0's and the sawyer peg's (N=256, H=16 each) and kernels #7 and #8 at
the sizes it times (PENDULUM_SIZES).
"""
from __future__ import annotations

import json

from .ops import pendulum
from .ops.chain_rollout import (PEG, REACHER, ChainExtRollout, ext_rollout_bytes,
                                 ext_rollout_flops, rollout_bytes, rollout_flops)
from .ops.forest_rollout import ForestRollout, forest_rollout_bytes, forest_rollout_flops
from .ops.noise import noise_flops

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
F32 = 4


def bound_ms(n_bytes: int, n_ops=None):
    """(least ms, "bytes" or "operations"): the larger of the two times;
    bytes alone when the operations are not counted."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = 0.0 if n_ops is None else n_ops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def chain_work(model, n: int, h: int, mode: str, task=REACHER, n_substeps: int = 2):
    """(bytes, operations) of one chain-kernel call in `mode` ("costs",
    "obs", "cl") for `task`: its d_obs and extras, and the operations
    counted from csrc/chain_rollout.cuh (ops/chain_rollout.py)."""
    return (rollout_bytes(model.nv, n, h, mode, task),
            rollout_flops(model, n_substeps, n, h, mode, task))


def kernel_table(model, n: int = 4096, h: int = 32, n_substeps: int = 2):
    """Bounds of the eight TPU kernels at N particles and H steps; #1-#4 on
    `model` (the reacher's ChainModel), the others at their envs' widths;
    #6 with pen-v0's task at its config's size (FOREST_SIZES)."""
    nv = model.nv
    d_obs = REACHER.d_obs(nv)
    nh = n * h
    rows = []

    def row(number, kernel, widths, n_bytes, n_ops, ops_from):
        ms, by = bound_ms(n_bytes, n_ops)
        rows.append(dict(number=number, kernel=kernel, n=n, h=h, widths=widths,
                         bytes=n_bytes, operations=n_ops, operations_from=ops_from,
                         bound_ms=ms, bound_by=by))

    row(1, "_chain_kernel", f"reacher nv={nv}",
        *chain_work(model, n, h, "costs", n_substeps=n_substeps), "csrc/chain_rollout.cuh")
    row(2, "_noise_kernel", f"dA={nv}", F32 * nh * nv, noise_flops(n, h, nv),
        "csrc/filtered_noise.cuh")
    row(3, "_chain_obs_kernel", f"reacher nv={nv} d_obs={d_obs}",
        *chain_work(model, n, h, "obs", n_substeps=n_substeps), "csrc/chain_rollout.cuh")
    row(4, "_chain_cl_kernel", f"reacher nv={nv} d_obs={d_obs}",
        *chain_work(model, n, h, "cl", n_substeps=n_substeps), "csrc/chain_rollout.cuh")
    # #5 with the half cheetah's task (ext_instance gives both tasks at
    # their configs' sizes)
    r5 = ext_instance(_loco_rollout("HalfCheetah-v0"), n, h)
    row(5, "_chain_ext_kernel", r5["widths"], r5["bytes"], r5["operations"],
        r5["operations_from"])
    r6 = forest_instance(_forest_rollout("pen-v0"), *FOREST_SIZES["pen-v0"])
    rows.append(dict(r6, number=6, kernel="build_forest_rollout kernel"))
    rows += [pendulum_instance(7, n, h), pendulum_instance(8, n, h)]
    return rows


def peg_instance(peg_model, n: int = 64, h: int = 32, n_substeps: int = 2) -> dict:
    """Kernel #4 with the peg task at the closed-loop peg config's
    N = 64 (8 x 8 particles), H = 32."""
    n_bytes, n_ops = chain_work(peg_model, n, h, "cl", PEG, n_substeps)
    ms, by = bound_ms(n_bytes, n_ops)
    return dict(number=4, kernel="_chain_cl_kernel", n=n, h=h,
                widths=f"peg nv={peg_model.nv} d_obs={PEG.d_obs(peg_model.nv)}",
                bytes=n_bytes, operations=n_ops, operations_from="csrc/chain_rollout.cuh",
                bound_ms=ms, bound_by=by)


# Kernel #5's calls on the locomotion configs (N = num_cpu x
# particles_per_cpu, H = horizon): configs/Swimmer-v0.yml and
# configs/HalfCheetah-v0.yml.
LOCO_SIZES = {"Swimmer-v0": (512, 32), "HalfCheetah-v0": (512, 16)}


def _loco_rollout(name: str) -> ChainExtRollout:
    """Kernel #5's wrapper for a locomotion env's task, on the CPU."""
    from . import envs
    from .envs import half_cheetah, swimmer
    module = swimmer if name == "Swimmer-v0" else half_cheetah
    return module.build_rollout(envs.make(name, device="cpu").params)


def ext_instance(roll: ChainExtRollout, n: int, h: int) -> dict:
    """Kernel #5 for the task of `roll` (its model, substeps, force law and
    velocity limit) at N particles and H steps."""
    model = roll.model
    n_bytes = ext_rollout_bytes(model.nv, n, h)
    n_ops = ext_rollout_flops(model, roll.n_substeps, n, h, roll.task,
                              roll.vel_limit is not None)
    ms, by = bound_ms(n_bytes, n_ops)
    return dict(number=5, kernel="_chain_ext_kernel", task=roll.task.name, n=n, h=h,
                widths=f"{roll.task.name} nv={model.nv} substeps={roll.n_substeps}",
                bytes=n_bytes, operations=n_ops, operations_from="csrc/chain_rollout.cuh",
                bound_ms=ms, bound_by=by)


# Kernel #6's calls at the configs' sizes: configs/hand/pen-v0.yml's mppi
# block (8 x 32 particles, H=16; 5 substeps) and
# configs/sawyer/sawyer_peg_insertion-v0.yml's (8 x 32, H=16; 2 substeps).
FOREST_SIZES = {"pen-v0": (256, 16), "sawyer_peg_insertion-v0": (256, 16)}


def _forest_rollout(name: str) -> ForestRollout:
    """Kernel #6's wrapper for pen-v0 or the sawyer peg, on the CPU."""
    from . import envs
    from .envs import pen, sawyer_tasks
    module = pen if name == "pen-v0" else sawyer_tasks
    return module.build_rollout(envs.make(name, device="cpu").params.model)


def forest_instance(roll: ForestRollout, n: int, h: int) -> dict:
    """Kernel #6 for the model and task of `roll` at N particles and H
    steps, counted by operations from csrc/forest_rollout.cuh."""
    model, d_act = roll.model, len(roll.act_bodies)
    n_bytes = forest_rollout_bytes(model, n, h, d_act, roll.task)
    n_ops = forest_rollout_flops(model, roll.n_substeps, n, h, roll.act_bodies, roll.task)
    ms, by = bound_ms(n_bytes, n_ops)
    return dict(number=6, kernel="build_forest_rollout kernel", task=roll.task.name, n=n, h=h,
                widths=f"{roll.task.name} nq={model.nq} nv={model.nv} dA={d_act} "
                       f"points={len(roll.task.points)} substeps={roll.n_substeps}",
                bytes=n_bytes, operations=n_ops, operations_from="csrc/forest_rollout.cuh",
                bound_ms=ms, bound_by=by)


# Kernels #7 and #8 at the sizes chip_smoke.py times: #7 at
# configs/SimplePendulum-v0.yml's N (mppi 4 x 6, the others 4 x 16), H=32,
# and at N=2048 and 4096; #8 at N=1024 (the JAX package's closed loop) and
# 2048.
PENDULUM_SIZES = {7: ((24, 32), (64, 32), (2048, 32), (4096, 32)), 8: ((1024, 32), (2048, 32))}


def pendulum_instance(number: int, n: int, h: int) -> dict:
    """Kernel #7 (the pendulum rollout) or #8 (the one-kernel MPPI solve,
    n rounded up as it samples) at N particles and H steps, counted from
    csrc/pendulum.cuh."""
    if number == 7:
        kernel, n_bytes, n_ops = ("_pendulum_kernel", pendulum.rollout_bytes(n, h),
                                  pendulum.rollout_flops(n, h))
    else:
        kernel, n_bytes, n_ops = ("_mppi_solve_kernel", pendulum.solve_bytes(h),
                                  pendulum.solve_flops(n, h))
    ms, by = bound_ms(n_bytes, n_ops)
    return dict(number=number, kernel=kernel, n=n, h=h, widths="pendulum nu=1",
                bytes=n_bytes, operations=n_ops, operations_from="csrc/pendulum.cuh",
                bound_ms=ms, bound_by=by)


def main() -> None:
    from . import envs
    model = envs.make("reacher_7dof-v0", device="cpu").params.model
    for r in kernel_table(model):
        print(json.dumps(r))
    print(json.dumps(peg_instance(envs.make("sawyer_peg_insertion-v0", device="cpu")
                                  .params.model)))
    for name, size in LOCO_SIZES.items():
        print(json.dumps(ext_instance(_loco_rollout(name), *size)))
    for name, size in FOREST_SIZES.items():
        print(json.dumps(forest_instance(_forest_rollout(name), *size)))
    for number, sizes in PENDULUM_SIZES.items():
        for size in sizes:
            print(json.dumps(pendulum_instance(number, *size)))


if __name__ == "__main__":
    main()
