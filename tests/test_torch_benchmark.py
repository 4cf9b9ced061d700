"""The port's harness/benchmark.py against the JAX package's module.

Every bench_* function runs on the CPU at a toy size (N=16, H=4, 2
iterations), and its rows carry the JAX function's metric strings and
keys for the same arguments (the JAX function run on the CPU as well),
with the two renames that name a device: filtered_noise_pallas_us ->
filtered_noise_kernel_us and mfu_pct_bf16 -> mfu_pct_f32. The JAX rows of
the pendulum are real runs; for the reacher's rows (bench_solver on the
reacher, aggregate, roofline, sharded, weak scaling) the JAX solve is a
stub returning a zero action, since a metric string does not depend on
the solve and the JAX reacher solve compiles for tens of seconds here.
Then the timers' read (a non-finite value raises) and main (an error row
makes it exit non-zero, --weak-scaling --cpu-mesh gives the 1/2/4/8 rows,
--profile writes a trace).
"""
import functools
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from mjmpc_tpu import parallel as jparallel
from mjmpc_tpu import solvers as jsolvers
from mjmpc_tpu.harness import benchmark as jbench
from mjmpc_tpu_torch import envs
from mjmpc_tpu_torch.harness import benchmark

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
H, N, ITERS = 4, 16, 2
RENAMED = {"filtered_noise_pallas_us": "filtered_noise_kernel_us",
           "mfu_pct_bf16": "mfu_pct_f32"}
PENDULUM_SOLVERS = ("mppi", "random_shooting", "cem", "pfmpc")
# name -> (a call of either module's bench function, "stub" where the JAX
# module's runs with stubbed solves)
CASES = {
    "solver_pendulum": (lambda b, **kw: [b.bench_solver("SimplePendulum-v0", c, H, N,
                                                        iters=ITERS, **kw)
                                         for c in PENDULUM_SOLVERS], None),
    "solver_reacher": (lambda b, **kw: [b.bench_solver("reacher_7dof-v0", "mppi", H, N,
                                                       iters=ITERS, **kw)], "stub"),
    "ops": (lambda b, **kw: b.bench_ops(N, H, 7, **kw), None),
    "latency": (lambda b, **kw: [b.bench_latency("SimplePendulum-v0", H, N, iters=ITERS,
                                                 **kw)], None),
    "aggregate": (lambda b, **kw: b.bench_aggregate("reacher_7dof-v0", H, N, batches=(1, 2),
                                                    iters=ITERS, **kw), "stub"),
    "roofline": (lambda b, **kw: [b.bench_roofline("reacher_7dof-v0", H, N, iters=ITERS, **kw)],
                 "stub"),
    "roofline_pendulum": (lambda b, **kw: [b.bench_roofline("SimplePendulum-v0", H, N,
                                                            iters=ITERS, **kw)], None),
    "sharded": (lambda b, **kw: [b.bench_sharded(H, 2, iters=ITERS, **kw)], "stub"),
    "weak_scaling": (lambda b, **kw: b.bench_weak_scaling(H, 2, iters=ITERS, **kw), "stub"),
}
CPU_MESH = ["cpu"] * 8   # the JAX tests' 8 CPU devices (tests/conftest.py)


def _stub_build(solver, env, *args, **kwargs):
    """A JAX solve that returns a zero action and the state unchanged."""
    def solve(params, env_state, state):
        return jnp.zeros(env.d_action), jnp.zeros(()), state
    return solve


@pytest.fixture(scope="module")
def jax_rows():
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (call, mode) in CASES.items():
            if mode == "stub":
                for target, attr in ((jsolvers, "make_solve_fn"), (jsolvers, "build_solve_fn"),
                                     (jparallel, "build_sharded_solve_fn")):
                    mp.setattr(target, attr, _stub_build)
            rows[name] = call(jbench)
            mp.undo()
    assert len(jax.devices()) == len(CPU_MESH)
    return rows


def _keys(row):
    return {RENAMED.get(k, k) for k in row}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_carry_the_jax_metric_strings(case, jax_rows):
    kw = dict(device=DEVICE)
    if case in ("sharded", "weak_scaling"):
        kw["devices"] = CPU_MESH
    got = CASES[case][0](benchmark, **kw)
    want = jax_rows[case]
    assert [r["metric"] for r in got] == [RENAMED.get(r["metric"], r["metric"]) for r in want]
    for g, w in zip(got, want):
        assert _keys(w) - {"error"} <= set(g), (g, w)
        assert g["unit"] == w["unit"] or w["unit"] == "us" and "pallas" in w["metric"]
        assert g["unit"] != "error" and math.isfinite(g["value"]) and g["value"] >= 0


def test_timers_raise_on_a_non_finite_read():
    with pytest.raises(RuntimeError, match="non-finite"):
        benchmark._finite_read((torch.tensor([1.0, float("nan")]), torch.zeros(1)))
    with pytest.raises(RuntimeError, match="non-finite"):
        benchmark._time(lambda: torch.tensor([float("inf")]), iters=2)
    assert benchmark._finite_read(torch.ones(3)) == 3.0
    env = envs.make("SimplePendulum-v0", device=DEVICE)

    def solve(params, env_state, state):
        return torch.tensor([float("nan")]), torch.zeros(()), state

    with pytest.raises(RuntimeError, match="non-finite"):
        benchmark.solves_per_s(solve, env, None, None, 2, 1)


def _cheap(monkeypatch, fail: str = ""):
    """main's suite cut to one pendulum row and toy sizes; the bench
    function named `fail` raises."""
    monkeypatch.setattr(benchmark, "DEFAULT_SUITE", [("SimplePendulum-v0", "mppi", H, N)])
    for name, fn in (("bench_latency", functools.partial(benchmark.bench_latency,
                                                         "SimplePendulum-v0", H, N)),
                     ("bench_roofline", functools.partial(benchmark.bench_roofline,
                                                          "SimplePendulum-v0", H, N)),
                     ("bench_aggregate", functools.partial(benchmark.bench_aggregate,
                                                           "reacher_7dof-v0", H, N)),
                     ("bench_ops", functools.partial(benchmark.bench_ops, N, H, 7))):
        if name == fail:
            def fn(*args, **kwargs):
                raise RuntimeError("kernel launch failed")
        monkeypatch.setattr(benchmark, name, fn)


def test_main_exits_nonzero_on_an_error_row(monkeypatch, tmp_path, capsys):
    _cheap(monkeypatch, fail="bench_latency")
    with pytest.raises(SystemExit) as exit_info:
        benchmark.main(["--quick", "--device", "cpu", "--json", str(tmp_path / "rows.json")])
    assert exit_info.value.code not in (0, None)
    rows = json.loads((tmp_path / "rows.json").read_text())
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["metric"] for r in rows if r["unit"] == "error"] == ["latency"]
    assert "kernel launch failed" in rows[1]["error"] and len(rows) > 4
    assert all(r["device"] == "cpu" for r in rows)


def test_main_profile_writes_a_trace(monkeypatch, tmp_path):
    _cheap(monkeypatch)
    rows = benchmark.main(["--quick", "--device", "cpu", "--profile", str(tmp_path)])
    assert rows[-1]["metric"] == "profile_trace"
    assert (tmp_path / "bench_latency.json").stat().st_size > 0
    assert not any(r["unit"] == "error" for r in rows)


def test_main_weak_scaling_on_a_cpu_mesh(monkeypatch):
    monkeypatch.setattr(benchmark, "bench_weak_scaling", functools.partial(
        benchmark.bench_weak_scaling, H, 2, iters=ITERS))
    rows = benchmark.main(["--weak-scaling", "--cpu-mesh"])
    assert [r["metric"] for r in rows] == [f"weak_scaling[devices={d},N={2 * d}]"
                                           for d in (1, 2, 4, 8)]
    assert rows[0]["efficiency_pct"] == 100.0 and all(r["device"] == "cpu" for r in rows)
