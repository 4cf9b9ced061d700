"""The port's harness/forest_perf.py against the JAX package's module.

- flops_per_particle_substep of pen-v0 and door-v0, counted from the CUDA
  kernel's source (csrc/forest_rollout.cuh), lies within 10% of the JAX
  package's jaxpr count of its lane function (the jaxpr also counts the
  TPU lane code's selects and compares);
- the --flops-only rows carry the JAX rows' keys (the CPU's; the JAX
  module's timing keys, with f32_peak_pct_N* in place of the TPU's
  vpu_peak_pct_N*, on the timed rows, timed here on the CPU at H=1 with
  one window).
"""
import functools
import math

import pytest

from mjmpc_tpu.harness import forest_perf as jforest_perf
from mjmpc_tpu_torch import envs
from mjmpc_tpu_torch.harness import forest_perf

ENVS = "pen-v0,door-v0"
# the JAX module's keys of a timed row, for N = 100 and 1024
TIMED = ("rollout_ms_N{}", "particle_substeps_per_s_N{}", "sustained_tflops_N{}",
         "vpu_peak_pct_N{}", "hbm_gb_per_s_N{}")


@pytest.fixture(scope="module")
def jax_rows():
    return jforest_perf.main(["--flops-only", "--envs", ENVS])


def test_substep_flops_within_ten_percent_of_the_jaxpr_count(jax_rows):
    for want in jax_rows:
        env = envs.make(want["metric"][len("forest_kernel["):-1], device="cpu")
        got = forest_perf.substep_flops(env)
        assert got["n_substeps"] == want["n_substeps"]
        ratio = got["flops_per_particle_substep"] / want["flops_per_particle_substep"]
        assert abs(ratio - 1.0) < 0.10, (env.name, got, want)
    with pytest.raises(ValueError):
        forest_perf.substep_flops(envs.make("reacher_7dof-v0", device="cpu"))


def test_flops_only_rows_carry_the_jax_keys(jax_rows):
    rows = forest_perf.main(["--flops-only", "--envs", ENVS])
    assert [r["metric"] for r in rows] == [r["metric"] for r in jax_rows]
    for got, want in zip(rows, jax_rows):
        assert set(want) <= set(got) and got["device"] == "cpu"
        assert "flops_error" not in got


def test_timed_rows_carry_the_jax_keys(monkeypatch):
    monkeypatch.setattr(forest_perf, "time_rollout", functools.partial(
        forest_perf.time_rollout, iters=1, windows=1))
    [row] = forest_perf.main(["--envs", "pen-v0", "--horizon", "1", "--device", "cpu"])
    for n in (100, 1024):
        for key in TIMED:
            key = key.format(n).replace("vpu_peak_pct", "f32_peak_pct")
            assert math.isfinite(row[key]) and row[key] >= 0, key
        assert row[f"rollout_ms_N{n}"] > 0 and row[f"particle_substeps_per_s_N{n}"] > 0
