"""Every spec of configs/dyn_randomize/ through the port's run_mpc
--dyn_randomize_config (CPU, tiny size: one episode of 2 steps, N=8, H=3,
mppi), each with its env's config: the planner's params are the spec's draw
from the config's seed (envs/randomize.py perturbed_params, held against
the JAX package in tests/test_torch_randomize.py), the real env's params
stay nominal, the rewards are finite, and the log holds the default and
randomized values. A perturbed env with a kernel plans on the kernel built
from its own model (here its plain version).
"""
import os

import numpy as np
import pytest
import torch
import yaml

from mjmpc_tpu_torch import envs, solvers
from mjmpc_tpu_torch.envs import randomize
from mjmpc_tpu_torch.harness import config as cfg
from mjmpc_tpu_torch.harness import run_mpc

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU

# each spec of configs/dyn_randomize/ and the config of its env
SPEC_CONFIGS = {
    "cartpole.yml": "configs/classic_control/cartpole-v0.yml",
    "hand_hammer.yml": "configs/hand/hammer-v0.yml",
    "hand_pen.yml": "configs/hand/pen-v0.yml",
    "panda_tray_glass-v1.yml": "configs/panda/tray_glass-v1.yml",
    "panda_tray_glass.yml": "configs/panda/tray_glass-v0.yml",
    "reacher_7dof.yml": "configs/reacher_7dof-v0.yml",
    "sawyer_peg_insertion-v0.yml": "configs/sawyer/sawyer_peg_insertion-v0.yml",
    "sawyer_peg_insertion-v1.yml": "configs/sawyer/sawyer_peg_insertion-v1.yml",
    "sawyer_pusher.yml": "configs/sawyer/sawyer_pusher-v0.yml",
}


def _leaves(params):
    return solvers.tensor_leaves(params)


@pytest.mark.parametrize("spec_name", sorted(SPEC_CONFIGS))
def test_every_spec_runs_through_run_mpc(spec_name, tmp_path):
    exp = cfg.load_config(SPEC_CONFIGS[spec_name])
    exp.update(n_episodes=1, max_ep_length=2)
    exp["mppi"].update(horizon=3, num_cpu=1, particles_per_cpu=8, n_iters=1)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(exp))
    spec_path = os.path.join("configs", "dyn_randomize", spec_name)
    real = envs.make(exp["env_name"], device=DEVICE)
    out = run_mpc.main(["--config", str(path), "--controller", "mppi", "--device", DEVICE,
                        "--dyn_randomize_config", spec_path,
                        "--save_dir", str(tmp_path)])["mppi"]
    assert out["rewards"].shape == (1, 2) and np.isfinite(out["rewards"]).all()
    with open(spec_path) as f:
        spec = yaml.safe_load(f)
    sim = envs.make(exp.get("sim_env_name", exp["env_name"]), device=DEVICE)
    want = _leaves(randomize.perturbed_params(sim, spec, base_seed=exp["seed"])[0])
    got = _leaves(out["sim_params"])
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    moved = [k for k in want if not torch.equal(want[k], _leaves(sim.params)[k])]
    if spec_name == "sawyer_peg_insertion-v1.yml":
        # the spec scales the sensor bias by 1 - 1 = 0 and the config's
        # planner (v0) has none, so nothing moves, as in the JAX package; on
        # v1 itself it removes the bias
        assert not moved
        v1 = randomize.perturbed_params(real, spec, base_seed=exp["seed"])[0]
        assert float(v1.sensor_bias.abs().max()) == 0.0 < float(real.params.sensor_bias.abs().max())
    else:
        assert moved, "the spec moved no parameter"
    stepped = _leaves(out["real_params"])   # the real env run_mpc stepped stays nominal
    for k, v in _leaves(real.params).items():
        assert torch.equal(stepped[k], v), k
    log = "".join(p.read_text() for p in tmp_path.rglob("*.log"))
    assert "Default params" in log and "Randomized params" in log
