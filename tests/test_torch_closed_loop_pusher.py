"""The pusher's closed loop against the JAX package's: sawyer_pusher-v0's
mppi block at N = 16, H = 4, K = 3 control steps on injected noise, every
record at 1e-4 after each step (test_torch_closed_loop_hand.py has the
protocol and the reading). The port's pusher episodes score above the
JAX package's own CPU episodes (-41.0 +- 3.1 on the card against -51.7
+- 4.1); the loops agree to 1.3e-5. About 30 s on one core.
"""
from mjmpc_tpu_torch import convert
from test_torch_closed_loop_hand import assert_loops_agree, closed_loops


def test_pusher_closed_loop_matches_jax():
    assert_loops_agree(closed_loops("configs/sawyer/sawyer_pusher-v0.yml",
                                    convert.pusher_state_from_reference))
