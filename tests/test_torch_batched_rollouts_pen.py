"""Kernel #6's batched entry on pen-v0 (the env's batched hook, on the CPU
its plain version per element) against jax.vmap of the JAX general
rollout over B = 2 starts from a pinch, every fingertip pressing on the
pen, so that the costs follow the hand's dynamics through contact: atol
1e-4, the pen checks' tolerance (test_torch_batched_rollouts.py has the
helper and the swimmer's and the peg's cases). About 50 s on one core,
most of it the JAX pen rollout's compile.
"""
from test_torch_batched_rollouts import check_against_vmapped_jax


def test_pen_batched_hook_matches_vmapped_jax_general_rollout():
    check_against_vmapped_jax("pen-v0")
