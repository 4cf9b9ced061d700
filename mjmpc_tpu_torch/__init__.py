"""PyTorch / CUDA port of the mjmpc_tpu sampling-MPC framework.

The JAX package `mjmpc_tpu` stays the reference; this package mirrors its
layout (ops, engine, envs, rollout, solvers, policies) in PyTorch idiom:
plain functions over tensors, frozen dataclasses holding tensors, a
`device` on every entry point (the CUDA card unless the caller asks for
the CPU) and counter-based random streams: Philox under a key from
(seed, tag) at the solver state's step, a device tensor (rng.py), so that
a solve can be captured as a CUDA graph and replayed. The hot rollouts
and the filtered-noise sampler run in hand-written CUDA kernels (csrc/)
built by nvcc at first use (kernels/build.py).

This package never imports jax.
"""
import torch

# Full-f32 products everywhere on CUDA. The cost-to-go is a discount-matrix
# product and the MPPI update is an einsum over particles; on the TPU a
# reduced-precision matmul corrupted the cost-to-go by O(1)
# (mjmpc_tpu/ops/control.py cost_to_go), and TF32 is the H100's analogue.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import envs, ops, policies, solvers  # noqa: E402

__all__ = ["envs", "ops", "policies", "solvers"]
