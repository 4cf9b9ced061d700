// Open-loop rollout of a scalar-joint (hinge/slide) kinematic chain over N
// particles and H control steps, one CUDA thread per particle.
//
// Replaces the TPU kernel mjmpc_tpu/ops/pallas_chain.py `_chain_kernel`
// (built by `build_chain_rollout`). It computes what that kernel computes,
// not its TPU layout: no (sublane, 128) lane panels and no padding of N.
//
//   for t in 0..H-1:
//     u = clip(mean[t] + noise[b, t], ULOW, UHIGH), held for N_SUBSTEPS
//     substep: FK, Jacobian-composed mass matrix (+ armature + dt*damping
//              on the diagonal), zero-qdd RNEA bias, unrolled Cholesky
//              solve of M qdd = gear*u - bias - damping*qd - stiffness*q
//              - frictionloss*tanh(50 qd), semi-implicit Euler, joint-limit
//              clamp with qd zeroed where clamped
//     costs[b, t] = l1 + 5*sqrt(|d|^2 + 1e-12), d = site - target, on the
//                   post-step state
//
// The per-thread code is in chain_rollout.cuh. The model constants come
// from the generated header chain_model.h (mjmpc_tpu_torch/ops/
// chain_rollout.py model_header) as compile-time constants, so the loops
// over bodies unroll into straight-line code with the topology resolved at
// compile time. q and qd stay in registers across
// all H * N_SUBSTEPS substeps; the only device-memory traffic is the noise
// read and the costs write. The FK of the state after step t serves both
// step t's cost and step t+1's first substep.
//
// What bounds it on an H100: compute, roughly 5 KFLOP per particle-substep
// in f32 (FK, the 7x7 mass matrix, RNEA, Cholesky) against 16 bytes read
// per particle-substep. Known limits of this first version, left to later
// work:
//   - at N = 4096 one thread per particle fills only 32 blocks of 128
//     threads on the card's 132 SMs;
//   - per-thread noise reads are strided by H * nv floats, so a warp's
//     loads are not coalesced;
//   - register pressure: the per-thread frames, mass matrix and Cholesky
//     factor need many registers (the ptxas -v count and spills are
//     recorded in PERF.md).
//
// IEEE f32 math: built without --use_fast_math, with sinf/cosf/sqrtf/tanhf.

#include <cuda_runtime.h>

#include "chain_rollout.cuh"

namespace {

__global__ void chain_rollout_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                                     const float* __restrict__ target,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ noise,
                                     float* __restrict__ costs, int n, int horizon) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < n) chain_rollout::rollout_particle(q0, qd0, target, mean, noise, costs, b, horizon);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch (0 on success). Does not synchronise.
int chain_rollout_launch(const float* q0, const float* qd0, const float* target,
                         const float* mean, const float* noise, float* costs, int n,
                         int horizon, void* stream) {
    constexpr int kBlock = 128;
    const int grid = (n + kBlock - 1) / kBlock;
    chain_rollout_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, target, mean, noise, costs, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

const char* chain_rollout_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
