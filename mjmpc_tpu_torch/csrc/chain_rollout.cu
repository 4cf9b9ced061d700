// Open-loop rollout of a scalar-joint (hinge/slide) kinematic chain over N
// particles and H control steps, one CUDA thread per particle.
//
// Replaces two TPU kernels of mjmpc_tpu/ops/pallas_chain.py:
// `_chain_kernel` (built by `build_chain_rollout`; entry
// chain_rollout_launch) and `_chain_obs_kernel` (built by
// `build_chain_obs_rollout`; entry chain_obs_rollout_launch), which also
// writes obs[b, t] = [q, qd, site, site - target] of the state entering
// step t. One source, one template: the obs stores are compiled out of
// the costs-only kernel. It computes what those kernels compute, not their
// TPU layout: no (sublane, 128) lane panels and no padding of N.
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
// read and the costs (and obs) writes. The FK of the state after step t serves both
// step t's cost and step t+1's first substep.
//
// What bounds it on an H100: compute, roughly 6 KFLOP per particle-substep
// in f32 (FK, the 7x7 mass matrix, RNEA, Cholesky; counted from this
// source by ops/chain_rollout.py substep_flops) against 14 bytes read per
// particle-substep, plus 80 bytes of obs written per particle-step by the
// obs kernel. Known limits of this first version, left to later
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

template <bool EMIT_OBS>
__global__ void chain_rollout_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                                     const float* __restrict__ target,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ noise,
                                     float* __restrict__ costs, float* __restrict__ obs, int n,
                                     int horizon) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < n)
        chain_rollout::rollout_particle<EMIT_OBS>(q0, qd0, target, mean, noise, costs, b,
                                                  horizon, obs);
}

constexpr int kBlock = 128;

int grid_of(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch (0 on success). Does not synchronise.
int chain_rollout_launch(const float* q0, const float* qd0, const float* target,
                         const float* mean, const float* noise, float* costs, int n,
                         int horizon, void* stream) {
    chain_rollout_kernel<false><<<grid_of(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, target, mean, noise, costs, nullptr, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

// The same rollout that also writes obs [n, horizon, D_OBS] (replaces the
// TPU kernel `_chain_obs_kernel`, built by `build_chain_obs_rollout`).
int chain_obs_rollout_launch(const float* q0, const float* qd0, const float* target,
                             const float* mean, const float* noise, float* costs, float* obs,
                             int n, int horizon, void* stream) {
    chain_rollout_kernel<true><<<grid_of(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, target, mean, noise, costs, obs, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

const char* chain_rollout_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
