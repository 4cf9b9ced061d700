// The rollout of a kinematic forest with penalty contact over N particles
// and H control steps, one CUDA thread per particle.
//
// Replaces the TPU kernel `kernel` of `build_forest_rollout` in
// mjmpc_tpu/ops/pallas_forest.py (its `pl.pallas_call`), the hand suite's
// and the sawyer peg's open-loop rollout: scalar-joint trees plus free
// quaternion bodies, the task's contact forces through the point
// Jacobians, one ancestor-sparse Cholesky solve per tree and the Euler
// equations of each free body in every substep, and the task's cost of the
// post-step state (forest_rollout.cuh has the arithmetic; the generated
// header forest_model.h the model, topology and task as compile-time
// constants).
//
//   for t in 0..H-1:
//     u = clip(mean[t] + noise[b, t], ULOW, UHIGH) on act_body(j), 0 elsewhere
//     N_SUBSTEPS times: FK; contact points, task forces, scatter; per
//       tree mass matrix, RNEA bias, Cholesky solve, Euler step, limits;
//       per free body the Euler equations, the quaternion retraction
//     costs[b, t] = the task's cost of the post-step state
//
// It computes what the TPU kernel computes, not its TPU layout: no lane
// panels (noise is read as [N, H, dA] directly), no padding of N and no
// zero_mat layout term.
//
// What bounds it on an H100: operations, about 23 K f32 operations per
// particle-substep for the pen (the 24-dof hand's FK, 320 mass-matrix pair
// terms, RNEA, the sparse Cholesky, 12 contact points; counted from
// forest_rollout.cuh by ops/forest_rollout.py forest_rollout_flops)
// against 96 bytes of noise read and 4 of costs written per particle-step.
// At the planners' N of 100-512 particles the work is too small to fill
// the card, so the kernel is latency-bound: one thread carries a particle
// through H * N_SUBSTEPS dependent substeps. The design keeps the code
// small enough for nvcc to build in seconds: the loops over bodies,
// ancestors and points stay rolled over the header's topology tables in
// __constant__ memory (every thread of a warp reads the same entry), the
// mass matrix is kept in packed ancestor rows, and the frames and rows sit
// in local memory. Blocks are one warp, so the particles spread over up
// to N / 32 SMs and each warp has its SM's L1 for that local memory.
// Making it fast (several threads per particle, the hand's digits split
// across a warp) is later work; PERF.md records its time and ptxas counts.
//
// IEEE f32 math: built without --use_fast_math, with sinf/cosf/sqrtf/tanhf.

#include <cuda_runtime.h>

#include "forest_rollout.cuh"

namespace {

constexpr int kBlock = 32;

__global__ void __launch_bounds__(kBlock)
    forest_rollout_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                          const float* __restrict__ extras, const float* __restrict__ mean,
                          const float* __restrict__ noise, float* __restrict__ costs, int n,
                          int horizon) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < n)
        forest_rollout::rollout_particle<forest_rollout::BuildTask>(q0, qd0, extras, mean, noise,
                                                                    costs, b, horizon);
}

}  // namespace

extern "C" {

// costs [n, horizon] of mean [horizon, D_ACT] + noise [n, horizon, D_ACT]
// from (q0 [NQ], qd0 [NV]) with the task's extras [N_EXTRAS]. Launch on
// `stream` (a cudaStream_t); returns cudaGetLastError() after the launch
// (0 on success). Does not synchronise.
int forest_rollout_launch(const float* q0, const float* qd0, const float* extras,
                          const float* mean, const float* noise, float* costs, int n,
                          int horizon, void* stream) {
    forest_rollout_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(q0, qd0, extras, mean, noise,
                                                                 costs, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

// The build's (task, nq, nv, dA, n_extras), checked by the wrapper.
void forest_rollout_layout(int* out) {
    out[0] = forest::TASK;
    out[1] = forest::NQ;
    out[2] = forest::NV;
    out[3] = forest::D_ACT;
    out[4] = forest::N_EXTRAS;
}

const char* forest_rollout_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
