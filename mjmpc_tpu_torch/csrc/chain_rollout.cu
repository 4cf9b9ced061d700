// Rollouts of a scalar-joint (hinge/slide) kinematic chain over N particles
// and H control steps, one CUDA thread per particle.
//
// Replaces four TPU kernels of mjmpc_tpu/ops/pallas_chain.py:
//   - `_chain_kernel` (built by `build_chain_rollout`; entry
//     chain_rollout_launch): costs only, open loop;
//   - `_chain_obs_kernel` (built by `build_chain_obs_rollout`; entry
//     chain_obs_rollout_launch): also writes obs[b, t] of the state
//     entering step t;
//   - `_chain_cl_kernel` (built by `build_chain_cl_rollout`; entry
//     chain_cl_rollout_launch): closed-loop-linear, a = W^T [obs; 1] +
//     eps computed in the kernel from the observation of the state
//     entering the step, stored before the clip, then u = clip(a); writes
//     obs, actions and costs.
//   - `_chain_ext_kernel` (built by `build_chain_ext_rollout`, with
//     `make_capsule_drag` or `make_ground_contact`; entry
//     chain_ext_rollout_launch): the locomotion rollout. Every substep
//     adds the task's external generalized forces (the swimmer's capsule
//     drag or the cheetah's ground contact, through analytic point
//     Jacobians) to the right-hand side; after a control step's substeps
//     the swimmer's |qd| limit; costs[b, t] = the task's step cost of
//     (state in, state out, u). A locomotion header (CHAIN_EXT_TASK)
//     builds this entry only: the JAX package has no costs, obs or
//     closed-loop kernel for those tasks.
// One source, one template (chain_rollout.cuh rollout_particle<MODE, Task>):
// the stores a mode does not need are compiled out. The task (observation,
// cost, extras) is the generated header's model::TASK: Reacher (extras =
// target [3]) or Peg (extras = hole entry, axis, depth, sensor bias [10]).
// It computes what those kernels compute, not their TPU layout: no
// (sublane, 128) lane panels, no padding of N, and no cap on the panel
// (the closed-loop kernel's VMEM limit on the TPU has no counterpart here).
//
//   for t in 0..H-1:
//     u = clip(mean[t] + noise[b, t], ULOW, UHIGH)             (costs, obs)
//     a = W^T [obs_b(t); 1] + noise[b, t], u = clip(a)         (closed loop)
//     held for N_SUBSTEPS substeps: FK, Jacobian-composed mass matrix
//       (+ armature + dt*damping on the diagonal), zero-qdd RNEA bias,
//       unrolled Cholesky solve of M qdd = gear*u - bias - damping*qd -
//       stiffness*q - frictionloss*tanh(50 qd), semi-implicit Euler,
//       joint-limit clamp with qd zeroed where clamped
//     costs[b, t] = the task's cost of the post-step state
//
// The model constants come from the generated header chain_model.h
// (mjmpc_tpu_torch/ops/chain_rollout.py model_header) as compile-time
// constants, so the loops over bodies unroll into straight-line code with
// the topology resolved at compile time. q and qd stay in registers across
// all H * N_SUBSTEPS substeps. The FK of the state after step t serves both
// step t's cost and step t+1's observation and first substep. In the
// closed-loop kernel W ([D_OBS + 1, N], at most 21 x 7 floats) is staged
// once per block in shared memory and read as a broadcast; the seven
// action sums grow while each observation element is produced and stored,
// so the observation never lives whole in registers.
//
// The locomotion rollout keeps its substep loop rolled (the cheetah's 25
// substeps per control step would multiply the code), unrolls the loops
// over dofs, links and contact points, and computes the contact force as a
// select on depth > 0, so no particle of a warp branches apart. Its work
// per particle-substep is FK, the mass matrix, RNEA and Cholesky as above
// plus the task's forces (ops/chain_rollout.py ext_rollout_flops counts
// them); it reads the mean and the noise and writes one cost per step.
//
// What bounds it on an H100: compute, roughly 6 KFLOP per particle-substep
// in f32 (FK, the 7x7 mass matrix, RNEA, Cholesky; counted from this
// source by ops/chain_rollout.py rollout_flops) against 14 bytes read per
// particle-substep, plus per particle-step the obs stores (80 bytes) and,
// closed loop, 7 x (2 D_OBS + 3) operations of the policy product and 28
// bytes of actions. Known limits of this first version, left to later
// work:
//   - at N = 4096 one thread per particle fills only 32 blocks of 128
//     threads on the card's 132 SMs;
//   - per-thread noise reads and obs/action stores are strided by the row
//     length, so a warp's accesses are not coalesced;
//   - register pressure: the per-thread frames, mass matrix and Cholesky
//     factor need many registers (the ptxas -v count and spills are
//     recorded in PERF.md).
//
// IEEE f32 math: built without --use_fast_math, with sinf/cosf/sqrtf/tanhf.

#include <cuda_runtime.h>

#include "chain_rollout.cuh"

namespace {

using chain_rollout::BuildTask;
using chain_rollout::CL;
using chain_rollout::COSTS;
using chain_rollout::EXT;
using chain_rollout::OBS;

template <int MODE>
__global__ void chain_rollout_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                                     const float* __restrict__ extras,
                                     const float* __restrict__ ctrl,
                                     const float* __restrict__ noise,
                                     float* __restrict__ costs, float* __restrict__ obs,
                                     float* __restrict__ acts, int n, int horizon) {
    const float* c = ctrl;
    if constexpr (MODE == CL) {
        constexpr int kW = (BuildTask::D_OBS + 1) * model::N;
        __shared__ float w_s[kW];
        for (int k = threadIdx.x; k < kW; k += blockDim.x) w_s[k] = ctrl[k];
        __syncthreads();
        c = w_s;
    }
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < n)
        chain_rollout::rollout_particle<MODE, BuildTask>(q0, qd0, extras, c, noise, costs, obs,
                                                         acts, b, horizon);
}

constexpr int kBlock = 128;

int grid_of(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

#ifdef CHAIN_EXT_TASK

// The locomotion rollout of mean [horizon, N] + noise [n, horizon, N] from
// (q0, qd0): costs [n, horizon] (replaces the TPU kernel `_chain_ext_kernel`,
// built by `build_chain_ext_rollout`). Launch on `stream` (a cudaStream_t);
// returns cudaGetLastError() after the launch. Does not synchronise.
int chain_ext_rollout_launch(const float* q0, const float* qd0, const float* mean,
                             const float* noise, float* costs, int n, int horizon,
                             void* stream) {
    chain_rollout_kernel<EXT><<<grid_of(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, nullptr, mean, noise, costs, nullptr, nullptr, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

// The build's task (model::TASK), checked by the wrapper against its own.
int chain_rollout_task() { return model::TASK; }

#else

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch (0 on success). Does not synchronise.
int chain_rollout_launch(const float* q0, const float* qd0, const float* extras,
                         const float* mean, const float* noise, float* costs, int n,
                         int horizon, void* stream) {
    chain_rollout_kernel<COSTS><<<grid_of(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, extras, mean, noise, costs, nullptr, nullptr, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

// The same rollout that also writes obs [n, horizon, D_OBS] (replaces the
// TPU kernel `_chain_obs_kernel`, built by `build_chain_obs_rollout`).
int chain_obs_rollout_launch(const float* q0, const float* qd0, const float* extras,
                             const float* mean, const float* noise, float* costs, float* obs,
                             int n, int horizon, void* stream) {
    chain_rollout_kernel<OBS><<<grid_of(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, extras, mean, noise, costs, obs, nullptr, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

// The closed-loop-linear rollout under W [D_OBS + 1, N]: writes obs
// [n, horizon, D_OBS], the pre-clip actions [n, horizon, N] and costs
// (replaces the TPU kernel `_chain_cl_kernel`, built by
// `build_chain_cl_rollout`).
int chain_cl_rollout_launch(const float* q0, const float* qd0, const float* extras,
                            const float* w, const float* noise, float* costs, float* obs,
                            float* acts, int n, int horizon, void* stream) {
    chain_rollout_kernel<CL><<<grid_of(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, extras, w, noise, costs, obs, acts, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

// The build's task layout, checked by the wrapper against its own.
int chain_rollout_d_obs() { return BuildTask::D_OBS; }

int chain_rollout_n_extras() { return BuildTask::N_EXTRAS; }

#endif  // CHAIN_EXT_TASK

const char* chain_rollout_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
