// The analytic pendulum's two kernels.
//
// Kernel #7, pendulum_rollout_kernel, replaces the TPU kernel
// mjmpc_tpu/ops/pallas_kernels.py `_pendulum_kernel` (built by
// `pendulum_rollout_pallas`): the open-loop rollout of N particles over H
// steps, costs [N, H] taken at each step's pre-step state. One thread per
// particle keeps (th, thdot) in registers across the H steps
// (pendulum.cuh rollout_particle). The TPU kernel's [H, N] lane panels
// padded to 256 particles become the [N, H] layout the port's rollouts
// use, with no padding: a thread past N returns.
//
// Kernel #8, mppi_pendulum_solve_kernel, replaces `_mppi_solve_kernel`
// (built by `mppi_pendulum_solve_pallas`): one whole MPPI solve in one
// launch of one block. As the TPU kernel does, it samples n =
// round_up(max(N, 128), 128) particles, every one of them live in the
// softmax and the mean. Pass 1: each thread takes particles tid, tid +
// blockDim, ... and for each draws its noise (Philox, the filtered-noise
// kernel's counter layout, so that ops/noise.py philox_normals reproduces
// it bit for bit), filters and scales it, rolls the pendulum out and takes
// the cost-to-go at t = 0 (pendulum.cuh solve_particle); eps and costs go
// to [n, H] scratch in device memory. Then a block-wide max and sum give
// the softmax weights of -ctg / lam. Pass 3: warp w forms the weighted
// sums of rows t = w, w + 32, ... over all n particles and writes the
// step-size blend of the old mean and that sum.
//
// Both read the start state and the six params from device memory (eight
// floats, pendulum.cuh Scalar), so no solve reads a value back to the host.
//
// What bounds them on an H100 (mjmpc_tpu_torch/bounds.py): #7 moves 2 N H
// floats (noise in, costs out) against 26 operations per particle-step,
// so the bytes bound it (0.31 us at N=4096, H=32); #8 reads and writes
// only 2 H + 8 floats against about 100 operations per particle-step
// (noise and Philox, the step, the weighted sum), so the operations bound
// it. Limits of this first version:
//   - #7's thread reads its noise row and writes its cost row, H floats
//     apart from the next thread's, so a warp's accesses are not coalesced;
//     each thread runs its H steps serially, so the kernel takes one
//     thread's latency at any N the card holds at once;
//   - #8 is one block on one SM of 132: a thread walks ceil(n / 1024)
//     particles' H-step rollouts in turn, and the block waits at two
//     reductions. Several blocks would need a reduction across blocks.
//
// IEEE f32 math: built without --use_fast_math (sinf, expf, fmodf, not
// their intrinsics) and with -fmad=false, so that the kernels round as the
// plain PyTorch version's separate operations do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pendulum.cuh"

namespace {

constexpr int kRolloutBlock = 128;
constexpr int kSolveMaxBlock = 1024;
constexpr int kWarp = 32;

__global__ void pendulum_rollout_kernel(const float* __restrict__ scalars,
                                        const float* __restrict__ mean,
                                        const float* __restrict__ noise,
                                        float* __restrict__ costs, int n, int horizon) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    const size_t row = static_cast<size_t>(b) * horizon;
    pendulum::rollout_particle(scalars, mean, noise + row, costs + row, horizon);
}

__device__ float warp_max(float v) {
    for (int o = kWarp / 2; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ float warp_sum(float v) {
    for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide reduction through shared memory; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* shared) {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    const int n_warps = blockDim.x / kWarp;
    v = kMax ? warp_max(v) : warp_sum(v);
    if (lane == 0) shared[warp] = v;
    __syncthreads();
    v = lane < n_warps ? shared[lane] : (kMax ? -INFINITY : 0.0f);
    v = kMax ? warp_max(v) : warp_sum(v);
    __syncthreads();   // shared[] is reused by the next reduction
    return v;
}

// scratch: eps [n, H], costs [n, H], then ex [n] (the softmax numerators).
__global__ void mppi_pendulum_solve_kernel(unsigned long long seed,
                                           const float* __restrict__ scalars,
                                           const float* __restrict__ mean,
                                           float* __restrict__ out, float* __restrict__ scratch,
                                           int n, int horizon, float b0, float b1, float b2,
                                           int filter, float sigma, float inv_lam, float keep,
                                           float step_size, float gamma) {
    __shared__ float shared[kWarp];
    float* eps = scratch;
    float* costs = eps + static_cast<size_t>(n) * horizon;
    float* ex = costs + static_cast<size_t>(n) * horizon;

    float local_max = -INFINITY;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float acc = pendulum::solve_particle(seed, scalars, mean, i, horizon, b0, b1, b2,
                                                   filter != 0, sigma, gamma, eps, costs);
        const float neg = -acc * inv_lam;
        ex[i] = neg;
        local_max = fmaxf(local_max, neg);
    }
    const float top = block_reduce<true>(local_max, shared);

    float local_sum = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float e = expf(ex[i] - top);
        ex[i] = e;
        local_sum += e;
    }
    const float total = block_reduce<false>(local_sum, shared);   // syncs: ex[] is complete

    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    for (int t = warp; t < horizon; t += blockDim.x / kWarp) {
        const float mt = mean[t];
        float acc = 0.0f;
        for (int i = lane; i < n; i += kWarp)
            acc += (ex[i] / total) * (mt + eps[static_cast<size_t>(i) * horizon + t]);
        acc = warp_sum(acc);
        if (lane == 0) out[t] = keep * mt + step_size * acc;
    }
}

}  // namespace

extern "C" {

// The launches run on `stream` (a cudaStream_t) and return
// cudaGetLastError() after the launch (0 on success). They do not
// synchronise.

int pendulum_rollout_launch(const float* scalars, const float* mean, const float* noise,
                            float* costs, int n, int horizon, void* stream) {
    const int grid = (n + kRolloutBlock - 1) / kRolloutBlock;
    pendulum_rollout_kernel<<<grid, kRolloutBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        scalars, mean, noise, costs, n, horizon);
    return static_cast<int>(cudaGetLastError());
}

// n: the sampled particle count, a multiple of 32 (the wrapper rounds the
// caller's N up to a multiple of 128).
int mppi_pendulum_solve_launch(unsigned long long seed, const float* scalars, const float* mean,
                               float* out, float* scratch, int n, int horizon, float b0,
                               float b1, float b2, int filter, float sigma, float inv_lam,
                               float keep, float step_size, float gamma, void* stream) {
    const int block = n < kSolveMaxBlock ? n : kSolveMaxBlock;
    mppi_pendulum_solve_kernel<<<1, block, 0, static_cast<cudaStream_t>(stream)>>>(
        seed, scalars, mean, out, scratch, n, horizon, b0, b1, b2, filter, sigma, inv_lam, keep,
        step_size, gamma);
    return static_cast<int>(cudaGetLastError());
}

const char* pendulum_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
