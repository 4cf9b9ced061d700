// AR(2)-filtered standard-normal action noise [N, H, dA], one CUDA thread
// per (particle, action dim) column.
//
// Replaces the TPU kernel mjmpc_tpu/ops/pallas_kernels.py `_noise_kernel`
// (built by `filtered_noise_pallas`). It computes what that kernel
// computes, not its TPU layout: the TPU's hardware PRNG becomes Philox
// (philox.cuh), whose counters (b, d, t/2) cannot collide the way the TPU
// kernel's per-tile seeds `seed + d*7919 + j*104729` can; uniforms and
// Box-Muller are the TPU kernel's (filtered_noise.cuh); the [dA, H, N]
// lane panels become the [N, H, dA] layout that the chain-rollout kernel
// reads. Colouring by chol(cov) stays outside the kernel, one matmul in
// the wrapper (mjmpc_tpu_torch/ops/noise.py FilteredNoise), as the TPU
// wrapper applies it outside its kernel.
//
// What bounds it on an H100: it reads nothing and writes N*H*dA floats
// (3.67 MB at N=4096, H=32, dA=7: 1.1 us at 3.35 TB/s); per element it
// does half a Philox call (10 rounds of 2 wide multiplies, 4 xors and 2
// key adds) and one Box-Muller normal (log, sqrt, cos): 69 operations
// (ops/noise.py noise_flops), 0.94 us at 67 TFLOP/s f32, so the bytes bound
// it, narrowly (mjmpc_tpu_torch/bounds.py). Limits of this first version:
//   - a warp's stores are only partly coalesced: threads of one particle
//     write dA neighbouring floats, the next particle's start H*dA floats
//     further on. The layout does not depend on dA (the JAX package's hand
//     envs have dA up to 30);
//   - each thread loops over H serially; at N*dA = 28,672 threads the card
//     holds every thread at once, so the loop's latency is the kernel's.
//
// IEEE f32 math: built without --use_fast_math, with logf/sqrtf/cosf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "filtered_noise.cuh"

namespace {

__global__ void filtered_noise_kernel(uint64_t seed, float b0, float b1, float b2, int filter,
                                      int n, int horizon, int d_action,
                                      float* __restrict__ out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= static_cast<long long>(n) * d_action) return;
    const int b = static_cast<int>(i / d_action);
    const int d = static_cast<int>(i % d_action);
    filtered_noise::noise_column(seed, b0, b1, b2, filter != 0, b, d, horizon, d_action, out);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch (0 on success). Does not synchronise.
int filtered_noise_launch(unsigned long long seed, float b0, float b1, float b2, int filter,
                          int n, int horizon, int d_action, float* out, void* stream) {
    constexpr int kBlock = 256;
    const long long threads = static_cast<long long>(n) * d_action;
    const int grid = static_cast<int>((threads + kBlock - 1) / kBlock);
    filtered_noise_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t>(seed), b0, b1, b2, filter, n, horizon, d_action, out);
    return static_cast<int>(cudaGetLastError());
}

const char* filtered_noise_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
