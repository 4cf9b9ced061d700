// AR(2)-filtered standard-normal action noise [N, H, dA], and Philox
// uniforms, keyed by a stream key and the solver state's step, which the
// kernels read from device memory.
//
// filtered_noise_kernel replaces the TPU kernel
// mjmpc_tpu/ops/pallas_kernels.py `_noise_kernel` (built by
// `filtered_noise_pallas`). It computes what that kernel computes, not its
// TPU layout: the TPU's hardware PRNG becomes Philox (philox.cuh), whose
// counters (b, d, t/2, step) cannot collide the way the TPU kernel's
// per-tile seeds `seed + d*7919 + j*104729` can; the step is read from
// device memory, as the TPU kernel reads `seed_ref`, so a launch captured in
// a CUDA graph draws anew on every replay; uniforms and Box-Muller are the
// TPU kernel's (filtered_noise.cuh); the [dA, H, N] lane panels become the
// [N, H, dA] layout that the rollout kernels read. Colouring by chol(cov)
// stays outside the kernel, one matmul in the wrapper
// (mjmpc_tpu_torch/ops/noise.py FilteredNoise), as the TPU wrapper applies
// it outside its kernel.
//
// A block owns `per_block` whole particles, one contiguous per_block*H*dA
// span of the output, staged in shared memory in the output's layout:
//   1. the block's threads cover its (particle, dim, step-pair) items, one
//      Philox call and two Box-Muller normals each, into the tile;
//   2. when filtered, one thread per (particle, dim) column runs the AR(2)
//      recurrence along the tile in the plain version's order;
//   3. the tile goes out with contiguous stores, float4 where the span
//      starts on 16 bytes.
// per_block is chosen at launch from N, H, dA and the SM count
// (filtered_noise_per_block), or given by the caller, so the layout does
// not depend on dA (the JAX package's hand envs reach 30); a block has one
// thread per item up to kBlock. Every element is computed alike whatever the partition, so two
// partitions agree bit for bit.
//
// A batch of B draws (filtered_noise_batch_launch: B solver states, keys
// [B] and steps [B] in device memory, out [B, N, H, dA]) is one launch of
// the same kernel, the counterpart of the TPU kernel under jax.vmap, whose
// batching rule lifts the batch into the grid: blocks_per_elem blocks per
// element, block k drawing for element k / blocks_per_elem with that
// element's key and step, its particles counted from 0 within the element.
// A single draw is the batch of one, its key passed by value. So element b
// of a batch is the single draw under (key_b, step_b) bit for bit: the same
// Philox counters, the same filter, whatever B.
//
// What bounds it on an H100: it reads 8 bytes (the step) and writes N*H*dA
// floats (3.67 MB at N=4096, H=32, dA=7: 1.1 us at 3.35 TB/s); per element
// it does half a Philox call and one Box-Muller normal: 69 operations
// (ops/noise.py noise_flops), 0.94 us at 67 TFLOP/s f32, so the bytes bound
// it, narrowly (mjmpc_tpu_torch/bounds.py).
//
// philox_uniforms_kernel: n uniforms in [2^-25, 1) of one stream at the
// step (filtered_noise.cuh uniform_quad), for the particle filter's
// resampling offset.
//
// IEEE f32 math: built without --use_fast_math, with logf/sqrtf/cosf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "filtered_noise.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kBlocksPerSM = 2;

// keys [B] (nullptr: every element's key is `key`), steps [B]; n particles
// an element, blocks_per_elem blocks an element.
__global__ void __launch_bounds__(kBlock)
    filtered_noise_kernel(const unsigned long long* __restrict__ keys, unsigned long long key,
                          const long long* __restrict__ steps, float b0, float b1, float b2,
                          int filter, int n, int horizon, int d_action, int per_block,
                          int blocks_per_elem, float* __restrict__ out) {
    extern __shared__ float4 tile4[];
    float* tile = reinterpret_cast<float*>(tile4);   // [count, horizon, d_action]
    const int elem = blockIdx.x / blocks_per_elem;
    const int first = (blockIdx.x - elem * blocks_per_elem) * per_block;
    const int count = min(per_block, n - first);
    const int pairs = (horizon + 1) / 2;
    const int row = horizon * d_action;
    if (keys != nullptr) key = keys[elem];
    const uint32_t k0 = static_cast<uint32_t>(key);
    const uint32_t k1 = static_cast<uint32_t>(key >> 32);
    const uint32_t s = static_cast<uint32_t>(steps[elem]);
    out += static_cast<size_t>(elem) * n * row;

    // 1. items (particle j, pair p, dim d), d fastest, so that neighbouring
    //    threads write neighbouring floats of the tile; a thread's item
    //    index k advances by blockDim, its (j, p, d) by the stride's digits
    //    with a carry, so that no item divides
    const int items = count * pairs * d_action;
    const int stride = blockDim.x;
    const int sd = stride % d_action, sp = stride / d_action % pairs;
    const int sj = stride / d_action / pairs;
    int d = threadIdx.x % d_action, p = threadIdx.x / d_action % pairs;
    int j = threadIdx.x / d_action / pairs;
    for (int k = threadIdx.x; k < items; k += stride) {
        float z0, z1;
        filtered_noise::normal_pair(k0, k1, static_cast<uint32_t>(first + j),
                                    static_cast<uint32_t>(d), static_cast<uint32_t>(p), s, z0,
                                    z1);
        float* at = tile + j * row + 2 * p * d_action + d;
        at[0] = z0;
        if (2 * p + 1 < horizon) at[d_action] = z1;
        d += sd;
        const int cd = d >= d_action;
        d -= cd * d_action;
        p += sp + cd;
        const int cp = p >= pairs;
        p -= cp * pairs;
        j += sj + cp;
    }
    __syncthreads();

    // 2. the filter, one column per thread
    if (filter) {
        for (int c = threadIdx.x; c < count * d_action; c += blockDim.x)
            filtered_noise::filter_column(tile + (c / d_action) * row + c % d_action, d_action,
                                          horizon, b0, b1, b2);
        __syncthreads();
    }

    // 3. the contiguous span out[first * row, (first + count) * row)
    const size_t base = static_cast<size_t>(first) * row;
    const int total = count * row;
    float* dst = out + base;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int v = threadIdx.x; v < total / 4; v += blockDim.x) dst4[v] = tile4[v];
        done = total / 4 * 4;
    }
    for (int i = done + threadIdx.x; i < total; i += blockDim.x) dst[i] = tile[i];
}

__global__ void philox_uniforms_kernel(unsigned long long key, const long long* __restrict__ step,
                                       int n, float* __restrict__ out) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (4 * q >= n) return;
    float u[4];
    filtered_noise::uniform_quad(static_cast<uint32_t>(key), static_cast<uint32_t>(key >> 32),
                                 static_cast<uint32_t>(q), static_cast<uint32_t>(*step), u);
    for (int k = 0; k < 4 && 4 * q + k < n; ++k) out[4 * q + k] = u[k];
}

// The card's largest dynamic shared memory a block can opt into, and its
// SM count, read once.
int max_dynamic_smem() {
    static int bytes = -1;
    if (bytes < 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    return bytes;
}

int sm_count() {
    static int sms = -1;
    if (sms < 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
}

}  // namespace

extern "C" {

// Once, before any launch (and before any graph capture): lets the noise
// kernel take the card's largest dynamic shared memory. Returns 0 or a
// cudaError_t.
int filtered_noise_setup() {
    return static_cast<int>(cudaFuncSetAttribute(
        filtered_noise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic_smem()));
}

// The particles a block of the noise kernel owns by default for n
// particles of (horizon, d_action) on a card of `sms` SMs: about
// kBlocksPerSM blocks an SM, at least one particle a block, within
// `smem_bytes` of shared memory; 0 when one particle's span does not fit.
// From a sweep of 1-32 particles a block (tools/kernel_ab.py
// --noise-sweep; PERF.md §6): fewer, fuller blocks won at N=4096, dA=7
// (16 a block), and two a block at N=512, dA=30, both about 2 blocks an SM.
int filtered_noise_per_block(int n, int horizon, int d_action, int smem_bytes, int sms) {
    const int row_bytes = 4 * horizon * d_action;
    if (row_bytes > smem_bytes) return 0;
    const int blocks = kBlocksPerSM * (sms > 0 ? sms : 1);
    int per_block = (n + blocks - 1) / blocks;
    if (per_block < 1) per_block = 1;
    if (per_block > smem_bytes / row_bytes) per_block = smem_bytes / row_bytes;
    return per_block;
}

int filtered_noise_max_smem() { return max_dynamic_smem(); }

// B draws of n particles each in one launch (the kernel's comment).
static int noise_launch(const unsigned long long* keys, unsigned long long key,
                        const long long* steps, float b0, float b1, float b2, int filter,
                        int batch, int n, int horizon, int d_action, int per_block, float* out,
                        void* stream) {
    const int smem_cap = max_dynamic_smem();
    if (per_block < 1)
        per_block = filtered_noise_per_block(batch * n, horizon, d_action, smem_cap, sm_count());
    if (per_block > n) per_block = n;  // a block holds particles of one element
    const size_t smem = static_cast<size_t>(per_block) * horizon * d_action * sizeof(float);
    if (per_block < 1 || smem > static_cast<size_t>(smem_cap))
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks_per_elem = (n + per_block - 1) / per_block;
    const long long items = static_cast<long long>(per_block) * ((horizon + 1) / 2) * d_action;
    const int threads = items < kBlock ? static_cast<int>((items + 31) / 32 * 32) : kBlock;
    filtered_noise_kernel<<<batch * blocks_per_elem, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        keys, key, steps, b0, b1, b2, filter, n, horizon, d_action, per_block, blocks_per_elem,
        out);
    return static_cast<int>(cudaGetLastError());
}

// Launch on `stream` (a cudaStream_t); `step` points at the int64 step on
// the device; per_block particles a block (0: filtered_noise_per_block's).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when the block's span does not fit in shared
// memory. Does not synchronise.
int filtered_noise_launch(unsigned long long key, const long long* step, float b0, float b1,
                          float b2, int filter, int n, int horizon, int d_action, int per_block,
                          float* out, void* stream) {
    return noise_launch(nullptr, key, step, b0, b1, b2, filter, 1, n, horizon, d_action,
                        per_block, out, stream);
}

// B = batch draws in one launch: keys [B] (uint64) and steps [B] (int64) in
// device memory, out [B, n, horizon, d_action]; element b equals
// filtered_noise_launch under (keys[b], steps[b]) bit for bit. per_block
// as there, from the B n particles. Returns as filtered_noise_launch.
int filtered_noise_batch_launch(const unsigned long long* keys, const long long* steps, float b0,
                                float b1, float b2, int filter, int batch, int n, int horizon,
                                int d_action, int per_block, float* out, void* stream) {
    return noise_launch(keys, 0ull, steps, b0, b1, b2, filter, batch, n, horizon, d_action,
                        per_block, out, stream);
}

int philox_uniforms_launch(unsigned long long key, const long long* step, int n, float* out,
                           void* stream) {
    constexpr int kUniformBlock = 128;
    const int quads = (n + 3) / 4;
    const int grid = (quads + kUniformBlock - 1) / kUniformBlock;
    philox_uniforms_kernel<<<grid, kUniformBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        key, step, n, out);
    return static_cast<int>(cudaGetLastError());
}

const char* filtered_noise_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
