// The analytic pendulum's two kernels.
//
// Kernel #7, pendulum_rollout_kernel, replaces the TPU kernel
// mjmpc_tpu/ops/pallas_kernels.py `_pendulum_kernel` (built by
// `pendulum_rollout_pallas`): the open-loop rollout of N particles over H
// steps, costs [N, H] taken at each step's pre-step state; B of them in one
// launch (pendulum_rollout_batch_launch, the kernel under jax.vmap), each
// element on blocks of its own. The TPU kernel's
// [H, N] lane panels padded to 256 particles become the [N, H] layout the
// port's rollouts use, with no padding. A block owns `per_block` whole
// particles, whose noise and costs are each one contiguous per_block * H
// run of floats (pendulum_rollout_per_block picks per_block from N, or the
// caller gives it), in three phases:
//   1. every thread clips actions: element k of the block's noise run, read
//      coalesced, plus mean[t] (read through the cache), clipped
//      (pendulum.cuh control) into a shared [per_block, H] tile;
//   2. one lane per particle runs only the serial recurrence (pendulum.cuh
//      rollout_states: sinf and the clamp), writing each step's pre-step
//      (th, thdot) into two more shared tiles;
//   3. every thread takes the cost of element k from the tiles (pendulum.cuh
//      state_cost: the angle wrap by fmodf and the cost's products) and
//      stores it coalesced.
// The tiles' rows are H | 1 floats apart, an odd stride, so that the lanes
// of phase 2, each on its own row, hit 32 different banks.
//
// Kernel #8, mppi_pendulum_solve_kernel, replaces `_mppi_solve_kernel`
// (built by `mppi_pendulum_solve_pallas`): one whole MPPI solve in one
// launch. As the TPU kernel does, it samples n = round_up(max(N, 128), 128)
// particles, every one of them live in the softmax and the mean. It reads
// its stream's step from device memory, as the TPU kernel reads `seed_ref`,
// so that a launch captured in a CUDA graph draws anew on every replay.
//
// One launch is one thread-block cluster of C CTAs (C chosen at launch
// from n, ops/pendulum.py solve_cluster); CTA r owns particles [r m, (r+1)
// m), m = n / C, and keeps all of their state in its shared memory:
//   1. its threads cover the (particle, step-pair) items, one Philox call
//      and two Box-Muller normals each (pendulum.cuh noise_item), into an
//      [H, m] tile, particle fastest;
//   2. one thread per particle filters and scales its row, rolls the
//      pendulum out, keeps its costs in a second [H, m] tile and takes the
//      cost-to-go at t = 0 (pendulum.cuh solve_row);
//   3. the max and the sum of the softmax of -ctg / lam are reduced in the
//      CTA and then across the cluster through distributed shared memory:
//      a warp's lane r reads rank r's value and one fixed shuffle tree adds
//      them, so that every CTA holds the same total; the weights are ex *
//      (1 / total);
//   4. each CTA forms its partial weighted sums over its particles, one warp
//      per row t; rank 0 adds the C partials of each row by the same tree
//      and writes the step-size blend of the old mean and that sum.
// No atomics and no global scratch: two launches agree bit for bit.
//
// Both read the start state and the six params from device memory (eight
// floats, pendulum.cuh Scalar), so no solve reads a value back to the host.
//
// What bounds them on an H100 (mjmpc_tpu_torch/bounds.py): #7 moves 2 N H
// floats (noise in, costs out) against 26 operations per particle-step,
// so the bytes bound it (0.31 us at N=4096, H=32); #8 reads and writes
// only 2 H + 8 floats against about 100 operations per particle-step
// (noise and Philox, the step, the weighted sum), so the operations bound
// it. Limits:
//   - #7's particle runs its H steps as one dependent chain of IEEE sinf
//     and a few products: a launch takes about that chain's latency plus
//     one coalesced load and one store of its tiles, the clip's and the
//     cost's items spread over every SM by small blocks (4 particles a
//     block up to 8 blocks an SM), at any N up to 8 blocks an SM;
//   - #8's particle runs its H steps serially on one thread, and the
//     cluster syncs four times.
//
// IEEE f32 math: built without --use_fast_math (sinf, expf, fmodf, not
// their intrinsics) and with -fmad=false, so that the kernels round as the
// plain PyTorch version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pendulum.cuh"

namespace cg = cooperative_groups;

namespace {

// Kernel #7's threads a block: at least kRolloutMinBlock (phases 1 and 3
// spread the tile over them), at least one per particle.
constexpr int kRolloutMinBlock = 128;
constexpr int kRolloutMaxBlock = 1024;
constexpr int kRolloutBlocksPerSM = 8;
constexpr int kSolveMaxBlock = 1024;
constexpr int kWarp = 32;

// The card's largest dynamic shared memory a block can opt into, read once.
int max_dynamic_smem() {
    static int bytes = -1;
    if (bytes < 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    return bytes;
}

// The card's SM count, read once.
int sm_count() {
    static int count = -1;
    if (count < 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    }
    return count;
}

// Kernel #7's shared tiles, in floats: the clipped actions, th and thdot,
// each [per_block] rows of rollout_stride(horizon) floats.
__host__ __device__ constexpr int rollout_stride(int horizon) { return horizon | 1; }

__host__ __device__ constexpr size_t rollout_smem_floats(int per_block, int horizon) {
    return 3 * static_cast<size_t>(per_block) * rollout_stride(horizon);
}

// n particles an element, blocks_per_elem blocks to an element (a single
// launch passes the whole grid: one element): block k owns particles
// [j per_block, (j + 1) per_block) of element k / blocks_per_elem, j = k %
// blocks_per_elem, whose scalars and mean are rows of `scalars` and `mean`.
// No block straddles two elements: a block reads one Model and one mean.
__global__ void __launch_bounds__(kRolloutMaxBlock)
    pendulum_rollout_kernel(const float* __restrict__ scalars, const float* __restrict__ mean,
                            const float* __restrict__ noise, float* __restrict__ costs, int n,
                            int horizon, int per_block, int blocks_per_elem) {
    extern __shared__ float smem[];
    const int stride = rollout_stride(horizon);
    float* u = smem;
    float* th = u + static_cast<size_t>(per_block) * stride;
    float* thdot = th + static_cast<size_t>(per_block) * stride;
    const int elem = blockIdx.x / blocks_per_elem;
    const int first = (blockIdx.x - elem * blocks_per_elem) * per_block;
    const int count = min(per_block, n - first);
    const int items = count * horizon;
    const size_t run = (static_cast<size_t>(elem) * n + first) * horizon;
    const float* __restrict__ nz = noise + run;
    float* __restrict__ out = costs + run;
    scalars += elem * pendulum::N_SCALARS;
    mean += static_cast<size_t>(elem) * horizon;
    const pendulum::Model m = pendulum::model(scalars);
    const int tid = threadIdx.x;

    // 1. the clipped actions, coalesced from the block's noise run
    for (int k = tid; k < items; k += blockDim.x) {
        const int i = k / horizon, t = k - i * horizon;
        u[i * stride + t] = pendulum::control(m, __ldg(mean + t) + nz[k]);
    }
    __syncthreads();
    // 2. the recurrence, one lane per particle
    if (tid < count) {
        const int row = tid * stride;
        pendulum::rollout_states(m, scalars[pendulum::TH0], scalars[pendulum::THDOT0], u + row,
                                 th + row, thdot + row, horizon);
    }
    __syncthreads();
    // 3. the costs of the pre-step states, coalesced into the block's run
    for (int k = tid; k < items; k += blockDim.x) {
        const int i = k / horizon, at = i * stride + (k - i * horizon);
        out[k] = pendulum::state_cost(th[at], thdot[at], u[at]);
    }
}

__device__ float warp_max(float v) {
    for (int o = kWarp / 2; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ float warp_sum(float v) {
    for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide reduction through shared memory (32 floats); every thread
// gets the result. blockDim.x is a multiple of 32.
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

// Shared memory of one CTA, in floats: the mean [H], the partial weighted
// sums [H], the block reductions' scratch [32], the CTA's max and sum for
// the cluster [2], the weights [m], then the eps and cost tiles [H, m].
__host__ __device__ constexpr size_t solve_smem_floats(int m, int horizon) {
    return 2 * static_cast<size_t>(horizon) + kWarp + 2 + m + 2 * static_cast<size_t>(horizon) * m;
}

__global__ void __launch_bounds__(kSolveMaxBlock)
    mppi_pendulum_solve_kernel(unsigned long long key, const long long* __restrict__ step,
                               const float* __restrict__ scalars, const float* __restrict__ mean,
                               float* __restrict__ out, int m, int horizon, float b0, float b1,
                               float b2, int filter, float sigma, float inv_lam, float keep,
                               float step_size, float gamma) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int n_ctas = static_cast<int>(cluster.num_blocks());
    extern __shared__ float smem[];
    float* mean_s = smem;
    float* part = mean_s + horizon;
    float* red = part + horizon;
    float* mine = red + kWarp;          // [0] the CTA's max, [1] its sum
    float* w = mine + 2;
    float* eps = w + m;
    float* cost = eps + static_cast<size_t>(horizon) * m;
    const int tid = threadIdx.x;

    for (int t = tid; t < horizon; t += blockDim.x) mean_s[t] = mean[t];
    // 1. the white normals of the CTA's particles
    const uint32_t k0 = static_cast<uint32_t>(key), k1 = static_cast<uint32_t>(key >> 32);
    const uint32_t s = static_cast<uint32_t>(*step);
    const int pairs = (horizon + 1) / 2;
    for (int k = tid; k < m * pairs; k += blockDim.x) {
        const int i = k % m;
        pendulum::noise_item(k0, k1, s, rank * m + i, k / m, eps + i, m, horizon);
    }
    __syncthreads();

    // 2. one thread per particle: filter, scale, roll out, cost-to-go
    float neg = -INFINITY;
    if (tid < m) {
        const pendulum::Model model = pendulum::model(scalars);
        const float acc = pendulum::solve_row(model, scalars[pendulum::TH0],
                                              scalars[pendulum::THDOT0], mean_s, eps + tid,
                                              cost + tid, m, horizon, b0, b1, b2, filter != 0,
                                              sigma, gamma);
        neg = -acc * inv_lam;
        w[tid] = neg;
    }

    // 3. the softmax's max and sum, over the CTA, then over the cluster
    const float cta_max = block_reduce<true>(neg, red);
    if (tid == 0) mine[0] = cta_max;
    cluster.sync();
    // every warp reads the C values, lane r rank r's, and reduces them by
    // the same shuffle tree, so every thread of every CTA gets the same
    const int lane = tid % kWarp, warp = tid / kWarp;
    const float top = warp_max(lane < n_ctas ? cluster.map_shared_rank(mine, lane)[0] : -INFINITY);
    float ex = 0.0f;
    if (tid < m) {
        ex = expf(w[tid] - top);
        w[tid] = ex;
    }
    const float cta_sum = block_reduce<false>(ex, red);
    if (tid == 0) mine[1] = cta_sum;
    cluster.sync();
    const float total = warp_sum(lane < n_ctas ? cluster.map_shared_rank(mine, lane)[1] : 0.0f);
    const float inv_total = 1.0f / total;
    if (tid < m) w[tid] = w[tid] * inv_total;
    __syncthreads();

    // 4. the CTA's weighted sums of mean + eps, one warp per row t
    for (int t = warp; t < horizon; t += blockDim.x / kWarp) {
        const float mt = mean_s[t];
        const float* row = eps + static_cast<size_t>(t) * m;
        float acc = 0.0f;
        for (int i = lane; i < m; i += kWarp) acc += w[i] * (mt + row[i]);
        acc = warp_sum(acc);
        if (lane == 0) part[t] = acc;
    }
    cluster.sync();
    if (rank == 0) {    // row t: lane r reads rank r's partial sum
        for (int t = warp; t < horizon; t += blockDim.x / kWarp) {
            const float acc =
                warp_sum(lane < n_ctas ? cluster.map_shared_rank(part, lane)[t] : 0.0f);
            if (lane == 0) out[t] = keep * mean_s[t] + step_size * acc;
        }
    }
    cluster.sync();   // no CTA leaves while rank 0 reads its partial sums
}

}  // namespace

extern "C" {

// The launches run on `stream` (a cudaStream_t) and return
// cudaGetLastError() after the launch (0 on success). They do not
// synchronise.

// Kernel #7's particles a block for n particles: the fewest of 4, 8, 16,
// ... that keeps the grid within kRolloutBlocksPerSM blocks an SM (4 up to
// N = 4224 on a 132-SM card), and at most what the tiles of a block fit
// in shared memory (0 when not one particle fits). Fewer particles a block
// spread the clip and the cost over more SMs, while the recurrence takes
// one lane's chain at any size. From the sweep of 1-128 particles a block
// at N = 24 to 8192 (tools/kernel_ab.py --pendulum-sweep; PERF.md §6):
// within 1.1% of the fastest size at every N.
int pendulum_rollout_per_block(int n, int horizon) {
    int per_block = 4;
    while (per_block < kRolloutMaxBlock &&
           (n + per_block - 1) / per_block > kRolloutBlocksPerSM * sm_count())
        per_block *= 2;
    while (per_block > 0 &&
           rollout_smem_floats(per_block, horizon) * sizeof(float) >
               static_cast<size_t>(max_dynamic_smem()))
        per_block /= 2;
    return per_block;
}

// per_block: the particles a block owns (0: pendulum_rollout_per_block's).
// Returns cudaErrorInvalidValue, without launching, when a block of
// per_block particles does not fit (more than kRolloutMaxBlock, or its
// tiles beyond the card's shared memory).
int pendulum_rollout_launch(const float* scalars, const float* mean, const float* noise,
                            float* costs, int n, int horizon, int per_block, void* stream) {
    if (per_block < 1) per_block = pendulum_rollout_per_block(n, horizon);
    const size_t bytes = rollout_smem_floats(per_block, horizon) * sizeof(float);
    if (per_block < 1 || per_block > kRolloutMaxBlock ||
        bytes > static_cast<size_t>(max_dynamic_smem()))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = per_block < kRolloutMinBlock ? kRolloutMinBlock
                                                     : (per_block + kWarp - 1) / kWarp * kWarp;
    const int grid = (n + per_block - 1) / per_block;
    pendulum_rollout_kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
        scalars, mean, noise, costs, n, horizon, per_block, grid);
    return static_cast<int>(cudaGetLastError());
}

// B = batch rollouts in one launch: scalars [B, N_SCALARS], mean [B,
// horizon, 1], noise [B, n, horizon, 1] -> costs [B, n, horizon] (the
// counterpart of `_pendulum_kernel` under jax.vmap). Each element takes
// ceil(n / per_block) blocks of its own (per_block 0: the rule's at batch
// * n particles), so that a block reads one element's Model and mean. A
// particle's arithmetic is the single launch's, whatever the partition, so
// element b equals pendulum_rollout_launch on element b's inputs bit for
// bit, whatever B. Returns cudaErrorInvalidValue, without launching, where
// pendulum_rollout_launch would.
int pendulum_rollout_batch_launch(const float* scalars, const float* mean, const float* noise,
                                  float* costs, int batch, int n, int horizon, int per_block,
                                  void* stream) {
    if (per_block < 1) per_block = pendulum_rollout_per_block(batch * n, horizon);
    const size_t bytes = rollout_smem_floats(per_block, horizon) * sizeof(float);
    if (batch < 1 || per_block < 1 || per_block > kRolloutMaxBlock ||
        bytes > static_cast<size_t>(max_dynamic_smem()))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = per_block < kRolloutMinBlock ? kRolloutMinBlock
                                                     : (per_block + kWarp - 1) / kWarp * kWarp;
    const int blocks_per_elem = (n + per_block - 1) / per_block;
    pendulum_rollout_kernel<<<batch * blocks_per_elem, threads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        scalars, mean, noise, costs, n, horizon, per_block, blocks_per_elem);
    return static_cast<int>(cudaGetLastError());
}

// Once, before any launch (and before any graph capture): lets both kernels
// take the card's largest dynamic shared memory and kernel #8 clusters of
// up to 16 CTAs. Returns 0 or a cudaError_t.
int pendulum_setup() {
    sm_count();
    cudaError_t rc = cudaFuncSetAttribute(pendulum_rollout_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          max_dynamic_smem());
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(mppi_pendulum_solve_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(cudaFuncSetAttribute(mppi_pendulum_solve_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 max_dynamic_smem()));
}

// Kernel #8's launch shape for n sampled particles in clusters of `ctas`:
// threads a CTA (one per (particle, step pair) item, at most 1024, at least
// one per particle) and dynamic shared memory bytes. Returns 0, or
// cudaErrorInvalidValue when n is not a multiple of ctas, a CTA would hold
// more than 1024 particles or its tiles do not fit in shared memory.
int mppi_pendulum_solve_shape(int n, int horizon, int ctas, int* threads, int* smem_bytes) {
    if (ctas < 1 || n % ctas != 0 || horizon < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int m = n / ctas;
    const long long items = static_cast<long long>(m) * ((horizon + 1) / 2);
    long long t = (items + kWarp - 1) / kWarp * kWarp;
    if (t > kSolveMaxBlock) t = kSolveMaxBlock;
    const size_t bytes = solve_smem_floats(m, horizon) * sizeof(float);
    if (m > kSolveMaxBlock || bytes > static_cast<size_t>(max_dynamic_smem()))
        return static_cast<int>(cudaErrorInvalidValue);
    *threads = static_cast<int>(t);
    *smem_bytes = static_cast<int>(bytes);
    return 0;
}

// The clusters of `ctas` CTAs of kernel #8's shape for (n, horizon) that the
// card can hold at once (cudaOccupancyMaxActiveClusters); 0 when none fits.
int mppi_pendulum_solve_max_clusters(int n, int horizon, int ctas, int* clusters) {
    int threads = 0, bytes = 0;
    int rc = mppi_pendulum_solve_shape(n, horizon, ctas, &threads, &bytes);
    if (rc != 0) return rc;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, mppi_pendulum_solve_kernel, &config));
}

// n: the sampled particle count, a multiple of 128 (the wrapper rounds the
// caller's N up); ctas: the cluster's size, dividing n. `step` points at
// the int64 step on the device. One cluster of `ctas` CTAs.
int mppi_pendulum_solve_launch(unsigned long long key, const long long* step,
                               const float* scalars, const float* mean, float* out, int n,
                               int horizon, int ctas, float b0, float b1, float b2, int filter,
                               float sigma, float inv_lam, float keep, float step_size,
                               float gamma, void* stream) {
    int threads = 0, bytes = 0;
    int rc = mppi_pendulum_solve_shape(n, horizon, ctas, &threads, &bytes);
    if (rc != 0) return rc;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = bytes;
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    rc = static_cast<int>(cudaLaunchKernelEx(&config, mppi_pendulum_solve_kernel, key, step,
                                             scalars, mean, out, n / ctas, horizon, b0, b1, b2,
                                             filter, sigma, inv_lam, keep, step_size, gamma));
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}

const char* pendulum_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
