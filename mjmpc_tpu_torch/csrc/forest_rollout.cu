// The rollout of a kinematic forest with penalty contact over N particles
// and H control steps, one team of forest::TEAM lanes per particle.
//
// Replaces the TPU kernel `kernel` of `build_forest_rollout` in
// mjmpc_tpu/ops/pallas_forest.py (its `pl.pallas_call`; B of them in one
// launch, forest_rollout_batch_launch, as under jax.vmap), the hand suite's
// and the sawyer peg's open-loop rollout: scalar-joint trees plus free
// quaternion bodies, the task's contact forces through the point
// Jacobians, one ancestor-sparse Cholesky solve per tree and the Euler
// equations of each free body in every substep, and the task's cost of the
// post-step state (forest_rollout.cuh has the arithmetic; the generated
// header forest_model.h the model, topology, the team's work tables and
// the task as compile-time constants).
//
//   for t in 0..H-1:
//     u = clip(mean[t] + noise[b, t], ULOW, UHIGH) on act_body(j), 0 elsewhere
//     N_SUBSTEPS times: contact points, task forces, generalized forces;
//       mass matrix, RNEA bias, Cholesky solve, Euler step, limits per
//       tree; per free body the Euler equations, the quaternion retraction;
//       FK of the new state
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
// At the planners' N of 100-512 particles that is far too little work to
// fill the card: the time is the length of one particle's dependent chain,
// H * N_SUBSTEPS substeps. With one thread per particle that chain was
// every operation of the substep in turn, through local memory.
//
// The design shortens the chain. A team of lanes carries one particle,
// whose whole state (q, qd, frames, packed mass rows, RNEA terms, contact
// points) sits in shared memory, so nothing of it goes to local memory.
// The team is TEAM lanes (32 for the 25-body hand, 8 for the 7-body arm:
// ops/forest_rollout.py default_team) in each of two warps. Each substep
// is a sequence of phases over the header's tables: every hinge's cos and
// sin at once, FK and the RNEA forward terms down the tree levels, each
// body's own terms; the contact points beside the (body, ancestor)
// Jacobian slots; the task's forces; the generalized forces beside the
// packed mass entries, whose terms the header lays out as one list per
// lane with every index a term needs; the Cholesky factor by columns, one
// column per level at every body below it, beside the RNEA backward pass
// up the levels; forward substitution down, back substitution with the
// Euler step up. A particle's chain is then about four times the tree's
// depth in phases, each as long as its slowest lane's items. Where a
// phase has two kinds of work, the first group takes one and the last
// group the other: in one warp they would run one after the other. The
// team syncs with __syncthreads between phases. There are no atomics and
// no sum is split
// between lanes, so every sum keeps the plain version's order and two
// launches give the same costs. A block holds 32 / TEAM
// particles, so N=256 pen particles spread over all 132 SMs. Each block
// first copies the model's tables from constant into shared memory: the
// lanes of a team read different entries at once, which constant memory
// serves one address at a time. The joint kinds a model lacks (slides,
// free bodies, coupled ones, friction loss) build no code (the header's
// HAS_* constants): a smaller kernel, which the instruction cache holds
// better. PERF.md records the times, ptxas counts and a cycle count per
// kind of phase (a -DFOREST_PHASE_CLOCKS build, tools/forest_ab.py).
//
// IEEE f32 math: built without --use_fast_math, with sinf/cosf/sqrtf/tanhf.

#include <cuda_runtime.h>

#include "forest_rollout.cuh"

namespace {

// A block is two warps holding 32 / TEAM teams: warp g holds every team's
// group g. The model's tables sit in static shared memory (at most 48 KB a
// block, which ptxas refuses to pass), the teams' particles in dynamic
// shared memory beside them: the arm-mounted hand's tables take 36 KB, and
// the two together pass 48 KB (forest_rollout_setup lets the kernel take
// them).
constexpr int kTeams = 32 / forest::TEAM;
constexpr int kBlock = 32 * forest_rollout::GROUPS;
constexpr size_t kParticleBytes = kTeams * sizeof(forest_rollout::Particle);

// n particles in all, per_elem of them to a batch element, whose start,
// extras and mean are rows of q0, qd0, extras and mean (a single launch
// passes per_elem = n: one element).
__global__ void __launch_bounds__(kBlock)
    forest_rollout_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                          const float* __restrict__ extras, const float* __restrict__ mean,
                          const float* __restrict__ noise, float* __restrict__ costs, int n,
                          int horizon, int per_elem) {
    extern __shared__ float4 particle_smem[];
    auto* particles = reinterpret_cast<forest_rollout::Particle*>(particle_smem);
    forest::load_tables(threadIdx.x, kBlock);
    __syncthreads();
    const int in_warp = threadIdx.x % 32;
    const int team = in_warp / forest::TEAM;
    // a ragged last block's spare teams roll out a copy of the last
    // particle, unwritten, since the block syncs together
    const int b = min(blockIdx.x * kTeams + team, n - 1);
    const bool live = blockIdx.x * kTeams + team < n;
    const int lane = threadIdx.x / 32 * forest::TEAM + in_warp % forest::TEAM;
    const int e = b / per_elem;   // the team's batch element
    forest_rollout::rollout_team<forest_rollout::BuildTask>(
        particles[team], forest_rollout::Team{lane}, q0 + e * forest::NQ, qd0 + e * forest::NV,
        extras + e * forest::N_EXTRAS, mean + static_cast<size_t>(e) * horizon * forest::D_ACT,
        noise, costs, b, horizon, live);
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
    forest_rollout_kernel<<<(n + kTeams - 1) / kTeams, kBlock, kParticleBytes,
                            static_cast<cudaStream_t>(stream)>>>(q0, qd0, extras, mean, noise,
                                                                 costs, n, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// B = batch rollouts in one launch over batch * n particles: q0 [B, NQ],
// qd0 [B, NV], extras [B, N_EXTRAS], mean [B, horizon, D_ACT], noise
// [B, n, horizon, D_ACT] -> costs [B, n, horizon]; particle p of the launch
// is particle p % n of element p / n, on that element's start, extras and
// mean (the counterpart of the Pallas kernel under jax.vmap, whose batching
// rule lifts the batch into the grid). The tables and each block's shared
// memory are the single launch's; only the grid grows, and only the last
// block can be ragged. A team runs the single rollout's arithmetic on its
// element's rows, so element b equals forest_rollout_launch on element b's
// inputs bit for bit, whatever B.
int forest_rollout_batch_launch(const float* q0, const float* qd0, const float* extras,
                                const float* mean, const float* noise, float* costs, int batch,
                                int n, int horizon, void* stream) {
    const int total = batch * n;
    forest_rollout_kernel<<<(total + kTeams - 1) / kTeams, kBlock, kParticleBytes,
                            static_cast<cudaStream_t>(stream)>>>(q0, qd0, extras, mean, noise,
                                                                 costs, total, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// Once, before any launch (and before any graph capture): lets the kernel
// take its particles' dynamic shared memory beside its static tables.
// Returns 0 or a cudaError_t.
int forest_rollout_setup() {
    return static_cast<int>(cudaFuncSetAttribute(
        forest_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kParticleBytes)));
}

// The build's (task, nq, nv, dA, n_extras, team), checked by the wrapper.
void forest_rollout_layout(int* out) {
    out[0] = forest::TASK;
    out[1] = forest::NQ;
    out[2] = forest::NV;
    out[3] = forest::D_ACT;
    out[4] = forest::N_EXTRAS;
    out[5] = forest::TEAM;
}

#ifdef FOREST_PHASE_CLOCKS
// A phase-clock build's cycles per kind of phase (forest_rollout.cuh
// PhaseKind) into out [N_PHASE_KINDS], summed since the last call, then
// zeroed; returns a cudaError_t (0 on success). Synchronises.
int forest_rollout_phase_cycles(unsigned long long* out) {
    auto& cycles = forest_rollout::phase_cycles;
    cudaError_t rc = cudaMemcpyFromSymbol(out, cycles, sizeof(cycles));
    void* address = nullptr;
    if (rc == cudaSuccess) rc = cudaGetSymbolAddress(&address, cycles);
    if (rc == cudaSuccess) rc = cudaMemset(address, 0, sizeof(cycles));
    return static_cast<int>(rc);
}
#endif

const char* forest_rollout_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
