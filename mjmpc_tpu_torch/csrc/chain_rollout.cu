// Rollouts of a scalar-joint (hinge/slide) kinematic chain over N particles
// and H control steps.
//
// Replaces four TPU kernels of mjmpc_tpu/ops/pallas_chain.py:
//   - `_chain_kernel` (built by `build_chain_rollout`; entry
//     chain_rollout_launch): costs only, open loop; and B of them in one
//     launch (chain_rollout_batch_launch, the kernel under jax.vmap);
//   - `_chain_obs_kernel` (built by `build_chain_obs_rollout`; entry
//     chain_obs_rollout_launch): also writes obs[b, t] of the state
//     entering step t;
//   - `_chain_cl_kernel` (built by `build_chain_cl_rollout`; entry
//     chain_cl_rollout_launch): closed-loop-linear, a = W^T [obs; 1] +
//     eps computed in the kernel from the observation of the state
//     entering the step, stored before the clip, then u = clip(a); writes
//     obs, actions and costs;
//   - `_chain_ext_kernel` (built by `build_chain_ext_rollout`, with
//     `make_capsule_drag` or `make_ground_contact`; entry
//     chain_ext_rollout_launch; B of them in one launch,
//     chain_ext_rollout_batch_launch): the locomotion rollout. Every substep
//     adds the task's external generalized forces (the swimmer's capsule
//     drag or the cheetah's ground contact, through analytic point
//     Jacobians) to the right-hand side; after a control step's substeps
//     the swimmer's |qd| limit; costs[b, t] = the task's step cost of
//     (state in, state out, u). A locomotion header (CHAIN_EXT_TASK)
//     builds this entry only: the JAX package has no costs, obs or
//     closed-loop kernel for those tasks.
// The task (observation, cost, extras) is the generated header's
// model::TASK: Reacher (extras = target [3]) or Peg (extras = hole entry,
// axis, depth, sensor bias [10]); Swimmer or Cheetah for the locomotion
// rollout. It computes what those kernels compute, not their TPU layout:
// no (sublane, 128) lane panels, no padding of N, and no cap on the panel
// (the closed-loop kernel's VMEM limit on the TPU has no counterpart).
//
//   for t in 0..H-1:
//     u = clip(mean[t] + noise[b, t], ULOW, UHIGH)       (costs, obs, locomotion)
//     a = W^T [obs_b(t); 1] + noise[b, t], u = clip(a)   (closed loop)
//     held for N_SUBSTEPS substeps: FK, Jacobian-composed mass matrix
//       (+ armature + dt*damping on the diagonal), zero-qdd RNEA bias,
//       (locomotion: the task's forces), Cholesky solve of M qdd = gear*u -
//       bias - damping*qd - stiffness*q - frictionloss*tanh(50 qd) (+ tau),
//       semi-implicit Euler, joint-limit clamp with qd zeroed where clamped
//     costs[b, t] = the task's cost of the post-step state (or its step cost)
//
// The model constants come from the generated header chain_model.h
// (mjmpc_tpu_torch/ops/chain_rollout.py model_header) as compile-time
// constants, so loops over bodies unroll into straight-line code with the
// topology resolved at compile time.
//
// What bounds these kernels on an H100: neither bytes nor operations. The
// main path's costs rollout at N=4096, H=32 needs 1.54 GFLOP and 4.2 MB,
// 23 us of the card's f32 rate; the closed loop at the peg config's N=64,
// H=32 24.8 MFLOP, 0.37 us; the cheetah's at N=512, H=16 1.38 GFLOP, 21 us
// (ops/chain_rollout.py rollout_flops, ext_rollout_flops; python -m
// mjmpc_tpu_torch.bounds). The time is the length of one particle's
// dependent chain, H * N_SUBSTEPS substeps of FK, the mass matrix, RNEA and
// a Cholesky solve, and, at large N, the instructions the warps issue. One
// thread per particle (this file's first design) took about 26 K cycles per
// substep: its 7x7 mass matrix and factor spilled to local memory, and a
// few particles per SM left most SMs idle (N=64 filled one block on one
// SM of 132).
//
// Every entry runs a team of team::TEAM lanes per particle (chain_team.cuh
// rollout_team, one mode per entry): a block of one warp holds 32 / TEAM
// particles. The header carries one team size. The closed-loop and
// locomotion rollouts (#4, #5) take the default, a whole warp
// (ops/chain_rollout.py DEFAULT_TEAM); the costs and obs rollouts (#1, #3)
// take the size open_loop_team picks from N and the card's SM count, from
// a library built for it: a whole warp where few particles would leave
// SMs idle, fewer lanes where many particles a warp issue fewer
// instructions. The particle's state sits in shared memory, so nothing
// goes to local memory; each lane reads what its items need of the model
// into registers before the step loop. A substep is six phases synced with
// __syncwarp over the team's lanes: every dof's Euler step and rotation at
// once; FK with the RNEA's forward terms down each branch of the tree on
// its own lane (the arm's 7 levels on one lane in registers, the cheetah's
// two legs side by side); every body's inertia and RNEA terms (and each
// contact point's force) at once; the Jacobian slots beside the RNEA's
// backward pass (and the gathered generalized forces); the mass entries;
// the solve on one lane in registers, one reciprocal square root per
// column (a phase per Cholesky column cost about 550 cycles a column: each
// IEEE division's slow-path branch keeps the next from starting). A
// control step adds two: the task's cost and observation on one lane, then
// the actions, with the team reading a step's mean and noise rows and
// writing its obs and action rows side by side. No sum is split between
// lanes and there are no atomics, so two launches agree bit for bit, and
// so do the team sizes. PERF.md records the times, ptxas counts and cycles
// per kind of phase (a -DCHAIN_PHASE_CLOCKS build, tools/kernel_ab.py
// --phases).
//
// IEEE f32 math: built without --use_fast_math, with sinf/cosf/sqrtf/tanhf.

#include <cuda_runtime.h>

#include "chain_team.cuh"

namespace {

using chain_rollout::BuildTask;
using chain_rollout::CL;
using chain_rollout::COSTS;
using chain_rollout::EXT;
using chain_rollout::OBS;

// A block of one warp: 32 / TEAM teams, each carrying one particle whose
// state sits in static shared memory.
constexpr int kTeams = 32 / team::TEAM;
constexpr int kWarp = 32;

// n particles in all; (COSTS, EXT) per_elem of them to a batch element,
// whose start, extras and mean are rows of q0, qd0, extras and ctrl (a
// single launch passes per_elem = n: one element; EXT has no extras).
template <int MODE>
__global__ void __launch_bounds__(kWarp)
    chain_team_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                      const float* __restrict__ extras, const float* __restrict__ ctrl,
                      const float* __restrict__ noise, float* __restrict__ costs,
                      float* __restrict__ obs, float* __restrict__ acts, int n, int horizon,
                      int per_elem) {
    __shared__ chain_team::Particle particles[kTeams];
    const float* c = ctrl;
    if constexpr (MODE == CL) {  // W [D_OBS + 1, N], read by every lane as a broadcast
        constexpr int kW = (BuildTask::D_OBS + 1) * model::N;
        __shared__ float w_s[kW];
        for (int k = threadIdx.x; k < kW; k += kWarp) w_s[k] = ctrl[k];
        __syncwarp();
        c = w_s;
    }
    const int slot = threadIdx.x / team::TEAM;
    const int lane = threadIdx.x % team::TEAM;
    const int b = blockIdx.x * kTeams + slot;
    if (b >= n) return;  // a ragged block's spare teams: their lanes leave together
    if constexpr (MODE == COSTS || MODE == EXT) {  // the team's batch element
        const int e = b / per_elem;
        q0 += e * model::N;
        qd0 += e * model::N;
        extras += e * BuildTask::N_EXTRAS;
        c += static_cast<size_t>(e) * horizon * model::N;
    }
    const unsigned mask = team::TEAM == 32 ? 0xffffffffu
                                           : ((1u << team::TEAM) - 1u) << (slot * team::TEAM);
    const chain_team::Team tm{lane, mask, chain_team::own_of(lane)};
    chain_team::rollout_team<MODE, BuildTask>(particles[slot], tm, q0, qd0, extras, c, noise,
                                              costs, obs, acts, b, horizon);
}

int team_grid(int n) { return (n + kTeams - 1) / kTeams; }

}  // namespace

extern "C" {

// The build's team size, checked by the wrapper against its own.
int chain_rollout_team() { return team::TEAM; }

#ifdef CHAIN_EXT_TASK

// The locomotion rollout of mean [horizon, N] + noise [n, horizon, N] from
// (q0, qd0): costs [n, horizon] (replaces the TPU kernel `_chain_ext_kernel`,
// built by `build_chain_ext_rollout`). Launch on `stream` (a cudaStream_t);
// returns cudaGetLastError() after the launch. Does not synchronise.
int chain_ext_rollout_launch(const float* q0, const float* qd0, const float* mean,
                             const float* noise, float* costs, int n, int horizon,
                             void* stream) {
    chain_team_kernel<EXT><<<team_grid(n), kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, nullptr, mean, noise, costs, nullptr, nullptr, n, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// B = batch locomotion rollouts in one launch over batch * n particles: q0,
// qd0 [B, N], mean [B, horizon, N], noise [B, n, horizon, N] -> costs
// [B, n, horizon]; particle p of the launch is particle p % n of element
// p / n, on that element's start and mean. The counterpart of
// `_chain_ext_kernel` under jax.vmap. A team runs the single rollout's
// arithmetic on its element's rows, so element b equals
// chain_ext_rollout_launch on element b's inputs bit for bit, whatever B.
int chain_ext_rollout_batch_launch(const float* q0, const float* qd0, const float* mean,
                                   const float* noise, float* costs, int batch, int n,
                                   int horizon, void* stream) {
    chain_team_kernel<EXT><<<team_grid(batch * n), kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, nullptr, mean, noise, costs, nullptr, nullptr, batch * n, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// The build's task (model::TASK), checked by the wrapper against its own.
int chain_rollout_task() { return model::TASK; }

#else

// The open-loop rollout of mean [horizon, N] + noise [n, horizon, N] from
// (q0, qd0): costs [n, horizon] (replaces the TPU kernel `_chain_kernel`,
// built by `build_chain_rollout`). Launch on `stream` (a cudaStream_t);
// returns cudaGetLastError() after the launch (0 on success). Does not
// synchronise.
int chain_rollout_launch(const float* q0, const float* qd0, const float* extras,
                         const float* mean, const float* noise, float* costs, int n,
                         int horizon, void* stream) {
    chain_team_kernel<COSTS><<<team_grid(n), kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, extras, mean, noise, costs, nullptr, nullptr, n, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// B = batch open-loop rollouts in one launch over batch * n particles: q0,
// qd0 [B, N], extras [B, N_EXTRAS], mean [B, horizon, N], noise [B, n,
// horizon, N] -> costs [B, n, horizon]; particle p of the launch is
// particle p % n of element p / n, on that element's start, extras and
// mean. The counterpart of `_chain_kernel` under jax.vmap, whose batching
// rule lifts the batch into the grid. A team runs the single rollout's
// arithmetic on its element's rows, so element b equals
// chain_rollout_launch on element b's inputs bit for bit, whatever B (and
// whatever the team size, which the launch picks from B n).
int chain_rollout_batch_launch(const float* q0, const float* qd0, const float* extras,
                               const float* mean, const float* noise, float* costs, int batch,
                               int n, int horizon, void* stream) {
    chain_team_kernel<COSTS><<<team_grid(batch * n), kWarp, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, extras, mean, noise, costs, nullptr, nullptr, batch * n, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// The same rollout that also writes obs [n, horizon, D_OBS] (replaces the
// TPU kernel `_chain_obs_kernel`, built by `build_chain_obs_rollout`).
int chain_obs_rollout_launch(const float* q0, const float* qd0, const float* extras,
                             const float* mean, const float* noise, float* costs, float* obs,
                             int n, int horizon, void* stream) {
    chain_team_kernel<OBS><<<team_grid(n), kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, extras, mean, noise, costs, obs, nullptr, n, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// The closed-loop-linear rollout under W [D_OBS + 1, N]: writes obs
// [n, horizon, D_OBS], the pre-clip actions [n, horizon, N] and costs
// (replaces the TPU kernel `_chain_cl_kernel`, built by
// `build_chain_cl_rollout`).
int chain_cl_rollout_launch(const float* q0, const float* qd0, const float* extras,
                            const float* w, const float* noise, float* costs, float* obs,
                            float* acts, int n, int horizon, void* stream) {
    chain_team_kernel<CL><<<team_grid(n), kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        q0, qd0, extras, w, noise, costs, obs, acts, n, horizon, n);
    return static_cast<int>(cudaGetLastError());
}

// The build's task layout, checked by the wrapper against its own.
int chain_rollout_d_obs() { return BuildTask::D_OBS; }

int chain_rollout_n_extras() { return BuildTask::N_EXTRAS; }

#endif  // CHAIN_EXT_TASK

#ifdef CHAIN_PHASE_CLOCKS
// A phase-clock build's cycles per kind of phase (chain_team.cuh
// PhaseKind) into out [N_PHASE_KINDS], summed since the last call, then
// zeroed; returns a cudaError_t (0 on success). Synchronises.
int chain_rollout_phase_cycles(unsigned long long* out) {
    auto& cycles = chain_team::phase_cycles;
    cudaError_t rc = cudaMemcpyFromSymbol(out, cycles, sizeof(cycles));
    void* address = nullptr;
    if (rc == cudaSuccess) rc = cudaGetSymbolAddress(&address, cycles);
    if (rc == cudaSuccess) rc = cudaMemset(address, 0, sizeof(cycles));
    return static_cast<int>(rc);
}
#endif

const char* chain_rollout_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
