// What the chain-rollout team code (chain_team.cuh) takes from the
// compile-time model of chain_model.h: the body frames, the rotation about
// an axis, the site, the tasks (Reacher, Peg; the locomotion tasks' layout)
// with their observations and costs, and the rollout's modes. Host-and-
// device, so that the CPU tests build it with g++ as well.
//
// The generated header's model::TASK picks the task; a locomotion header
// also defines CHAIN_EXT_TASK and its constants (namespace loco), and only
// the team kernel's external-force mode runs it.

#pragma once

#include <math.h>
#include <stddef.h>

#include "chain_model.h"
#include "peg_cost.cuh"
#include "vec3.cuh"

#define CHAIN_FN __host__ __device__ __forceinline__

namespace chain_rollout {

using model::N;

using namespace vec3;

// Rotation about the unit axis a by the angle whose cosine and sine are c
// and s.
CHAIN_FN M3 rodrigues(V3 a, float c, float s) {
    const float x = a.x, y = a.y, z = a.z;
    const float one_c = 1.0f - c;
    return {{c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
             y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
             z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c}};
}

// Body frames (rotation, origin) and world DOF axes. A scalar joint's DOF
// anchor is its body's frame origin.
struct Frames {
    M3 R[N];
    V3 P[N];
    V3 A[N];
};

// World position of the site (model::SITE_BODY, offset site_pos).
CHAIN_FN V3 site_of(const Frames& f) {
    constexpr int sb = model::SITE_BODY;
    const V3 sp = {model::site_pos(0), model::site_pos(1), model::site_pos(2)};
    return add(f.P[sb], mv(f.R[sb], sp));
}

// ---------------------------------------------------------------------------
// Tasks. A task gives N_EXTRAS (the floats of `extras`), D_OBS, load() of
// its extras, obs(), which hands the observation of a state to a sink one
// element at a time (sink(j, value) for j = 0 .. D_OBS - 1, in order), and
// cost() of the state whose frames are f.
// ---------------------------------------------------------------------------

// Reacher family (envs/reacher_7dof.py): extras = target [3];
// obs = [q, qd, site, site - target]; cost = l1 + 5 * sqrt(|d|^2 + 1e-12) of
// d = site - target.
struct Reacher {
    static constexpr int N_EXTRAS = 3;
    static constexpr int D_OBS = 2 * N + 6;

    struct Extras {
        V3 target;
    };

    static CHAIN_FN Extras load(const float* __restrict__ e) { return {{e[0], e[1], e[2]}}; }

    template <class Sink>
    static CHAIN_FN void obs(const Frames& f, const float (&q)[N], const float (&qd)[N],
                             const Extras& ex, Sink& sink) {
#pragma unroll
        for (int i = 0; i < N; ++i) sink(i, q[i]);
#pragma unroll
        for (int i = 0; i < N; ++i) sink(N + i, qd[i]);
        const V3 s = site_of(f);
        sink(2 * N + 0, s.x);
        sink(2 * N + 1, s.y);
        sink(2 * N + 2, s.z);
        sink(2 * N + 3, s.x - ex.target.x);
        sink(2 * N + 4, s.y - ex.target.y);
        sink(2 * N + 5, s.z - ex.target.z);
    }

    static CHAIN_FN float cost(const Frames& f, const Extras& ex) {
        const V3 d = sub(site_of(f), ex.target);
        const float l1 = fabsf(d.x) + fabsf(d.y) + fabsf(d.z);
        const float l2 = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z + 1e-12f);
        return l1 + 5.0f * l2;
    }
};

// Peg insertion (envs/sawyer_tasks.py): the site is the peg's tip; extras =
// [hole entry 3, hole axis 3 (unit, into the hole), hole depth, sensor bias
// 3]. Depth and lateral offset are taken from the sensed entry (entry +
// bias); obs = [q, qd, tip - entry, depth, lateral] with the UNbiased entry
// in the third block; cost = the depth-progress insertion cost, |tip -
// bottom| + 5 * lateral * inserted - inserted.
struct Peg {
    static constexpr int N_EXTRAS = 10;
    static constexpr int D_OBS = 2 * N + 5;

    using Extras = peg::Extras;

    static CHAIN_FN Extras load(const float* __restrict__ e) { return peg::load(e); }

    template <class Sink>
    static CHAIN_FN void obs(const Frames& f, const float (&q)[N], const float (&qd)[N],
                             const Extras& ex, Sink& sink) {
#pragma unroll
        for (int i = 0; i < N; ++i) sink(i, q[i]);
#pragma unroll
        for (int i = 0; i < N; ++i) sink(N + i, qd[i]);
        const V3 tip = site_of(f);
        float depth, lateral;
        peg::sensed(tip, ex, depth, lateral);
        sink(2 * N + 0, tip.x - ex.entry.x);
        sink(2 * N + 1, tip.y - ex.entry.y);
        sink(2 * N + 2, tip.z - ex.entry.z);
        sink(2 * N + 3, depth);
        sink(2 * N + 4, lateral);
    }

    static CHAIN_FN float cost(const Frames& f, const Extras& ex) {
        return peg::cost(site_of(f), ex);
    }
};

template <int TASK>
struct TaskOf;
template <>
struct TaskOf<0> {
    using type = Reacher;
};
template <>
struct TaskOf<1> {
    using type = Peg;
};

#ifdef CHAIN_EXT_TASK
// The locomotion tasks (the swimmer's capsule drag, the half cheetah's
// ground contact): no extras and no observation; their force laws and step
// cost are the team kernel's (chain_team.cuh).
struct Loco {
    static constexpr int N_EXTRAS = 0;
    static constexpr int D_OBS = 0;

    struct Extras {};

    static CHAIN_FN Extras load(const float* __restrict__) { return {}; }
};

template <>
struct TaskOf<2> {
    using type = Loco;
};
template <>
struct TaskOf<3> {
    using type = Loco;
};
#endif  // CHAIN_EXT_TASK

// The task of this build (model::TASK of the generated header).
using BuildTask = TaskOf<model::TASK>::type;

// ---------------------------------------------------------------------------
// The rollout's modes (chain_team.cuh rollout_team) and the observation's
// store
// ---------------------------------------------------------------------------

enum Mode : int {
    COSTS = 0,  // costs only (_chain_kernel)
    OBS = 1,    // costs and pre-step observations (_chain_obs_kernel)
    CL = 2,     // closed-loop-linear (_chain_cl_kernel)
    EXT = 3,    // external forces (_chain_ext_kernel)
};

// Takes the observation one element at a time and stores it, so the
// observation is never held whole in registers.
struct ObsSink {
    float* __restrict__ o;  // this step's obs row

    CHAIN_FN void operator()(int j, float v) { o[j] = v; }
};

}  // namespace chain_rollout
