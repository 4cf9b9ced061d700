// Per-particle arithmetic of the one-thread chain-rollout kernels
// (chain_rollout.cu's costs and obs entries, kernels #1 and #3):
// straight-line code over the compile-time model of chain_model.h, and the
// tasks (Reacher, Peg; the locomotion tasks' layout) that the team kernel
// (chain_team.cuh) shares. The functions are host-and-device, so the same
// source also compiles as plain C++ (tests/test_torch_chain_rollout.py and
// tests/test_torch_obs_rollout.py check it on the CPU that way).
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

CHAIN_FN V3 axis_of(int i) {
    return {model::axis(i, 0), model::axis(i, 1), model::axis(i, 2)};
}

CHAIN_FN V3 com_of(int i) {
    return {model::com(i, 0), model::com(i, 1), model::com(i, 2)};
}

// Rotation about the unit axis a by the angle whose cosine and sine are c
// and s.
CHAIN_FN M3 rodrigues(V3 a, float c, float s) {
    const float x = a.x, y = a.y, z = a.z;
    const float one_c = 1.0f - c;
    return {{c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
             y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
             z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c}};
}

// Rotation about the constant unit axis of joint i by angle `ang`.
CHAIN_FN M3 rodrigues(int i, float ang) { return rodrigues(axis_of(i), cosf(ang), sinf(ang)); }

// R I R^T with I the constant body-frame inertia of body i.
CHAIN_FN M3 world_inertia(const M3& r, int i) {
    M3 inertia;
#pragma unroll
    for (int k = 0; k < 9; ++k) inertia.m[k] = model::inertia(i, k);
    return rotate_inertia(r, inertia);
}

// Body frames (rotation, origin) and world DOF axes. A scalar joint's DOF
// anchor is its body's frame origin.
struct Frames {
    M3 R[N];
    V3 P[N];
    V3 A[N];
};

CHAIN_FN void fk(const float (&q)[N], Frames& f) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int pi = model::parent(i);
        const V3 bp = {model::body_pos(i, 0), model::body_pos(i, 1), model::body_pos(i, 2)};
        const V3 ax = axis_of(i);
        if (pi < 0) {  // world parent: identity rotation, zero origin
            if (model::jtype(i) == 0) {
                f.P[i] = bp;
                f.R[i] = rodrigues(i, q[i]);
                f.A[i] = mv(f.R[i], ax);
            } else {
                f.P[i] = add(bp, scale(q[i], ax));
                f.R[i] = {{1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f}};
                f.A[i] = ax;
            }
        } else {
            const M3 rp = f.R[pi];
            const V3 base = add(f.P[pi], mv(rp, bp));
            if (model::jtype(i) == 0) {  // hinge
                f.P[i] = base;
                f.R[i] = mm(rp, rodrigues(i, q[i]));
                f.A[i] = mv(f.R[i], ax);
            } else {  // slide
                const V3 aw = mv(rp, ax);
                f.P[i] = add(base, scale(q[i], aw));
                f.R[i] = rp;
                f.A[i] = aw;
            }
        }
    }
}

// Upper triangle M[a][b], a <= b, of the joint-space mass matrix, and the
// RNEA bias at zero qdd (oracle.cpp mass_matrix_impl + bias_impl).
CHAIN_FN void mass_and_bias(const Frames& f, const float (&qd)[N],
                                              float (&M)[N][N], float (&bias)[N]) {
    V3 rc[N];
    M3 iw[N];
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = 0; b < N; ++b) M[a][b] = 0.f;
    // mass matrix: sum over bodies of m Jv^T Jv + Jw^T Iw Jw
#pragma unroll
    for (int i = 0; i < N; ++i) {
        rc[i] = mv(f.R[i], com_of(i));
        const V3 ci = add(f.P[i], rc[i]);
        iw[i] = world_inertia(f.R[i], i);
        V3 jv[N], jw[N];
#pragma unroll
        for (int d = 0; d <= i; ++d) {
            if (!model::ancestor(i, d)) continue;
            if (model::jtype(d) == 0) {
                jv[d] = cross(f.A[d], sub(ci, f.P[d]));
                jw[d] = f.A[d];
            } else {
                jv[d] = f.A[d];
            }
        }
#pragma unroll
        for (int a = 0; a <= i; ++a) {
            if (!model::ancestor(i, a)) continue;
#pragma unroll
            for (int b = a; b <= i; ++b) {
                if (!model::ancestor(i, b)) continue;
                float term = model::mass(i) * dot(jv[a], jv[b]);
                if (model::jtype(a) == 0 && model::jtype(b) == 0)
                    term = term + dot(jw[a], mv(iw[i], jw[b]));
                M[a][b] = M[a][b] + term;
            }
        }
    }
    // bias: forward velocity/acceleration recursion at qdd = 0 ...
    const V3 zero = {0.f, 0.f, 0.f};
    const V3 g = {model::gravity(0), model::gravity(1), model::gravity(2)};
    V3 w[N], dw[N], ao[N], fc[N], nc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int pi = model::parent(i);
        V3 wp = zero, dwp = zero, ap = zero, pp = zero;
        if (pi >= 0) {
            wp = w[pi];
            dwp = dw[pi];
            ap = ao[pi];
            pp = f.P[pi];
        }
        const V3 r = sub(f.P[i], pp);
        const V3 a = scale(qd[i], f.A[i]);
        const V3 wj = model::jtype(i) == 0 ? a : zero;
        const V3 vj = model::jtype(i) == 0 ? zero : a;
        w[i] = add(wp, wj);
        dw[i] = add(dwp, cross(wp, wj));
        ao[i] = add(add(ap, cross(dwp, r)),
                    add(cross(wp, cross(wp, r)), scale(2.0f, cross(wp, vj))));
        const V3 acc_c = add(ao[i], add(cross(dw[i], rc[i]), cross(w[i], cross(w[i], rc[i]))));
        fc[i] = scale(model::mass(i), sub(acc_c, g));
        nc[i] = add(mv(iw[i], dw[i]), cross(w[i], mv(iw[i], w[i])));
    }
    // ... then the backward force recursion
    V3 fa[N], na[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        fa[i] = zero;
        na[i] = zero;
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
        const int pi = model::parent(i);
        const V3 fi = add(fc[i], fa[i]);
        const V3 nmom = add(add(nc[i], cross(rc[i], fc[i])), na[i]);
        bias[i] = model::jtype(i) == 0 ? dot(f.A[i], nmom) : dot(f.A[i], fi);
        if (pi >= 0) {
            fa[pi] = add(fa[pi], fi);
            na[pi] = add(na[pi], add(nmom, cross(sub(f.P[i], f.P[pi]), fi)));
        }
    }
}

// Solve M x = rhs for the SPD M given by its upper triangle (unrolled
// Cholesky, then forward and back substitution); x overwrites rhs.
CHAIN_FN void chol_solve(const float (&M)[N][N], float (&x)[N]) {
    float L[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float s = M[j][i];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
            L[i][j] = (i == j) ? sqrtf(s) : s / L[j][j];
        }
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float s = x[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i][k] * x[k];
        x[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
        float s = x[i];
#pragma unroll
        for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
        x[i] = s / L[i][i];
    }
}

// One semi-implicit Euler substep from the frames f of q.
CHAIN_FN void substep(float (&q)[N], float (&qd)[N], const float (&u)[N], const Frames& f) {
    float M[N][N], bias[N], acc[N];
    mass_and_bias(f, qd, M, bias);
#pragma unroll
    for (int i = 0; i < N; ++i) {
        M[i][i] = M[i][i] + (model::armature(i) + model::DT * model::damping(i));
        float r = model::gear(i) * u[i] - bias[i] - model::damping(i) * qd[i]
                - model::stiffness(i) * q[i];
        if (model::frictionloss(i) != 0.0f)  // smooth Coulomb friction
            r = r - model::frictionloss(i) * tanhf(qd[i] * 50.0f);
        acc[i] = r;
    }
    chol_solve(M, acc);
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const float qdn = qd[i] + model::DT * acc[i];
        const float qn = q[i] + model::DT * qdn;
        const float clamped = fminf(fmaxf(qn, model::qlow(i)), model::qhigh(i));
        qd[i] = clamped == qn ? qdn : 0.0f;
        q[i] = clamped;
    }
}

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
// Rollout
// ---------------------------------------------------------------------------

enum Mode : int {
    COSTS = 0,  // costs only (_chain_kernel), one thread per particle
    OBS = 1,    // costs and pre-step observations (_chain_obs_kernel), one thread per particle
    CL = 2,     // closed-loop-linear (_chain_cl_kernel), a team per particle (chain_team.cuh)
    EXT = 3,    // external forces (_chain_ext_kernel), a team per particle (chain_team.cuh)
};

// Takes the observation one element at a time and stores it, so the
// observation is never held whole in registers.
struct ObsSink {
    float* __restrict__ o;  // this step's obs row

    CHAIN_FN void operator()(int j, float v) { o[j] = v; }
};

// Roll out particle b on one thread. noise [n, horizon, N], costs [n,
// horizon] and obs [n, horizon, D_OBS] (OBS) are contiguous f32; q0, qd0
// [N], extras [N_EXTRAS] and the mean [horizon, N] are shared; u =
// clip(mean[t] + eps). Observations are of the state entering each step,
// from the frames that serve that step's first substep; costs of the state
// after it.
template <int MODE, class Task>
CHAIN_FN void rollout_particle(const float* __restrict__ q0, const float* __restrict__ qd0,
                               const float* __restrict__ extras,
                               const float* __restrict__ mean,
                               const float* __restrict__ noise, float* __restrict__ costs,
                               float* __restrict__ obs, int b, int horizon) {
    static_assert(MODE == COSTS || MODE == OBS, "the one-thread kernel runs COSTS and OBS");
    float q[N], qd[N], u[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        q[i] = q0[i];
        qd[i] = qd0[i];
    }
    const typename Task::Extras ex = Task::load(extras);
    const float* nz = noise + static_cast<size_t>(b) * horizon * N;
    float* out = costs + static_cast<size_t>(b) * horizon;
    Frames f;
    fk(q, f);
    for (int t = 0; t < horizon; ++t) {
        const float* eps = nz + t * N;
        if constexpr (MODE == OBS) {
            const size_t row = static_cast<size_t>(b) * horizon + t;
            ObsSink sink{obs + row * Task::D_OBS};
            Task::obs(f, q, qd, ex, sink);
        }
#pragma unroll
        for (int j = 0; j < N; ++j)
            u[j] = fminf(fmaxf(mean[t * N + j] + eps[j], model::ULOW), model::UHIGH);
        substep(q, qd, u, f);
        for (int s = 1; s < model::N_SUBSTEPS; ++s) {
            fk(q, f);
            substep(q, qd, u, f);
        }
        fk(q, f);
        out[t] = Task::cost(f, ex);
    }
}

}  // namespace chain_rollout
