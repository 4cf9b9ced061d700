// Per-particle arithmetic of the chain-rollout kernel (chain_rollout.cu):
// straight-line code over the compile-time model of chain_model.h. The
// functions are host-and-device, so the same source also compiles as plain
// C++ (tests/test_torch_chain_rollout.py and tests/test_torch_obs_rollout.py
// check it on the CPU that way).

#pragma once

#include <math.h>
#include <stddef.h>

#include "chain_model.h"

#define CHAIN_FN __host__ __device__ __forceinline__

namespace chain_rollout {

using model::N;

struct V3 {
    float x, y, z;
};

struct M3 {
    float m[9];  // row-major
};

CHAIN_FN V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
CHAIN_FN V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
CHAIN_FN V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
CHAIN_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

CHAIN_FN V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

CHAIN_FN V3 mv(const M3& r, V3 v) {
    return {r.m[0] * v.x + r.m[1] * v.y + r.m[2] * v.z,
            r.m[3] * v.x + r.m[4] * v.y + r.m[5] * v.z,
            r.m[6] * v.x + r.m[7] * v.y + r.m[8] * v.z};
}

CHAIN_FN M3 mm(const M3& a, const M3& b) {
    M3 out;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            out.m[3 * i + j] = a.m[3 * i] * b.m[j] + a.m[3 * i + 1] * b.m[3 + j]
                             + a.m[3 * i + 2] * b.m[6 + j];
    return out;
}

CHAIN_FN V3 axis_of(int i) {
    return {model::axis(i, 0), model::axis(i, 1), model::axis(i, 2)};
}

CHAIN_FN V3 com_of(int i) {
    return {model::com(i, 0), model::com(i, 1), model::com(i, 2)};
}

// Rotation about the constant unit axis of joint i by angle `ang`.
CHAIN_FN M3 rodrigues(int i, float ang) {
    const float c = cosf(ang), s = sinf(ang);
    const float x = model::axis(i, 0), y = model::axis(i, 1), z = model::axis(i, 2);
    const float one_c = 1.0f - c;
    return {{c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
             y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
             z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c}};
}

// R I R^T with I the constant body-frame inertia of body i.
CHAIN_FN M3 world_inertia(const M3& r, int i) {
    M3 inertia;
#pragma unroll
    for (int k = 0; k < 9; ++k) inertia.m[k] = model::inertia(i, k);
    const M3 ri = mm(r, inertia);
    M3 out;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
            out.m[3 * a + b] = ri.m[3 * a] * r.m[3 * b] + ri.m[3 * a + 1] * r.m[3 * b + 1]
                             + ri.m[3 * a + 2] * r.m[3 * b + 2];
    return out;
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
CHAIN_FN void substep(float (&q)[N], float (&qd)[N], const float (&u)[N],
                                        const Frames& f) {
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

CHAIN_FN float site_cost(const Frames& f, V3 target) {
    const V3 d = sub(site_of(f), target);
    const float l1 = fabsf(d.x) + fabsf(d.y) + fabsf(d.z);
    const float l2 = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z + 1e-12f);
    return l1 + 5.0f * l2;
}

// Reacher-family observation [q, qd, site, site - target] of the state
// whose frames are f (envs/reacher_7dof.py _observe).
constexpr int D_OBS = 2 * N + 6;

CHAIN_FN void write_obs(const Frames& f, const float (&q)[N], const float (&qd)[N], V3 target,
                        float* __restrict__ o) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        o[i] = q[i];
        o[N + i] = qd[i];
    }
    const V3 s = site_of(f);
    o[2 * N + 0] = s.x;
    o[2 * N + 1] = s.y;
    o[2 * N + 2] = s.z;
    o[2 * N + 3] = s.x - target.x;
    o[2 * N + 4] = s.y - target.y;
    o[2 * N + 5] = s.z - target.z;
}

// Roll out particle b: noise [n, horizon, N] and costs [n, horizon] are
// contiguous f32; q0, qd0 [N], target [3] and mean [horizon, N] are shared.
// With EMIT_OBS, obs [n, horizon, D_OBS] also receives the observation of
// the state entering each step (the pre-step state, as rollout_open_loop
// records it), from the same frames that serve that step's first substep.
template <bool EMIT_OBS = false>
CHAIN_FN void rollout_particle(const float* __restrict__ q0, const float* __restrict__ qd0,
                               const float* __restrict__ target,
                               const float* __restrict__ mean,
                               const float* __restrict__ noise, float* __restrict__ costs,
                               int b, int horizon, float* __restrict__ obs = nullptr) {
    float q[N], qd[N], u[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        q[i] = q0[i];
        qd[i] = qd0[i];
    }
    const V3 tgt = {target[0], target[1], target[2]};
    const float* nz = noise + static_cast<size_t>(b) * horizon * N;
    float* out = costs + static_cast<size_t>(b) * horizon;
    Frames f;
    fk(q, f);
    for (int t = 0; t < horizon; ++t) {
        if constexpr (EMIT_OBS)
            write_obs(f, q, qd, tgt, obs + (static_cast<size_t>(b) * horizon + t) * D_OBS);
#pragma unroll
        for (int j = 0; j < N; ++j)
            u[j] = fminf(fmaxf(mean[t * N + j] + nz[t * N + j], model::ULOW), model::UHIGH);
        substep(q, qd, u, f);
        for (int s = 1; s < model::N_SUBSTEPS; ++s) {
            fk(q, f);
            substep(q, qd, u, f);
        }
        fk(q, f);
        out[t] = site_cost(f, tgt);
    }
}

}  // namespace chain_rollout
