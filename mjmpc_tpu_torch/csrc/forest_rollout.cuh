// Per-particle arithmetic of the forest-rollout kernel (forest_rollout.cu)
// over the forest of forest_model.h (the model, its topology and the task,
// generated by mjmpc_tpu_torch/ops/forest_rollout.py model_header). The
// functions are host-and-device, so the same source also compiles as plain
// C++ (tests/test_torch_forest.py checks it on the CPU that way).
//
// The forest: trees of hinge/slide bodies (a body's parent comes before
// it) plus free root bodies without children. q[qoff(i)] and qd[voff(i)]
// are a scalar body's position and velocity, q[qoff(i) .. +7] (position,
// quaternion wxyz) and qd[voff(i) .. +6] (linear velocity, body-frame
// angular velocity) a free body's.
//
// The loops over bodies, ancestors and contact points stay rolled and read
// the topology from tables (forest::parent, depth, anc, ...): in __constant__
// memory on the card, where every thread of a warp reads the same entry.
// Unrolling them over a compile-time 25-body hand multiplies the code past
// what nvcc builds in reasonable time. The mass matrix is kept in packed
// ancestor-sparse rows: M[b][k] is the entry of the pair (anc(b, k), b), k <
// depth(b), the k-th body on b's root path (root first, b last). The
// forest's mass matrix is block-diagonal and a tree's block ordered
// ancestors-first factorises without fill-in outside ancestor pairs, so
// the Cholesky factor L takes the same slots, and nothing across trees is
// ever stored.
//
// Tasks (forest::TASK, and FOREST_TASK for the preprocessor): Pen (the
// 12-point pen contact and the pen cost, envs/pen.py), Peg (no contact, the
// depth-progress insertion cost of peg_cost.cuh) and GroundSpheres
// (spheres against the plane z = 0). A task gives N_EXTRAS, load() of its
// extras, forces() at the contact points, joint_torque() (the optional
// hook on the joints' generalized forces) and cost() of a post-step state.
// The contact primitives follow envs/contact.py formula for formula.

#pragma once

#include <math.h>
#include <stddef.h>

#ifndef __CUDACC__  // a host build (the tests' g++): the tables are plain arrays
#define __constant__
#endif

#include "forest_model.h"
#include "peg_cost.cuh"
#include "vec3.cuh"

#ifndef FOREST_TASK
#error "forest_model.h must define FOREST_TASK"
#endif

#define FOREST_FN __host__ __device__ __forceinline__

namespace forest_rollout {

using namespace vec3;
using forest::MAXD;
using forest::NB;
using forest::NQ;
using forest::NV;

constexpr int HINGE = 0;
constexpr int FREE = 2;
// array length of the per-point arrays (a task without contact has none)
constexpr int NP = forest::N_POINTS > 0 ? forest::N_POINTS : 1;

FOREST_FN V3 axis_of(int i) { return {forest::axis(i, 0), forest::axis(i, 1), forest::axis(i, 2)}; }

FOREST_FN V3 body_pos_of(int i) {
    return {forest::body_pos(i, 0), forest::body_pos(i, 1), forest::body_pos(i, 2)};
}

FOREST_FN V3 com_of(int i) { return {forest::com(i, 0), forest::com(i, 1), forest::com(i, 2)}; }

FOREST_FN V3 point_local_of(int k) {
    return {forest::point_local(k, 0), forest::point_local(k, 1), forest::point_local(k, 2)};
}

FOREST_FN M3 inertia_of(int i) {
    M3 out;
#pragma unroll
    for (int k = 0; k < 9; ++k) out.m[k] = forest::inertia(i, k);
    return out;
}

FOREST_FN V3 load3(const float* v) { return {v[0], v[1], v[2]}; }

FOREST_FN void add3(float* v, V3 a) {
    v[0] = v[0] + a.x;
    v[1] = v[1] + a.y;
    v[2] = v[2] + a.z;
}

// Rotation about the constant unit axis of joint i by angle `ang`.
FOREST_FN M3 rodrigues(int i, float ang) {
    const float c = cosf(ang), s = sinf(ang);
    const float x = forest::axis(i, 0), y = forest::axis(i, 1), z = forest::axis(i, 2);
    const float one_c = 1.0f - c;
    return {{c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
             y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
             z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c}};
}

// The rotation of a unit quaternion (w, x, y, z).
FOREST_FN M3 quat_to_mat(float w, float x, float y, float z) {
    return {{1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
             2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
             2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)}};
}

// Body frames (rotation, origin) and a scalar body's world DOF axis (its
// DOF anchor is its frame origin).
struct Frames {
    M3 R[NB];
    V3 P[NB];
    V3 A[NB];
};

FOREST_FN void fk(const float (&q)[NQ], Frames& f) {
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        const int pi = forest::parent(i);
        const V3 bp = body_pos_of(i);
        const int qi = forest::qoff(i);
        if (forest::jtype(i) == FREE) {  // a root: p = body_pos + translation
            f.P[i] = add(bp, {q[qi], q[qi + 1], q[qi + 2]});
            f.R[i] = quat_to_mat(q[qi + 3], q[qi + 4], q[qi + 5], q[qi + 6]);
            f.A[i] = {0.f, 0.f, 0.f};
            continue;
        }
        const V3 ax = axis_of(i);
        if (pi < 0) {  // world parent: identity rotation, zero origin
            if (forest::jtype(i) == HINGE) {
                f.P[i] = bp;
                f.R[i] = rodrigues(i, q[qi]);
                f.A[i] = mv(f.R[i], ax);
            } else {
                f.A[i] = ax;
                f.R[i] = {{1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f}};
                f.P[i] = add(bp, scale(q[qi], ax));
            }
        } else {
            const M3 rp = f.R[pi];
            const V3 base = add(f.P[pi], mv(rp, bp));
            if (forest::jtype(i) == HINGE) {
                f.P[i] = base;
                f.R[i] = mm(rp, rodrigues(i, q[qi]));
                f.A[i] = mv(f.R[i], ax);
            } else {  // slide
                const V3 aw = mv(rp, ax);
                f.A[i] = aw;
                f.R[i] = rp;
                f.P[i] = add(base, scale(q[qi], aw));
            }
        }
    }
}

// The translational Jacobian column of joint d at the world point p (on a
// body that d moves): a_d x (p - o_d) for a hinge, a_d for a slide.
FOREST_FN V3 point_column(const Frames& f, int d, V3 p) {
    return forest::jtype(d) == HINGE ? cross(f.A[d], sub(p, f.P[d])) : f.A[d];
}

// ---------------------------------------------------------------------------
// Contact primitives (envs/contact.py): the force on body A, branch-free.
// ---------------------------------------------------------------------------

// Spring-damper normal force along the unit normal n, gated on overlap > 0,
// plus Coulomb friction with smooth slip regularisation.
FOREST_FN V3 force_along(V3 n, float overlap, V3 rel_vel, float kp, float kd, float mu,
                         float v_slip = 0.02f) {
    const float vn = dot(rel_vel, n);
    const float push = fmaxf(kp * overlap - kd * vn, 0.0f);
    const float fn = overlap > 0.0f ? push : 0.0f;
    const V3 vt = sub(rel_vel, scale(vn, n));
    const float den = sqrtf(dot(vt, vt)) + v_slip;
    const float c = -mu * fn;
    return add(scale(fn, n), {c * vt.x / den, c * vt.y / den, c * vt.z / den});
}

// sep from the closest point on B to A's point, rel_vel = v_A - v_B,
// overlap = combined radius - distance.
FOREST_FN V3 penalty_force(V3 sep, V3 rel_vel, float overlap, float kp, float kd, float mu) {
    const float den = sqrtf(dot(sep, sep)) + 1e-9f;
    return force_along({sep.x / den, sep.y / den, sep.z / den}, overlap, rel_vel, kp, kd, mu);
}

// A sphere against the plane z = 0, along the plane's fixed +z normal.
FOREST_FN V3 sphere_plane_force(V3 p, V3 v, float r, float kp, float kd, float mu) {
    return force_along({0.f, 0.f, 1.f}, r - (p.z - 0.0f), v, kp, kd, mu);
}

// The closest point on segment ab to p, and its weight t.
FOREST_FN V3 closest_on_segment(V3 p, V3 a, V3 b, float& t) {
    const V3 d = sub(b, a);
    t = fminf(fmaxf(dot(sub(p, a), d) / (dot(d, d) + 1e-12f), 0.0f), 1.0f);
    return add(a, scale(t, d));
}

// A sphere (p, v, radius r) against a capsule segment (a, b with
// velocities va, vb, radius r_seg): the force on the sphere and the closest
// point's weight t (the capsule takes -(1 - t) f at a and -t f at b).
FOREST_FN V3 sphere_segment_force(V3 p, V3 v, float r, V3 a, V3 b, V3 va, V3 vb, float r_seg,
                                  float kp, float kd, float mu, float& t) {
    const V3 c = closest_on_segment(p, a, b, t);
    const V3 v_c = add(scale(1.0f - t, va), scale(t, vb));
    const V3 sep = sub(p, c);
    const float overlap = (r + r_seg) - sqrtf(dot(sep, sep));
    return penalty_force(sep, sub(v, v_c), overlap, kp, kd, mu);
}

// Closest points of segments a and b: p_a = lerp(a0, a1, s), p_b =
// lerp(b0, b1, t), the clamped pairwise recurrence.
FOREST_FN void segment_segment_closest(V3 a0, V3 a1, V3 b0, V3 b1, V3& pa, V3& pb, float& s,
                                       float& t) {
    const V3 d1 = sub(a1, a0), d2 = sub(b1, b0), r = sub(a0, b0);
    const float a = dot(d1, d1) + 1e-12f, e = dot(d2, d2) + 1e-12f, b = dot(d1, d2);
    const float c = dot(d1, r), f = dot(d2, r);
    const float denom = a * e - b * b;
    s = fminf(fmaxf(denom > 1e-12f ? (b * f - c * e) / denom : 0.0f, 0.0f), 1.0f);
    t = fminf(fmaxf((b * s + f) / e, 0.0f), 1.0f);
    s = fminf(fmaxf((b * t - c) / a, 0.0f), 1.0f);
    pa = add(a0, scale(s, d1));
    pb = add(b0, scale(t, d2));
}

// A moving capsule A (a0, a1 with velocities va0, va1) against a static
// capsule B: the force on A at its closest point and that point's weight s
// (A's ends take (1 - s) f and s f).
FOREST_FN V3 capsule_capsule_force(V3 a0, V3 a1, V3 va0, V3 va1, float ra, V3 b0, V3 b1,
                                   float rb, float kp, float kd, float mu, float& s) {
    V3 pa, pb;
    float t;
    segment_segment_closest(a0, a1, b0, b1, pa, pb, s, t);
    const V3 v = add(scale(1.0f - s, va0), scale(s, va1));
    const V3 sep = sub(pa, pb);
    const float overlap = (ra + rb) - sqrtf(dot(sep, sep));
    return penalty_force(sep, v, overlap, kp, kd, mu);
}

// Sphere A against sphere B (the force on A).
FOREST_FN V3 sphere_sphere_force(V3 pa, V3 va, float ra, V3 pb, V3 vb, float rb, float kp,
                                 float kd, float mu) {
    const V3 sep = sub(pa, pb);
    const float overlap = (ra + rb) - sqrtf(dot(sep, sep));
    return penalty_force(sep, sub(va, vb), overlap, kp, kd, mu);
}

// ---------------------------------------------------------------------------
// Tasks
// ---------------------------------------------------------------------------

// The site (forest::SITE_BODY, offset site_pos) in the world.
FOREST_FN V3 site_of(const Frames& f) {
    constexpr int sb = forest::SITE_BODY;
    const V3 sp = {forest::site_pos(0), forest::site_pos(1), forest::site_pos(2)};
    return add(f.P[sb], mv(f.R[sb], sp));
}

// What every task leaves alone: no joint torques of its own.
struct NoJointTorque {
    static FOREST_FN void joint_torque(const float (&)[NQ], const float (&)[NV], const Frames&,
                                       float (&)[NV]) {}
};

#if FOREST_TASK == 0
// pen-v0 (envs/pen.py): extras = [desired axis 3, kp, kd, mu, pen radius].
// Points: the tip and mid sphere of each digit (N_TIPS), then the pen
// capsule's two ends. The capsule ends rest on the palm plane and see-saw
// on the static ridge (its force split between the ends by its weight s);
// each finger sphere pushes the pen (the reaction split by t onto the two
// ends) and the palm plane pushes the finger; only finger-on-pen forces
// react onto the pen.
struct Pen : NoJointTorque {
    static constexpr int N_EXTRAS = 7;

    struct Extras {
        V3 desired;
        float kp, kd, mu, pen_r;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) {
        return {{e[0], e[1], e[2]}, e[3], e[4], e[5], e[6]};
    }

    static FOREST_FN void forces(const V3 (&p)[NP], const V3 (&v)[NP], const Extras& ex,
                                 V3 (&out)[NP]) {
        using namespace forest_task;
        constexpr int a = N_TIPS, b = N_TIPS + 1;
        const V3 ridge_a_ = {ridge_a(0), ridge_a(1), ridge_a(2)};
        const V3 ridge_b_ = {ridge_b(0), ridge_b(1), ridge_b(2)};
        V3 f_a = sphere_plane_force(p[a], v[a], ex.pen_r, ex.kp, ex.kd, ex.mu);
        V3 f_b = sphere_plane_force(p[b], v[b], ex.pen_r, ex.kp, ex.kd, ex.mu);
        float sr;
        const V3 f_ridge = capsule_capsule_force(p[a], p[b], v[a], v[b], ex.pen_r, ridge_a_,
                                                 ridge_b_, RIDGE_R, ex.kp, ex.kd, ex.mu, sr);
        f_a = add(f_a, scale(1.0f - sr, f_ridge));
        f_b = add(f_b, scale(sr, f_ridge));
#pragma unroll 1
        for (int k = 0; k < N_TIPS; ++k) {
            float t;
            const V3 f_pen = sphere_segment_force(p[k], v[k], tip_radius(k), p[a], p[b], v[a],
                                                  v[b], ex.pen_r, ex.kp, ex.kd, ex.mu, t);
            f_a = sub(f_a, scale(1.0f - t, f_pen));
            f_b = sub(f_b, scale(t, f_pen));
            out[k] = add(f_pen, sphere_plane_force(p[k], v[k], tip_radius(k), ex.kp, ex.kd, ex.mu));
        }
        out[a] = f_a;
        out[b] = f_b;
    }

    // -reward: -|pen - rest| + axis . desired, +10 / +50 at similarity >
    // 0.90 / 0.95 while within 0.075 of the rest position, -5 once the pen
    // is more than 0.15 from the axis horizontally.
    static FOREST_FN float cost(const Frames& f, const float (&)[NQ], const float (&)[NV],
                                const Extras& ex) {
        using namespace forest_task;
        const V3 pp = f.P[PEN_BODY];
        const M3& r = f.R[PEN_BODY];
        const V3 axis = {r.m[0], r.m[3], r.m[6]};
        const V3 diff = sub(pp, {desired_pos(0), desired_pos(1), desired_pos(2)});
        const float pos_err = sqrtf(dot(diff, diff));
        const float orien = dot(axis, ex.desired);
        const bool close = pos_err < 0.075f;
        const bool dropped = sqrtf(pp.x * pp.x + pp.y * pp.y) > 0.15f;
        const float reward = -pos_err + orien + (close && orien > 0.90f ? 10.0f : 0.0f)
                           + (close && orien > 0.95f ? 50.0f : 0.0f) - (dropped ? 5.0f : 0.0f);
        return -reward;
    }
};
using BuildTask = Pen;
#elif FOREST_TASK == 1
// Peg insertion (envs/sawyer_tasks.py): the arm alone, no contact; extras =
// [hole entry 3, hole axis 3, hole depth, sensor bias 3]; the cost of the
// site (the peg's tip) is peg_cost.cuh's.
struct Peg : NoJointTorque {
    static constexpr int N_EXTRAS = 10;
    using Extras = peg::Extras;

    static FOREST_FN Extras load(const float* __restrict__ e) { return peg::load(e); }

    static FOREST_FN void forces(const V3 (&)[NP], const V3 (&)[NP], const Extras&, V3 (&)[NP]) {}

    static FOREST_FN float cost(const Frames& f, const float (&)[NQ], const float (&)[NV],
                                const Extras& ex) {
        return peg::cost(site_of(f), ex);
    }
};
using BuildTask = Peg;
#elif FOREST_TASK == 2
// Spheres at the points (radius sphere_radius(k)) against the plane z = 0;
// extras = [kp, kd, mu, target 3]; cost = |site - target|.
struct GroundSpheres : NoJointTorque {
    static constexpr int N_EXTRAS = 6;

    struct Extras {
        float kp, kd, mu;
        V3 target;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) {
        return {e[0], e[1], e[2], {e[3], e[4], e[5]}};
    }

    static FOREST_FN void forces(const V3 (&p)[NP], const V3 (&v)[NP], const Extras& ex,
                                 V3 (&out)[NP]) {
#pragma unroll 1
        for (int k = 0; k < forest::N_POINTS; ++k)
            out[k] = sphere_plane_force(p[k], v[k], forest_task::sphere_radius(k), ex.kp, ex.kd,
                                        ex.mu);
    }

    static FOREST_FN float cost(const Frames& f, const float (&)[NQ], const float (&)[NV],
                                const Extras& ex) {
        const V3 d = sub(site_of(f), ex.target);
        return sqrtf(dot(d, d));
    }
};
using BuildTask = GroundSpheres;
#endif

static_assert(BuildTask::N_EXTRAS == forest::N_EXTRAS, "the task's extras and the header's differ");

// ---------------------------------------------------------------------------
// Physics
// ---------------------------------------------------------------------------

// The generalized forces tau [NV] of the task's contact forces: every
// point's world position and velocity, the task's force law, then the
// scatter through the same point Jacobians (a free body takes f on its
// linear dofs and l x R^T f on its angular ones).
template <class Task>
FOREST_FN void contact(const Frames& f, const float (&qd)[NV], const typename Task::Extras& ex,
                       float (&tau)[NV]) {
    V3 p[NP], v[NP], force[NP];
#pragma unroll 1
    for (int k = 0; k < forest::N_POINTS; ++k) {
        const int b = forest::point_body(k);
        const V3 l = point_local_of(k);
        p[k] = add(f.P[b], mv(f.R[b], l));
        if (forest::jtype(b) == FREE) {
            const int vi = forest::voff(b);
            v[k] = add(load3(&qd[vi]), mv(f.R[b], cross(load3(&qd[vi + 3]), l)));
        } else {
            V3 vk = {0.f, 0.f, 0.f};
#pragma unroll 1
            for (int kk = 0; kk < forest::depth(b); ++kk) {
                const int d = forest::anc(b, kk);
                vk = add(vk, scale(qd[forest::voff(d)], point_column(f, d, p[k])));
            }
            v[k] = vk;
        }
    }
    Task::forces(p, v, ex, force);
#pragma unroll 1
    for (int k = 0; k < forest::N_POINTS; ++k) {
        const int b = forest::point_body(k);
        if (forest::jtype(b) == FREE) {
            const int vi = forest::voff(b);
            add3(&tau[vi], force[k]);
            add3(&tau[vi + 3], cross(point_local_of(k), mtv(f.R[b], force[k])));
        } else {
#pragma unroll 1
            for (int kk = 0; kk < forest::depth(b); ++kk) {
                const int d = forest::anc(b, kk);
                const int vd = forest::voff(d);
                tau[vd] = tau[vd] + dot(point_column(f, d, p[k]), force[k]);
            }
        }
    }
}

// The joint-space mass matrix of the scalar bodies by Jacobian composition,
// in packed rows (M[b][k] the pair (anc(b, k), b)), and the RNEA bias at
// zero qdd (pallas_forest.py _tree_mass_and_bias, every tree at once).
FOREST_FN void mass_and_bias(const Frames& f, const float (&qd)[NV], float (&M)[NB][MAXD],
                             float (&bias)[NB]) {
    V3 rc[NB];
    M3 iw[NB];
#pragma unroll 1
    for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int k = 0; k < MAXD; ++k) M[i][k] = 0.f;
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        if (forest::jtype(i) == FREE) continue;
        rc[i] = mv(f.R[i], com_of(i));
        const V3 ci = add(f.P[i], rc[i]);
        iw[i] = rotate_inertia(f.R[i], inertia_of(i));
        const int di = forest::depth(i);
        const float mass = forest::mass(i);
        V3 jv[MAXD], mjv[MAXD], iwjw[MAXD];
#pragma unroll 1
        for (int k = 0; k < di; ++k) {
            const int d = forest::anc(i, k);
            if (forest::jtype(d) == HINGE) {
                jv[k] = cross(f.A[d], sub(ci, f.P[d]));
                iwjw[k] = mv(iw[i], f.A[d]);
            } else {
                jv[k] = f.A[d];
            }
            mjv[k] = scale(mass, jv[k]);
        }
#pragma unroll 1
        for (int ka = 0; ka < di; ++ka) {
            const int a = forest::anc(i, ka);
#pragma unroll 1
            for (int kb = ka; kb < di; ++kb) {
                const int b = forest::anc(i, kb);
                float term = dot(jv[ka], mjv[kb]);
                if (forest::jtype(a) == HINGE && forest::jtype(b) == HINGE)
                    term = term + dot(f.A[a], iwjw[kb]);
                M[b][ka] = M[b][ka] + term;
            }
        }
    }
    // the forward velocity/acceleration recursion at qdd = 0 ...
    const V3 zero = {0.f, 0.f, 0.f};
    const V3 g = {forest::gravity(0), forest::gravity(1), forest::gravity(2)};
    V3 w[NB], dw[NB], ao[NB], fc[NB], nc[NB];
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        if (forest::jtype(i) == FREE) continue;
        const int pi = forest::parent(i);
        V3 wp = zero, dwp = zero, ap = zero, pp = zero;
        if (pi >= 0) {
            wp = w[pi];
            dwp = dw[pi];
            ap = ao[pi];
            pp = f.P[pi];
        }
        const V3 r = sub(f.P[i], pp);
        const V3 a = scale(qd[forest::voff(i)], f.A[i]);
        const bool hinge = forest::jtype(i) == HINGE;
        const V3 wj = hinge ? a : zero;
        const V3 vj = hinge ? zero : a;
        w[i] = add(wp, wj);
        dw[i] = add(dwp, cross(wp, wj));
        ao[i] = add(add(ap, cross(dwp, r)),
                    add(cross(wp, cross(wp, r)), scale(2.0f, cross(wp, vj))));
        const V3 acc_c = add(ao[i], add(cross(dw[i], rc[i]), cross(w[i], cross(w[i], rc[i]))));
        fc[i] = scale(forest::mass(i), sub(acc_c, g));
        nc[i] = add(mv(iw[i], dw[i]), cross(w[i], mv(iw[i], w[i])));
    }
    // ... then the backward force recursion
    V3 fa[NB], na[NB];
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        fa[i] = zero;
        na[i] = zero;
    }
#pragma unroll 1
    for (int i = NB - 1; i >= 0; --i) {
        if (forest::jtype(i) == FREE) continue;
        const int pi = forest::parent(i);
        const V3 fi = add(fc[i], fa[i]);
        const V3 nmom = add(add(nc[i], cross(rc[i], fc[i])), na[i]);
        bias[i] = forest::jtype(i) == HINGE ? dot(f.A[i], nmom) : dot(f.A[i], fi);
        if (pi >= 0) {
            fa[pi] = add(fa[pi], fi);
            na[pi] = add(na[pi], add(nmom, cross(sub(f.P[i], f.P[pi]), fi)));
        }
    }
}

// Solve M x = rhs over the scalar bodies, M in packed rows: the
// ancestor-sparse Cholesky factor L overwrites M in the same slots (L(b, b)
// at M[b][depth(b) - 1]), then forward and back substitution; x overwrites
// rhs. The order of every sum is pallas_forest.py _tree_chol_solve's.
FOREST_FN void chol_solve(float (&M)[NB][MAXD], float (&x)[NB]) {
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        if (forest::jtype(i) == FREE) continue;
        const int di = forest::depth(i);
#pragma unroll 1
        for (int kj = 0; kj < di - 1; ++kj) {
            const int j = forest::anc(i, kj);
            float s = M[i][kj];
#pragma unroll 1
            for (int kk = 0; kk < kj; ++kk) s = s - M[i][kk] * M[j][kk];
            M[i][kj] = s / M[j][kj];
        }
        float s = M[i][di - 1];
#pragma unroll 1
        for (int kk = 0; kk < di - 1; ++kk) s = s - M[i][kk] * M[i][kk];
        M[i][di - 1] = sqrtf(s);
    }
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        if (forest::jtype(i) == FREE) continue;
        const int di = forest::depth(i);
        float s = x[i];
#pragma unroll 1
        for (int kk = 0; kk < di - 1; ++kk) s = s - M[i][kk] * x[forest::anc(i, kk)];
        x[i] = s / M[i][di - 1];
    }
#pragma unroll 1
    for (int i = NB - 1; i >= 0; --i) {
        if (forest::jtype(i) == FREE) continue;
        const int di = forest::depth(i);
        float s = x[i];
#pragma unroll 1
        for (int k = i + 1; k < NB; ++k)
            if (forest::ancestor(k, i)) s = s - M[k][di - 1] * x[k];
        x[i] = s / M[i][di - 1];
    }
}

// The unit quaternion exp(w / 2) of an axis-angle vector, with the
// small-angle series below |w|^2 = 1e-8.
FOREST_FN void exp_quat(V3 w, float (&out)[4]) {
    const float t2 = dot(w, w);
    const bool small = t2 < 1e-8f;
    const float t = sqrtf(small ? 1.0f : t2);
    const float half = 0.5f * t;
    const float sinc_half = small ? 0.5f - t2 / 48.0f : sinf(half) / t;
    out[0] = small ? 1.0f - t2 / 8.0f : cosf(half);
    out[1] = sinc_half * w.x;
    out[2] = sinc_half * w.y;
    out[3] = sinc_half * w.z;
}

// Free body i's substep from its generalized forces tau[voff(i) .. +6]:
// the Euler equations in (world-linear, body-angular) coordinates, then
// the retraction. With the com at the joint origin the blocks decouple:
// (m + reg) a = f + m g - damp v and (I_c + reg I) alpha = tau - w x I_c w -
// damp w, the 3x3 factor baked in the header; with an offset com the
// symmetric 6x6 system [[(m + reg) I, -m R [c]x], [., I_o + reg I]] [a;
// alpha] = [Q_v - m R (w x (w x c)); Q_w - m c x (w x (w x c)) - w x I_c w]
// (I_o = I_c - m [c]x [c]x, Q_v = f + m g - damp v, Q_w = tau - damp w + c x
// R^T m g) is factorised per particle, its B block depending on R. The
// header's coupled(i) picks the branch from the model's com.
FOREST_FN void free_substep(int i, const Frames& f, float (&q)[NQ], float (&qd)[NV],
                            const float (&tau)[NV]) {
    const int qi = forest::qoff(i), vi = forest::voff(i);
    const V3 v = load3(&qd[vi]), w = load3(&qd[vi + 3]);
    const V3 fl = load3(&tau[vi]), tb = load3(&tau[vi + 3]);
    const V3 mg = {forest::free_mg(i, 0), forest::free_mg(i, 1), forest::free_mg(i, 2)};
    const float damp_l = forest::free_damp_l(i), damp_a = forest::free_damp_a(i);
    const M3 ib = inertia_of(i);
    V3 acc_l, acc_a;
    if (!forest::coupled(i)) {
        const float inv_ml = forest::free_inv_ml(i);
        acc_l = {(fl.x + mg.x - damp_l * v.x) * inv_ml, (fl.y + mg.y - damp_l * v.y) * inv_ml,
                 (fl.z + mg.z - damp_l * v.z) * inv_ml};
        const V3 rhs = sub(sub(tb, cross(w, mv(ib, w))), scale(damp_a, w));
        const float l00 = forest::free_chol3(i, 0), l10 = forest::free_chol3(i, 1),
                    l20 = forest::free_chol3(i, 2), l11 = forest::free_chol3(i, 3),
                    l21 = forest::free_chol3(i, 4), l22 = forest::free_chol3(i, 5);
        const float y0 = rhs.x / l00;
        const float y1 = (rhs.y - l10 * y0) / l11;
        const float y2 = (rhs.z - l20 * y0 - l21 * y1) / l22;
        const float x2 = y2 / l22;
        const float x1 = (y1 - l21 * x2) / l11;
        const float x0 = (y0 - l10 * x1 - l20 * x2) / l00;
        acc_a = {x0, x1, x2};
    } else {
        const M3& r = f.R[i];
        const V3 cv = com_of(i);
        const float mass = forest::mass(i);
        const V3 q_v = sub(add(fl, mg), scale(damp_l, v));
        const V3 q_w = add(sub(tb, scale(damp_a, w)), cross(cv, mtv(r, mg)));
        const V3 wwc = cross(w, cross(w, cv));
        const V3 rhs_v = sub(q_v, scale(mass, mv(r, wwc)));
        const V3 rhs_w = sub(sub(q_w, scale(mass, cross(cv, wwc))), cross(w, mv(ib, w)));
        M3 mskew;
#pragma unroll
        for (int k = 0; k < 9; ++k) mskew.m[k] = forest::free_mskew(i, k);
        const M3 blk = mm(r, mskew);  // -m R [c]x
        float m6[6][6], x6[6] = {rhs_v.x, rhs_v.y, rhs_v.z, rhs_w.x, rhs_w.y, rhs_w.z};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int b = a; b < 3; ++b) {
                m6[a][b] = a == b ? forest::free_m_reg_l(i) : 0.0f;
                m6[3 + a][3 + b] = forest::free_i_o(i, 3 * a + b)
                                 + (a == b ? forest::free_reg_a(i) : 0.0f);
            }
#pragma unroll
            for (int b = 0; b < 3; ++b) m6[a][3 + b] = blk.m[3 * a + b];
        }
        // dense Cholesky of the upper triangle, L in the lower one
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int b = 0; b < a; ++b) {
                float s = m6[b][a];
#pragma unroll
                for (int k = 0; k < b; ++k) s = s - m6[a][k] * m6[b][k];
                m6[a][b] = s / m6[b][b];
            }
            float s = m6[a][a];
#pragma unroll
            for (int k = 0; k < a; ++k) s = s - m6[a][k] * m6[a][k];
            m6[a][a] = sqrtf(s);
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
            float s = x6[a];
#pragma unroll
            for (int k = 0; k < a; ++k) s = s - m6[a][k] * x6[k];
            x6[a] = s / m6[a][a];
        }
#pragma unroll
        for (int a = 5; a >= 0; --a) {
            float s = x6[a];
#pragma unroll
            for (int k = a + 1; k < 6; ++k) s = s - m6[k][a] * x6[k];
            x6[a] = s / m6[a][a];
        }
        acc_l = {x6[0], x6[1], x6[2]};
        acc_a = {x6[3], x6[4], x6[5]};
    }
    const V3 v_new = add(v, scale(forest::DT, acc_l));
    const V3 w_new = add(w, scale(forest::DT, acc_a));
    const V3 pos_new = add(load3(&q[qi]), scale(forest::DT, v_new));
    float e[4];
    exp_quat(scale(forest::DT, w_new), e);
    const float aw = q[qi + 3], ax = q[qi + 4], ay = q[qi + 5], az = q[qi + 6];
    const float n0 = aw * e[0] - ax * e[1] - ay * e[2] - az * e[3];
    const float n1 = aw * e[1] + ax * e[0] + ay * e[3] - az * e[2];
    const float n2 = aw * e[2] - ax * e[3] + ay * e[0] + az * e[1];
    const float n3 = aw * e[3] + ax * e[2] - ay * e[1] + az * e[0];
    const float norm = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + n3 * n3);
    q[qi] = pos_new.x;
    q[qi + 1] = pos_new.y;
    q[qi + 2] = pos_new.z;
    q[qi + 3] = n0 / norm;
    q[qi + 4] = n1 / norm;
    q[qi + 5] = n2 / norm;
    q[qi + 6] = n3 / norm;
    qd[vi] = v_new.x;
    qd[vi + 1] = v_new.y;
    qd[vi + 2] = v_new.z;
    qd[vi + 3] = w_new.x;
    qd[vi + 4] = w_new.y;
    qd[vi + 5] = w_new.z;
}

// One semi-implicit Euler substep from the frames f of q under the
// controls ub [NB] (zero on bodies without an action).
template <class Task>
FOREST_FN void substep(float (&q)[NQ], float (&qd)[NV], const float (&ub)[NB], const Frames& f,
                       const typename Task::Extras& ex) {
    float tau[NV];
#pragma unroll 1
    for (int k = 0; k < NV; ++k) tau[k] = 0.0f;
    if constexpr (forest::N_POINTS > 0) contact<Task>(f, qd, ex, tau);
    Task::joint_torque(q, qd, f, tau);
    float M[NB][MAXD], bias[NB], acc[NB];
    mass_and_bias(f, qd, M, bias);
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        if (forest::jtype(i) == FREE) continue;
        const int vi = forest::voff(i), qi = forest::qoff(i);
        const int di = forest::depth(i);
        M[i][di - 1] = M[i][di - 1] + forest::reg(i);
        float r = forest::gear(i) * ub[i] - bias[i] - forest::damping(i) * qd[vi]
                - forest::stiffness(i) * q[qi] + tau[vi];
        if (forest::frictionloss(i) != 0.0f)  // smooth Coulomb friction
            r = r - forest::frictionloss(i) * tanhf(qd[vi] * 50.0f);
        acc[i] = r;
    }
    chol_solve(M, acc);
#pragma unroll 1
    for (int i = 0; i < NB; ++i) {
        if (forest::jtype(i) == FREE) {
            free_substep(i, f, q, qd, tau);
            continue;
        }
        const int vi = forest::voff(i), qi = forest::qoff(i);
        const float qdn = qd[vi] + forest::DT * acc[i];
        const float qn = q[qi] + forest::DT * qdn;
        const float clamped = fminf(fmaxf(qn, forest::qlow(i)), forest::qhigh(i));
        qd[vi] = clamped == qn ? qdn : 0.0f;
        q[qi] = clamped;
    }
}

// Roll out particle b: noise [n, horizon, D_ACT] and costs [n, horizon]
// contiguous f32; q0 [NQ], qd0 [NV], extras [N_EXTRAS] and mean [horizon,
// D_ACT] shared. u = clip(mean[t] + noise[b, t]) on the bodies act_body(j),
// held for N_SUBSTEPS substeps; costs[b, t] = the task's cost of the state
// after step t.
template <class Task>
FOREST_FN void rollout_particle(const float* __restrict__ q0, const float* __restrict__ qd0,
                                const float* __restrict__ extras,
                                const float* __restrict__ mean,
                                const float* __restrict__ noise, float* __restrict__ costs,
                                int b, int horizon) {
    float q[NQ], qd[NV], ub[NB];
#pragma unroll 1
    for (int i = 0; i < NQ; ++i) q[i] = q0[i];
#pragma unroll 1
    for (int i = 0; i < NV; ++i) qd[i] = qd0[i];
    const typename Task::Extras ex = Task::load(extras);
    const float* nz = noise + static_cast<size_t>(b) * horizon * forest::D_ACT;
    float* out = costs + static_cast<size_t>(b) * horizon;
    Frames f;
#pragma unroll 1
    for (int t = 0; t < horizon; ++t) {
#pragma unroll 1
        for (int i = 0; i < NB; ++i) ub[i] = 0.0f;
#pragma unroll 1
        for (int j = 0; j < forest::D_ACT; ++j)
            ub[forest::act_body(j)] =
                fminf(fmaxf(mean[t * forest::D_ACT + j] + nz[t * forest::D_ACT + j], forest::ULOW),
                      forest::UHIGH);
#pragma unroll 1
        for (int s = 0; s < forest::N_SUBSTEPS; ++s) {
            fk(q, f);
            substep<Task>(q, qd, ub, f, ex);
        }
        fk(q, f);
        out[t] = Task::cost(f, q, qd, ex);
    }
}

}  // namespace forest_rollout
