// Per-particle arithmetic of the forest-rollout kernel (forest_rollout.cu),
// written for a team of forest::TEAM lanes that carries one particle, over
// the forest of forest_model.h (the model, its topology, the team's work
// tables and the task, generated by mjmpc_tpu_torch/ops/forest_rollout.py
// model_header). The functions are host-and-device, so the same source
// also compiles as plain C++ (tests/test_torch_forest.py checks it on the
// CPU that way).
//
// The forest: trees of hinge/slide bodies (a body's parent comes before
// it) plus free root bodies without children. q[qoff(i)] and qd[voff(i)]
// are a scalar body's position and velocity, q[qoff(i) .. +7] (position,
// quaternion wxyz) and qd[voff(i) .. +6] (linear velocity, body-frame
// angular velocity) a free body's.
//
// A particle's whole state lives in a Particle, in shared memory on the
// card. A substep is a sequence of phases; in each, every lane of the team
// works on its own items of the header's tables (bodies of one tree level,
// contact points, (body, ancestor) slots, mass-matrix pairs) and writes only
// its own items' outputs, reading what earlier phases wrote; the team syncs
// between phases (phase()). On the host the lanes of a phase run one after
// another, so the CPU build runs the kernel's own partition and order.
// Every sum keeps the plain version's order (ops/forest_rollout.py
// forest_substep), whatever the team size: a sum is never split between
// lanes, and there are no atomics, so two launches give the same costs.
//
// The loops over bodies, ancestors and contact points stay rolled and read
// the topology from tables (forest::parent, depth, anc, ...): unrolling them
// over a compile-time 25-body hand multiplies the code past what nvcc
// builds in reasonable time. The mass matrix is kept in packed
// ancestor-sparse rows: M[b][k] is the entry of the pair (anc(b, k), b), k <
// depth(b), the k-th body on b's root path (root first, b last). The
// forest's mass matrix is block-diagonal and a tree's block ordered
// ancestors-first factorises without fill-in outside ancestor pairs, so
// the Cholesky factor L takes the same slots (its diagonal apart, in ld),
// and nothing across trees is ever stored.
//
// Tasks (forest::TASK, and FOREST_TASK for the preprocessor): Pen (the
// 12-point pen contact and the pen cost, envs/pen.py), Peg (no contact, the
// depth-progress insertion cost of peg_cost.cuh), GroundSpheres (spheres
// against the plane z = 0), Relocate (the 12-point ball contact, the hand's
// weight on the arm's z slide and the relocate cost, envs/relocate.py),
// Hammer (the 15-point handle, table and strike contact, the hand's weight
// and the nail's dry friction, the hammer cost, envs/hammer.py), SawyerDoor
// (the grab spring on the door's handle) and Pusher (the hand-block
// contact between two scalar trees), both envs/sawyer_tasks.py, Tray (no
// contact, the arm's gravity feed-forward from the FK's frames,
// envs/panda_tasks.py) and Door (the 13-point handle contact, the hand's
// weight, the latch's spring and the strike plate, envs/hand_door.py). A task
// gives N_EXTRAS, load() of its extras, point_force() of one contact point
// (its first N_FIRST points on a team's first group, the rest on its last;
// for a force law that sums over points, N_SUMS sums in sum_forces()),
// joint_torque() (the optional hook on a scalar joint's generalized force,
// after the contact forces) and cost() of a post-step state. The contact
// primitives follow envs/contact.py formula for formula.

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
using forest::TEAM;

static_assert(TEAM == 1 || TEAM == 2 || TEAM == 4 || TEAM == 8 || TEAM == 16 || TEAM == 32,
              "a team's group is a power of two of lanes within one warp");
// A particle's lanes: TEAM in each of GROUPS = 2 warps. Lanes [0, TEAM) are
// the first group, [TEAM, LANES) the last. Where a phase has two kinds of
// work, the first group takes one and the last group the other, so that
// they run side by side, not one after the other in a warp.
constexpr int GROUPS = 2;
constexpr int LANES = TEAM * GROUPS;

FOREST_FN bool first_group(int lane) { return lane < TEAM; }
FOREST_FN bool last_group(int lane) { return lane >= LANES - TEAM; }

constexpr int HINGE = 0;
constexpr int FREE = 2;
// array lengths of the per-point and per-slot arrays (a task without
// contact has no points)
constexpr int NP = forest::N_POINTS > 0 ? forest::N_POINTS : 1;
constexpr int NS = forest::N_SLOTS > 0 ? forest::N_SLOTS : 1;

// A body's joint kind. The kinds a model lacks (the header's HAS_FREE,
// HAS_SLIDE) are decided at compile time, so their code is not built: a
// smaller kernel, which the instruction cache holds better.
FOREST_FN bool is_free(int i) { return forest::HAS_FREE && forest::jtype(i) == FREE; }
FOREST_FN bool is_hinge(int i) {
    return forest::HAS_SLIDE ? forest::jtype(i) == HINGE : !is_free(i);
}

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

// Rotation about the constant unit axis of joint i by the angle whose
// cosine and sine are c and s.
FOREST_FN M3 rodrigues(int i, float c, float s) {
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

// One particle's state, in shared memory on the card.
struct Particle {
    float q[NQ], qd[NV];
    float ub[NB];    // the step's controls per body (zero on bodies without an action)
    float tau[NV];   // the generalized contact forces
    // body frames (rotation, origin) and a scalar body's world DOF axis (its
    // DOF anchor is its frame origin)
    M3 R[NB];
    V3 P[NB], A[NB];
    float cq[NB], sq[NB];  // a hinge's cos and sin of its angle
    // per scalar body: com offset R c, world inertia, the RNEA's forward
    // terms at qdd = 0 and what the backward pass hands to the parent
    V3 rc[NB];
    M3 iw[NB];
    V3 w[NB], dw[NB], ao[NB], fc[NB], nc[NB];
    V3 fi[NB], nmom[NB];
    // per slot (scalar body i, the k-th body d on its root path): the
    // translational Jacobian column of i's com for d, and iw_i a_d
    V3 jv[NS], iwa[NS];
    float M[NB][MAXD];  // packed mass rows, then L off the diagonal
    float ld[NB];       // L's diagonal
    float bias[NB];
    float x[NB];        // the solve's right-hand side, then qdd
    // contact points: world position, velocity, force; the task's scratch
    V3 p[NP], v[NP], f[NP];
    V3 pf[NP];
    float pt[NP];
};

// A thread's place in its team: its lane.
struct Team {
    int lane;
};

// The kinds of phase, as the optional cycle count names them.
enum PhaseKind { PH_INIT, PH_FK, PH_POINTS, PH_FORCES, PH_SUMS, PH_MASS, PH_CHOL, PH_FORWARD,
                 PH_BACK, PH_COST, N_PHASE_KINDS };

#if defined(__CUDACC__) && defined(FOREST_PHASE_CLOCKS)
// A build with -DFOREST_PHASE_CLOCKS sums the clock64() cycles of each kind
// of phase, sync included, as the first thread of block 0 sees them (its
// particle's whole chain); forest_rollout_phase_cycles reads them.
__device__ unsigned long long phase_cycles[N_PHASE_KINDS];
#endif

// One phase: f(lane) for every lane of the team, then the team syncs (with
// its block: its groups are in two warps). On the card each thread runs
// its own lane; on the host the lanes run one after another.
template <class F>
FOREST_FN void phase(const Team& team, PhaseKind kind, F&& f) {
#ifdef __CUDA_ARCH__
#ifdef FOREST_PHASE_CLOCKS
    const long long start = clock64();
#endif
    f(team.lane);
    __syncthreads();
#ifdef FOREST_PHASE_CLOCKS
    if (blockIdx.x == 0 && threadIdx.x == 0) phase_cycles[kind] += clock64() - start;
#endif
#else
    (void)team;
    (void)kind;
    for (int lane = 0; lane < LANES; ++lane) f(lane);
#endif
}

// ---------------------------------------------------------------------------
// Kinematics
// ---------------------------------------------------------------------------

// Body i's frame from its parent's, then (a scalar body) the RNEA's
// forward recursion at qdd = 0 (pallas_forest.py _tree_mass_and_bias): the
// part of it that its children read.
FOREST_FN void fk_body(Particle& s, int i) {
    const int pi = forest::parent(i);
    const V3 bp = body_pos_of(i);
    const int qi = forest::qoff(i);
    if (is_free(i)) {  // a root: p = body_pos + translation
        s.P[i] = add(bp, {s.q[qi], s.q[qi + 1], s.q[qi + 2]});
        s.R[i] = quat_to_mat(s.q[qi + 3], s.q[qi + 4], s.q[qi + 5], s.q[qi + 6]);
        s.A[i] = {0.f, 0.f, 0.f};
        return;
    }
    const V3 ax = axis_of(i);
    const bool hinge = is_hinge(i);
    M3 r;
    V3 p, a;
    if (pi < 0) {  // world parent: identity rotation, zero origin
        if (hinge) {
            p = bp;
            r = rodrigues(i, s.cq[i], s.sq[i]);
            a = mv(r, ax);
        } else {
            a = ax;
            r = {{1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f}};
            p = add(bp, scale(s.q[qi], ax));
        }
    } else {
        const M3 rp = s.R[pi];
        const V3 base = add(s.P[pi], mv(rp, bp));
        if (hinge) {
            p = base;
            r = mm(rp, rodrigues(i, s.cq[i], s.sq[i]));
            a = mv(r, ax);
        } else {  // slide
            a = mv(rp, ax);
            r = rp;
            p = add(base, scale(s.q[qi], a));
        }
    }
    s.R[i] = r;
    s.P[i] = p;
    s.A[i] = a;
    const V3 zero = {0.f, 0.f, 0.f};
    V3 wp = zero, dwp = zero, ap = zero, pp = zero;
    if (pi >= 0) {
        wp = s.w[pi];
        dwp = s.dw[pi];
        ap = s.ao[pi];
        pp = s.P[pi];
    }
    const V3 rr = sub(p, pp);
    const V3 av = scale(s.qd[forest::voff(i)], a);
    const V3 wj = hinge ? av : zero;
    const V3 vj = hinge ? zero : av;
    s.w[i] = add(wp, wj);
    s.dw[i] = add(dwp, cross(wp, wj));
    s.ao[i] = add(add(ap, cross(dwp, rr)),
                  add(cross(wp, cross(wp, rr)), scale(2.0f, cross(wp, vj))));
}

// Scalar body i's com offset R c, world inertia and the RNEA's force and
// moment terms at qdd = 0, from its frame and forward terms.
FOREST_FN void body_terms(Particle& s, int i) {
    const V3 g = {forest::gravity(0), forest::gravity(1), forest::gravity(2)};
    const M3 r = s.R[i];
    const V3 rc = mv(r, com_of(i));
    const M3 iw = rotate_inertia(r, inertia_of(i));
    const V3 w = s.w[i], dw = s.dw[i];
    const V3 acc_c = add(s.ao[i], add(cross(dw, rc), cross(w, cross(w, rc))));
    s.rc[i] = rc;
    s.iw[i] = iw;
    s.fc[i] = scale(forest::mass(i), sub(acc_c, g));
    s.nc[i] = add(mv(iw, dw), cross(w, mv(iw, w)));
}

// FK and the RNEA's forward recursion over the forest: every hinge's cos
// and sin at once, then down the tree levels, then every scalar body's own
// terms at once.
FOREST_FN void fk_pass(Particle& s, const Team& team) {
    phase(team, PH_FK, [&](int lane) {
#pragma unroll 1
        for (int i = lane; i < NB; i += LANES) {
            if (is_hinge(i)) {
                const float ang = s.q[forest::qoff(i)];
                s.cq[i] = cosf(ang);
                s.sq[i] = sinf(ang);
            }
        }
    });
#pragma unroll 1
    for (int lv = 0; lv < forest::N_LEVELS; ++lv)
        phase(team, PH_FK, [&](int lane) {
#pragma unroll 1
            for (int e = forest::level_start(lv) + lane; e < forest::level_start(lv + 1);
                 e += LANES)
                fk_body(s, forest::level_body(e));
        });
    phase(team, PH_FK, [&](int lane) {
#pragma unroll 1
        for (int i = lane; i < NB; i += LANES)
            if (!is_free(i)) body_terms(s, i);
    });
}

// The translational Jacobian column of joint d at the world point p (on a
// body that d moves): a_d x (p - o_d) for a hinge, a_d for a slide.
FOREST_FN V3 point_column(const Particle& s, int d, V3 p) {
    return is_hinge(d) ? cross(s.A[d], sub(p, s.P[d])) : s.A[d];
}

// Contact point k's world position and velocity.
FOREST_FN void point_state(Particle& s, int k) {
    const int b = forest::point_body(k);
    const V3 l = point_local_of(k);
    const V3 p = add(s.P[b], mv(s.R[b], l));
    s.p[k] = p;
    if (is_free(b)) {
        const int vi = forest::voff(b);
        s.v[k] = add(load3(&s.qd[vi]), mv(s.R[b], cross(load3(&s.qd[vi + 3]), l)));
        return;
    }
    V3 vk = {0.f, 0.f, 0.f};
    const int db = forest::depth(b);
#pragma unroll
    for (int kk = 0; kk < MAXD; ++kk) {
        if (kk < db) {
            const int d = forest::anc(b, kk);
            vk = add(vk, scale(s.qd[forest::voff(d)], point_column(s, d, p)));
        }
    }
    s.v[k] = vk;
}

// Slot sl, (scalar body i, the k-th body d on its root path): the column
// a_d x (c_i - o_d) of i's com (a_d for a slide) and iw_i a_d.
FOREST_FN void com_slot(Particle& s, int sl) {
    const int i = forest::slot_body(sl);
    const int d = forest::anc(i, forest::slot_k(sl));
    if (is_hinge(d)) {
        const V3 ci = add(s.P[i], s.rc[i]);
        s.jv[sl] = cross(s.A[d], sub(ci, s.P[d]));
        s.iwa[sl] = mv(s.iw[i], s.A[d]);
    } else {
        s.jv[sl] = s.A[d];
    }
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
FOREST_FN V3 site_of(const Particle& s) {
    constexpr int sb = forest::SITE_BODY;
    const V3 sp = {forest::site_pos(0), forest::site_pos(1), forest::site_pos(2)};
    return add(s.P[sb], mv(s.R[sb], sp));
}

// What every task leaves alone: no joint torques of its own. The hook
// adds to scalar body i's generalized force `tau` after the contact forces.
struct NoJointTorque {
    template <class Extras>
    static FOREST_FN void joint_torque(const Particle&, const Extras&, int, float&) {}
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
    static constexpr int N_SUMS = 2;  // the two ends' sums over the tips
    static constexpr int N_FIRST = forest_task::N_TIPS;  // the tips; then the ends

    struct Extras {
        V3 desired;
        float kp, kd, mu, pen_r;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) {
        return {{e[0], e[1], e[2]}, e[3], e[4], e[5], e[6]};
    }

    // A tip's force (its push on the pen and its weight t kept for the
    // ends' sums); for the first end, both ends' plane and ridge forces.
    static FOREST_FN void point_force(Particle& s, const Extras& ex, int k) {
        using namespace forest_task;
        constexpr int a = N_TIPS, b = N_TIPS + 1;
        if (k < N_TIPS) {
            float t;
            const V3 f_pen = sphere_segment_force(s.p[k], s.v[k], tip_radius(k), s.p[a], s.p[b],
                                                  s.v[a], s.v[b], ex.pen_r, ex.kp, ex.kd, ex.mu, t);
            s.pf[k] = f_pen;
            s.pt[k] = t;
            s.f[k] = add(f_pen, sphere_plane_force(s.p[k], s.v[k], tip_radius(k), ex.kp, ex.kd,
                                                   ex.mu));
        } else if (k == a) {
            const V3 ridge_a_ = {ridge_a(0), ridge_a(1), ridge_a(2)};
            const V3 ridge_b_ = {ridge_b(0), ridge_b(1), ridge_b(2)};
            const V3 f_a = sphere_plane_force(s.p[a], s.v[a], ex.pen_r, ex.kp, ex.kd, ex.mu);
            const V3 f_b = sphere_plane_force(s.p[b], s.v[b], ex.pen_r, ex.kp, ex.kd, ex.mu);
            float sr;
            const V3 f_ridge = capsule_capsule_force(s.p[a], s.p[b], s.v[a], s.v[b], ex.pen_r,
                                                     ridge_a_, ridge_b_, RIDGE_R, ex.kp, ex.kd,
                                                     ex.mu, sr);
            s.pf[a] = add(f_a, scale(1.0f - sr, f_ridge));
            s.pf[b] = add(f_b, scale(sr, f_ridge));
        }
    }

    // End e (0: a, 1: b) takes the tips' reactions, in tip order.
    static FOREST_FN void sum_forces(Particle& s, int e) {
        using namespace forest_task;
        const int end = N_TIPS + e;
        V3 f = s.pf[end];
#pragma unroll
        for (int k = 0; k < N_TIPS; ++k)
            f = sub(f, scale(e == 0 ? 1.0f - s.pt[k] : s.pt[k], s.pf[k]));
        s.f[end] = f;
    }

    // -reward: -|pen - rest| + axis . desired, +10 / +50 at similarity >
    // 0.90 / 0.95 while within 0.075 of the rest position, -5 once the pen
    // is more than 0.15 from the axis horizontally.
    static FOREST_FN float cost(const Particle& s, const Extras& ex) {
        using namespace forest_task;
        const V3 pp = s.P[PEN_BODY];
        const M3& r = s.R[PEN_BODY];
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
    static constexpr int N_SUMS = 0;
    static constexpr int N_FIRST = 0;
    using Extras = peg::Extras;

    static FOREST_FN Extras load(const float* __restrict__ e) { return peg::load(e); }

    static FOREST_FN void point_force(Particle&, const Extras&, int) {}

    static FOREST_FN void sum_forces(Particle&, int) {}

    static FOREST_FN float cost(const Particle& s, const Extras& ex) {
        return peg::cost(site_of(s), ex);
    }
};
using BuildTask = Peg;
#elif FOREST_TASK == 2
// Spheres at the points (radius sphere_radius(k)) against the plane z = 0;
// extras = [kp, kd, mu, target 3]; cost = |site - target|.
struct GroundSpheres : NoJointTorque {
    static constexpr int N_EXTRAS = 6;
    static constexpr int N_SUMS = 0;
    static constexpr int N_FIRST = forest::N_POINTS;

    struct Extras {
        float kp, kd, mu;
        V3 target;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) {
        return {e[0], e[1], e[2], {e[3], e[4], e[5]}};
    }

    static FOREST_FN void point_force(Particle& s, const Extras& ex, int k) {
        s.f[k] = sphere_plane_force(s.p[k], s.v[k], forest_task::sphere_radius(k), ex.kp, ex.kd,
                                    ex.mu);
    }

    static FOREST_FN void sum_forces(Particle&, int) {}

    static FOREST_FN float cost(const Particle& s, const Extras& ex) {
        const V3 d = sub(site_of(s), ex.target);
        return sqrtf(dot(d, d));
    }
};
using BuildTask = GroundSpheres;
#elif FOREST_TASK == 3
// relocate-v0 (envs/relocate.py): extras = [target 3, kp, kd, mu, ball
// radius]. Points: the tip and mid sphere of each digit (N_TIPS), the ball's
// centre, then the palm pad on the arm's z slide (body 2). Each finger
// sphere and the palm pad push the ball (the push kept for the ball's sum)
// and the table holds them up; the table holds up the ball; only the
// finger-on-ball and palm-on-ball forces react onto the ball. The z slide
// carries the hand's weight.
struct Relocate {
    static constexpr int N_EXTRAS = 7;
    static constexpr int N_SUMS = 1;  // the ball's sum over the tips and the palm
    static constexpr int N_FIRST = forest_task::N_TIPS;  // the tips; then the ball, the palm
    static constexpr int BALL = forest_task::N_TIPS, PALM = forest_task::N_TIPS + 1;

    struct Extras {
        V3 target;
        float kp, kd, mu, ball_r;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) {
        return {{e[0], e[1], e[2]}, e[3], e[4], e[5], e[6]};
    }

    static FOREST_FN void point_force(Particle& s, const Extras& ex, int k) {
        using namespace forest_task;
        if (k < N_TIPS) {
            const V3 f_ball = sphere_sphere_force(s.p[k], s.v[k], tip_radius(k), s.p[BALL],
                                                  s.v[BALL], ex.ball_r, ex.kp, ex.kd, ex.mu);
            s.pf[k] = f_ball;
            s.f[k] = add(f_ball, sphere_plane_force(s.p[k], s.v[k], tip_radius(k), ex.kp, ex.kd,
                                                    ex.mu));
        } else if (k == BALL) {
            s.pf[BALL] = sphere_plane_force(s.p[BALL], s.v[BALL], ex.ball_r, ex.kp, ex.kd, ex.mu);
        } else {
            const V3 f_ball = sphere_sphere_force(s.p[PALM], s.v[PALM], PALM_R, s.p[BALL],
                                                  s.v[BALL], ex.ball_r, ex.kp, ex.kd, ex.mu);
            s.pf[PALM] = f_ball;
            s.f[PALM] = add(f_ball, sphere_plane_force(s.p[PALM], s.v[PALM], PALM_R, ex.kp,
                                                       ex.kd, ex.mu));
        }
    }

    // The ball takes the tips' and then the palm's reactions.
    static FOREST_FN void sum_forces(Particle& s, int) {
        V3 f = s.pf[BALL];
#pragma unroll
        for (int k = 0; k < forest_task::N_TIPS; ++k) f = sub(f, s.pf[k]);
        s.f[BALL] = sub(f, s.pf[PALM]);
    }

    static FOREST_FN void joint_torque(const Particle&, const Extras&, int i, float& tau) {
        if (i == 2) tau = tau + forest_task::HAND_WEIGHT;
    }

    // -reward: -0.1 |palm - ball|, once the ball is above LIFT_Z 1 - 0.5
    // |palm - target| - 0.5 |ball - target|, +10 / +20 with the ball within
    // 0.10 / 0.05 of the target.
    static FOREST_FN float cost(const Particle& s, const Extras& ex) {
        using namespace forest_task;
        const V3 palm = add(s.P[2], mv(s.R[2], {palm_local(0), palm_local(1), palm_local(2)}));
        const V3 ball = s.P[BALL_BODY];
        const V3 d_reach = sub(palm, ball), d_carry = sub(ball, ex.target),
                 d_palm = sub(palm, ex.target);
        const float reach = sqrtf(dot(d_reach, d_reach));
        const float carry = sqrtf(dot(d_carry, d_carry));
        const float palm_t = sqrtf(dot(d_palm, d_palm));
        const float reward = -0.1f * reach
                           + (ball.z > LIFT_Z ? 1.0f - 0.5f * palm_t - 0.5f * carry : 0.0f)
                           + (carry < 0.10f ? 10.0f : 0.0f) + (carry < 0.05f ? 20.0f : 0.0f);
        return -reward;
    }
};
using BuildTask = Relocate;
#elif FOREST_TASK == 4
// hammer-v0 (envs/hammer.py): extras = [kp, kd, mu]. Points: the tip and mid
// sphere of each digit (N_TIPS), the handle capsule's two ends, the head's
// centre, the nail's head and the palm pad. Each finger sphere and the palm
// pad push the handle (the reaction split by t onto the two ends), the
// table holds up the fingers, the handle's ends and the head, and the head
// strikes the nail's head, the strike reacting onto the nail; only the
// finger-on-handle and palm-on-handle forces react onto the hammer. The z
// slide carries the hand's weight; the nail's slide takes its dry friction.
// The hammer's com sits off its joint origin: free_substep's coupled branch.
struct Hammer {
    static constexpr int N_EXTRAS = 3;
    static constexpr int N_SUMS = 2;  // the two ends' sums over the tips and the palm
    static constexpr int N_FIRST = forest_task::N_TIPS;  // the tips; then the rest

    struct Extras {
        float kp, kd, mu;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) { return {e[0], e[1], e[2]}; }

    // A tip's or the palm's push on the handle (its weight t kept for the
    // ends' sums); each end's plane force; the head's plane force and strike,
    // whose reaction is the nail's whole force (the nail's own call adds
    // nothing).
    static FOREST_FN void point_force(Particle& s, const Extras& ex, int k) {
        using namespace forest_task;
        if (k < N_TIPS || k == PALM) {
            const float r = k < N_TIPS ? tip_radius(k) : PALM_R;
            float t;
            const V3 f_handle = sphere_segment_force(s.p[k], s.v[k], r, s.p[CAP_A], s.p[CAP_B],
                                                     s.v[CAP_A], s.v[CAP_B], HANDLE_R, ex.kp,
                                                     ex.kd, ex.mu, t);
            s.pf[k] = f_handle;
            s.pt[k] = t;
            s.f[k] = k < N_TIPS ? add(f_handle, sphere_plane_force(s.p[k], s.v[k], r, ex.kp,
                                                                   ex.kd, ex.mu))
                                : f_handle;
        } else if (k == CAP_A || k == CAP_B) {
            s.pf[k] = sphere_plane_force(s.p[k], s.v[k], HANDLE_R, ex.kp, ex.kd, ex.mu);
        } else if (k == HEAD) {
            const V3 f_strike = sphere_sphere_force(s.p[HEAD], s.v[HEAD], HEAD_R, s.p[NAIL],
                                                    s.v[NAIL], NAIL_R, ex.kp, ex.kd, ex.mu);
            s.f[HEAD] = add(sphere_plane_force(s.p[HEAD], s.v[HEAD], HEAD_R, ex.kp, ex.kd, ex.mu),
                            f_strike);
            s.f[NAIL] = scale(-1.0f, f_strike);
        }
    }

    // End e (0: a, 1: b) takes the tips' reactions, in tip order, then the
    // palm's.
    static FOREST_FN void sum_forces(Particle& s, int e) {
        using namespace forest_task;
        const int end = CAP_A + e;
        V3 f = s.pf[end];
#pragma unroll
        for (int k = 0; k < N_TIPS; ++k)
            f = sub(f, scale(e == 0 ? 1.0f - s.pt[k] : s.pt[k], s.pf[k]));
        s.f[end] = sub(f, scale(e == 0 ? 1.0f - s.pt[PALM] : s.pt[PALM], s.pf[PALM]));
    }

    static FOREST_FN void joint_torque(const Particle& s, const Extras&, int i, float& tau) {
        using namespace forest_task;
        if (i == 2) tau = tau + HAND_WEIGHT;
        if (i == NAIL_BODY)
            tau = tau + -NAIL_RESIST * tanhf(s.qd[forest::voff(i)] / NAIL_V_SLIP);
    }

    // -reward: -0.1 |palm - hammer| - |head - nail| + 2 depth / travel, +25
    // / +75 with the nail past half / 95% of its travel.
    static FOREST_FN float cost(const Particle& s, const Extras&) {
        using namespace forest_task;
        const V3 palm = add(s.P[2], mv(s.R[2], {palm_local(0), palm_local(1), palm_local(2)}));
        const V3 hammer = s.P[HAMMER_BODY];
        const V3 head = add(hammer, mv(s.R[HAMMER_BODY],
                                       {head_local(0), head_local(1), head_local(2)}));
        const V3 d_palm = sub(palm, hammer), d_head = sub(head, s.P[NAIL_BODY]);
        const float depth = -s.q[forest::qoff(NAIL_BODY)];
        const float reward = -0.1f * sqrtf(dot(d_palm, d_palm)) - sqrtf(dot(d_head, d_head))
                           + 2.0f * depth / NAIL_TRAVEL + (depth > HALF_DEPTH ? 25.0f : 0.0f)
                           + (depth > FULL_DEPTH ? 75.0f : 0.0f);
        return -reward;
    }
};
using BuildTask = Hammer;
#elif FOREST_TASK == 5
// sawyer_door-v0 (envs/sawyer_tasks.py): extras = [k_grab, grab radius,
// target angle]. Points: the hand (the wrist's origin) and the handle on the
// door. The grab spring k_grab (hand - handle), while |hand - handle| +
// 1e-8 < grab radius, acts on the handle only: the hand gets no force.
struct SawyerDoor : NoJointTorque {
    static constexpr int N_EXTRAS = 3;
    static constexpr int N_SUMS = 0;
    static constexpr int N_FIRST = forest::N_POINTS;  // both on the first group

    struct Extras {
        float k_grab, grab_r, target_angle;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) { return {e[0], e[1], e[2]}; }

    static FOREST_FN void point_force(Particle& s, const Extras& ex, int k) {
        if (k == 0) {
            s.f[0] = {0.f, 0.f, 0.f};
            return;
        }
        const V3 diff = sub(s.p[0], s.p[1]);
        const float dist = sqrtf(dot(diff, diff)) + 1e-8f;
        const float gain = dist < ex.grab_r ? ex.k_grab : 0.0f;
        s.f[1] = scale(gain, diff);
    }

    static FOREST_FN void sum_forces(Particle&, int) {}

    // -reward: 2 |target angle - q_door| + 0.5 |hand - handle|.
    static FOREST_FN float cost(const Particle& s, const Extras& ex) {
        using namespace forest_task;
        const V3 handle = add(s.P[DOOR_BODY], mv(s.R[DOOR_BODY], {handle_local(0), handle_local(1),
                                                                  handle_local(2)}));
        const V3 d = sub(s.P[HAND_BODY], handle);
        const float reach = sqrtf(dot(d, d));
        return fabsf(ex.target_angle - s.q[forest::qoff(DOOR_BODY)]) * 2.0f + 0.5f * reach;
    }
};
using BuildTask = SawyerDoor;
#elif FOREST_TASK == 6
// sawyer_pusher-v0 (envs/sawyer_tasks.py): extras = [target 2, k_contact].
// Points: the hand sphere's and the block's centres, on two scalar trees
// (the arm; the block's x and y slides). Their overlap (CONTACT_R -
// distance) pushes with k_contact * overlap along the centres' line: +f on
// the block, -f on the hand (the first point's lane writes both).
struct Pusher : NoJointTorque {
    static constexpr int N_EXTRAS = 3;
    static constexpr int N_SUMS = 0;
    static constexpr int N_FIRST = forest::N_POINTS;

    struct Extras {
        float tx, ty, k;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) { return {e[0], e[1], e[2]}; }

    static FOREST_FN void point_force(Particle& s, const Extras& ex, int k) {
        if (k != 0) return;
        const V3 diff = sub(s.p[1], s.p[0]);
        const float dist = sqrtf(dot(diff, diff)) + 1e-8f;
        const float overlap = forest_task::CONTACT_R - dist;
        const float fmag = overlap > 0.0f ? ex.k * overlap : 0.0f;
        const float r = fmag / dist;
        const V3 f = {r * diff.x, r * diff.y, r * diff.z};
        s.f[0] = {-f.x, -f.y, -f.z};
        s.f[1] = f;
    }

    static FOREST_FN void sum_forces(Particle&, int) {}

    // -reward: |hand - block| + 2 |block_xy - target|.
    static FOREST_FN float cost(const Particle& s, const Extras& ex) {
        using namespace forest_task;
        const V3 block = s.P[BLOCK_BODY];
        const V3 d = sub(s.P[HAND_BODY], block);
        const float dx = block.x - ex.tx, dy = block.y - ex.ty;
        return sqrtf(dot(d, d)) + 2.0f * sqrtf(dx * dx + dy * dy);
    }
};
using BuildTask = Pusher;
#elif FOREST_TASK == 7
// The tray-glass family (envs/panda_tasks.py): extras = [target 3, fall
// penalty]; no contact. Each arm dof d (d < N_ARM) gets the gravity
// feed-forward -sum_i m_i g . J_d(c_i) over the bodies i it moves, in
// increasing order (the header's desc list: d, then its descendants), with
// J_d(c) = a_d x (c - o_d) for a hinge and a_d for a slide and c_i = P_i +
// R_i com_i, all from the FK pass of this substep's state.
struct Tray {
    static constexpr int N_EXTRAS = 4;
    static constexpr int N_SUMS = 0;
    static constexpr int N_FIRST = 0;

    struct Extras {
        V3 target;
        float fall;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) {
        return {{e[0], e[1], e[2]}, e[3]};
    }

    static FOREST_FN void point_force(Particle&, const Extras&, int) {}

    static FOREST_FN void sum_forces(Particle&, int) {}

    static FOREST_FN void joint_torque(const Particle& s, const Extras&, int d, float& tau) {
        if (d >= forest_task::N_ARM) return;
        const V3 g = {forest::gravity(0), forest::gravity(1), forest::gravity(2)};
        const bool hinge = is_hinge(d);
        float total = 0.0f;
#pragma unroll 1
        for (int e = forest::desc_start(d); e < forest::desc_start(d + 1); ++e) {
            const int i = forest::desc(e);
            const V3 ci = add(s.P[i], s.rc[i]);
            const V3 jv = hinge ? cross(s.A[d], sub(ci, s.P[d])) : s.A[d];
            const float gdot = g.x * jv.x + g.y * jv.y + g.z * jv.z;
            total = total + -forest::mass(i) * gdot;
        }
        tau = tau + total;
    }

    // -reward: |tray - target| + 2 slide, + the fall penalty once slide >
    // TRAY_R.
    static FOREST_FN float cost(const Particle& s, const Extras& ex) {
        using namespace forest_task;
        const V3 d = sub(site_of(s), ex.target);
        const float gx = s.q[GLASS_Q], gy = s.q[GLASS_Q + 1];
        const float slide = sqrtf(gx * gx + gy * gy);
        return sqrtf(dot(d, d)) + 2.0f * slide + (slide > TRAY_R ? ex.fall : 0.0f);
    }
};
using BuildTask = Tray;
#elif FOREST_TASK == 8
// door-v0 (envs/hand_door.py): extras = [kp, kd, mu]. Points: the tip and
// mid sphere of each digit (N_TIPS), the handle capsule's two ends and the
// palm pad. Each finger sphere and the palm pad push the handle (the
// reaction split by t onto the two ends); there is no table. The z slide
// carries the hand's weight, the latch its return spring, the door its
// closing spring and the strike plate, gated by the latch's and the door's
// angles.
struct Door {
    static constexpr int N_EXTRAS = 3;
    static constexpr int N_SUMS = 2;  // the two ends' sums over the tips and the palm
    static constexpr int N_FIRST = forest_task::N_TIPS;  // the tips; then the ends, the palm

    struct Extras {
        float kp, kd, mu;
    };

    static FOREST_FN Extras load(const float* __restrict__ e) { return {e[0], e[1], e[2]}; }

    // A tip's or the palm's push on the handle, its weight t kept for the
    // ends' sums; the ends' own calls add nothing.
    static FOREST_FN void point_force(Particle& s, const Extras& ex, int k) {
        using namespace forest_task;
        if (k < N_TIPS || k == PALM) {
            const float r = k < N_TIPS ? tip_radius(k) : PALM_R;
            float t;
            const V3 f = sphere_segment_force(s.p[k], s.v[k], r, s.p[CAP_A], s.p[CAP_B],
                                              s.v[CAP_A], s.v[CAP_B], HANDLE_R, ex.kp, ex.kd,
                                              ex.mu, t);
            s.pf[k] = f;
            s.pt[k] = t;
            s.f[k] = f;
        }
    }

    // End e (0: a, 1: b) takes the tips' reactions, in tip order, then the
    // palm's.
    static FOREST_FN void sum_forces(Particle& s, int e) {
        using namespace forest_task;
        V3 f = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < N_TIPS; ++k)
            f = sub(f, scale(e == 0 ? 1.0f - s.pt[k] : s.pt[k], s.pf[k]));
        s.f[CAP_A + e] = sub(f, scale(e == 0 ? 1.0f - s.pt[PALM] : s.pt[PALM], s.pf[PALM]));
    }

    static FOREST_FN float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

    static FOREST_FN void joint_torque(const Particle& s, const Extras&, int i, float& tau) {
        using namespace forest_task;
        if (i == 2) tau = tau + HAND_WEIGHT;
        const float q_latch = s.q[forest::qoff(LATCH_BODY)];
        if (i == LATCH_BODY) tau = tau + -LATCH_SPRING * q_latch;
        if (i == DOOR_BODY) {
            const float q_door = s.q[forest::qoff(DOOR_BODY)];
            const float gate = sigmoid((LATCH_THRESH - q_latch) / 0.05f)
                             * sigmoid((0.12f - q_door) / 0.04f);
            tau = tau + (-DOOR_SPRING * q_door - BLOCK_K * tanhf(q_door / 0.03f) * gate);
        }
    }

    // -reward: 0.1 |palm - handle| - 0.5 q_latch - 2 q_door, -2 / -8 / -10
    // with the door past 0.2 / 1.0 / 1.35 rad.
    static FOREST_FN float cost(const Particle& s, const Extras&) {
        using namespace forest_task;
        const V3 palm = add(s.P[2], mv(s.R[2], {palm_local(0), palm_local(1), palm_local(2)}));
        const V3 handle = add(s.P[LATCH_BODY], mv(s.R[LATCH_BODY],
                                                  {handle_mid(0), handle_mid(1), handle_mid(2)}));
        const V3 d = sub(palm, handle);
        const float q_door = s.q[forest::qoff(DOOR_BODY)];
        const float q_latch = s.q[forest::qoff(LATCH_BODY)];
        const float reward = -0.1f * sqrtf(dot(d, d)) + 0.5f * q_latch + 2.0f * q_door
                           + (q_door > 0.2f ? 2.0f : 0.0f) + (q_door > 1.0f ? 8.0f : 0.0f)
                           + (q_door > 1.35f ? 10.0f : 0.0f);
        return -reward;
    }
};
using BuildTask = Door;
#endif

static_assert(BuildTask::N_EXTRAS == forest::N_EXTRAS, "the task's extras and the header's differ");

// ---------------------------------------------------------------------------
// Physics
// ---------------------------------------------------------------------------

// Body d's generalized contact forces, gathered over the points it moves in
// increasing order (the plain version's scatter, point by point): a scalar
// body takes column . f, a free body f on its linear dofs and l x R^T f on
// its angular ones; then the task's joint torque.
template <class Task>
FOREST_FN void gather_tau(Particle& s, const typename Task::Extras& ex, int d) {
    const int vd = forest::voff(d);
    const int lo = forest::point_start(d), hi = forest::point_start(d + 1);
    if (is_free(d)) {
        V3 lin = {0.f, 0.f, 0.f}, ang = {0.f, 0.f, 0.f};
#pragma unroll 4
        for (int e = lo; e < hi; ++e) {
            const int k = forest::dof_point(e);
            lin = add(lin, s.f[k]);
            ang = add(ang, cross(point_local_of(k), mtv(s.R[d], s.f[k])));
        }
        s.tau[vd] = lin.x;
        s.tau[vd + 1] = lin.y;
        s.tau[vd + 2] = lin.z;
        s.tau[vd + 3] = ang.x;
        s.tau[vd + 4] = ang.y;
        s.tau[vd + 5] = ang.z;
        return;
    }
    float t = 0.0f;
#pragma unroll 4
    for (int e = lo; e < hi; ++e) {
        const int k = forest::dof_point(e);
        t = t + dot(point_column(s, d, s.p[k]), s.f[k]);
    }
    Task::joint_torque(s, ex, d, t);
    s.tau[vd] = t;
}

// The lane's packed mass entries M[b][ka] of the pairs (a = anc(b, ka), b)
// by Jacobian composition: each the sum over b and the bodies i below it,
// in increasing order, of jv_a . m_i jv_b (+ a_a . iw a_b for two hinges),
// then armature + dt * damping on the diagonal. The header lays the lane's
// entries out as one list of terms, each with its slots, body a, m_i, the
// entry's place in M and its edge bits (1 an entry's first term, 2 its
// last, 4 a diagonal entry, 8 two hinges), so that a term needs one round
// of table reads, no branch, and the warp walks its longest lane's terms
// once.
FOREST_FN void mass_terms(Particle& s, int lane) {
    float* __restrict__ m = &s.M[0][0];
    const V3* __restrict__ jv = s.jv;
    const V3* __restrict__ iwa = s.iwa;
    const V3* __restrict__ axes = s.A;
    float sum = 0.0f;
#pragma unroll 4
    for (int e = forest::term_start(lane); e < forest::term_start(lane + 1); ++e) {
        const int edge = forest::term_edge(e), jb = forest::term_jb(e);
        float term = dot(jv[forest::term_ja(e)], scale(forest::term_mass(e), jv[jb]));
        const float rot = dot(axes[forest::term_a(e)], iwa[jb]);  // unread for a slide
        term = (edge & 8) ? term + rot : term;
        sum = ((edge & 1) ? 0.0f : sum) + term;
        const float entry = (edge & 4) ? sum + forest::term_reg(e) : sum;
        if (edge & 2) m[forest::term_m(e)] = entry;
    }
}

// Column c of the ancestor-sparse Cholesky factor at scalar body i, whose
// depth passes c: with j = anc(i, c), L(i, j) into M[i][c], or at j = i the
// diagonal L(i, i) into ld[i]. Columns < c are done. The lane recomputes
// j's diagonal from j's row rather than wait a phase for it, so a column
// takes one phase; every sum keeps pallas_forest.py _tree_chol_solve's
// order, and the diagonals stay out of M, so no lane reads an entry that
// another writes in the same phase.
FOREST_FN void chol_entry(Particle& s, int i, int c) {
    const int j = forest::anc(i, c);
    float d = s.M[j][c];
#pragma unroll
    for (int kk = 0; kk < MAXD - 1; ++kk)
        if (kk < c) d = d - s.M[j][kk] * s.M[j][kk];
    d = sqrtf(d);
    if (j == i) {
        s.ld[i] = d;
        return;
    }
    float v = s.M[i][c];
#pragma unroll
    for (int kk = 0; kk < MAXD - 1; ++kk)
        if (kk < c) v = v - s.M[i][kk] * s.M[j][kk];
    s.M[i][c] = v / d;
}

// The RNEA's backward step at body i, its children done: their forces and
// moments gathered in decreasing order (the plain version's reverse loop),
// the bias, and what i hands to its parent.
FOREST_FN void rnea_backward(Particle& s, int i) {
    V3 fa = {0.f, 0.f, 0.f}, na = {0.f, 0.f, 0.f};
#pragma unroll 4
    for (int e = forest::child_start(i); e < forest::child_start(i + 1); ++e) {
        const int c = forest::child(e);
        fa = add(fa, s.fi[c]);
        na = add(na, add(s.nmom[c], cross(sub(s.P[c], s.P[i]), s.fi[c])));
    }
    const V3 fi = add(s.fc[i], fa);
    const V3 nmom = add(add(s.nc[i], cross(s.rc[i], s.fc[i])), na);
    s.bias[i] = is_hinge(i) ? dot(s.A[i], nmom) : dot(s.A[i], fi);
    s.fi[i] = fi;
    s.nmom[i] = nmom;
}

// Forward substitution at scalar body i from the right-hand side gear u -
// bias - damping qd - stiffness q + tau (- frictionloss tanh(50 qd)), its
// ancestors done.
FOREST_FN void forward_row(Particle& s, int i) {
    const int vi = forest::voff(i), qi = forest::qoff(i), di = forest::depth(i);
    float r = forest::gear(i) * s.ub[i] - s.bias[i] - forest::damping(i) * s.qd[vi]
            - forest::stiffness(i) * s.q[qi] + s.tau[vi];
    if (forest::HAS_FRICTIONLOSS && forest::frictionloss(i) != 0.0f)  // smooth Coulomb friction
        r = r - forest::frictionloss(i) * tanhf(s.qd[vi] * 50.0f);
#pragma unroll
    for (int kk = 0; kk < MAXD - 1; ++kk)
        if (kk < di - 1) r = r - s.M[i][kk] * s.x[forest::anc(i, kk)];
    s.x[i] = r / s.ld[i];
}

// Back substitution at scalar body i over the bodies below it in increasing
// order, those done, then its semi-implicit Euler step and joint-limit
// clamp (qd zeroed where clamped).
FOREST_FN void back_row(Particle& s, int i) {
    const int vi = forest::voff(i), qi = forest::qoff(i);
    const float* m = &s.M[0][0];
    float r = s.x[i];
#pragma unroll 4
    for (int e = forest::desc_start(i) + 1; e < forest::desc_start(i + 1); ++e)
        r = r - m[forest::desc_m(e)] * s.x[forest::desc(e)];  // L(k, i) x_k
    const float acc = r / s.ld[i];
    s.x[i] = acc;
    const float qdn = s.qd[vi] + forest::DT * acc;
    const float qn = s.q[qi] + forest::DT * qdn;
    const float clamped = fminf(fmaxf(qn, forest::qlow(i)), forest::qhigh(i));
    s.qd[vi] = clamped == qn ? qdn : 0.0f;
    s.q[qi] = clamped;
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
FOREST_FN void free_substep(Particle& s, int i) {
    const int qi = forest::qoff(i), vi = forest::voff(i);
    const V3 v = load3(&s.qd[vi]), w = load3(&s.qd[vi + 3]);
    const V3 fl = load3(&s.tau[vi]), tb = load3(&s.tau[vi + 3]);
    const V3 mg = {forest::free_mg(i, 0), forest::free_mg(i, 1), forest::free_mg(i, 2)};
    const float damp_l = forest::free_damp_l(i), damp_a = forest::free_damp_a(i);
    const M3 ib = inertia_of(i);
    V3 acc_l, acc_a;
    if (!forest::HAS_COUPLED || !forest::coupled(i)) {
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
        const M3& r = s.R[i];
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
                float sum = m6[b][a];
#pragma unroll
                for (int k = 0; k < b; ++k) sum = sum - m6[a][k] * m6[b][k];
                m6[a][b] = sum / m6[b][b];
            }
            float sum = m6[a][a];
#pragma unroll
            for (int k = 0; k < a; ++k) sum = sum - m6[a][k] * m6[a][k];
            m6[a][a] = sqrtf(sum);
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
            float sum = x6[a];
#pragma unroll
            for (int k = 0; k < a; ++k) sum = sum - m6[a][k] * x6[k];
            x6[a] = sum / m6[a][a];
        }
#pragma unroll
        for (int a = 5; a >= 0; --a) {
            float sum = x6[a];
#pragma unroll
            for (int k = a + 1; k < 6; ++k) sum = sum - m6[k][a] * x6[k];
            x6[a] = sum / m6[a][a];
        }
        acc_l = {x6[0], x6[1], x6[2]};
        acc_a = {x6[3], x6[4], x6[5]};
    }
    const V3 v_new = add(v, scale(forest::DT, acc_l));
    const V3 w_new = add(w, scale(forest::DT, acc_a));
    const V3 pos_new = add(load3(&s.q[qi]), scale(forest::DT, v_new));
    float e[4];
    exp_quat(scale(forest::DT, w_new), e);
    const float aw = s.q[qi + 3], ax = s.q[qi + 4], ay = s.q[qi + 5], az = s.q[qi + 6];
    const float n0 = aw * e[0] - ax * e[1] - ay * e[2] - az * e[3];
    const float n1 = aw * e[1] + ax * e[0] + ay * e[3] - az * e[2];
    const float n2 = aw * e[2] - ax * e[3] + ay * e[0] + az * e[1];
    const float n3 = aw * e[3] + ax * e[2] - ay * e[1] + az * e[0];
    const float norm = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + n3 * n3);
    s.q[qi] = pos_new.x;
    s.q[qi + 1] = pos_new.y;
    s.q[qi + 2] = pos_new.z;
    s.q[qi + 3] = n0 / norm;
    s.q[qi + 4] = n1 / norm;
    s.q[qi + 5] = n2 / norm;
    s.q[qi + 6] = n3 / norm;
    s.qd[vi] = v_new.x;
    s.qd[vi + 1] = v_new.y;
    s.qd[vi + 2] = v_new.z;
    s.qd[vi + 3] = w_new.x;
    s.qd[vi + 4] = w_new.y;
    s.qd[vi + 5] = w_new.z;
}

// One semi-implicit Euler substep from the frames and RNEA forward terms of
// q, qd (fk_pass); the caller's FK pass follows. At the first substep
// of control step t (t >= 0) the team first reads the step's actions,
// u = clip(mean[t] + noise[t]) on act_body(j), lane j on action j (an
// action whose body a later one sets has act_body -1: the last wins).
template <class Task>
FOREST_FN void substep(Particle& s, const Team& team, const typename Task::Extras& ex, int t,
                       const float* __restrict__ mean, const float* __restrict__ nz) {
    constexpr int np = forest::N_POINTS;
    // the actions; the contact points' state (first group) and the com's
    // Jacobian slots (last group)
    phase(team, PH_POINTS, [&](int lane) {
        if (t >= 0) {
#pragma unroll 1
            for (int j = lane; j < forest::D_ACT; j += LANES) {
                const int body = forest::act_body(j);
                if (body >= 0)
                    s.ub[body] =
                        fminf(fmaxf(mean[t * forest::D_ACT + j] + nz[t * forest::D_ACT + j],
                                    forest::ULOW), forest::UHIGH);
            }
        }
        const int g = lane % TEAM;
        if (first_group(lane)) {
#pragma unroll 1
            for (int k = g; k < np; k += TEAM) point_state(s, k);
        }
        if (last_group(lane)) {
#pragma unroll 1
            for (int sl = g; sl < forest::N_SLOTS; sl += TEAM) com_slot(s, sl);
        }
    });
    if constexpr (np > 0) {  // the task's force law: its first N_FIRST points on the
                             // first group, the rest on the last
        phase(team, PH_FORCES, [&](int lane) {
            const int g = lane % TEAM;
            if (first_group(lane)) {
#pragma unroll 1
                for (int k = g; k < Task::N_FIRST; k += TEAM) Task::point_force(s, ex, k);
            }
            if (last_group(lane)) {
#pragma unroll 1
                for (int k = Task::N_FIRST + g; k < np; k += TEAM) Task::point_force(s, ex, k);
            }
        });
        if constexpr (Task::N_SUMS > 0)
            phase(team, PH_SUMS, [&](int lane) {
#pragma unroll 1
                for (int e = lane; e < Task::N_SUMS; e += LANES) Task::sum_forces(s, e);
            });
    }
    // the generalized forces (first group) and the packed mass entries (last
    // group), each as the header deals them to a group's lanes
    phase(team, PH_MASS, [&](int lane) {
        const int g = lane % TEAM;
        if (first_group(lane)) {
#pragma unroll 1
            for (int e = forest::tau_start(g); e < forest::tau_start(g + 1); ++e)
                gather_tau<Task>(s, ex, forest::tau_body(e));
        }
        if (last_group(lane)) mass_terms(s, g);
    });
    // the Cholesky factor by columns, column c at every body below level c
    // (first group), beside the RNEA's backward pass up the levels and, with
    // the first column, the free bodies' substeps (last group)
    constexpr int nl = forest::N_LEVELS;
#pragma unroll 1
    for (int lv = 0; lv < nl; ++lv)
        phase(team, PH_CHOL, [&](int lane) {
            const int g = lane % TEAM;
            if (first_group(lane)) {
#pragma unroll 1
                for (int e = forest::level_start(lv) + g; e < forest::level_start(nl); e += TEAM) {
                    const int i = forest::level_body(e);
                    if (!is_free(i)) chol_entry(s, i, lv);
                }
            }
            if (last_group(lane)) {
                const int up = nl - 1 - lv;
#pragma unroll 1
                for (int e = forest::level_start(up) + g; e < forest::level_start(up + 1);
                     e += TEAM) {
                    const int i = forest::level_body(e);
                    if (!is_free(i)) rnea_backward(s, i);
                }
                if (forest::HAS_FREE && lv == 0) {
#pragma unroll 1
                    for (int e = g; e < forest::level_start(1); e += TEAM) {
                        const int i = forest::level_body(e);
                        if (is_free(i)) free_substep(s, i);
                    }
                }
            }
        });
#pragma unroll 1
    for (int lv = 0; lv < nl; ++lv)
        phase(team, PH_FORWARD, [&](int lane) {
#pragma unroll 1
            for (int e = forest::level_start(lv) + lane; e < forest::level_start(lv + 1);
                 e += LANES) {
                const int i = forest::level_body(e);
                if (!is_free(i)) forward_row(s, i);
            }
        });
#pragma unroll 1
    for (int lv = nl - 1; lv >= 0; --lv)
        phase(team, PH_BACK, [&](int lane) {
#pragma unroll 1
            for (int e = forest::level_start(lv) + lane; e < forest::level_start(lv + 1);
                 e += LANES) {
                const int i = forest::level_body(e);
                if (!is_free(i)) back_row(s, i);
            }
        });
}

// Roll out particle b on the team (costs written only when `live`: a
// ragged block's spare teams roll out a copy, since every team of the
// block syncs together): noise [n, horizon, D_ACT] and costs [n,
// horizon] contiguous f32; q0 [NQ], qd0 [NV], extras [N_EXTRAS] and mean
// [horizon, D_ACT] shared. u = clip(mean[t] + noise[b, t]) on the bodies
// act_body(j), held for N_SUBSTEPS substeps; costs[b, t] = the task's cost
// of the state after step t. A step's last FK pass gives the cost's frames
// and the next substep's; the FK pass has one call site, which keeps the
// kernel's code small.
template <class Task>
FOREST_FN void rollout_team(Particle& s, const Team& team, const float* __restrict__ q0,
                            const float* __restrict__ qd0, const float* __restrict__ extras,
                            const float* __restrict__ mean, const float* __restrict__ noise,
                            float* __restrict__ costs, int b, int horizon, bool live = true) {
    const typename Task::Extras ex = Task::load(extras);
    const float* nz = noise + static_cast<size_t>(b) * horizon * forest::D_ACT;
    float* out = costs + static_cast<size_t>(b) * horizon;
    phase(team, PH_INIT, [&](int lane) {
#pragma unroll 1
        for (int k = lane; k < NQ; k += LANES) s.q[k] = q0[k];
#pragma unroll 1
        for (int k = lane; k < NV; k += LANES) s.qd[k] = qd0[k];
#pragma unroll 1
        for (int k = lane; k < NB; k += LANES) s.ub[k] = 0.0f;
    });
    constexpr int ns = forest::N_SUBSTEPS;
#pragma unroll 1
    for (int k = 0;; ++k) {  // k substeps done
        fk_pass(s, team);
        if (k > 0 && k % ns == 0)
            phase(team, PH_COST, [&](int lane) {
                if (lane == 0 && live) out[k / ns - 1] = Task::cost(s, ex);
            });
        if (k == horizon * ns) break;
        substep<Task>(s, team, ex, k % ns == 0 ? k / ns : -1, mean, nz);
    }
}

}  // namespace forest_rollout
