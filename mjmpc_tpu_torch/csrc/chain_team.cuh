// Per-particle arithmetic of the chain rollout written for a team of
// team::TEAM lanes that carries one particle (every entry of
// chain_rollout.cu: costs, obs, closed loop, external forces), over the
// compile-time chain of chain_model.h: the model (namespace model), the
// team's work tables (namespace team, generated by
// mjmpc_tpu_torch/ops/chain_rollout.py team_schedule) and, for a
// locomotion header, the force law (namespace loco). Host-and-device: the
// same source also compiles as plain C++, and then each phase runs its
// lanes one after another, so the CPU tests (tests/test_torch_chain_team.py)
// run the kernel's own partition and order.
//
// A particle's state (q, qd, the frames, the RNEA terms, the Jacobian
// slots, the mass matrix, the task's scratch) lives in a Particle, in
// shared memory on the card. A substep is a sequence of
// phases. In each, every lane works on its own items and writes only
// their outputs, reading what earlier phases wrote (and, within a phase,
// what it wrote itself); the team syncs between phases (phase()). What a
// lane needs of the model for its items (a dof's limits, a body's com and
// inertia, the slots, mass entries and contact points it owns) is read
// into its registers before the step loop (Own, own_of); the loop reads
// no table at an index that depends on the lane. The serial recursions
// (FK, the RNEA's backward pass) run on one lane per branch of the tree,
// unrolled over compile-time levels, with the constants of a level's bodies
// selected by lane (pick()); the solve on one lane.
//
// Phases of a substep:
//   A  every dof: the previous substep's Euler step and joint clamp (and,
//      at the end of a control step, the velocity limit); its rotation
//   B  FK down each branch with the RNEA's forward terms (w, dw, ao)
//   C  every body: R c, the world inertia, the RNEA force and moment terms;
//      (EXT) the task's force at every contact point and its terms on the
//      dofs that move the point
//      [at a control step's start: TASK (the cost of the step before; OBS,
//      CL: the observation) and ACT (the actions; OBS, CL: the observation
//      row)]
//   D  the Jacobian slots (body i, its k-th ancestor d): a_d x (c_i - o_d)
//      and I_i a_d; the RNEA backward pass of the leaf branches; (EXT)
//      each dof's generalized force, gathered over its points in a fixed
//      order
//   E  the mass entries (a, b), each the sum over the bodies below b; the
//      RNEA backward pass of the next branches
//   S  on one lane in registers: the right-hand side, the Cholesky factor
//      and both substitutions (chol_solve_rcp), a dataflow chain with one
//      reciprocal square root per column; a phase per column took about
//      550 cycles a column on the card
// Every sum has one fixed order: a mass entry's over the bodies below it in
// increasing order, a body's children in decreasing order in the RNEA's
// backward pass, a dof's contact points in increasing order (each point's
// terms summed before they are added), the solve's columns in order. No
// sum is split between lanes and there are no atomics, so two launches
// give the same results and the team size changes no bit. The solve
// multiplies by the reciprocal square roots of its pivots where the plain
// version's Cholesky divides by their square roots (within the kernels'
// tolerance).

#pragma once

#include <type_traits>

#include "chain_rollout.cuh"

namespace chain_team {

using namespace vec3;
using chain_rollout::Frames;
using model::N;
using team::MAXD;
using team::TEAM;

static_assert(TEAM == 4 || TEAM == 8 || TEAM == 16 || TEAM == 32,
              "a team is a power of two of lanes within one warp");

// rounds of a lane's items: dofs, slots, mass entries, contact points
constexpr int DOF_ROUNDS = (N + TEAM - 1) / TEAM;
constexpr int SR = team::SLOT_ROUNDS;
constexpr int ER = team::ENTRY_ROUNDS;
constexpr int NP = team::N_POINTS > 0 ? team::N_POINTS : 1;
constexpr int PR = team::POINT_ROUNDS > 0 ? team::POINT_ROUNDS : 1;

CHAIN_FN bool is_hinge(int d) { return (team::HINGE_MASK >> d) & 1u; }

// (EXT) the task's |qd| limit after a control step's substeps
#ifdef CHAIN_EXT_TASK
constexpr bool HAS_VEL_LIMIT = loco::HAS_VEL_LIMIT;
#else
constexpr bool HAS_VEL_LIMIT = false;
#endif

// A Jacobian slot (body i, its k-th ancestor d): the column a_d x (c_i - o_d)
// of i's com (a_d for a slide), m_i beside it, and I_i a_d.
struct alignas(16) Slot {
    V3 jv;
    float m;
    V3 iwa;
    float pad;
};

// One particle's state, in shared memory on the card.
struct Particle {
    float q[N], qd[N], u[N];
    M3 rl[N];   // a hinge's rotation about its axis
    Frames f;   // body frames and world DOF axes
    V3 w[N], dw[N], ao[N];
    V3 rc[N];
    M3 iw[N];
    V3 fc[N], nown[N], fi[N], nmom[N];  // nown = nc + R c x fc, the body's own moment
    Slot slot[N][MAXD];
    float M[N][N];  // upper triangle: the mass matrix
    float bias[N];
    float acc[N];   // qdd
    float tau[N];   // (EXT) the generalized external forces
    float ctb[NP][MAXD];  // (EXT) a point's terms on the dofs that move it, by depth
    float q_in0;          // (EXT) q[0] at the control step's start
    float obs[chain_rollout::BuildTask::D_OBS > 0 ? chain_rollout::BuildTask::D_OBS : 1];
};

// What a lane needs of the model for its items, read before the step loop.
struct Own {
    // dofs lane + r TEAM: limits, velocity limit, axis, body constants;
    // (EXT) the points that the dof moves and its depth
    float qlow[DOF_ROUNDS], qhigh[DOF_ROUNDS], vlim[DOF_ROUNDS], mass[DOF_ROUNDS];
    V3 axis[DOF_ROUNDS], com[DOF_ROUNDS];
    M3 inertia[DOF_ROUNDS];
    unsigned pmask[DOF_ROUNDS];
    int depth[DOF_ROUNDS];
    // slots: body, ancestor depth, ancestor (-1: none) and the body's mass
    int si[SR], sk[SR], sd[SR];
    float sm[SR];
    // mass entries (a, b): rows, their depths, the end of b's subtree (the
    // bodies below b are b .. end - 1) and armature + dt * damping on the
    // diagonal (a = -1: none)
    int ea[ER], eb[ER], eka[ER], ekb[ER], eend[ER];
    float eadd[ER];
    // (EXT) contact points: index (-1: none), body, its depth, its root
    // path (4 bits a level), the force law's constants
    int pp[PR], pb[PR], pdep[PR];
    unsigned panc[PR];
    float pc[PR][3];
};

#ifdef CHAIN_EXT_TASK
CHAIN_FN void point_constants(int p, float (&pc)[3]);
#endif

CHAIN_FN Own own_of(int lane) {
    Own o{};
#pragma unroll
    for (int r = 0; r < DOF_ROUNDS; ++r) {
        const int i = lane + r * TEAM;
        if (i >= N) continue;
        o.qlow[r] = model::qlow(i);
        o.qhigh[r] = model::qhigh(i);
        o.mass[r] = model::mass(i);
        o.axis[r] = {model::axis(i, 0), model::axis(i, 1), model::axis(i, 2)};
        o.com[r] = {model::com(i, 0), model::com(i, 1), model::com(i, 2)};
#pragma unroll
        for (int k = 0; k < 9; ++k) o.inertia[r].m[k] = model::inertia(i, k);
        o.depth[r] = team::depth(i);
#ifdef CHAIN_EXT_TASK
        o.vlim[r] = loco::vel_limit(i);
        o.pmask[r] = team::dof_points(i);
#endif
    }
#pragma unroll
    for (int r = 0; r < SR; ++r) {
        o.si[r] = team::slot_i(r, lane);
        o.sk[r] = team::slot_k(r, lane);
        o.sd[r] = team::slot_d(r, lane);
        o.sm[r] = o.si[r] >= 0 ? model::mass(o.si[r]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < ER; ++r) {
        o.ea[r] = team::entry_a(r, lane);
        o.eb[r] = team::entry_b(r, lane);
        o.eka[r] = team::entry_ka(r, lane);
        o.ekb[r] = team::entry_kb(r, lane);
        o.eend[r] = team::entry_end(r, lane);
        const int b = o.eb[r];
        o.eadd[r] = b >= 0 ? model::armature(b) + model::DT * model::damping(b) : 0.0f;
    }
#ifdef CHAIN_EXT_TASK
#pragma unroll
    for (int r = 0; r < PR; ++r) {
        const int p = team::point_p(r, lane);
        o.pp[r] = p;
        o.pb[r] = team::point_body(r, lane);
        o.pdep[r] = team::point_depth(r, lane);
        o.panc[r] = team::point_anc(r, lane);
        if (p >= 0) point_constants(p, o.pc[r]);
    }
#else
    for (int r = 0; r < PR; ++r) o.pp[r] = -1;
#endif
    return o;
}

// A thread's place in its team: its lane, the team's lanes in the warp, and
// what the lane owns. The host build runs every lane itself, from the
// table `lanes` of what each owns.
struct Team {
    int lane;
    unsigned mask;
    Own own;
    const Own* lanes;
};

// The kinds of phase, as the optional cycle count names them.
enum PhaseKind { PH_INIT, PH_DOFS, PH_FK, PH_BODY, PH_TASK, PH_ACT, PH_SLOTS, PH_ENTRIES,
                 PH_SOLVE, N_PHASE_KINDS };

#if defined(__CUDACC__) && defined(CHAIN_PHASE_CLOCKS)
// A build with -DCHAIN_PHASE_CLOCKS sums the clock64() cycles of each kind
// of phase, sync included, as the first thread of block 0 sees them (its
// particle's whole chain); chain_rollout_phase_cycles reads them.
__device__ unsigned long long phase_cycles[N_PHASE_KINDS];
#endif

// One phase: f(lane, own) for every lane of the team, then the team syncs.
// On the card each thread runs its own lane; on the host the lanes run one
// after another.
template <class F>
CHAIN_FN void phase(const Team& team, PhaseKind kind, F&& f) {
#ifdef __CUDA_ARCH__
#ifdef CHAIN_PHASE_CLOCKS
    const long long start = clock64();
#endif
    f(team.lane, team.own);
    __syncwarp(team.mask);
#ifdef CHAIN_PHASE_CLOCKS
    if (blockIdx.x == 0 && threadIdx.x == 0) phase_cycles[kind] += clock64() - start;
#endif
#else
    (void)kind;
    for (int lane = 0; lane < TEAM; ++lane) f(lane, team.lanes[lane]);
#endif
}

// f(std::integral_constant<int, I>) for I = BEGIN .. END - 1: a loop whose
// index is a compile-time constant in the body.
template <int I, int END, class F>
CHAIN_FN void static_for(F&& f) {
    if constexpr (I < END) {
        f(std::integral_constant<int, I>{});
        static_for<I + 1, END>(f);
    }
}

// f(p) for the lane's branch p < P, where f(p) is a compile-time constant:
// a select among P constants, not a table lookup.
template <int P, class F>
CHAIN_FN auto pick(int lane, F&& f) -> decltype(f(std::integral_constant<int, 0>{})) {
    auto v = f(std::integral_constant<int, 0>{});
    static_for<1, P>([&](auto p) {
        if (lane == decltype(p)::value) v = f(p);
    });
    return v;
}

// ---------------------------------------------------------------------------
// The phases
// ---------------------------------------------------------------------------

// A: the previous substep's semi-implicit Euler step and joint-limit clamp
// (qd zeroed where clamped; at a control step's end, with `limit`, the
// task's velocity limit), then each dof's rotation about its axis (unread
// for a slide).
CHAIN_FN void dofs(Particle& s, int lane, const Own& o, bool euler, bool limit) {
#pragma unroll
    for (int r = 0; r < DOF_ROUNDS; ++r) {
        const int i = lane + r * TEAM;
        if (i >= N) continue;
        float q = s.q[i];
        if (euler) {
            const float qdn = s.qd[i] + model::DT * s.acc[i];
            const float qn = q + model::DT * qdn;
            const float clamped = fminf(fmaxf(qn, o.qlow[r]), o.qhigh[r]);
            float qd = clamped == qn ? qdn : 0.0f;
            if (limit) qd = fminf(fmaxf(qd, -o.vlim[r]), o.vlim[r]);
            s.qd[i] = qd;
            s.q[i] = q = clamped;
        }
        s.rl[i] = chain_rollout::rodrigues(o.axis[r], cosf(q), sinf(q));
    }
}

// The constants of body b at a level of a branch (b = -1: none).
struct LevelBody {
    int i;
    bool hinge, store;
    V3 bp, ax;
};

constexpr LevelBody level_body(int b, int store) {
    if (b < 0) return {-1, false, false, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    return {b, model::jtype(b) == 0, store != 0,
            {model::body_pos(b, 0), model::body_pos(b, 1), model::body_pos(b, 2)},
            {model::axis(b, 0), model::axis(b, 1), model::axis(b, 2)}};
}

// B: FK down branch `lane` of the tree, level by level from the root (the
// branches share their upper levels, which each computes and the first
// stores), with the RNEA's forward recursion at qdd = 0: w, dw and the
// origin's acceleration ao.
CHAIN_FN void fk_branch(Particle& s, int lane) {
    constexpr int P = team::N_BRANCHES;
    if (lane >= P) return;
    const V3 zero = {0.f, 0.f, 0.f};
    M3 rp = {{1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f}};
    V3 pp = zero, wp = zero, dwp = zero, ap = zero;
    static_for<0, MAXD>([&](auto level) {
        constexpr int lv = decltype(level)::value;
        const LevelBody c = pick<P>(lane, [](auto p) {
            constexpr LevelBody lb = level_body(team::fk_body(decltype(p)::value, lv),
                                                team::fk_store(decltype(p)::value, lv));
            return lb;
        });
        const int i = c.i;
        if (i < 0) return;  // a shorter branch
        const bool hinge = c.hinge;
        M3 r;
        V3 pos, a;
        if constexpr (lv == 0) {  // the root: world parent, identity rotation, zero origin
            if (hinge) {
                pos = c.bp;
                r = s.rl[i];
                a = mv(r, c.ax);
            } else {
                pos = add(c.bp, scale(s.q[i], c.ax));
                r = rp;
                a = c.ax;
            }
        } else {
            const V3 base = add(pp, mv(rp, c.bp));
            if (hinge) {
                pos = base;
                r = mm(rp, s.rl[i]);
                a = mv(r, c.ax);
            } else {
                a = mv(rp, c.ax);
                pos = add(base, scale(s.q[i], a));
                r = rp;
            }
        }
        const V3 rr = sub(pos, pp);
        const V3 av = scale(s.qd[i], a);
        const V3 wj = hinge ? av : zero;
        const V3 vj = hinge ? zero : av;
        const V3 w = add(wp, wj);
        const V3 dw = add(dwp, cross(wp, wj));
        const V3 ao = add(add(ap, cross(dwp, rr)),
                          add(cross(wp, cross(wp, rr)), scale(2.0f, cross(wp, vj))));
        if (c.store) {
            s.f.R[i] = r;
            s.f.P[i] = pos;
            s.f.A[i] = a;
            s.w[i] = w;
            s.dw[i] = dw;
            s.ao[i] = ao;
        }
        rp = r;
        pp = pos;
        wp = w;
        dwp = dw;
        ap = ao;
    });
}

// C: body i's com offset R c, world inertia R I R^T and the RNEA's force
// and moment terms at qdd = 0 (the moment about the body's origin).
CHAIN_FN void body_terms(Particle& s, int lane, const Own& o) {
    const V3 g = {model::gravity(0), model::gravity(1), model::gravity(2)};
#pragma unroll
    for (int r = 0; r < DOF_ROUNDS; ++r) {
        const int i = lane + r * TEAM;
        if (i >= N) continue;
        const M3 R = s.f.R[i];
        const V3 rc = mv(R, o.com[r]);
        const M3 iw = rotate_inertia(R, o.inertia[r]);
        const V3 w = s.w[i], dw = s.dw[i];
        const V3 acc_c = add(s.ao[i], add(cross(dw, rc), cross(w, cross(w, rc))));
        s.rc[i] = rc;
        s.iw[i] = iw;
        const V3 fc = scale(o.mass[r], sub(acc_c, g));
        const V3 nc = add(mv(iw, dw), cross(w, mv(iw, w)));
        s.fc[i] = fc;
        s.nown[i] = add(nc, cross(rc, fc));
    }
}

// D: the lane's Jacobian slots.
CHAIN_FN void slots(Particle& s, const Own& o) {
#pragma unroll
    for (int r = 0; r < SR; ++r) {
        const int i = o.si[r];
        if (i < 0) continue;
        const int d = o.sd[r];
        Slot& sl = s.slot[i][o.sk[r]];
        sl.m = o.sm[r];
        if (is_hinge(d)) {
            const V3 ci = add(s.f.P[i], s.rc[i]);
            sl.jv = cross(s.f.A[d], sub(ci, s.f.P[d]));
            sl.iwa = mv(s.iw[i], s.f.A[d]);
        } else {
            sl.jv = s.f.A[d];
        }
    }
}

// A body of a run and its children in decreasing order (-1: none).
struct RunBody {
    int i;
    bool hinge;
    int child[team::MAX_CHILDREN];
};

template <int SEG, int P, int J>
constexpr RunBody run_body() {
    RunBody out{team::run_body(SEG, P, J), false, {}};
    if (out.i >= 0) out.hinge = model::jtype(out.i) == 0;
    for (int k = 0; k < team::MAX_CHILDREN; ++k) out.child[k] = team::run_child(SEG, P, J, k);
    return out;
}

// D, E: the RNEA's backward pass over the runs of segment SEG (a run goes
// up from a leaf or a branching body to below the next branching body),
// one run per lane: at each body its children's forces and moments,
// gathered in decreasing order from the state, the bias, and what the body
// hands to its parent.
template <int SEG>
CHAIN_FN void rnea_backward(Particle& s, int lane) {
    constexpr int P = team::N_RUNS;
    if (lane >= P) return;
    static_for<0, team::RUN_LEN>([&](auto step) {
        constexpr int j = decltype(step)::value;
        const RunBody c = pick<P>(lane, [](auto p) {
            constexpr RunBody rb = run_body<SEG, decltype(p)::value, j>();
            return rb;
        });
        const int i = c.i;
        if (i < 0) return;  // a shorter run
        V3 fa = {0.f, 0.f, 0.f}, na = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < team::MAX_CHILDREN; ++k) {
            const int ch = c.child[k];
            if (ch >= 0) {
                const V3 fc = s.fi[ch];
                fa = add(fa, fc);
                na = add(na, add(s.nmom[ch], cross(sub(s.f.P[ch], s.f.P[i]), fc)));
            }
        }
        const V3 fi = add(s.fc[i], fa);
        const V3 nmom = add(s.nown[i], na);
        s.bias[i] = c.hinge ? dot(s.f.A[i], nmom) : dot(s.f.A[i], fi);
        s.fi[i] = fi;
        s.nmom[i] = nmom;
    });
}

// E: the lane's packed mass entries M[a][b] by Jacobian composition: each
// the sum over the bodies i below b, in increasing order, of jv_a . m_i jv_b
// (+ a_a . I_i a_b for two hinges); armature + dt * damping on the
// diagonal. The sums are unrolled to their round's longest
// (team::entry_terms), so that every term's loads issue at once.
CHAIN_FN void mass_entries(Particle& s, const Own& o) {
    static_for<0, ER>([&](auto round) {
        constexpr int r = decltype(round)::value;
        const int a = o.ea[r];
        if (a < 0) return;
        const int b = o.eb[r], ka = o.eka[r], kb = o.ekb[r];
        const bool rot = is_hinge(a) && is_hinge(b);
        const V3 aa = s.f.A[a];
        const int n_terms = o.eend[r] - b;
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < team::entry_terms(r); ++k) {
            if (k < n_terms) {
                const Slot& sa = s.slot[b + k][ka];
                const Slot& sb = s.slot[b + k][kb];
                float term = sa.m * dot(sa.jv, sb.jv);
                if (rot) term = term + dot(aa, sb.iwa);
                sum = sum + term;
            }
        }
        s.M[a][b] = a == b ? sum + o.eadd[r] : sum;
    });
}

// 1 / sqrt(v): on the card rsqrtf (at most 2 ulp off, as sinf is, and no
// slow-path branch), on the host the division.
CHAIN_FN float inv_sqrt(float v) {
#ifdef __CUDA_ARCH__
    return rsqrtf(v);
#else
    return 1.0f / sqrtf(v);
#endif
}

// Solve M x = rhs for the SPD M given by its upper triangle, in registers:
// the Cholesky factor row by row, then forward and back substitution; the
// factor's diagonal enters only as its reciprocal, 1 / sqrt of the pivot,
// which multiplies: an IEEE division or square root carries a slow-path
// branch that keeps the next one from starting, so 4N of them in a row
// cost far more than N reciprocal square roots (another rounding, within
// the kernel's tolerance).
CHAIN_FN void chol_solve_rcp(const float (&m)[N][N], float (&x)[N]) {
    float l[N][N], inv[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float v = m[j][i];
#pragma unroll
            for (int k = 0; k < j; ++k) v = v - l[i][k] * l[j][k];
            if (i == j) {
                inv[i] = inv_sqrt(v);
            } else {
                l[i][j] = v * inv[j];
            }
        }
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float v = x[i];
#pragma unroll
        for (int k = 0; k < i; ++k) v = v - l[i][k] * x[k];
        x[i] = v * inv[i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
        float v = x[i];
#pragma unroll
        for (int k = i + 1; k < N; ++k) v = v - l[k][i] * x[k];
        x[i] = v * inv[i];
    }
}

// S: on the first lane, in registers: the right-hand side gear u - bias -
// damping qd - stiffness q (- frictionloss tanh(50 qd)) (+ tau) and the
// solve (chol_solve_rcp): qdd.
template <bool HAS_EXT>
CHAIN_FN void solve(Particle& s, int lane) {
    if (lane != 0) return;
    float m[N][N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = i; j < N; ++j) m[i][j] = s.M[i][j];
        float r = model::gear(i) * s.u[i] - s.bias[i] - model::damping(i) * s.qd[i]
                - model::stiffness(i) * s.q[i];
        if (model::frictionloss(i) != 0.0f)  // smooth Coulomb friction
            r = r - model::frictionloss(i) * tanhf(s.qd[i] * 50.0f);
        if constexpr (HAS_EXT) r = r + s.tau[i];
        x[i] = r;
    }
    chol_solve_rcp(m, x);
#pragma unroll
    for (int i = 0; i < N; ++i) s.acc[i] = x[i];
}

// The action u = clip(a) of dof i for the step's substeps.
CHAIN_FN void set_action(Particle& s, int i, float a) {
    s.u[i] = fminf(fmaxf(a, model::ULOW), model::UHIGH);
}

// ---------------------------------------------------------------------------
// External forces (EXT): the locomotion tasks' force laws at a contact
// point, and its terms on the dofs that move it.
// ---------------------------------------------------------------------------

#ifdef CHAIN_EXT_TASK
static_assert(CHAIN_EXT_TASK == model::TASK, "the header's task and CHAIN_EXT_TASK differ");

// The translational Jacobian columns of the world point p on a body whose
// root path is `anc` (4 bits a level, levels 0 .. dep): a_d x (p - o_d) for
// a hinge d, a_d for a slide; and the point's velocity, sum_d qd_d col_d,
// root to leaf.
CHAIN_FN V3 point_columns(const Particle& s, unsigned anc, int dep, V3 p, V3 (&col)[MAXD]) {
    V3 v = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
        if (k <= dep) {
            const int d = (anc >> (4 * k)) & 15u;
            col[k] = is_hinge(d) ? cross(s.f.A[d], sub(p, s.f.P[d])) : s.f.A[d];
            v = add(v, scale(s.qd[d], col[k]));
        }
    }
    return v;
}

#if CHAIN_EXT_TASK == 2
// Swimmer (envs/swimmer.py): anisotropic quadratic drag on x-aligned
// capsule links at N_SAMPLES points along each link's axis (link-major):
// F = -c_perp/2 min(|v_n|, VCAP) v_n - c_par/2 min(|v_t|, VCAP) v_t; the
// point's constants are its offset along the axis and the link's halved
// coefficients.
CHAIN_FN void point_constants(int p, float (&pc)[3]) {
    const int li = p / loco::N_SAMPLES;
    pc[0] = loco::sample(p % loco::N_SAMPLES);
    pc[1] = loco::drag_perp(li);
    pc[2] = loco::drag_par(li);
}

CHAIN_FN void point_terms(const Particle& s, int b, int dep, unsigned anc, const float (&pc)[3],
                          float* ctb) {
    const M3& rb = s.f.R[b];
    const V3 ax = {rb.m[0], rb.m[3], rb.m[6]};  // R e_x
    const V3 p = add(s.f.P[b], scale(pc[0], ax));
    V3 col[MAXD];
    const V3 v = point_columns(s, anc, dep, p, col);
    const float v_ax = dot(v, ax);
    const V3 v_par = scale(v_ax, ax);
    const V3 v_perp = sub(v, v_par);
    const float n_perp = sqrtf(dot(v_perp, v_perp));
    const float n_par = fabsf(v_ax);
    const V3 force = add(scale(-pc[1] * fminf(n_perp, loco::VCAP), v_perp),
                         scale(-pc[2] * fminf(n_par, loco::VCAP), v_par));
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
        if (k <= dep) ctb[k] = dot(col[k], force);
}
#elif CHAIN_EXT_TASK == 3
// Half cheetah (envs/half_cheetah.py): compliant ground contact at
// body-local points, a spring-damper normal force below z = RADIUS and
// saturated Coulomb friction -MU f_n tanh(v_x * INV_SLIP) along x; the
// branch on depth is a select. The point's constants are its body-local
// position.
CHAIN_FN void point_constants(int p, float (&pc)[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pc[k] = loco::contact_point(p, k);
}

CHAIN_FN void point_terms(const Particle& s, int b, int dep, unsigned anc, const float (&pc)[3],
                          float* ctb) {
    const V3 p = add(s.f.P[b], mv(s.f.R[b], {pc[0], pc[1], pc[2]}));
    V3 col[MAXD];
    const V3 v = point_columns(s, anc, dep, p, col);
    const float depth = loco::RADIUS - p.z;
    const float push = fmaxf(loco::KP * depth - loco::KD * v.z, 0.0f);
    const float fn = depth > 0.0f ? push : 0.0f;
    const float ft = -loco::MU * fn * tanhf(v.x * loco::INV_SLIP);
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
        if (k <= dep) ctb[k] = col[k].x * ft + col[k].z * fn;
}
#endif

// C: the lane's contact points.
CHAIN_FN void points(Particle& s, const Own& o) {
#pragma unroll
    for (int r = 0; r < PR; ++r)
        if (o.pp[r] >= 0) point_terms(s, o.pb[r], o.pdep[r], o.panc[r], o.pc[r], s.ctb[o.pp[r]]);
}

// D: dof i's generalized force, its points' terms in increasing order.
CHAIN_FN void gather_tau(Particle& s, int lane, const Own& o) {
#pragma unroll
    for (int r = 0; r < DOF_ROUNDS; ++r) {
        const int i = lane + r * TEAM;
        if (i >= N) continue;
        float t = 0.0f;
#pragma unroll
        for (int p = 0; p < team::N_POINTS; ++p)
            if ((o.pmask[r] >> p) & 1u) t = t + s.ctb[p][o.depth[r]];
        s.tau[i] = t;
    }
}

// The step cost of (state in, state out, clipped action), -reward of the
// env's step: CTRL_WEIGHT * sum of u_j^2 over the actuated dofs j >= U0
// minus the forward progress (x_out - x_in) / control dt.
CHAIN_FN float loco_step_cost(const Particle& s) {
    float ctrl = 0.0f;
#pragma unroll
    for (int j = loco::U0; j < N; ++j) ctrl = ctrl + s.u[j] * s.u[j];
    return loco::CTRL_WEIGHT * ctrl - (s.q[0] - s.q_in0) * loco::INV_DT;
}
#endif  // CHAIN_EXT_TASK

// ---------------------------------------------------------------------------
// Rollout
// ---------------------------------------------------------------------------

using chain_rollout::CL;
using chain_rollout::COSTS;
using chain_rollout::EXT;
using chain_rollout::OBS;

// Roll out particle b on the team. noise [n, horizon, N], costs [n,
// horizon], (OBS, CL) obs [n, horizon, D_OBS] and (CL) acts [n, horizon,
// N] are contiguous f32; q0, qd0 [N] and extras [N_EXTRAS] are shared;
// ctrl is the mean [horizon, N] (COSTS, OBS, EXT: u = clip(mean[t] + eps))
// or the policy W [D_OBS + 1, N] (CL: a = W^T [obs; 1] + eps from the
// observation of the state entering the step, stored before the clip, u =
// clip(a)). COSTS, OBS, CL: costs of the state after each step, from the
// FK that also serves the next step's observation and first substep; (OBS,
// CL) the observation of the state entering each step. EXT: FK and the
// task's external forces at the start of every substep, the velocity limit
// after the step's substeps, the task's step cost of (state in, state
// out, u). A step's row of noise, obs and actions is read or written by
// the team's lanes side by side; one lane writes the cost.
template <int MODE, class Task>
CHAIN_FN void rollout_team(Particle& s, const Team& lane_team, const float* __restrict__ q0,
                           const float* __restrict__ qd0, const float* __restrict__ extras,
                           const float* __restrict__ ctrl, const float* __restrict__ noise,
                           float* __restrict__ costs, float* __restrict__ obs,
                           float* __restrict__ acts, int b, int horizon) {
#ifdef __CUDA_ARCH__
    const Team& team = lane_team;
#else
    (void)lane_team;
    Own lanes[TEAM];  // the host runs every lane: each lane's items, read once
    for (int lane = 0; lane < TEAM; ++lane) lanes[lane] = own_of(lane);
    const Team team{0, 0u, {}, lanes};
#endif
    constexpr bool kExt = MODE == EXT;
    constexpr int ns = model::N_SUBSTEPS;
    const typename Task::Extras ex = Task::load(extras);
    const float* nz = noise + static_cast<size_t>(b) * horizon * N;
    float* out = costs + static_cast<size_t>(b) * horizon;
    phase(team, PH_INIT, [&](int lane, const Own&) {
        for (int k = lane; k < N; k += TEAM) {
            s.q[k] = q0[k];
            s.qd[k] = qd0[k];
        }
        for (int k = lane; k < N * N; k += TEAM) (&s.M[0][0])[k] = 0.0f;  // pairs never set stay 0
    });
#pragma unroll 1
    for (int k = 0;; ++k) {  // k substeps done
        const bool step_start = k % ns == 0;
        const int t = k / ns;
        phase(team, PH_DOFS, [&](int lane, const Own& o) {
            dofs(s, lane, o, k > 0, HAS_VEL_LIMIT && step_start);
        });
        phase(team, PH_FK, [&](int lane, const Own&) { fk_branch(s, lane); });
        phase(team, PH_BODY, [&](int lane, const Own& o) {
            body_terms(s, lane, o);
#ifdef CHAIN_EXT_TASK
            points(s, o);
#endif
        });
        if (step_start) {
            // the cost of the step before; (OBS, CL) this step's observation
            phase(team, PH_TASK, [&](int lane, const Own&) {
                if (lane != 0) return;
                if constexpr (kExt) {
#ifdef CHAIN_EXT_TASK
                    if (t > 0) out[t - 1] = loco_step_cost(s);
#endif
                } else {
                    if (t > 0) out[t - 1] = Task::cost(s.f, ex);
                    if constexpr (MODE != COSTS) {
                        if (t < horizon) {
                            chain_rollout::ObsSink sink{s.obs};
                            Task::obs(s.f, s.q, s.qd, ex, sink);
                        }
                    }
                }
            });
            if (t == horizon) break;
            // the step's actions: (CL) the observation row, a = W^T [obs; 1]
            // + eps stored before the clip; (COSTS, OBS, EXT) mean + eps;
            // (EXT) q[0]; (OBS) the observation row
            const float* eps = nz + t * N;
            phase(team, PH_ACT, [&](int lane, const Own&) {
                if constexpr (MODE != CL) {
                    for (int i = lane; i < N; i += TEAM) set_action(s, i, ctrl[t * N + i] + eps[i]);
                    if constexpr (kExt) {
                        if (lane == 0) s.q_in0 = s.q[0];
                    }
                    if constexpr (MODE == OBS) {
                        constexpr int d_obs = Task::D_OBS;
                        const size_t row = static_cast<size_t>(b) * horizon + t;
                        for (int j = lane; j < d_obs; j += TEAM) obs[row * d_obs + j] = s.obs[j];
                    }
                } else {
                    constexpr int d_obs = Task::D_OBS;
                    const size_t row = static_cast<size_t>(b) * horizon + t;
                    for (int j = lane; j < d_obs; j += TEAM) obs[row * d_obs + j] = s.obs[j];
                    for (int i = lane; i < N; i += TEAM) {
                        float a = ctrl[d_obs * N + i] + eps[i];
#pragma unroll
                        for (int j = 0; j < d_obs; ++j) a = a + ctrl[j * N + i] * s.obs[j];
                        acts[row * N + i] = a;
                        set_action(s, i, a);
                    }
                }
            });
        }
        // D: slots, the leaf runs of the RNEA's backward pass, (EXT) the
        // generalized forces
        phase(team, PH_SLOTS, [&](int lane, const Own& o) {
            slots(s, o);
            rnea_backward<0>(s, lane);
#ifdef CHAIN_EXT_TASK
            gather_tau(s, lane, o);
#endif
        });
        // E: mass entries, the next runs
        phase(team, PH_ENTRIES, [&](int lane, const Own& o) {
            mass_entries(s, o);
            if constexpr (team::N_SEGMENTS > 1) rnea_backward<1>(s, lane);
        });
        if constexpr (team::N_SEGMENTS > 2)
            phase(team, PH_ENTRIES, [&](int lane, const Own&) { rnea_backward<2>(s, lane); });
        phase(team, PH_SOLVE, [&](int lane, const Own&) { solve<kExt>(s, lane); });
    }
}

}  // namespace chain_team
