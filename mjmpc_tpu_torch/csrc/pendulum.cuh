// Per-thread arithmetic of the pendulum kernels (pendulum.cu): the
// analytic pendulum's control step, split into the torque's clip, the cost
// of a pre-step state and the recurrence; kernel #7's three phases (the
// clip of one element, one particle's recurrence, the cost of one
// element) and the one-kernel MPPI solve's noise item and particle row
// (kernel #8). Host-and-device code, so the same source also compiles as
// plain C++ (tests/test_torch_pendulum.py checks it on the CPU that way);
// the plain PyTorch version is mjmpc_tpu_torch/ops/pendulum.py, which
// performs the same float32 operations in the same order (the library is
// built with -fmad=false, so no multiply-add is contracted here either).
//
// The model is read from device memory at call time, as eight floats
// (Scalar below): the start state and the six PendulumParams.

#pragma once

#include <math.h>
#include <stdint.h>

#include "filtered_noise.cuh"

#define PENDULUM_FN __host__ __device__ __forceinline__

namespace pendulum {

constexpr float kPi = 3.14159274101257324f;     // float32(pi)
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)

// Layout of the scalars array: the state entering step 0, then the params.
enum Scalar { TH0 = 0, THDOT0, G, M, L, DT, MAX_SPEED, MAX_TORQUE, N_SCALARS };

struct Model {
    float c_grav;    // -3 g / (2 l)
    float c_torque;  // 3 / (m l^2)
    float dt, max_speed, max_torque;
};

PENDULUM_FN Model model(const float* s) {
    Model m;
    m.c_grav = (-3.0f * s[G]) / (2.0f * s[L]);
    m.c_torque = 3.0f / (s[M] * (s[L] * s[L]));
    m.dt = s[DT];
    m.max_speed = s[MAX_SPEED];
    m.max_torque = s[MAX_TORQUE];
    return m;
}

PENDULUM_FN float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// x mod y with the sign of y: the floor modulo of JAX's % and of
// torch.remainder (the truncated fmodf, then y added to a remainder whose
// sign differs from y's), so that th + pi < 0 wraps into [0, 2 pi). fmodf
// alone keeps the sign of x and puts the angle outside [-pi, pi).
PENDULUM_FN float floor_mod(float x, float y) {
    const float r = fmodf(x, y);
    return (r != 0.0f && (r < 0.0f) != (y < 0.0f)) ? r + y : r;
}

// The torque that the commanded action a applies: a clipped to
// [-max_torque, max_torque].
PENDULUM_FN float control(const Model& m, float a) { return clip(a, -m.max_torque, m.max_torque); }

// The cost of the pre-step state (th, thdot) under the clipped torque u.
PENDULUM_FN float state_cost(float th, float thdot, float u) {
    const float ang = floor_mod(th + kPi, kTwoPi) - kPi;
    return ang * ang + 0.1f * (thdot * thdot) + 0.001f * (u * u);
}

// One step of the recurrence under the clipped torque u: th advances with
// the unclamped new thdot, and thdot is clamped last.
PENDULUM_FN void advance(const Model& m, float u, float& th, float& thdot) {
    thdot = thdot + (m.c_grav * sinf(th + kPi) + m.c_torque * u) * m.dt;
    th = th + thdot * m.dt;
    thdot = clip(thdot, -m.max_speed, m.max_speed);
}

// One control step under the commanded torque a: the torque is clipped,
// the cost is taken at the pre-step state, then the state advances
// (mjmpc_tpu/envs/pendulum.py step).
PENDULUM_FN float step(const Model& m, float a, float& th, float& thdot) {
    const float u = control(m, a);
    const float cost = state_cost(th, thdot, u);
    advance(m, u, th, thdot);
    return cost;
}

// Kernel #7, phase 2, one particle: its pre-step states (ths[t], thdots[t])
// of the rollout from (th, thdot) under its clipped torques u[t]. Only this
// recurrence is serial; the clip before it and the cost after it
// (state_cost) are per element.
PENDULUM_FN void rollout_states(const Model& m, float th, float thdot, const float* u,
                                float* ths, float* thdots, int horizon) {
    for (int t = 0;; ++t) {
        ths[t] = th;
        thdots[t] = thdot;
        if (t + 1 == horizon) return;
        advance(m, u[t], th, thdot);
    }
}

// Kernel #8, phase 1, item (particle i, step pair p): its two white
// normals, the filtered-noise kernel's counter (i, 0, p, step) under the
// key (filtered_noise.cuh normal_pair), so that ops/noise.py
// philox_normals reproduces them bit for bit. Written to the row's t = 2p
// and, when H has it, t = 2p + 1, `stride` floats apart.
PENDULUM_FN void noise_item(uint32_t k0, uint32_t k1, uint32_t step, int i, int p, float* row,
                            int stride, int horizon) {
    float z0, z1;
    filtered_noise::normal_pair(k0, k1, static_cast<uint32_t>(i), 0u, static_cast<uint32_t>(p),
                                step, z0, z1);
    row[static_cast<size_t>(2 * p) * stride] = z0;
    if (2 * p + 1 < horizon) row[static_cast<size_t>(2 * p + 1) * stride] = z1;
}

// Kernel #8, phase 2, one particle: its row e[t * stride] holds its white
// normals on entry and eps[t] = sigma * AR(2)(white)[t] on return; c[t *
// stride] gets the costs of the rollout of mean[t] + eps[t] from (th0,
// thdot0). Returns the cost-to-go at t = 0 by the backward recurrence acc =
// c[H-1], acc = c[t] + gamma acc (ops/pendulum.py mppi_blend_plain).
PENDULUM_FN float solve_row(const Model& m, float th, float thdot, const float* mean, float* e,
                            float* c, int stride, int horizon, float b0, float b1, float b2,
                            bool filter, float sigma, float gamma) {
    if (filter) filtered_noise::filter_column(e, stride, horizon, b0, b1, b2);
    for (int t = 0; t < horizon; ++t) {
        const size_t at = static_cast<size_t>(t) * stride;
        const float et = sigma * e[at];
        e[at] = et;
        c[at] = step(m, mean[t] + et, th, thdot);
    }
    float acc = c[static_cast<size_t>(horizon - 1) * stride];
    for (int t = horizon - 2; t >= 0; --t) acc = c[static_cast<size_t>(t) * stride] + gamma * acc;
    return acc;
}

}  // namespace pendulum
