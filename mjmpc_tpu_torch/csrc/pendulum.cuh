// Per-thread arithmetic of the pendulum kernels (pendulum.cu): the
// analytic pendulum's control step, one particle's open-loop rollout
// (kernel #7) and one particle's share of the one-kernel MPPI solve
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

// One control step under the commanded torque a: the torque is clipped,
// the cost is taken at the pre-step state, th advances with the unclamped
// new thdot, and thdot is clamped last (mjmpc_tpu/envs/pendulum.py step).
PENDULUM_FN float step(const Model& m, float a, float& th, float& thdot) {
    const float u = clip(a, -m.max_torque, m.max_torque);
    const float ang = floor_mod(th + kPi, kTwoPi) - kPi;
    const float cost = ang * ang + 0.1f * (thdot * thdot) + 0.001f * (u * u);
    thdot = thdot + (m.c_grav * sinf(th + kPi) + m.c_torque * u) * m.dt;
    th = th + thdot * m.dt;
    thdot = clip(thdot, -m.max_speed, m.max_speed);
    return cost;
}

// Kernel #7, particle b: costs[t] of the rollout of mean[t] + noise[t]
// from (th0, thdot0); noise and costs point at the particle's row.
PENDULUM_FN void rollout_particle(const float* s, const float* mean, const float* noise,
                                  float* costs, int horizon) {
    const Model m = model(s);
    float th = s[TH0], thdot = s[THDOT0];
    for (int t = 0; t < horizon; ++t) costs[t] = step(m, mean[t] + noise[t], th, thdot);
}

// Kernel #8, particle i: its noise row eps[i, t] = sigma * e[t], e the
// AR(2)-filtered normals of the filtered-noise kernel's Philox counter
// (i, 0, t / 2, 0) under `seed` (filtered_noise.cuh noise_column), the
// rollout of mean[t] + eps[i, t] with its costs in costs[i, t], and the
// return value: the cost-to-go at t = 0 by the backward recurrence
// acc = c[H-1], acc = c[t] + gamma acc. eps and costs are [n, horizon]
// scratch arrays.
PENDULUM_FN float solve_particle(uint64_t seed, const float* s, const float* mean, int i,
                                 int horizon, float b0, float b1, float b2, bool filter,
                                 float sigma, float gamma, float* eps, float* costs) {
    filtered_noise::noise_column(seed, b0, b1, b2, filter, i, 0, horizon, 1, eps);
    float* e = eps + static_cast<size_t>(i) * horizon;
    float* c = costs + static_cast<size_t>(i) * horizon;
    const Model m = model(s);
    float th = s[TH0], thdot = s[THDOT0];
    for (int t = 0; t < horizon; ++t) {
        e[t] = sigma * e[t];
        c[t] = step(m, mean[t] + e[t], th, thdot);
    }
    float acc = c[horizon - 1];
    for (int t = horizon - 2; t >= 0; --t) acc = c[t] + gamma * acc;
    return acc;
}

}  // namespace pendulum
