// Per-item arithmetic of the filtered-noise kernels (filtered_noise.cu) and
// of the one-kernel pendulum solve's noise (pendulum.cuh): Philox normals
// and uniforms, and the AR(2) filter along one column. Host-and-device
// code, so the same source also compiles as plain C++
// (tests/test_torch_noise.py checks it on the CPU that way).
//
// Random bits: Philox4x32-10 (philox.cuh) under the stream's 64-bit key,
// with the solver state's step as the last counter word. Normals: counter
// (b, d, p, step) for particle b, action dim d and step pair p; one call
// gives two Box-Muller normals, words (x, y) for step t = 2p and (z, w) for
// t = 2p + 1. Uniforms: counter (q, 0xFFFFFFFF, 0, step) gives four, words
// x, y, z, w for indices 4q to 4q + 3 (no action dim reaches 0xFFFFFFFF).
// Counters never repeat within a stream at one step, and the step makes
// every solve's draw a new one.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"

#define NOISE_FN __host__ __device__ __forceinline__

namespace filtered_noise {

// U[2^-25, 1) from the top 24 bits, so that log never sees 0 (the TPU
// kernel's _uniform01 in mjmpc_tpu/ops/pallas_kernels.py).
NOISE_FN float uniform01(uint32_t bits) {
    return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f  // 2^-24
           + 2.98023223876953125e-08f;                              // 2^-25
}

// One standard normal from two words: sqrt(-2 log u1) cos(2 pi u2).
NOISE_FN float box_muller(uint32_t a, uint32_t b) {
    const float u1 = uniform01(a);
    const float u2 = uniform01(b);
    return sqrtf(-2.0f * logf(u1)) * cosf(6.28318548202514648f * u2);
}

// The two normals of item (b, d, p) at `step` under the key (k0, k1): z0 is
// step t = 2p of column (b, d), z1 step t = 2p + 1.
NOISE_FN void normal_pair(uint32_t k0, uint32_t k1, uint32_t b, uint32_t d, uint32_t p,
                          uint32_t step, float& z0, float& z1) {
    const philox::U4 r = philox::philox4x32_10({b, d, p, step}, k0, k1);
    z0 = box_muller(r.x, r.y);
    z1 = box_muller(r.z, r.w);
}

// Uniforms 4q to 4q + 3 at `step` under the key (k0, k1), as uniform01.
NOISE_FN void uniform_quad(uint32_t k0, uint32_t k1, uint32_t q, uint32_t step, float* u) {
    const philox::U4 r = philox::philox4x32_10({q, 0xFFFFFFFFu, 0u, step}, k0, k1);
    u[0] = uniform01(r.x);
    u[1] = uniform01(r.y);
    u[2] = uniform01(r.z);
    u[3] = uniform01(r.w);
}

// The AR(2) filter in place along a column of `horizon` values `stride`
// floats apart: e[t] = z[t] for t < 2, then e[t] = b0 z[t] + b1 e[t-1] +
// b2 e[t-2] (previous values already filtered), the plain version's
// operations in its order (ops/noise.py ar_filter). The taps stay in
// registers.
NOISE_FN void filter_column(float* col, int stride, int horizon, float b0, float b1, float b2) {
    if (horizon <= 2) return;
    float e2 = col[0], e1 = col[stride];
    for (int t = 2; t < horizon; ++t) {
        float* at = col + static_cast<size_t>(t) * stride;
        const float e = b0 * *at + b1 * e1 + b2 * e2;
        *at = e;
        e2 = e1;
        e1 = e;
    }
}

}  // namespace filtered_noise
