// Per-thread arithmetic of the filtered-noise kernel (filtered_noise.cu):
// one (particle b, action dim d) column of AR(2)-filtered standard normals
// along the horizon. Host-and-device code, so the same source also
// compiles as plain C++ (tests/test_torch_noise.py checks it on the CPU).
//
// Random bits: Philox4x32-10 (philox.cuh) keyed by the 64-bit seed, with
// counter (b, d, t / 2, 0). One call gives four words, i.e. two
// Box-Muller normals: words (x, y) for the even step, (z, w) for the odd.
// Counters never repeat across (b, d, t), so streams cannot collide.

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

// Column (b, d): z[t] for t < horizon, then e[t] = z[t] for t < 2 and
// e[t] = b0 z[t] + b1 e[t-1] + b2 e[t-2] after (previous values already
// filtered) when `filter` is set. Writes out[b, t, d] of a contiguous
// [n, horizon, d_action] array; the two filter taps stay in registers.
NOISE_FN void noise_column(uint64_t seed, float b0, float b1, float b2, bool filter, int b,
                           int d, int horizon, int d_action, float* __restrict__ out) {
    const uint32_t k0 = static_cast<uint32_t>(seed);
    const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
    float* col = out + static_cast<size_t>(b) * horizon * d_action + d;
    philox::U4 r = {0u, 0u, 0u, 0u};
    float e1 = 0.0f, e2 = 0.0f;
    for (int t = 0; t < horizon; ++t) {
        if ((t & 1) == 0)
            r = philox::philox4x32_10(
                {static_cast<uint32_t>(b), static_cast<uint32_t>(d),
                 static_cast<uint32_t>(t >> 1), 0u},
                k0, k1);
        const float z = (t & 1) ? box_muller(r.z, r.w) : box_muller(r.x, r.y);
        const float e = (filter && t >= 2) ? b0 * z + b1 * e1 + b2 * e2 : z;
        col[static_cast<size_t>(t) * d_action] = e;
        e2 = e1;
        e1 = e;
    }
}

}  // namespace filtered_noise
