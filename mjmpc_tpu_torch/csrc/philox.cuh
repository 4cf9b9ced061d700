// Philox4x32-10, the counter-based generator of Salmon et al., "Parallel
// random numbers: as easy as 1, 2, 3" (SC 2011): four 32-bit counter words
// and a 64-bit key give four random 32-bit words, with no state between
// calls. Host-and-device code, so the same source also compiles as plain
// C++ (tests/test_torch_noise.py checks it on the CPU that way); the plain
// PyTorch version is mjmpc_tpu_torch/ops/noise.py philox4x32_10.

#pragma once

#include <stdint.h>

#define PHILOX_FN __host__ __device__ __forceinline__

namespace philox {

struct U4 {
    uint32_t x, y, z, w;
};

constexpr uint32_t kM0 = 0xD2511F53u;  // round multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // key schedule (Weyl) increments
constexpr uint32_t kW1 = 0xBB67AE85u;

PHILOX_FN void mulhilo(uint32_t a, uint32_t b, uint32_t& hi, uint32_t& lo) {
    const uint64_t p = static_cast<uint64_t>(a) * b;
    hi = static_cast<uint32_t>(p >> 32);
    lo = static_cast<uint32_t>(p);
}

// Ten rounds on counter c under key (k0, k1).
PHILOX_FN U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        uint32_t hi0, lo0, hi1, lo1;
        mulhilo(kM0, c.x, hi0, lo0);
        mulhilo(kM1, c.z, hi1, lo1);
        c = {hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
        k0 += kW0;
        k1 += kW1;
    }
    return c;
}

}  // namespace philox
