// 3-vectors and row-major 3x3 matrices in f32, host-and-device, shared by
// the rollout kernels' per-particle code (chain_rollout.cuh,
// forest_rollout.cuh). Plain C++ with the CUDA qualifiers, so the tests
// also build it with g++.

#pragma once

#include <math.h>

#define VEC3_FN __host__ __device__ __forceinline__

namespace vec3 {

struct V3 {
    float x, y, z;
};

struct M3 {
    float m[9];  // row-major
};

VEC3_FN V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
VEC3_FN V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
VEC3_FN V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
VEC3_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

VEC3_FN V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// r v
VEC3_FN V3 mv(const M3& r, V3 v) {
    return {r.m[0] * v.x + r.m[1] * v.y + r.m[2] * v.z,
            r.m[3] * v.x + r.m[4] * v.y + r.m[5] * v.z,
            r.m[6] * v.x + r.m[7] * v.y + r.m[8] * v.z};
}

// r^T v
VEC3_FN V3 mtv(const M3& r, V3 v) {
    return {r.m[0] * v.x + r.m[3] * v.y + r.m[6] * v.z,
            r.m[1] * v.x + r.m[4] * v.y + r.m[7] * v.z,
            r.m[2] * v.x + r.m[5] * v.y + r.m[8] * v.z};
}

// a b
VEC3_FN M3 mm(const M3& a, const M3& b) {
    M3 out;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            out.m[3 * i + j] = a.m[3 * i] * b.m[j] + a.m[3 * i + 1] * b.m[3 + j]
                             + a.m[3 * i + 2] * b.m[6 + j];
    return out;
}

// r i r^T for a symmetric i
VEC3_FN M3 rotate_inertia(const M3& r, const M3& inertia) {
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

}  // namespace vec3
