// The peg-insertion task's sensed hole frame and its depth-progress cost
// (envs/sawyer_tasks.py), shared by the chain kernels' Peg task
// (chain_rollout.cuh) and the forest kernel's (forest_rollout.cuh), so that
// the three peg planners compute one cost. Host-and-device.

#pragma once

#include "vec3.cuh"

namespace peg {

using vec3::V3;

// extras = [hole entry 3, hole axis 3 (unit, into the hole), hole depth,
// sensor bias 3]
struct Extras {
    V3 entry, axis;
    float depth;
    V3 bias;
};

VEC3_FN Extras load(const float* __restrict__ e) {
    return {{e[0], e[1], e[2]}, {e[3], e[4], e[5]}, e[6], {e[7], e[8], e[9]}};
}

// Depth along the hole axis and lateral offset of the tip from the sensed
// entry (entry + bias).
VEC3_FN void sensed(V3 tip, const Extras& ex, float& depth, float& lateral) {
    const V3 rel = vec3::sub(tip, vec3::add(ex.entry, ex.bias));
    depth = vec3::dot(rel, ex.axis);
    const V3 off = vec3::sub(rel, vec3::scale(depth, ex.axis));
    lateral = sqrtf(vec3::dot(off, off) + 1e-12f);
}

// |tip - bottom| + 5 * lateral * inserted - inserted, inserted =
// clip(depth, 0, hole depth) / hole depth: the env's reward negated.
VEC3_FN float cost(V3 tip, const Extras& ex) {
    float depth, lateral;
    sensed(tip, ex, depth, lateral);
    const V3 d = vec3::sub(tip, vec3::add(ex.entry, vec3::scale(ex.depth, ex.axis)));
    const float inserted = fminf(fmaxf(depth, 0.0f), ex.depth) / fmaxf(ex.depth, 1e-6f);
    return sqrtf(vec3::dot(d, d) + 1e-12f) + 5.0f * lateral * inserted - inserted;
}

}  // namespace peg
