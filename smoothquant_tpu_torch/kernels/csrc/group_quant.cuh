// Per-(row, group) activation quantize of one warp, shared by K1's pre-pass
// (int4_group_matmul.cu) and K7a (act_prep.cu).
//
// Lane l holds the group's elements l, l + 32, ... (group size <= 128, so at
// most GQ_PER_LANE each); elements past the group hold 0.  The scale is
// max(absmax, 1e-5)·(1/qmax) — the f32 reciprocal multiply XLA compiles the
// JAX division by the constant qmax to — and each code rint(y / scale), a
// true division rounded half to even.
#pragma once

#include "common.cuh"

constexpr int GQ_PER_LANE = 4;  // group size <= 128

// Returns the group's scale (every lane) and writes the lane's codes.
__device__ __forceinline__ float warp_quantize_group(const float (&y)[GQ_PER_LANE],
                                                     float inv_qmax, int (&q)[GQ_PER_LANE]) {
  float absmax = 0.0f;
#pragma unroll
  for (int t = 0; t < GQ_PER_LANE; ++t) absmax = fmaxf(absmax, fabsf(y[t]));
  absmax = warp_max(absmax);
  const float scale = fmaxf(absmax, 1e-5f) * inv_qmax;
#pragma unroll
  for (int t = 0; t < GQ_PER_LANE; ++t) q[t] = (int)rintf(y[t] / scale);
  return scale;
}
