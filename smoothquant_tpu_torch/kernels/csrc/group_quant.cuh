// Per-(row, group) activation quantize of one warp, shared by K1's pre-pass
// (int4_group_matmul.cu, rawx.cuh) and K7a and K7b (act_prep.cu); and the
// RMSNorm factor of one row that K1's pre-pass and K7b take.
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

// 1/√(mean(x²) + eps) of one row of C values; every thread of the block
// calls it and gets the factor.  Σx² in f64 (exact squares), rounded to f32
// once: then its value does not depend on the order of the sum, and the
// plain versions and models.common.rms_norm, which sum the same way
// (quant.core.rms_factor), agree with it on the CPU and on the card.  1/√v:
// the square root and the reciprocal each correctly rounded, as IEEE fixes
// them on both devices (rsqrtf, like torch.rsqrt, is approximate and
// differs between them).  `scratch` holds 32 doubles.
template <typename T>
__device__ __forceinline__ float row_rms_factor(const T* __restrict__ xr, int C, float eps,
                                                double* scratch) {
  double ss = 0.0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const double v = to_f<T>(xr[c]);
    ss += v * v;
  }
  ss = block_sum_f64(ss, scratch);
  return __frcp_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(__double2float_rn(ss), 1.0f / (float)C), eps)));
}
