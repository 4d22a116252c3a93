// One decode position's k or v vector of one (slot, kv head) → int8 codes
// and an f32 scale: the math the two cache writers share, K2 (S-major
// cache, attn_smajor.cu) and K10 (head-major cache, cache_write.cu).
//
// A warp takes one head vector of D <= 256 values, lane l owning dims l,
// l + 32, ...  Rotary on k in f32 with the lane-half rotate: x·cos +
// rot(x)·sin.  The two JAX writers round it differently and each is
// mirrored: K2's Pallas body keeps the rounded products apart (FMA =
// false), jitted XLA fuses K10's into fma(x, cos, rot(x)·sin) (FMA = true).
// Then scale = max(absmax, 1e-8)·(1/127) (XLA's reciprocal multiply) and
// codes rint(x / scale), round half to even.
#pragma once

#include "common.cuh"

constexpr int KVQ_MAX_D_PER_LANE = 8;  // head_dim <= 256

template <typename T, bool FMA>
__device__ __forceinline__ void warp_quantize_kv(const T* __restrict__ src, int D, bool rot,
                                                 const float* __restrict__ cos_row,
                                                 const float* __restrict__ sin_row,
                                                 int8_t* __restrict__ dst,
                                                 float* __restrict__ scale_dst) {
  const int lane = threadIdx.x & 31;
  float vals[KVQ_MAX_D_PER_LANE];
  float absmax = 0.0f;
#pragma unroll
  for (int t = 0; t < KVQ_MAX_D_PER_LANE; ++t) {
    const int d = lane + 32 * t;
    float x = 0.0f;
    if (d < D) {
      x = to_f<T>(src[d]);
      if (rot) {
        const float partner = d < D / 2 ? -to_f<T>(src[d + D / 2]) : to_f<T>(src[d - D / 2]);
        const float ps = __fmul_rn(partner, sin_row[d]);
        x = FMA ? __fmaf_rn(x, cos_row[d], ps) : __fadd_rn(__fmul_rn(x, cos_row[d]), ps);
      }
    }
    vals[t] = x;
    absmax = fmaxf(absmax, fabsf(x));
  }
  absmax = warp_max(absmax);
  const float scale = fmaxf(absmax, 1e-8f) * (1.0f / 127.0f);
#pragma unroll
  for (int t = 0; t < KVQ_MAX_D_PER_LANE; ++t) {
    const int d = lane + 32 * t;
    if (d < D) dst[d] = (int8_t)(int)rintf(vals[t] / scale);
  }
  if (lane == 0) *scale_dst = scale;
}
