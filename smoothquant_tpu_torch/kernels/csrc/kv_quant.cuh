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

// ---------------------------------------------------------------------------
// The row body of K2 and K10: one decode position's q, k and v of B slots,
// read where the qkv linear left them, written in one launch.
//
// K2 (S-major cache) and K10 (head-major cache) differ only in where a row
// lands and in how k's rotary rounds (FMA above), so both are this body
// templated on the layout.  What bounds it on the H100: launch latency —
// a call moves a few KB to a few MB, well under a microsecond of bytes — so
// the design takes the work the torch glue around the old call did into the
// launch it already costs, and keeps every value in registers:
//   - q, k and v are read in place through a slot stride and a head stride
//     each (Llama's fused qkv row: q at 0, k at nh·D, v at (nh + n_kv)·D,
//     head stride D; Bloom's interleaved (nh, 3, D): head stride 3·D), so no
//     copy comes first;
//   - q's rotary runs here when the caller asks for it, bit for bit as the
//     model's apply_rotary rounds it (bf16: the tables rounded to bf16, each
//     product and the sum rounded to bf16; f32: fma(x, cos, rot(x)·sin)),
//     into a fresh (B, H, D) output; GQA reads nh q heads and n_kv k / v;
//   - the position comes from layer i's row of the (L, B) or (L,) int32
//     positions (pos_sb 0 for an aligned one) and the tables from (B or 1,
//     1, D) f32 rows (t_sb 0 for a shared row), clamped to S − 1 here;
//   - a lane holds 8 consecutive values of one head (one 16-byte load of
//     bf16, two of f32), so a head is D/8 lanes of one warp (D = 16 .. 256,
//     a power of two), the rotary partner d ± D/2 is D/16 lanes away (one
//     shuffle a value) and the absmax a shuffle tree over the head's lanes;
//     codes go out 8 a lane, one scale a head, q 16 bytes at a time.
// Slot b's heads — q (Hq of them, 0 without q), then k, then v — are chunks
// c = head·D/8 + lane over blockIdx.x·blockDim.x + threadIdx.x, the grid
// (chunks / threads, B): no shared memory, no loop, no integer division.
// VEC false is the same body with scalar loads and stores, for rows that do
// not start 16 bytes aligned (the wrapper's shape rule picks it).
struct KvRowArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* cos_t;
  const float* sin_t;
  const int* pos;
  void* q_out;
  int8_t* kq;
  int8_t* vq;
  float* ks;
  float* vs;
  long long q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;   // element strides: slot, head
  int t_sb, pos_sb;                               // table row / position strides (0: shared)
  int S, Hq, Hkv, D, lg;                          // lg = log2(D / 8)
  int rotary;
};

// 8 consecutive values from p as f32 (16-byte loads when VEC)
template <typename T, bool VEC>
__device__ __forceinline__ void kv_load8(const T* __restrict__ p, float (&v)[8]) {
  if constexpr (VEC && sizeof(T) == 2) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = to_f<T>(__ldg(p + e));
  }
}

// 8 values (already representable in T) to p (16-byte stores when VEC)
template <typename T, bool VEC>
__device__ __forceinline__ void kv_store8(T* __restrict__ p, const float (&v)[8]) {
  if constexpr (VEC && sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = from_f<T>(v[e]);
  }
}

template <typename T, bool SMAJOR, bool VEC>
__global__ void __launch_bounds__(1024) kv_rows_kernel(const KvRowArgs a) {
  constexpr bool FMA = !SMAJOR;   // K10's k rotary as jitted XLA fuses it; K2's products apart
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int lanes = 1 << a.lg;
  const int hh = c >> a.lg, j = c & (lanes - 1);
  const bool live = hh < a.Hq + 2 * a.Hkv;
  const int kind = hh < a.Hq ? 0 : (hh < a.Hq + a.Hkv ? 1 : 2);   // q, k, v
  const int h = hh - (kind == 0 ? 0 : (kind == 1 ? a.Hq : a.Hq + a.Hkv));
  const bool rot = a.rotary != 0 && kind < 2;
  float x[8], cs[8], sn[8];
  int p = 0;
  if (live) {
    const void* base = kind == 0 ? a.q : (kind == 1 ? a.k : a.v);
    const long long sb = kind == 0 ? a.q_sb : (kind == 1 ? a.k_sb : a.v_sb);
    const long long sh = kind == 0 ? a.q_sh : (kind == 1 ? a.k_sh : a.v_sh);
    kv_load8<T, VEC>(static_cast<const T*>(base) + b * sb + h * sh + 8 * j, x);
    if (rot) {
      const size_t t = (size_t)b * a.t_sb + 8 * j;
      kv_load8<float, VEC>(a.cos_t + t, cs);
      kv_load8<float, VEC>(a.sin_t + t, sn);
    }
    if (kind != 0) p = __ldg(a.pos + (size_t)b * a.pos_sb);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.0f;
  }
  // the rotary partner of value d is d ± D/2: lanes/2 lanes away in the same
  // warp.  Every lane shuffles (a head never straddles a warp; a dead head
  // is whole), whatever its kind.
  const bool lo = j < (lanes >> 1);
  float pr[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float y = __shfl_xor_sync(0xffffffffu, x[e], lanes >> 1);
    pr[e] = lo ? -y : y;
  }
  if (rot) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (kind == 0) {
        if constexpr (sizeof(T) == 2) {   // apply_rotary in bf16: x·cos + rot(x)·sin
          const float c_t = round_to<T>(cs[e]), s_t = round_to<T>(sn[e]);
          x[e] = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x[e], c_t)),
                                       round_to<T>(__fmul_rn(pr[e], s_t))));
        } else {
          x[e] = __fmaf_rn(x[e], cs[e], __fmul_rn(pr[e], sn[e]));
        }
      } else {
        const float ps = __fmul_rn(pr[e], sn[e]);
        x[e] = FMA ? __fmaf_rn(x[e], cs[e], ps) : __fadd_rn(__fmul_rn(x[e], cs[e]), ps);
      }
    }
  }
  float m = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(x[e]));
  for (int o = lanes >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (!live) return;
  if (kind == 0) {
    kv_store8<T, VEC>(static_cast<T*>(a.q_out) + ((size_t)b * a.Hq + h) * a.D + 8 * j, x);
    return;
  }
  p = p < 0 ? 0 : (p > a.S - 1 ? a.S - 1 : p);
  const float scale = fmaxf(m, 1e-8f) * (1.0f / 127.0f);
  float qv[8];
  if (scale >= AR_DIV_LO && scale <= AR_DIV_HI) {
    const float r1 = ar_rcp(scale);
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[e] = ar_div(x[e], scale, r1);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[e] = x[e] / scale;
  }
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    packed[e >> 2] |= ((uint32_t)(int)rintf(qv[e]) & 0xffu) << (8 * (e & 3));
  const size_t sc = ((size_t)b * a.Hkv + h) * a.S + p;
  const size_t row = SMAJOR ? (((size_t)b * a.S + p) * a.Hkv + h) * a.D : sc * a.D;
  int8_t* dst = (kind == 1 ? a.kq : a.vq) + row + 8 * j;
  if constexpr (VEC) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = (int8_t)(packed[e >> 2] >> (8 * (e & 3)));
  }
  if (j == 0) (kind == 1 ? a.ks : a.vs)[sc] = scale;
}

// The C entries of K2 (attn_smajor.cu) and K10 (cache_write.cu): q may be
// null (no q rotated: Hq 0); the tables may be null with rotary off.
template <bool SMAJOR>
inline int kv_rows_entry(const void* q, const void* k, const void* v, const void* cos_t,
                         const void* sin_t, const void* pos, void* q_out, void* kq, void* vq,
                         void* ks, void* vs, long long q_sb, long long q_sh, long long k_sb,
                         long long k_sh, long long v_sb, long long v_sh, int t_sb, int pos_sb,
                         int B, int S, int Hq, int Hkv, int D, int rotary, int vec, int threads,
                         int x_dt, cudaStream_t st) {
  int lg = 0;
  while ((8 << lg) < D) ++lg;
  if (D < 16 || D > 256 || (8 << lg) != D || threads < 32 || threads > 1024 || threads % 32 ||
      B < 1 || B > 65535 || Hkv < 1 || Hq < 0 || S < 1 || (Hq > 0 && !q_out) ||
      (rotary && (!cos_t || !sin_t)))
    return (int)cudaErrorInvalidValue;
  KvRowArgs a;
  a.q = q, a.k = k, a.v = v;
  a.cos_t = (const float*)cos_t, a.sin_t = (const float*)sin_t, a.pos = (const int*)pos;
  a.q_out = q_out, a.kq = (int8_t*)kq, a.vq = (int8_t*)vq, a.ks = (float*)ks, a.vs = (float*)vs;
  a.q_sb = q_sb, a.q_sh = q_sh, a.k_sb = k_sb, a.k_sh = k_sh, a.v_sb = v_sb, a.v_sh = v_sh;
  a.t_sb = t_sb, a.pos_sb = pos_sb;
  a.S = S, a.Hq = Hq, a.Hkv = Hkv, a.D = D, a.lg = lg, a.rotary = rotary;
  const int chunks = (Hq + 2 * Hkv) << lg;
  const dim3 grid((chunks + threads - 1) / threads, B);
  using bf16 = __nv_bfloat16;
  if (x_dt == DT_BF16) {
    if (vec) kv_rows_kernel<bf16, SMAJOR, true><<<grid, threads, 0, st>>>(a);
    else kv_rows_kernel<bf16, SMAJOR, false><<<grid, threads, 0, st>>>(a);
  } else {
    if (vec) kv_rows_kernel<float, SMAJOR, true><<<grid, threads, 0, st>>>(a);
    else kv_rows_kernel<float, SMAJOR, false><<<grid, threads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
