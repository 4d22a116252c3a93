// Single-query decode attention over a head-major KV cache (K11).
//
// Replaces smoothquant_tpu/kernels/decode_attention.py
// decode_attention_stacked (pallas_call at :306; the per-layer wrapper
// decode_attention at :351 runs the same kernel).  Cache layout as the JAX
// package: k/v (B, H_kv, S, D) in the query's dtype (bf16 / f32), or int8
// with (B, H_kv, S) f32 scales; the wrapper passes pointers already offset
// to one layer.  A
// (B, S) additive bias carries validity.
//
// Bound: the bytes of the cache positions the bias leaves unmasked (each
// adds exactly 0 otherwise), ~2·S·D bytes per (b, kv head) for bf16.  One
// block of 16 warps per (b, kv head) serves its rep = H/H_kv query heads,
// so every cache byte is read once; each warp keeps 4 rows in flight, a lane
// reading its D/32 consecutive elements (a warp reads a row whole), and a
// position whose bias is at or below NEG_INF/10 is neither loaded nor
// multiplied: its probability is exactly 0 either way.
//   phase 1  scores = (q·k)·sm_scale [·k_scale] + bias in f32, one warp per
//            position, kept in shared memory (rep·S floats);
//   phase 2  the TPU kernel's online softmax over tiles of ts positions,
//            reproduced tile by tile: running max guarded at NEG_INF/2, the
//            rescale α = exp(m_prev − m_safe), l = l·α + Σp, and p [·v_scale]
//            rounded to the value dtype (bf16 for the int8 cache), as the TPU
//            kernel rounds it before its PV dot;
//   phase 3  each warp sums p·v over its positions tile by tile (rescaling
//            by α between tiles), the 16 partials are added in warp order
//            and divided by l (1 where l == 0: a fully masked row gives 0).
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float SKIP_AT = -1e29f;  // bias at or below: the position contributes 0
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;
constexpr int MAX_REP = 8;
constexpr int MAX_TILES = 64;

// DPL consecutive elements of TC at p, as floats, in 16/8/4/2-byte loads
template <typename TC, int DPL>
__device__ __forceinline__ void load_vals(const TC* __restrict__ p, float (&f)[DPL]) {
  constexpr int BYTES = DPL * (int)sizeof(TC);
  static_assert(BYTES >= 2 && (BYTES & (BYTES - 1)) == 0, "row slice must be a power of two");
  alignas(16) unsigned char buf[BYTES];
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(buf)[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(buf) = __ldg(reinterpret_cast<const uint2*>(p));
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned int*>(buf) = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    *reinterpret_cast<unsigned short*>(buf) = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  const TC* e = reinterpret_cast<const TC*>(buf);
#pragma unroll
  for (int t = 0; t < DPL; ++t) f[t] = to_f<TC>(e[t]);
}

// TQ: query / output dtype; TC: cache dtype (int8 when QUANT); TV: the
// dtype p is rounded to before PV; head_dim = 32·DPL
template <typename TQ, typename TC, typename TV, bool QUANT, int DPL>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const TQ* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const float* __restrict__ bias, TQ* __restrict__ out, int H, int Hkv, int S,
                   int ts, float sm_scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  const int rep = H / Hkv;
  const int n_tiles = S / ts;
  float* sc = smem;                        // (rep, S) scores, then rounded p
  float* part = sc + rep * S;              // (WARPS, rep, D) PV partials
  float* alpha = part + WARPS * rep * D;   // (rep, n_tiles) tile rescale factors
  __shared__ float scratch[32];
  __shared__ float denom[MAX_REP];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t head = (size_t)b * Hkv + kvh;
  const TC* k_base = k + head * S * D + lane * DPL;
  const TC* v_base = v + head * S * D + lane * DPL;
  const float* ks_row = QUANT ? ks + head * S : nullptr;
  const float* vs_row = QUANT ? vs + head * S : nullptr;
  const float* bias_row = bias + (size_t)b * S;

  float qv[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      qv[r][t] = r < rep ? to_f<TQ>(q[((size_t)b * H + kvh * rep + r) * D + lane * DPL + t])
                         : 0.0f;

  // phase 1: warp w scores positions w, w + WARPS, ...; UNROLL rows are
  // loaded before any is used
  for (int s0 = warp; s0 < S; s0 += WARPS * UNROLL) {
    float kr[UNROLL][DPL];
    float bs[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * WARPS;
      bs[u] = s < S ? bias_row[s] : NEG_INF;
      if (bs[u] > SKIP_AT) {
        load_vals<TC, DPL>(k_base + (size_t)s * D, kr[u]);
      } else {
#pragma unroll
        for (int t = 0; t < DPL; ++t) kr[u][t] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * WARPS;
      if (s >= S) break;
      const float k_scale = QUANT && bs[u] > SKIP_AT ? ks_row[s] : 1.0f;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        if (bs[u] <= SKIP_AT) {
          if (lane == 0) sc[r * S + s] = bs[u];
          continue;
        }
        float dot = 0.0f;
#pragma unroll
        for (int t = 0; t < DPL; ++t) dot = fmaf(qv[r][t], kr[u][t], dot);
        dot = warp_sum(dot);
        float x = __fmul_rn(dot, sm_scale);
        if (QUANT) x = __fmul_rn(x, k_scale);
        if (lane == 0) sc[r * S + s] = __fadd_rn(x, bs[u]);
      }
    }
  }
  __syncthreads();

  // phase 2: the online softmax, one ts-wide tile at a time
  for (int r = 0; r < rep; ++r) {
    float m_run = 0.0f, l_run = 0.0f;
    for (int t = 0; t < n_tiles; ++t) {
      float* row = sc + r * S + t * ts;
      float m = -INFINITY;
      for (int s = threadIdx.x; s < ts; s += blockDim.x) m = fmaxf(m, row[s]);
      m = block_reduce<true>(m, scratch);
      const float m_new = t == 0 ? m : fmaxf(m_run, m);
      const float m_safe = fmaxf(m_new, NEG_INF / 2);
      const float a = t == 0 ? 0.0f : expf(m_run - m_safe);
      float l = 0.0f;
      for (int s = threadIdx.x; s < ts; s += blockDim.x) {
        const float p = expf(row[s] - m_safe);
        l += p;
        row[s] = round_to<TV>(QUANT ? p * vs_row[t * ts + s] : p);
      }
      l = block_reduce<false>(l, scratch);
      l_run = t == 0 ? l : __fadd_rn(__fmul_rn(l_run, a), l);
      m_run = m_new;
      if (threadIdx.x == 0) alpha[r * n_tiles + t] = a;
    }
    if (threadIdx.x == 0) denom[r] = l_run > 0.0f ? l_run : 1.0f;
  }
  __syncthreads();

  // phase 3: p·v per warp, tile by tile, then the warps' partials in order
  float acc[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        const float a = alpha[r * n_tiles + t];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] *= a;
      }
    }
    const int s_end = (t + 1) * ts;
    for (int s0 = t * ts + warp; s0 < s_end; s0 += WARPS * UNROLL) {
      float vr[UNROLL][DPL];
      bool live[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = s0 + u * WARPS;
        live[u] = s < s_end && bias_row[s] > SKIP_AT;
        if (live[u]) {
          load_vals<TC, DPL>(v_base + (size_t)s * D, vr[u]);
        } else {
#pragma unroll
          for (int d = 0; d < DPL; ++d) vr[u][d] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!live[u]) continue;
        const int s = s0 + u * WARPS;
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r >= rep) break;
          const float p = sc[r * S + s];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(p, vr[u][d], acc[r][d]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int d = 0; d < DPL; ++d) part[(warp * rep + r) * D + lane * DPL + d] = acc[r][d];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    float sum = 0.0f;
    for (int w = 0; w < WARPS; ++w) sum += part[(w * rep + r) * D + d];
    out[((size_t)b * H + kvh * rep + r) * D + d] = from_f<TQ>(sum / denom[r]);
  }
}

template <typename TQ, typename TC, typename TV, bool QUANT, int DPL>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bias, void* out, int B, int H, int Hkv, int S, int ts, float sm_scale,
           cudaStream_t st) {
  const int rep = H / Hkv;
  const size_t smem =
      ((size_t)rep * S + (size_t)WARPS * rep * 32 * DPL + (size_t)rep * (S / ts)) * sizeof(float);
  auto kern = decode_attn_kernel<TQ, TC, TV, QUANT, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, Hkv), THREADS, smem, st>>>((const TQ*)q, (const TC*)k, (const TC*)v,
                                           (const float*)ks, (const float*)vs, (const float*)bias,
                                           (TQ*)out, H, Hkv, S, ts, sm_scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, typename TV, bool QUANT>
int by_dim(int D, const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bias, void* out, int B, int H, int Hkv, int S, int ts, float sm_scale,
           cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<TQ, TC, TV, QUANT, 2>(q, k, v, ks, vs, bias, out, B, H, Hkv, S, ts, sm_scale,
                                          st);
    case 128:
      return launch<TQ, TC, TV, QUANT, 4>(q, k, v, ks, vs, bias, out, B, H, Hkv, S, ts, sm_scale,
                                          st);
    case 256:
      return launch<TQ, TC, TV, QUANT, 8>(q, k, v, ks, vs, bias, out, B, H, Hkv, S, ts, sm_scale,
                                          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K11: one layer of single-query attention over a head-major cache.
// q_dt: 0 float32, 1 bfloat16; an fp cache holds q's dtype; with quant the
// cache is int8 and ks / vs are its (B, H_kv, S) scales.
SQ_EXPORT int sq_decode_attn(const void* q, const void* k, const void* v, const void* ks,
                             const void* vs, const void* bias, void* out, int B, int H, int Hkv,
                             int S, int D, int ts, float sm_scale, int q_dt, int quant,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H % Hkv || H / Hkv > MAX_REP || ts < WARPS * UNROLL || ts % (WARPS * UNROLL) || S % ts ||
      S / ts > MAX_TILES)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (quant && q_dt == DT_BF16)
    return by_dim<bf16, int8_t, bf16, true>(D, q, k, v, ks, vs, bias, out, B, H, Hkv, S, ts,
                                            sm_scale, st);
  if (quant)
    return by_dim<float, int8_t, bf16, true>(D, q, k, v, ks, vs, bias, out, B, H, Hkv, S, ts,
                                             sm_scale, st);
  if (q_dt == DT_BF16)
    return by_dim<bf16, bf16, bf16, false>(D, q, k, v, ks, vs, bias, out, B, H, Hkv, S, ts,
                                           sm_scale, st);
  return by_dim<float, float, float, false>(D, q, k, v, ks, vs, bias, out, B, H, Hkv, S, ts,
                                            sm_scale, st);
}
