// Single-query flash decode over one (slot, kv head) of a cache: the device
// code K11 (decode_attention.cu), K12 (attn_fused.cu) and K3 (attn_smajor.cu)
// share, for the shapes their split-S bodies (split_decode.cuh) do not take.
// One block of WARPS warps serves the rep = H / H_kv query heads of its kv
// head, so every cache byte is read once; above FLASH_MAX_REP query heads a
// kv head (Falcon-7B's 71 over one; K11, K3 and K12) the rows split into groups
// of FLASH_MAX_REP, a block each (grid z), so registers and shared memory
// stay those of rep 8 and the groups re-read the rows; a lane holds DPL consecutive
// elements of a row (a warp reads a row whole).  A head's rows lie `stride`
// elements apart: D in a head-major cache (B, H_kv, S, D), H_kv·D in the
// S-major one (B, S, H_kv·D).  A position
// whose additive bias is at or below SKIP_AT is neither loaded nor
// multiplied: its probability is exactly 0 either way.  The phases:
//   flash_scores    scores = (q·k)·sm_scale [·k_scale] [+ slope·s] + bias in
//                   f32 (slope·s: K11's ALiBi term at the key's absolute
//                   position s, MHA only), one warp per position, UNROLL
//                   rows loaded before any is used, kept in shared memory
//                   (rep·S floats);
//   flash_softmax   the TPU kernel's online softmax over tiles of ts
//                   positions, reproduced tile by tile: running max guarded
//                   at NEG_INF/2, the rescale α = exp(m_prev − m_safe),
//                   l = l·α + Σp, and p [·v_scale] rounded to the value
//                   dtype TV before PV, as the TPU kernel rounds it;
//   flash_pv        each warp sums p·v over its positions tile by tile
//                   (rescaling by α between tiles) into a (rep, D) partial;
//                   the caller adds the WARPS partials in warp order.
#pragma once

#include "common.cuh"

namespace {

constexpr float FLASH_NEG_INF = -1e30f;
constexpr float FLASH_SKIP_AT = -1e29f;  // bias at or below: the position contributes 0
constexpr int FLASH_WARPS = 16;
constexpr int FLASH_THREADS = 32 * FLASH_WARPS;
constexpr int FLASH_UNROLL = 4;
constexpr int FLASH_MAX_REP = 8;
constexpr int FLASH_MAX_TILES = 64;

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

// Phase 1.  qv: the lane's slice of the rep query rows (f32 values of the
// query dtype); k_base: the head's row 0 plus the lane's offset, rows
// `stride` elements apart; bias(s):
// the additive bias of position s; sc: (rep, S) scores; with alibi, the
// head's slope times the position is added before the bias (rep = 1).
template <typename TC, bool QUANT, int DPL, typename Bias>
__device__ __forceinline__ void flash_scores(const float (&qv)[FLASH_MAX_REP][DPL],
                                             const TC* __restrict__ k_base, size_t stride,
                                             const float* __restrict__ ks_row, Bias bias,
                                             float* sc, int rep, int S, float sm_scale,
                                             bool alibi = false, float slope = 0.0f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s0 = warp; s0 < S; s0 += FLASH_WARPS * FLASH_UNROLL) {
    float kr[FLASH_UNROLL][DPL];
    float bs[FLASH_UNROLL];
#pragma unroll
    for (int u = 0; u < FLASH_UNROLL; ++u) {
      const int s = s0 + u * FLASH_WARPS;
      bs[u] = s < S ? bias(s) : FLASH_NEG_INF;
      if (bs[u] > FLASH_SKIP_AT) {
        load_vals<TC, DPL>(k_base + (size_t)s * stride, kr[u]);
      } else {
#pragma unroll
        for (int t = 0; t < DPL; ++t) kr[u][t] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < FLASH_UNROLL; ++u) {
      const int s = s0 + u * FLASH_WARPS;
      if (s >= S) break;
      const float k_scale = QUANT && bs[u] > FLASH_SKIP_AT ? ks_row[s] : 1.0f;
#pragma unroll
      for (int r = 0; r < FLASH_MAX_REP; ++r) {
        if (r >= rep) break;
        if (bs[u] <= FLASH_SKIP_AT) {
          if (lane == 0) sc[r * S + s] = bs[u];
          continue;
        }
        float dot = 0.0f;
#pragma unroll
        for (int t = 0; t < DPL; ++t) dot = fmaf(qv[r][t], kr[u][t], dot);
        dot = warp_sum(dot);
        float x = __fmul_rn(dot, sm_scale);
        if (QUANT) x = __fmul_rn(x, k_scale);
        if (alibi) x = __fadd_rn(x, __fmul_rn(slope, (float)s));
        if (lane == 0) sc[r * S + s] = __fadd_rn(x, bs[u]);
      }
    }
  }
}

// Phase 2, after a __syncthreads: rewrites sc as the rounded p, alpha (rep,
// n_tiles) as each tile's rescale, and the running max and sum of each row
// into m_out / l_out (thread 0 writes them).
template <typename TV, bool QUANT>
__device__ __forceinline__ void flash_softmax(float* sc, const float* __restrict__ vs_row,
                                              float* alpha, float* m_out, float* l_out,
                                              int rep, int S, int ts, float* scratch) {
  const int n_tiles = S / ts;
  for (int r = 0; r < rep; ++r) {
    float m_run = 0.0f, l_run = 0.0f;
    for (int t = 0; t < n_tiles; ++t) {
      float* row = sc + r * S + t * ts;
      float m = -INFINITY;
      for (int s = threadIdx.x; s < ts; s += blockDim.x) m = fmaxf(m, row[s]);
      m = block_reduce<true>(m, scratch);
      const float m_new = t == 0 ? m : fmaxf(m_run, m);
      const float m_safe = fmaxf(m_new, FLASH_NEG_INF / 2);
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
    if (threadIdx.x == 0) {
      m_out[r] = m_run;
      l_out[r] = l_run;
    }
  }
}

// Phase 3, after a __syncthreads: the warp's p·v partial (rep, D) into
// part[warp], each row scaled by post[r] at the end when post is given.
template <typename TC, int DPL, typename Bias>
__device__ __forceinline__ void flash_pv(const float* sc, const float* alpha,
                                         const float* post, const TC* __restrict__ v_base,
                                         size_t stride, Bias bias, float* part, int rep, int S,
                                         int ts) {
  constexpr int D = 32 * DPL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = S / ts;
  float acc[FLASH_MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < FLASH_MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
#pragma unroll
      for (int r = 0; r < FLASH_MAX_REP; ++r) {
        if (r >= rep) break;
        const float a = alpha[r * n_tiles + t];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] *= a;
      }
    }
    const int s_end = (t + 1) * ts;
    for (int s0 = t * ts + warp; s0 < s_end; s0 += FLASH_WARPS * FLASH_UNROLL) {
      float vr[FLASH_UNROLL][DPL];
      bool live[FLASH_UNROLL];
#pragma unroll
      for (int u = 0; u < FLASH_UNROLL; ++u) {
        const int s = s0 + u * FLASH_WARPS;
        live[u] = s < s_end && bias(s) > FLASH_SKIP_AT;
        if (live[u]) {
          load_vals<TC, DPL>(v_base + (size_t)s * stride, vr[u]);
        } else {
#pragma unroll
          for (int d = 0; d < DPL; ++d) vr[u][d] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < FLASH_UNROLL; ++u) {
        if (!live[u]) continue;
        const int s = s0 + u * FLASH_WARPS;
#pragma unroll
        for (int r = 0; r < FLASH_MAX_REP; ++r) {
          if (r >= rep) break;
          const float p = sc[r * S + s];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(p, vr[u][d], acc[r][d]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FLASH_MAX_REP; ++r) {
    if (r >= rep) break;
    const float a = post != nullptr ? post[r] : 1.0f;
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      part[(warp * rep + r) * D + lane * DPL + d] = post != nullptr ? acc[r][d] * a : acc[r][d];
  }
}

// Shared memory of the three phases: (rep, S) scores, (WARPS, rep, D)
// partials, (rep, n_tiles) rescales.
inline size_t flash_smem_bytes(int rep, int S, int D, int ts) {
  return ((size_t)rep * S + (size_t)FLASH_WARPS * rep * D + (size_t)rep * (S / ts)) *
         sizeof(float);
}

inline bool flash_shape_ok(int H, int Hkv, int S, int ts) {
  return !(H % Hkv || ts < FLASH_WARPS * FLASH_UNROLL ||
           ts % (FLASH_WARPS * FLASH_UNROLL) || S % ts || S / ts > FLASH_MAX_TILES);
}

// The flash body of K11 and K3: one block a (slot, kv head), the three
// phases, the WARPS partials added in warp order and divided by l (1 where
// l == 0: a fully masked row gives 0).  TQ: query / output dtype; TC: cache
// dtype (int8 when QUANT); TV: the dtype p is rounded to before PV; head_dim
// = 32·DPL; SMAJOR: the S-major layout (rows H_kv·D apart), else head-major.
// slopes, when not null, the (H,) ALiBi slopes (H == H_kv).  Grid (B, H_kv,
// ⌈rep / FLASH_MAX_REP⌉): block z serves the kv head's query rows
// [z·FLASH_MAX_REP, min(rep, (z + 1)·FLASH_MAX_REP)).
template <typename TQ, typename TC, typename TV, bool QUANT, int DPL, bool SMAJOR>
__global__ void __launch_bounds__(FLASH_THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const float* __restrict__ bias, const float* __restrict__ slopes,
                    TQ* __restrict__ out, int H, int Hkv, int S, int ts, float sm_scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  const int rep_all = H / Hkv;
  const int r0 = blockIdx.z * FLASH_MAX_REP;      // the group's first query row
  const int rep = min(rep_all - r0, FLASH_MAX_REP);
  float* sc = smem;                              // (rep, S) scores, then rounded p
  float* part = sc + rep * S;                    // (WARPS, rep, D) PV partials
  float* alpha = part + FLASH_WARPS * rep * D;   // (rep, n_tiles) tile rescale factors
  __shared__ float scratch[32];
  __shared__ float m_run[FLASH_MAX_REP], l_run[FLASH_MAX_REP];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const size_t head = (size_t)b * Hkv + kvh;
  const size_t stride = SMAJOR ? (size_t)Hkv * D : D;
  const size_t row0 = (SMAJOR ? (size_t)b * S * Hkv * D + (size_t)kvh * D : head * S * D) +
                      lane * DPL;
  const float* ks_row = QUANT ? ks + head * S : nullptr;
  const float* vs_row = QUANT ? vs + head * S : nullptr;
  const float* bias_row = bias + (size_t)b * S;
  auto bias_at = [bias_row](int s) { return bias_row[s]; };

  float qv[FLASH_MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < FLASH_MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      qv[r][t] = r < rep ? to_f<TQ>(q[((size_t)b * H + kvh * rep_all + r0 + r) * D + lane * DPL + t])
                         : 0.0f;

  flash_scores<TC, QUANT, DPL>(qv, k + row0, stride, ks_row, bias_at, sc, rep, S, sm_scale,
                               slopes != nullptr, slopes != nullptr ? slopes[kvh] : 0.0f);
  __syncthreads();
  flash_softmax<TV, QUANT>(sc, vs_row, alpha, m_run, l_run, rep, S, ts, scratch);
  __syncthreads();
  flash_pv<TC, DPL>(sc, alpha, nullptr, v + row0, stride, bias_at, part, rep, S, ts);
  __syncthreads();
  for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    float sum = 0.0f;
    for (int w = 0; w < FLASH_WARPS; ++w) sum += part[(w * rep + r) * D + d];
    const float denom = l_run[r] > 0.0f ? l_run[r] : 1.0f;
    out[((size_t)b * H + kvh * rep_all + r0 + r) * D + d] = from_f<TQ>(sum / denom);
  }
}

template <typename TQ, typename TC, typename TV, bool QUANT, int DPL, bool SMAJOR>
int flash_decode_launch(const void* q, const void* k, const void* v, const void* ks,
                        const void* vs, const void* bias, const void* slopes, void* out, int B,
                        int H, int Hkv, int S, int ts, float sm_scale, cudaStream_t st) {
  const int rep = H / Hkv, groups = (rep + FLASH_MAX_REP - 1) / FLASH_MAX_REP;
  const size_t smem = flash_smem_bytes(rep < FLASH_MAX_REP ? rep : FLASH_MAX_REP, S, 32 * DPL, ts);
  auto kern = flash_decode_kernel<TQ, TC, TV, QUANT, DPL, SMAJOR>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, Hkv, groups), FLASH_THREADS, smem, st>>>((const TQ*)q, (const TC*)k, (const TC*)v,
                                           (const float*)ks, (const float*)vs, (const float*)bias,
                                           (const float*)slopes, (TQ*)out, H, Hkv, S, ts,
                                           sm_scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, typename TV, bool QUANT, bool SMAJOR>
int flash_decode_by_dim(int D, const void* q, const void* k, const void* v, const void* ks,
                        const void* vs, const void* bias, const void* slopes, void* out, int B,
                        int H, int Hkv, int S, int ts, float sm_scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return flash_decode_launch<TQ, TC, TV, QUANT, 2, SMAJOR>(q, k, v, ks, vs, bias, slopes,
                                                               out, B, H, Hkv, S, ts, sm_scale,
                                                               st);
    case 128:
      return flash_decode_launch<TQ, TC, TV, QUANT, 4, SMAJOR>(q, k, v, ks, vs, bias, slopes,
                                                               out, B, H, Hkv, S, ts, sm_scale,
                                                               st);
    case 256:
      return flash_decode_launch<TQ, TC, TV, QUANT, 8, SMAJOR>(q, k, v, ks, vs, bias, slopes,
                                                               out, B, H, Hkv, S, ts, sm_scale,
                                                               st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
