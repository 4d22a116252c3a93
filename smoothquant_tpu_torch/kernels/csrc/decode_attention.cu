// Single-query decode attention over a head-major KV cache (K11).
//
// Replaces smoothquant_tpu/kernels/decode_attention.py
// decode_attention_stacked (pallas_call at :306; the per-layer wrapper
// decode_attention at :351 runs the same kernel).  Cache layout as the JAX
// package: k/v (B, H_kv, S, D) in the query's dtype (bf16 / f32), or int8
// with (B, H_kv, S) f32 scales; the wrapper passes pointers already offset
// to one layer.  A
// (B, S) additive bias carries validity.  The ALiBi body (Bloom; the JAX
// kernel's _alibi_row, :133-139): with (H,) f32 slopes given (MHA only), the
// score of position s gains slope_h·s after the k_scale product and before
// the bias, in f32 with each operation rounded as the TPU kernel rounds it.
//
// Bound: the bytes of the cache positions the bias leaves unmasked (each
// adds exactly 0 otherwise), ~2·S·D bytes per (b, kv head) for bf16.  One
// block of 16 warps per (b, kv head) runs the three phases of
// flash_decode.cuh (shared with K12): the scores, the TPU kernel's online
// softmax tile by tile, then p·v; the 16 partials are added in warp order
// and divided by l (1 where l == 0: a fully masked row gives 0).  This
// flash body takes only f32 queries and head_dim 256 on the paths; bf16
// queries at head_dim 64 / 128 take the split-S cluster body of
// split_decode.cuh (sq_decode_attn_split), the Python shape rule
// decode_attention.attn_body choosing.
#include "flash_decode.cuh"
#include "split_decode.cuh"

namespace {

// TQ: query / output dtype; TC: cache dtype (int8 when QUANT); TV: the
// dtype p is rounded to before PV; head_dim = 32·DPL
template <typename TQ, typename TC, typename TV, bool QUANT, int DPL>
__global__ void __launch_bounds__(FLASH_THREADS)
decode_attn_kernel(const TQ* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const float* __restrict__ bias, const float* __restrict__ slopes,
                   TQ* __restrict__ out, int H, int Hkv, int S, int ts, float sm_scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  const int rep = H / Hkv;
  float* sc = smem;                              // (rep, S) scores, then rounded p
  float* part = sc + rep * S;                    // (WARPS, rep, D) PV partials
  float* alpha = part + FLASH_WARPS * rep * D;   // (rep, n_tiles) tile rescale factors
  __shared__ float scratch[32];
  __shared__ float m_run[FLASH_MAX_REP], l_run[FLASH_MAX_REP];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const size_t head = (size_t)b * Hkv + kvh;
  const float* ks_row = QUANT ? ks + head * S : nullptr;
  const float* vs_row = QUANT ? vs + head * S : nullptr;
  const float* bias_row = bias + (size_t)b * S;
  auto bias_at = [bias_row](int s) { return bias_row[s]; };

  float qv[FLASH_MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < FLASH_MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      qv[r][t] = r < rep ? to_f<TQ>(q[((size_t)b * H + kvh * rep + r) * D + lane * DPL + t])
                         : 0.0f;

  flash_scores<TC, QUANT, DPL>(qv, k + head * S * D + lane * DPL, ks_row, bias_at, sc, rep, S,
                               sm_scale, slopes != nullptr,
                               slopes != nullptr ? slopes[kvh] : 0.0f);
  __syncthreads();
  flash_softmax<TV, QUANT>(sc, vs_row, alpha, m_run, l_run, rep, S, ts, scratch);
  __syncthreads();
  flash_pv<TC, DPL>(sc, alpha, nullptr, v + head * S * D + lane * DPL, bias_at, part, rep, S,
                    ts);
  __syncthreads();
  for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    float sum = 0.0f;
    for (int w = 0; w < FLASH_WARPS; ++w) sum += part[(w * rep + r) * D + d];
    const float denom = l_run[r] > 0.0f ? l_run[r] : 1.0f;
    out[((size_t)b * H + kvh * rep + r) * D + d] = from_f<TQ>(sum / denom);
  }
}

template <typename TQ, typename TC, typename TV, bool QUANT, int DPL>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bias, const void* slopes, void* out, int B, int H, int Hkv, int S, int ts,
           float sm_scale, cudaStream_t st) {
  const size_t smem = flash_smem_bytes(H / Hkv, S, 32 * DPL, ts);
  auto kern = decode_attn_kernel<TQ, TC, TV, QUANT, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, Hkv), FLASH_THREADS, smem, st>>>((const TQ*)q, (const TC*)k, (const TC*)v,
                                           (const float*)ks, (const float*)vs, (const float*)bias,
                                           (const float*)slopes, (TQ*)out, H, Hkv, S, ts,
                                           sm_scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, typename TV, bool QUANT>
int by_dim(int D, const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bias, const void* slopes, void* out, int B, int H, int Hkv, int S, int ts,
           float sm_scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<TQ, TC, TV, QUANT, 2>(q, k, v, ks, vs, bias, slopes, out, B, H, Hkv, S,
                                          ts, sm_scale, st);
    case 128:
      return launch<TQ, TC, TV, QUANT, 4>(q, k, v, ks, vs, bias, slopes, out, B, H, Hkv, S,
                                          ts, sm_scale, st);
    case 256:
      return launch<TQ, TC, TV, QUANT, 8>(q, k, v, ks, vs, bias, slopes, out, B, H, Hkv, S,
                                          ts, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K11: one layer of single-query attention over a head-major cache.
// q_dt: 0 float32, 1 bfloat16; an fp cache holds q's dtype; with quant the
// cache is int8 and ks / vs are its (B, H_kv, S) scales; slopes, when not
// null, the (H,) ALiBi slopes (H == H_kv).
SQ_EXPORT int sq_decode_attn(const void* q, const void* k, const void* v, const void* ks,
                             const void* vs, const void* bias, const void* slopes, void* out,
                             int B, int H, int Hkv, int S, int D, int ts, float sm_scale, int q_dt,
                             int quant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!flash_shape_ok(H, Hkv, S, ts) || (slopes != nullptr && H != Hkv))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (quant && q_dt == DT_BF16)
    return by_dim<bf16, int8_t, bf16, true>(D, q, k, v, ks, vs, bias, slopes, out, B, H, Hkv, S,
                                            ts, sm_scale, st);
  if (quant)
    return by_dim<float, int8_t, bf16, true>(D, q, k, v, ks, vs, bias, slopes, out, B, H, Hkv, S,
                                             ts, sm_scale, st);
  if (q_dt == DT_BF16)
    return by_dim<bf16, bf16, bf16, false>(D, q, k, v, ks, vs, bias, slopes, out, B, H, Hkv, S,
                                           ts, sm_scale, st);
  return by_dim<float, float, float, false>(D, q, k, v, ks, vs, bias, slopes, out, B, H, Hkv, S,
                                            ts, sm_scale, st);
}

// K11's split-S body (split_decode.cuh): bf16 q (B, H, D), D 64 or 128; a
// bf16 cache, or int8 (quant) with its (B, H_kv, S) f32 scales; slopes as
// above; S split over (1 << lsplit) cluster ranks of S >> lsplit positions,
// softmax tiles of ts positions.
SQ_EXPORT int sq_decode_attn_split(const void* q, const void* k, const void* v, const void* ks,
                                   const void* vs, const void* bias, const void* slopes,
                                   void* out, int B, int H, int Hkv, int S, int D, int ts,
                                   int lsplit, float sm_scale, int quant, void* stream) {
  int lts = 0;
  while ((1 << lts) < ts) ++lts;
  const int chunk = S >> lsplit;
  if (B < 1 || Hkv < 1 || H % Hkv || H / Hkv > 8 || (slopes != nullptr && H != Hkv) ||
      lsplit < 0 || lsplit > 3 || (1 << lts) != ts || S % ts || S / ts > SD_MAX_TILES ||
      (chunk << lsplit) != S || chunk % 16 || chunk > SD_MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  SdArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = k;
  a.v = v;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.bias = (const float*)bias;
  a.slopes = (const float*)slopes;
  a.out = (__nv_bfloat16*)out;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.rep = H / Hkv;
  a.chunk = chunk;
  a.lsplit = lsplit;
  a.lts = lts;
  a.n_tiles = S / ts;
  a.sm_scale = sm_scale;
  cudaStream_t st = (cudaStream_t)stream;
  return quant ? sd_by_dim<int8_t, true>(D, a, B, st)
               : sd_by_dim<__nv_bfloat16, false>(D, a, B, st);
}
