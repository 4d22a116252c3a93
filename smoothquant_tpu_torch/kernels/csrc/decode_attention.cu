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
// and divided by l (1 where l == 0: a fully masked row gives 0); the kernel,
// flash_decode_kernel, is K3's flash body too.  This flash body takes only
// f32 queries and head_dim 256 on the paths; bf16 queries at head_dim 64 /
// 128 take the split-S cluster body of split_decode.cuh
// (sq_decode_attn_split, mode SD_HM_BIAS), the Python shape rule
// decode_attention.attn_body choosing.
#include "flash_decode.cuh"
#include "split_decode.cuh"

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
    return flash_decode_by_dim<bf16, int8_t, bf16, true, false>(D, q, k, v, ks, vs, bias, slopes,
                                                                out, B, H, Hkv, S, ts, sm_scale,
                                                                st);
  if (quant)
    return flash_decode_by_dim<float, int8_t, bf16, true, false>(D, q, k, v, ks, vs, bias, slopes,
                                                                 out, B, H, Hkv, S, ts, sm_scale,
                                                                 st);
  if (q_dt == DT_BF16)
    return flash_decode_by_dim<bf16, bf16, bf16, false, false>(D, q, k, v, ks, vs, bias, slopes,
                                                               out, B, H, Hkv, S, ts, sm_scale,
                                                               st);
  return flash_decode_by_dim<float, float, float, false, false>(D, q, k, v, ks, vs, bias, slopes,
                                                                out, B, H, Hkv, S, ts, sm_scale,
                                                                st);
}

// K11's split-S body (split_decode.cuh): bf16 q (B, H, D), D 64 or 128; a
// bf16 cache, or int8 (quant) with its (B, H_kv, S) f32 scales; slopes as
// above; S split over (1 << lsplit) cluster ranks of S >> lsplit positions,
// softmax tiles of ts positions.
SQ_EXPORT int sq_decode_attn_split(const void* q, const void* k, const void* v, const void* ks,
                                   const void* vs, const void* bias, const void* slopes,
                                   void* out, int B, int H, int Hkv, int S, int D, int ts,
                                   int lsplit, float sm_scale, int quant, void* stream) {
  SdArgs a = {};
  if (!sd_plan(a, B, H, Hkv, S, ts, lsplit) || (slopes != nullptr && H != Hkv))
    return (int)cudaErrorInvalidValue;
  a.q = (const __nv_bfloat16*)q;
  a.k = k;
  a.v = v;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.bias = (const float*)bias;
  a.slopes = (const float*)slopes;
  a.out = (__nv_bfloat16*)out;
  a.sm_scale = sm_scale;
  const SdMaps maps = {};
  cudaStream_t st = (cudaStream_t)stream;
  return quant ? sd_by_dim<int8_t, true, SD_HM_BIAS>(D, a, maps, B, st)
               : sd_by_dim<__nv_bfloat16, false, SD_HM_BIAS>(D, a, maps, B, st);
}
