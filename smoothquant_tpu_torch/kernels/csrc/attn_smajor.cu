// S-major int8 KV cache kernels for Hopper: the decode cache writer (K2)
// and single-query decode attention (K3).
//
// Cache layout (as the JAX package): values (L, B, S, H_kv*D) int8 — one
// row holds every kv head's vector for one position — and scales
// (L, B, H_kv, S) f32.  The wrappers pass pointers already offset to one
// layer.
//
// K2 replaces smoothquant_tpu/kernels/attn_smajor.py
// write_quant_cache_smajor (pallas_call at :340).  It moves a few KB per
// call (B·H_kv·D values in, the same count of int8 bytes out), so launch
// latency, not bytes or operations, bounds it.  A block per batch row and
// 8 kv heads, a warp per head (k, then v): warp_quantize_kv (kv_quant.cuh,
// shared with K10) with the rounded rotary products kept apart, as the
// Pallas body rounds them, and an IN-PLACE write of row min(pos[b], S-1) — the
// position is read from a device tensor and clamped on the device, because
// the batcher keeps advancing dead slots past the cache length.  That
// one-warp-a-head body stays as the wrapper's body="warps"; every call the
// wrapper's shape rule takes goes to the row body K10 shares
// (kv_quant.cuh kv_rows_kernel): q, k and v read where the qkv linear left
// them, q's rotary in the same launch, a row in registers.
//
// K3 replaces decode_attention_smajor_stacked (pallas_call at :213).  At
// decode it reads the k / v rows of the positions the bias leaves unmasked
// (and their scales) for 4·B·H·n_valid·D flops, so those bytes bound it.  It
// follows the TPU kernel's online softmax over tiles of _pick_tile_s(S)
// positions: p is formed against the running max of its tile and p·v_scale
// is rounded to bf16 there.  Two bodies, picked by a Python shape rule
// (attn_smajor.smajor_body), each a mode of a body K11 shares:
//   split  bf16 queries at head_dim 64 / 128: split_decode.cuh in mode
//          SD_SM_BIAS — S split over a cluster of 1-8 CTAs a (slot, kv
//          head), bias and scales staged by bulk copies, only the stages of
//          the unmasked range [lo, hi] streamed.  One head's rows are D bytes
//          every H_kv·D bytes (128 B every 4 KB for Llama), so a stage of 32
//          positions is one 2-D TMA box (D bytes × 32 rows) over the layer
//          viewed as a (B·S, H_kv·D) byte matrix; the two tensor maps are
//          encoded per call on the host (the layer's base moves);
//   flash  f32 queries and head_dim 256: flash_decode.cuh's block a (slot,
//          kv head) with rows H_kv·D apart, masked rows never loaded.
// Any GQA rep (the JAX kernel takes multiples of 8 above 8): above 8 query
// rows a kv head both bodies run the rows in groups of 8 as grid z (a
// cluster or block each), each group reading the kv head's rows again
// (from the L2 after the first), as K11 does; a rep of 8 or less is one
// group, the bodies and bits of before.  The softmax scale is the
// caller's (default 1/√D).
#include "flash_decode.cuh"
#include "split_decode.cuh"   // (includes kv_quant.cuh)

namespace {

template <typename T>
__global__ void write_cache_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                                   const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t,
                                   const int* __restrict__ pos, int8_t* __restrict__ kq,
                                   int8_t* __restrict__ vq, float* __restrict__ ks,
                                   float* __restrict__ vs, int S, int H, int D, int rotary) {
  const int b = blockIdx.x;
  const int h = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (h >= H) return;
  int p = pos[b];
  p = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
  const size_t row = ((size_t)b * S + p) * H * D + (size_t)h * D;
  const size_t sc = ((size_t)b * H + h) * S + p;
  const size_t src = ((size_t)b * H + h) * D;
  // with rotary off the tables may be null: no row of them is formed or read
  warp_quantize_kv<T, false>(k_new + src, D, rotary != 0,
                             rotary ? cos_t + (size_t)b * D : nullptr,
                             rotary ? sin_t + (size_t)b * D : nullptr, kq + row, ks + sc);
  warp_quantize_kv<T, false>(v_new + src, D, false, nullptr, nullptr, vq + row, vs + sc);
}

}  // namespace

// K2: rotary-k + int8 quantize + in-place S-major row write at clamped pos.
SQ_EXPORT int sq_write_cache_smajor(const void* k_new, const void* v_new, const void* cos_t,
                                    const void* sin_t, const void* pos, void* kq, void* vq,
                                    void* ks, void* vs, int B, int S, int H, int D,
                                    int rotary, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D > 32 * KVQ_MAX_D_PER_LANE) return (int)cudaErrorInvalidValue;
  const int warps = H < 8 ? H : 8;
  const dim3 grid(B, (H + warps - 1) / warps);
  if (x_dt == DT_BF16)
    write_cache_kernel<__nv_bfloat16><<<grid, 32 * warps, 0, st>>>(
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const float*)cos_t,
        (const float*)sin_t, (const int*)pos, (int8_t*)kq, (int8_t*)vq, (float*)ks,
        (float*)vs, S, H, D, rotary);
  else
    write_cache_kernel<float><<<grid, 32 * warps, 0, st>>>(
        (const float*)k_new, (const float*)v_new, (const float*)cos_t, (const float*)sin_t,
        (const int*)pos, (int8_t*)kq, (int8_t*)vq, (float*)ks, (float*)vs, S, H, D, rotary);
  return (int)cudaGetLastError();
}

// K2's row body (kv_quant.cuh, S-major rows, k's rotary products kept
// apart): q / k / v read in place by their strides, q rotated into q_out
// when Hq > 0, rows written at each slot's clamped position.
SQ_EXPORT int sq_kv_rows_smajor(const void* q, const void* k, const void* v,
                                const void* cos_t, const void* sin_t, const void* pos,
                                void* q_out, void* kq, void* vq, void* ks, void* vs,
                                long long q_sb, long long q_sh, long long k_sb,
                                long long k_sh, long long v_sb, long long v_sh, int t_sb,
                                int pos_sb, int B, int S, int Hq, int Hkv, int D,
                                int rotary, int vec, int threads, int x_dt, void* stream) {
  return kv_rows_entry<true>(q, k, v, cos_t, sin_t, pos, q_out, kq, vq, ks, vs, q_sb,
                             q_sh, k_sb, k_sh, v_sb, v_sh, t_sb, pos_sb, B, S, Hq, Hkv, D,
                             rotary, vec, threads, x_dt, (cudaStream_t)stream);
}

// K3's flash body: single-query decode attention over one layer of the
// S-major cache; q_dt: 0 float32, 1 bfloat16 (q and out share it).
SQ_EXPORT int sq_decode_attn_smajor(const void* q, const void* kq, const void* vq,
                                    const void* ks, const void* vs, const void* bias,
                                    void* out, int B, int H, int Hkv, int S, int D, int ts,
                                    float sm_scale, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!flash_shape_ok(H, Hkv, S, ts)) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_dt == DT_BF16)
    return flash_decode_by_dim<bf16, int8_t, bf16, true, true>(
        D, q, kq, vq, ks, vs, bias, nullptr, out, B, H, Hkv, S, ts, sm_scale, st);
  return flash_decode_by_dim<float, int8_t, bf16, true, true>(
      D, q, kq, vq, ks, vs, bias, nullptr, out, B, H, Hkv, S, ts, sm_scale, st);
}

// K3's split body (split_decode.cuh, mode SD_SM_BIAS): bf16 q (B, H, D), D 64
// or 128, over the layer's int8 rows (B, S, H_kv·D) and (B, H_kv, S) f32
// scales; S split over (1 << lsplit) cluster ranks, softmax tiles of ts
// positions.
SQ_EXPORT int sq_decode_attn_smajor_split(const void* q, const void* kq, const void* vq,
                                          const void* ks, const void* vs, const void* bias,
                                          void* out, int B, int H, int Hkv, int S, int D, int ts,
                                          int lsplit, float sm_scale, void* stream) {
  SdArgs a = {};
  if ((D != 64 && D != 128) || !sd_plan(a, B, H, Hkv, S, ts, lsplit))
    return (int)cudaErrorInvalidValue;
  SdMaps maps;
  const uint64_t cols = (uint64_t)Hkv * D, rows = (uint64_t)B * S;
  if (!wg_map(&maps.k, kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, cols, rows, cols, D, SD_ROWS,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !wg_map(&maps.v, vq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, cols, rows, cols, D, SD_ROWS,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return (int)cudaErrorInvalidValue;
  a.q = (const __nv_bfloat16*)q;
  a.k = kq;
  a.v = vq;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.bias = (const float*)bias;
  a.out = (__nv_bfloat16*)out;
  a.sm_scale = sm_scale;
  return sd_by_dim<int8_t, true, SD_SM_BIAS>(D, a, maps, B, (cudaStream_t)stream);
}
