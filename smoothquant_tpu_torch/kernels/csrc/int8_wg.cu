// The main-path bodies of K4 (int8 prefill matmul) and K15a (static-scale
// int8 linear): both compute one full-depth int8 × int8 → int32 product with
// both operands K-major — K4's x codes (N, K) and its identity-int8 weight's
// (O, K) storage, K15a's x (N, K) and w (O, K) — and differ only in the
// epilogue.
//
// K4 replaces smoothquant_tpu/kernels/int8_prefill.py int8_prefill_matmul
// (pallas_call at :282), pre-quantized mode with bf16 salient operands or
// none (every promoted Llama site and the lm_head):
//     out[n,o] = fma(f32(acc)·s_x[n], s_w[o], Σ_s x_sal[n,s]·w_sal[s,o])
// on the warp-specialized s8 wgmma body (wg_s8_gemm.cuh).  f32 salient
// operands and the raw-x mode keep int8_prefill.cu's mma.sync tiles.
//
// K15a replaces smoothquant_tpu/kernels/int8.py int8_linear (pallas_call
// at :105): y = fma(f32(acc), α, bias), ReLU, f32 or int8 out, bit for bit
// the plain version's.  Above the stream rows the wgmma body; at 1-64 rows
// (the decode linears) the weight-streaming body's (O, K) int8 kind
// (stream_gmm.cuh stream_s8_kernel): there the weight's bytes bound the
// call, and the (O, K) rows go by TMA straight into mma.sync's A fragments,
// K split over a cluster as stream_gmm.split plans it.  K15b keeps
// int8.cu's bodies, K15a's old tile and GEMV kernels among them.
// The row split between the two K15a bodies is int8.STREAM_MAX_ROWS (Python).
#include "wg_s8_gemm.cuh"
#include "stream_gmm.cuh"

namespace {

// tile columns and ring slots: 128 × 128 tiles and five 32 KB slots where
// K4's salient accumulator leaves room for a 64 × 128 s32 one only, else
// 128 × 256 tiles and three 48 KB slots (the output chunks staged beside)
constexpr int SAL_BN = 128, SAL_STAGES = S8_STAGES;
constexpr int WIDE_BN = 256, WIDE_STAGES = 3;

}  // namespace

// K4 on the wgmma body: xq (N, K) int8, sx (N,) f32, w_ok (O, K) int8, sw
// (O,) f32, x_sal (N, ks) and w_sal (ks, O) bf16 (ks may be 0), out (N, O)
// bf16 / f32 (out_dt 1 / 0).  K and ks multiples of 16, O of 8, every
// pointer 16-byte aligned (TMA); `blocks`: the persistent grid (one an SM).
SQ_EXPORT int sq_int8_prefill_wg(const void* xq, const void* sx, const void* w_ok, const void* sw,
                                 const void* xsal, const void* wsal, void* out, int N, int K,
                                 int O, int ks, int out_dt, int blocks, void* stream) {
  if (N < 1 || K < 16 || K % 16 || O < 8 || O % 8 || ks < 0 || ks % 16 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  S8Args a = {};
  a.n_sal = (ks + S8_SAL_K - 1) / S8_SAL_K;
  a.n_s8 = (K + S8_KB - 1) / S8_KB;
  a.sx = (const float*)sx;
  a.sw = (const float*)sw;
  a.out = out;
  S8Maps m = {};
  if (ks == 0) {   // the lm_head: no salient stages, the wide tiles
    if (!s8_plan<WIDE_BN>(a, N, O) || !s8_maps<WIDE_BN>(m, xq, w_ok, N, K, O))
      return (int)cudaErrorInvalidValue;
    return out_dt == DT_BF16
               ? s8_launch<WIDE_BN, WIDE_STAGES, false, S8_K4, __nv_bfloat16>(a, m, blocks, st)
               : s8_launch<WIDE_BN, WIDE_STAGES, false, S8_K4, float>(a, m, blocks, st);
  }
  if (!s8_plan<SAL_BN>(a, N, O) || !s8_maps<SAL_BN>(m, xq, w_ok, N, K, O) ||
      !wg_map(&m.xsal, xsal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ks, N, ks, S8_SAL_K, S8_BM,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg_map(&m.wsal, wsal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, ks, O, 64, S8_SAL_K,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  return out_dt == DT_BF16
             ? s8_launch<SAL_BN, SAL_STAGES, true, S8_K4, __nv_bfloat16>(a, m, blocks, st)
             : s8_launch<SAL_BN, SAL_STAGES, true, S8_K4, float>(a, m, blocks, st);
}

// K15a on the wgmma body: x (N, K) and w (O, K) int8 (K a multiple of 16,
// both 16-byte aligned), bias (O,) f32 or null, out (N, O) f32 / int8
// (out_dt 0 / 2); `blocks`: the persistent grid.
SQ_EXPORT int sq_int8_linear_wg(const void* x, const void* w, const void* bias, void* out, int N,
                                int K, int O, float alpha, int relu, int out_dt, int blocks,
                                void* stream) {
  if (N < 1 || K < 16 || K % 16 || O < 1 || blocks < 1 || (out_dt != DT_F32 && out_dt != DT_I8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  S8Args a = {};
  if (!s8_plan<WIDE_BN>(a, N, O)) return (int)cudaErrorInvalidValue;
  a.n_sal = 0;
  a.n_s8 = (K + S8_KB - 1) / S8_KB;
  a.bias = (const float*)bias;
  a.alpha = alpha;
  a.relu = relu;
  a.out = out;
  S8Maps m = {};
  if (!s8_maps<WIDE_BN>(m, x, w, N, K, O)) return (int)cudaErrorInvalidValue;
  return out_dt == DT_I8
             ? s8_launch<WIDE_BN, WIDE_STAGES, false, S8_LINEAR, int8_t>(a, m, blocks, st)
             : s8_launch<WIDE_BN, WIDE_STAGES, false, S8_LINEAR, float>(a, m, blocks, st);
}

// K15a on the stream body's (O, K) int8 kind: x (N <= 64, K), w (O, K) as
// above, the 128-byte stages of K split over n_split ranks (1, 2, 4 or 8,
// each with a stage at least).
SQ_EXPORT int sq_int8_linear_stream(const void* x, const void* w, const void* bias, void* out,
                                    int N, int K, int O, float alpha, int relu, int out_dt,
                                    int n_split, void* stream) {
  const int stages = (K + 127) / 128;
  if (N < 1 || N > 64 || K < 16 || K % 16 || O < 1 ||
      (n_split != 1 && n_split != 2 && n_split != 4 && n_split != 8) || stages < n_split ||
      (out_dt != DT_F32 && out_dt != DT_I8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const SkArgs a{(const float*)bias, out, alpha, N, O, stages, n_split, relu};
  return out_dt == DT_I8 ? sk_dispatch<int8_t>(x, w, a, K, st)
                         : sk_dispatch<float>(x, w, a, K, st);
}
