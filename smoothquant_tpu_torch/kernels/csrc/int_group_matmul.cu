// Integer group matmul over int8-container weights (K8).
//
// Replaces smoothquant_tpu/kernels/int_group_matmul.py int_group_matmul
// (pallas_call at :157; bodies _kernel with the salient dot, _kernel_nosal
// without):
//     out[n,o] = Σ_s x_sal[n,s]·w_sal[s,o]
//              + Σ_g f32(Σ_{c∈g} x_q[n,c]·w_q[c,o]) · s_x[n,g] · s_w[g,o]
// with w_q (K, O) int8 holding int4- or int8-range values, one byte each.
// It is the per-layer pack's int path: every decode linear of the default
// pack_model, and single-group recipes at any token count.
//
// What bounds it on the H100: at decode N (a handful of rows) the weight's
// bytes — one byte an element, 45 MB for a Llama-2-7B gate_proj, 13.4 µs at
// 3.35 TB/s — against 2·N int8 operations an element.  At prefill N the
// int8 products cost 2·N·K·O at 1979 TOP/s, but the per-group epilogue (a
// convert, a multiply and an fma per output element and group, on the CUDA
// cores at ~67 TFLOP/s) costs about as much: 3 f32 operations against
// 2·gs = 128 int8 ones, a 30× slower unit.  That epilogue is the price of
// never materialising a dequantized weight; K9 pays a dequant instead, and
// real_linear's INT_PATH_MAX_TOKENS is where the two cross on the card.
//
// Design: K6's tile kernel (gmm_tiles.cuh) with NIBBLE = false — 64×64
// output tiles, the int8 codes staged 128 channels a step into shared
// memory, the (K, O) weight transposed four rows at a time into K-packed
// column words, mma.sync m16n8k32 into an int32 partial per group, and the
// epilogue acc = fma(f32(p)·s_x, s_w, acc) group by group in K order after
// the salient dot, the TPU body's order.  Where the O- and N-tiles alone
// leave the card underfilled (decode), the groups split across blocks
// (gmm_plan), each split writing an f32 partial that a fixed-order reduce
// sums: the f32 association then differs from the plain version's single
// chain, a last-bit difference.  A single group (G = 1) never splits.  No
// cp.async pipeline yet: blocks in flight hide the load latency.
#include "gmm_tiles.cuh"

namespace {

GmmPlan int_gmm_plan(int N, int O, int kk, int gs) {
  return gmm_plan(N, O, gm_units(false, kk, gs));
}

}  // namespace

// Bytes of f32 partials sq_int_gmm needs for these shapes (0 without a split).
SQ_EXPORT long long sq_int_gmm_workspace_bytes(int N, int O, int kk, int gs) {
  const int n_split = int_gmm_plan(N, O, kk, gs).n_split;
  return n_split == 1 ? 0 : (long long)n_split * N * O * (long long)sizeof(float);
}

// K8: xq (N, x_rs) int8 codes (rows zero-padded from K to x_rs, a multiple
// of 16), xs (N, G) f32, w (K, O) int8, ws (G, O) f32 / bf16, xsal (N, k_s)
// and wsal (k_s, O) in the output dtype; out (N, O).  K = G·gs, or G = 1
// with gs = K.
SQ_EXPORT int sq_int_gmm(const void* xq, const void* xs, const void* w, const void* ws,
                         const void* xsal, const void* wsal, void* workspace, void* out,
                         int N, int O, int kk, int gs, int k_s, int x_rs, int s_dt, int x_dt,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = kk / gs;
  if (N < 1 || O % 4 || x_rs % 16 || x_rs < kk || G * gs != kk ||
      (G > 1 && (gs % 16 || gs > 2 * GM_MAX_GS)))
    return (int)cudaErrorInvalidValue;
  const GmmPlan p = int_gmm_plan(N, O, kk, gs);
  const GmmArgs a{xq, xs, w, ws, xsal, wsal, out, workspace, N, O, kk, gs, k_s,
                  x_rs, gs, G, 1, p.gps, p.n_split};
  return x_dt == DT_BF16 ? dispatch_gmm<false, __nv_bfloat16>(a, s_dt, st)
                         : dispatch_gmm<false, float>(a, s_dt, st);
}
