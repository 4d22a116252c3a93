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
// Two bodies, picked by shape alone (int_group_matmul.py int_gmm_body):
//   * the stream body (stream_gmm.cuh) at 1-64 rows — every call the "int"
//     path makes up to INT_PATH_MAX_TOKENS — with G > 1 groups of 16, 32,
//     64 or 128 channels and O % 16 == 0: the weight streamed by TMA through
//     a ring of 128-row stages, byte-transposed in registers into mma.sync
//     A fragments with the tokens on the n side, one int32 partial a group
//     started at 0x4B400000 so f32(p) is one subtract (no I2F; the same bits
//     as __int2float_rn), K split over a cluster and reduced through
//     distributed shared memory in rank order.  The groups are folded in K
//     order after the salient dot within each rank.
//   * gmm_kernel (gmm_tiles.cuh) for every other shape: 64×64 output tiles,
//     the codes staged 128 channels a step, the (K, O) weight transposed four
//     rows at a time, mma.sync m16n8k32 into an int32 partial per group,
//     acc = fma(f32(p)·s_x, s_w, acc) group by group in K order; where the
//     O- and N-tiles alone leave the card underfilled the groups split
//     across blocks (gmm_plan) into f32 partials that a fixed-order reduce
//     sums.  A single group (G = 1) never splits and converts its partial,
//     which may pass 2^22, with __int2float_rn.
// Both take the f32 association the plan gives, a last-bit difference from
// the plain version's single chain.  Times: PERF.md §6.
#include "gmm_tiles.cuh"
#include "stream_gmm.cuh"

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

// K8, stream body (stream_gmm.cuh): 1-64 rows, G > 1 groups of 16, 32, 64
// or 128 channels, O % 16 == 0; xq (N, x_rs) codes, x_rs a multiple of 16;
// xsal (N, xsal_rs) and wsal (k_s, O) in the output dtype (bf16: xsal_rs a
// multiple of 8); every pointer 16-byte aligned (TMA).  n_split ranks (1, 2,
// 4 or 8) take each 128-column tile's stages: 128 weight rows a group stage,
// 64 salient rows a bf16 salient stage.
SQ_EXPORT int sq_int_gmm_stream(const void* xq, const void* xs, const void* w, const void* ws,
                                const void* xsal, const void* wsal, void* out, int N, int O,
                                int kk, int gs, int k_s, int x_rs, int xsal_rs, int n_split,
                                int s_dt, int x_dt, void* stream) {
  const int G = kk / gs, s_bf16 = s_dt == DT_BF16, t_bf16 = x_dt == DT_BF16;
  const int n_grp = (kk + 127) / 128, n_sal = t_bf16 ? (k_s + 63) / 64 : 0;
  if ((gs != 16 && gs != 32 && gs != 64 && gs != 128) || G < 2 || G * gs != kk || x_rs % 16 ||
      x_rs < kk || !sg_args_ok(N, O, k_s, xsal_rs, n_split, n_sal + n_grp, t_bf16))
    return (int)cudaErrorInvalidValue;
  const SgArgs a{(const float*)xs, xsal, wsal, out, N, O, G, k_s, xsal_rs, G, 1, 128, 0, 0, 0,
                 n_sal, n_grp, n_split, s_bf16, t_bf16};
  const int n_box = 8 * sg_tiles_for(N);
  SgMaps m = {};
  if (!sg_weight_map(&m.w, w, O, kk, 128) ||
      !wg_map(&m.x, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kk, N, x_rs, 128, n_box,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sg_common_maps(m, ws, xsal, wsal, s_bf16, N, O, G, n_sal ? k_s : 0, xsal_rs, n_box, 64,
                      128 / gs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (gs) {
    case 16: return sg_dispatch<false, 16>(a, m, st);
    case 32: return sg_dispatch<false, 32>(a, m, st);
    case 64: return sg_dispatch<false, 64>(a, m, st);
    default: return sg_dispatch<false, 128>(a, m, st);
  }
}
