// W4A4 group matmul kernels for Hopper: the decode linear (K1), the
// prefill linear (K6) and the stacked linear on quantized activations (K5).
//
// K1 replaces smoothquant_tpu/kernels/int4_group_matmul.py
// int4_group_matmul_stacked_rawx (pallas_call at :649), at N <= 32 token
// rows.  At decode N (the batch) it is bound by the bytes of the layer's
// packed weight: ~0.56 bytes per weight element (nibbles + bf16 group
// scales) plus the bf16 salient block, against 2·N int ops per element.
// The design spends nothing on the activations beyond one tiny pre-pass and
// spreads the weight stream over every SM, in three launches behind one
// entry, sq_rawx:
//   * rawx_prep_kernel (a block per token row and 8 groups, a warp per group,
//     plus a block per row for the salient slice) does the optional RMSNorm
//     or 0/1 channel mask, the tail-mode salient split and the per-(row,
//     group) activation quantize ONCE (group_quant.cuh, shared with K7a:
//     scale = max(absmax,1e-5)·(1/qmax), the f32 reciprocal multiply XLA
//     compiles the JAX division to; round half to even), writing int8 codes,
//     f32 scales, int32 code sums and the salient activations rounded to the
//     compute dtype.  (The TPU kernel quantized at j == 0 into VMEM scratch;
//     here one pre-pass serves every O-tile instead of each block redoing it.)
//   * rawx_main_kernel is split over O (4 columns a lane, 512 a block) and over
//     K (group pairs, plus 64-row slices of the salient block), so a
//     Llama-2-7B decode linear launches 250-500 blocks.  Each lane loads
//     the 32-bit words of 16 packed rows of its 4 columns before using
//     any (loads in flight are what a bandwidth-bound kernel needs), its
//     accumulators sized for 4 or 8 token rows; above 8 rows the grid also
//     splits the rows into chunks of 8, the chunk varying fastest so the
//     blocks reading one weight tile run together and L2 serves all but the
//     first (the weight streams from DRAM about once; registers, not the
//     weight, are what a 32-row accumulator would not fit).  It transposes
//     bytes with __byte_perm into one K-packed word per column, masks the
//     biased low/high nibbles (channel r and r + K/2) and feeds __dp4a; the
//     +8 bias leaves the int32 sum as −8·Σx_q per group.  The epilogue is
//     (p − 8Σx)·s_x·s_w in f32.  Each split writes its own f32 partial.
//   * rawx_reduce_kernel sums the salient partials, then the group partials in
//     K order (the TPU kernel seeded its accumulator with the salient dot
//     and added groups in order), and casts to the output dtype.
//
// K6 replaces int4_group_matmul (pallas_call at :950): the same inner
// product on activations that are already quantized, at prefill N (up to
// rows·bucket = 1024), where the int8 operations, not the bytes, bound it.
// It runs them on the int8 tensor cores (mma.sync m16n8k32): 64×64 output
// tiles, 4 warps of 32×32; each group pair stages the int8 activation rows
// and the nibble-unpacked, K-packed weight columns in shared memory (rows
// padded to 17 words, so fragment loads hit 32 distinct banks), one mma
// chain per half gives the group's int32 product and the (p − 8Σx)·s_x·s_w
// epilogue folds it into f32 accumulators seeded by the salient fp dot.
// Loads are not overlapped with the mma (no cp.async / TMA pipeline yet).
// The tile kernel lives in gmm_tiles.cuh, shared with K8's int8 containers.
//
// K5 replaces int4_group_matmul_stacked (pallas_call at :807): layer i of a
// stacked (L, K/2, O) pack on quantized activations, the decode linears of
// 33+ token rows (K7a's pre-laid (G, N_pad, gs) codes, or (N, K) row-major
// ones from the identity layout's quantize).  At N = 64 it is still bound by
// the weight's bytes (2·64 int ops per ~0.56-byte element, ~230 ops a byte
// against the card's ~590), so it is K6's tile kernel with strided
// activation addressing, on the layer's base pointers, its f32 result cast
// to the output dtype, and a split over the group pairs (f32 partials, then
// the fixed-order reduce) where the 64-wide O-tiles alone give fewer than
// ~6 blocks per SM (every decode linear at N = 64).
#include "gmm_tiles.cuh"

namespace {

// K1 pre-pass.  Grid (N, ceil(G / PREP_WARPS) + 1): block (n, y) runs the
// pre-pass item (n, y) of rawx.cuh.
template <typename T>
__global__ void __launch_bounds__(PREP_WARPS * 32)
rawx_prep_kernel(const T* __restrict__ x, const float* __restrict__ nw,
                 const T* __restrict__ x_sal_ext, int8_t* __restrict__ xq,
                 float* __restrict__ xs, int* __restrict__ xsum, float* __restrict__ xsal,
                 int C, int kk, int gs, int k_ns_raw, int n_sal, int k_s, int mode,
                 int need_mask, float eps, float inv_qmax) {
  __shared__ double scratch[32];
  rawx_prep_item<T>(blockIdx.x, blockIdx.y, gridDim.y, x, nw, x_sal_ext, xq, xs, xsum, xsal,
                    C, kk, gs, k_ns_raw, n_sal, k_s, mode, need_mask, eps, inv_qmax, scratch);
}

// NT: token rows the accumulators hold (4, or RAWX_CHUNK = 8).  Above NT
// rows the grid splits the rows into n_chunks chunks of NT, the chunk index
// varying fastest in blockIdx.x, so the blocks that read the same weight
// tile run side by side and the tile comes from DRAM once (L2 serves the
// other chunks).  Each warp takes 32·RAWX_COLS columns (rawx_main_warp).
template <int NT, typename S, typename T>
__global__ void __launch_bounds__(RAWX_WARPS * 32)
rawx_main_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int* __restrict__ xsum, const float* __restrict__ xsal,
                 const int8_t* __restrict__ w, const S* __restrict__ ws,
                 const T* __restrict__ wsal, float* __restrict__ part, int N, int O, int kk,
                 int gs, int k_s, int gps, int n_int_splits, int n_chunks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ob = blockIdx.x / n_chunks;
  const int n0 = (blockIdx.x % n_chunks) * NT;   // this block's first token row
  const int col0 = (ob * RAWX_WARPS + warp) * RAWX_WARP_COLS + lane * RAWX_COLS;
  rawx_main_warp<NT, S, T>(col0, blockIdx.y, n0, min(NT, N - n0), xq, xs, xsum, xsal, w, ws,
                           wsal, part, N, O, kk, gs, k_s, gps, n_int_splits);
}


template <typename T>
void launch_prep(const void* x, const void* nw, const void* x_sal, void* xq, void* xs,
                 void* xsum, void* xsal, int N, int C, int kk, int gs, int k_ns_raw,
                 int n_sal, int k_s, int mode, int need_mask, float eps, float inv_qmax,
                 cudaStream_t st) {
  const dim3 grid(N, (kk / gs + PREP_WARPS - 1) / PREP_WARPS + 1);
  rawx_prep_kernel<T><<<grid, PREP_WARPS * 32, 0, st>>>(
      (const T*)x, (const float*)nw, (const T*)x_sal, (int8_t*)xq, (float*)xs, (int*)xsum,
      (float*)xsal, C, kk, gs, k_ns_raw, n_sal, k_s, mode, need_mask, eps, inv_qmax);
}

template <typename S, typename T>
void launch_main(const void* xq, const void* xs, const void* xsum, const void* xsal,
                 const void* w, const void* ws, const void* wsal, void* part, int N, int O,
                 int kk, int gs, int k_s, int gps, int n_int, int n_sal_splits,
                 cudaStream_t st) {
  const int cols_per_block = RAWX_WARPS * 32 * RAWX_COLS;
  const int chunks = rawx_chunks(N);
  dim3 grid((O + cols_per_block - 1) / cols_per_block * chunks, n_int + n_sal_splits);
  if (N <= 4)
    rawx_main_kernel<4, S, T><<<grid, RAWX_WARPS * 32, 0, st>>>(
        (const int8_t*)xq, (const float*)xs, (const int*)xsum, (const float*)xsal,
        (const int8_t*)w, (const S*)ws, (const T*)wsal, (float*)part, N, O, kk, gs, k_s,
        gps, n_int, chunks);
  else
    rawx_main_kernel<RAWX_CHUNK, S, T><<<grid, RAWX_WARPS * 32, 0, st>>>(
        (const int8_t*)xq, (const float*)xs, (const int*)xsum, (const float*)xsal,
        (const int8_t*)w, (const S*)ws, (const T*)wsal, (float*)part, N, O, kk, gs, k_s,
        gps, n_int, chunks);
}


}  // namespace

// Bytes of device workspace sq_rawx needs for these shapes.
SQ_EXPORT long long sq_rawx_workspace_bytes(int N, int O, int kk, int gs, int k_s) {
  return (long long)rawx_plan(N, O, kk, gs, k_s).bytes;
}

// K1: pre-pass (norm / mask, salient split, per-group quantize), split-K /
// split-O nibble dp4a products into f32 partials, fixed-order reduce.
SQ_EXPORT int sq_rawx(const void* x, const void* nw, const void* x_sal, const void* w,
                      const void* ws, const void* wsal, void* workspace, void* out, int N,
                      int C, int O, int kk, int gs, int k_ns_raw, int n_sal, int k_s,
                      int mode, int need_mask, float eps, float inv_qmax, int s_dt, int x_dt,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > RAWX_MAX_N || gs > 32 * GQ_PER_LANE || gs % 4)
    return (int)cudaErrorInvalidValue;
  const RawxPlan p = rawx_plan(N, O, kk, gs, k_s);
  char* base = static_cast<char*>(workspace);
  void *xq = base + p.xq, *xs = base + p.xs, *xsum = base + p.xsum, *xsal = base + p.xsal,
       *part = base + p.part;
  if (x_dt == DT_BF16)
    launch_prep<__nv_bfloat16>(x, nw, x_sal, xq, xs, xsum, xsal, N, C, kk, gs, k_ns_raw,
                               n_sal, k_s, mode, need_mask, eps, inv_qmax, st);
  else
    launch_prep<float>(x, nw, x_sal, xq, xs, xsum, xsal, N, C, kk, gs, k_ns_raw, n_sal,
                       k_s, mode, need_mask, eps, inv_qmax, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (s_dt == DT_BF16 && x_dt == DT_BF16)
    launch_main<__nv_bfloat16, __nv_bfloat16>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O,
                                              kk, gs, k_s, p.gps, p.n_int, p.n_sal, st);
  else if (s_dt == DT_BF16)
    launch_main<__nv_bfloat16, float>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O, kk, gs,
                                      k_s, p.gps, p.n_int, p.n_sal, st);
  else if (x_dt == DT_BF16)
    launch_main<float, __nv_bfloat16>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O, kk, gs,
                                      k_s, p.gps, p.n_int, p.n_sal, st);
  else
    launch_main<float, float>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O, kk, gs, k_s,
                              p.gps, p.n_int, p.n_sal, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int NO = N * O, threads = 256, blocks = (NO + threads - 1) / threads;
  if (x_dt == DT_BF16)
    rawx_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const float*)part, (__nv_bfloat16*)out, NO, p.n_int, p.n_sal);
  else
    rawx_reduce_kernel<float><<<blocks, threads, 0, st>>>((const float*)part, (float*)out,
                                                          NO, p.n_int, p.n_sal);
  return (int)cudaGetLastError();
}

// K6: tiled int4 group matmul on pre-quantized (N, K) activations.
SQ_EXPORT int sq_int4_gmm(const void* xq, const void* xs, const void* w, const void* ws,
                          const void* xsal, const void* wsal, void* out, int N, int O,
                          int kk, int gs, int k_s, int s_dt, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gs > GM_MAX_GS || gs % 16) return (int)cudaErrorInvalidValue;
  const int G = kk / gs;
  const GmmArgs a{xq, xs, w, ws, xsal, wsal, out, nullptr, N, O, kk, gs, k_s,
                  kk, gs, G, 1, G / 2, 1};
  return x_dt == DT_BF16 ? dispatch_gmm<true, __nv_bfloat16>(a, s_dt, st)
                         : dispatch_gmm<true, float>(a, s_dt, st);
}

// Bytes of f32 partials sq_int4_gmm_stacked needs for these shapes (0 when
// the tiles alone fill the card and no split is made).
SQ_EXPORT long long sq_gmm_stacked_workspace_bytes(int N, int O, int kk, int gs) {
  const int n_split = gmm_plan(N, O, gm_units(true, kk, gs)).n_split;
  return n_split == 1 ? 0 : (long long)n_split * N * O * (long long)sizeof(float);
}

// K5: one layer of a stacked int4 group matmul on quantized activations,
// row-major (pre_laid = 0: xq (N, K), xs (N, G)) or K7a's layout
// (pre_laid = N_pad: xq (G, N_pad, gs), xs (G, N_pad)); out (N, O) in the
// output dtype, from f32 sums seeded by the salient dot.
SQ_EXPORT int sq_int4_gmm_stacked(const void* xq, const void* xs, const void* w,
                                  const void* ws, const void* xsal, const void* wsal,
                                  void* workspace, void* out, int N, int O, int kk, int gs,
                                  int k_s, int pre_laid, int s_dt, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gs > GM_MAX_GS || gs % 16 || (pre_laid && pre_laid < N)) return (int)cudaErrorInvalidValue;
  const int G = kk / gs;
  const GmmPlan p = gmm_plan(N, O, gm_units(true, kk, gs));
  GmmArgs a{xq, xs, w, ws, xsal, wsal, out, workspace, N, O, kk, gs, k_s,
            kk, gs, G, 1, p.gps, p.n_split};
  if (pre_laid) {
    a.x_rs = gs;
    a.x_gs = pre_laid * gs;
    a.s_rs = 1;
    a.s_gs = pre_laid;
  }
  return x_dt == DT_BF16 ? dispatch_gmm<true, __nv_bfloat16>(a, s_dt, st)
                         : dispatch_gmm<true, float>(a, s_dt, st);
}
