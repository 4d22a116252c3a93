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
#include "rawx.cuh"

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
  __shared__ float scratch[32];
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
__global__ void rawx_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                                   int NO, int n_int_splits, int n_sal_splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NO) return;
  out[i] = from_f<T>(rawx_reduce_at(part, (size_t)NO, (size_t)i, n_int_splits, n_sal_splits));
}

// ---------------------------------------------------------------- K6
constexpr int GM_BM = 64, GM_BN = 64, GM_THREADS = 128;  // 4 warps, 32×32 each
constexpr int GM_MAX_GS = 64;               // group size the smem tiles hold
constexpr int GM_WORDS = GM_MAX_GS / 4 + 1; // padded row stride (words)
constexpr int GM_SAL_K = 32;
constexpr int GM_TARGET_BLOCKS = 792;       // K5: ~6 blocks per SM (smem allows 6)

// Thread (warp, lane) owns acc[mt][nt][e] at tile row
// wm + 16·mt + lane/4 + 8·(e/2) and tile column wn + 8·nt + 2·(lane%4) + e%2
// (the mma accumulator layout).
//
// Shared by K6 and K5.  Code (n, channel g·gs + i) lies at
// xq[n·x_rs + g·x_gs + i] and its group scale at xs[n·s_rs + g·s_gs]: (N, K)
// row-major codes with (N, G) scales (x_rs = K, x_gs = gs, s_rs = G,
// s_gs = 1), or K7a's pre-laid (G, N_pad, gs) / (G, N_pad) (x_rs = gs,
// x_gs = N_pad·gs, s_rs = 1, s_gs = N_pad).  blockIdx.z splits the group
// pairs gps at a time; with one split the block writes out in T, with more
// each split writes its f32 partial (the salient dot seeds split 0) and
// rawx_reduce_kernel adds them in split order.
template <typename S, typename T>
__global__ void __launch_bounds__(GM_THREADS)
gmm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
           const int8_t* __restrict__ w, const S* __restrict__ ws,
           const T* __restrict__ xsal, const T* __restrict__ wsal, T* __restrict__ out,
           float* __restrict__ part, int N, int O, int kk, int gs, int k_s, int x_rs,
           int x_gs, int s_rs, int s_gs, int gps) {
  __shared__ int x_lo[GM_BM][GM_WORDS], x_hi[GM_BM][GM_WORDS];
  __shared__ int w_lo[GM_BN][GM_WORDS], w_hi[GM_BN][GM_WORDS];
  __shared__ int sum_lo[GM_BM], sum_hi[GM_BM];
  __shared__ float sx_lo[GM_BM], sx_hi[GM_BM], sw_lo[GM_BN], sw_hi[GM_BN];
  __shared__ float xs_tile[GM_BM][GM_SAL_K + 1];
  __shared__ float ws_tile[GM_SAL_K][GM_BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.y * GM_BM, o0 = blockIdx.x * GM_BN;
  const int G = kk / gs, g_half = G / 2, words = gs / 4;
  const int split = blockIdx.z;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // salient fp dot seeds the accumulator (f32 sums of compute-dtype values)
  for (int j0 = 0; split == 0 && j0 < k_s; j0 += GM_SAL_K) {
    for (int e = tid; e < GM_BM * GM_SAL_K; e += GM_THREADS) {
      const int r = e / GM_SAL_K, j = e % GM_SAL_K;
      const int n = n0 + r, jj = j0 + j;
      xs_tile[r][j] = (n < N && jj < k_s) ? to_f<T>(xsal[(size_t)n * k_s + jj]) : 0.0f;
    }
    for (int e = tid; e < GM_SAL_K * GM_BN; e += GM_THREADS) {
      const int j = e / GM_BN, c = e % GM_BN;
      const int o = o0 + c, jj = j0 + j;
      ws_tile[j][c] = (o < O && jj < k_s) ? to_f<T>(wsal[(size_t)jj * O + o]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < GM_SAL_K; ++j) {
      float xv[2][2], wv[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) xv[mt][h] = xs_tile[wm + 16 * mt + gid + 8 * h][j];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) wv[nt][h] = ws_tile[j][wn + 8 * nt + 2 * tig + h];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = fmaf(xv[mt][e >> 1], wv[nt][e & 1], acc[mt][nt][e]);
    }
    __syncthreads();
  }

  const int g_end = min(g_half, (split + 1) * gps);
  for (int g = split * gps; g < g_end; ++g) {
    // activation tiles: rows n0.., lo channels g*gs.., hi channels
    // half+g*gs..; a fixed trip count so every load is issued up front
    constexpr int X_ITEMS = GM_BM * (GM_MAX_GS / 4) / GM_THREADS;
    int lo[X_ITEMS], hi[X_ITEMS];
#pragma unroll
    for (int i = 0; i < X_ITEMS; ++i) {
      const int e = tid + i * GM_THREADS;
      const int r = e / words, wd = e % words, n = n0 + r;
      lo[i] = hi[i] = 0;
      if (e < GM_BM * words && n < N) {
        const int8_t* xr = xq + (size_t)n * x_rs + wd * 4;
        lo[i] = *reinterpret_cast<const int*>(xr + (size_t)g * x_gs);
        hi[i] = *reinterpret_cast<const int*>(xr + (size_t)(g + g_half) * x_gs);
      }
    }
#pragma unroll
    for (int i = 0; i < X_ITEMS; ++i) {
      const int e = tid + i * GM_THREADS;
      if (e < GM_BM * words) {
        x_lo[e / words][e % words] = lo[i];
        x_hi[e / words][e % words] = hi[i];
      }
    }
    if (tid < GM_BM) {
      const int n = n0 + tid;
      sx_lo[tid] = n < N ? xs[(size_t)n * s_rs + (size_t)g * s_gs] : 0.0f;
      sx_hi[tid] = n < N ? xs[(size_t)n * s_rs + (size_t)(g + g_half) * s_gs] : 0.0f;
    } else if (tid < GM_BM + GM_BN) {
      const int c = tid - GM_BM, o = o0 + c;
      sw_lo[c] = o < O ? to_f<S>(ws[(size_t)g * O + o]) : 0.0f;
      sw_hi[c] = o < O ? to_f<S>(ws[(size_t)(g + g_half) * O + o]) : 0.0f;
    }
    // weight tile: 4 packed rows x 4 columns per item, transposed to one
    // K-packed word per column (the column-major B operand), split into
    // biased lo/hi nibble words
    for (int e = tid; e < words * (GM_BN / 4); e += GM_THREADS) {
      const int q = e / (GM_BN / 4), cq = e % (GM_BN / 4);
      const int o = o0 + cq * 4;
      uint32_t rw[4] = {0u, 0u, 0u, 0u};
      if (o < O) {
        const int8_t* wp = w + (size_t)(g * gs + q * 4) * O + o;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          rw[k] = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)k * O));
      }
      uint32_t cw[4];
      transpose4(rw[0], rw[1], rw[2], rw[3], cw);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        w_lo[cq * 4 + c][q] = (int)(cw[c] & 0x0F0F0F0Fu);
        w_hi[cq * 4 + c][q] = (int)((cw[c] >> 4) & 0x0F0F0F0Fu);
      }
    }
    __syncthreads();
    if (tid < 2 * GM_BM) {  // per-row code sums of this group pair
      const int r = tid % GM_BM;
      const int* src = tid < GM_BM ? x_lo[r] : x_hi[r];
      int s = 0;
      for (int wd = 0; wd < words; ++wd) s = __dp4a(src[wd], 0x01010101, s);
      if (tid < GM_BM) sum_lo[r] = s; else sum_hi[r] = s;
    }
    __syncthreads();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int(*xt)[GM_WORDS] = hf ? x_hi : x_lo;
      const int(*wt)[GM_WORDS] = hf ? w_hi : w_lo;
      const int* sum = hf ? sum_hi : sum_lo;
      const float* sx = hf ? sx_hi : sx_lo;
      const float* sw = hf ? sw_hi : sw_lo;
      int p[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0;
      for (int kw = 0; kw < words; kw += 8) {  // one 32-byte k step
        const bool full = kw + 4 < words;      // a 16-byte tail zero-fills
        int a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm + 16 * mt + gid;
          a[mt][0] = xt[r][kw + tig];
          a[mt][1] = xt[r + 8][kw + tig];
          a[mt][2] = full ? xt[r][kw + 4 + tig] : 0;
          a[mt][3] = full ? xt[r + 8][kw + 4 + tig] : 0;
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn + 8 * nt + gid;
          b[nt][0] = wt[c][kw + tig];
          b[nt][1] = full ? wt[c][kw + 4 + tig] : 0;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(p[mt][nt], a[mt], b[nt]);
      }
      float row_sx[2][2], col_sw[4][2];
      int row_sum[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + 16 * mt + gid + 8 * h;
          row_sx[mt][h] = sx[r];
          row_sum[mt][h] = 8 * sum[r];
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) col_sw[nt][h] = sw[wn + 8 * nt + 2 * tig + h];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] += ((float)(p[mt][nt][e] - row_sum[mt][e >> 1]) *
                               row_sx[mt][e >> 1]) * col_sw[nt][e & 1];
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wm + 16 * mt + gid + 8 * (e >> 1);
        const int o = o0 + wn + 8 * nt + 2 * tig + (e & 1);
        if (n >= N || o >= O) continue;
        if (gridDim.z == 1)
          out[(size_t)n * O + o] = from_f<T>(acc[mt][nt][e]);
        else
          part[((size_t)split * N + n) * O + o] = acc[mt][nt][e];
      }
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

struct GmmArgs {
  const void *xq, *xs, *w, *ws, *xsal, *wsal;
  void *out, *part;
  int N, O, kk, gs, k_s, x_rs, x_gs, s_rs, s_gs, gps, n_split;
};

template <typename S, typename T>
int launch_gmm(const GmmArgs& a, cudaStream_t st) {
  dim3 grid((a.O + GM_BN - 1) / GM_BN, (a.N + GM_BM - 1) / GM_BM, a.n_split);
  gmm_kernel<S, T><<<grid, GM_THREADS, 0, st>>>(
      (const int8_t*)a.xq, (const float*)a.xs, (const int8_t*)a.w, (const S*)a.ws,
      (const T*)a.xsal, (const T*)a.wsal, (T*)a.out, (float*)a.part, a.N, a.O, a.kk, a.gs,
      a.k_s, a.x_rs, a.x_gs, a.s_rs, a.s_gs, a.gps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  const int NO = a.N * a.O, threads = 256;
  rawx_reduce_kernel<T><<<(NO + threads - 1) / threads, threads, 0, st>>>(
      (const float*)a.part, (T*)a.out, NO, a.n_split, 0);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_gmm(const GmmArgs& a, int s_dt, cudaStream_t st) {
  return s_dt == DT_BF16 ? launch_gmm<__nv_bfloat16, T>(a, st) : launch_gmm<float, T>(a, st);
}

// K5's split of the group pairs, gps a split: enough blocks for ~6 per SM
// (132 SMs; the 35.6 KB of shared memory a block allows 6) when the O- and
// N-tiles alone do not give them.  A block waits on each group pair's loads
// before its mma (no pipeline yet), so blocks in flight are what hides the
// latency: at 2 a SM the first build read 13.7× its byte bound.
struct GmmPlan {
  int gps, n_split;
};

GmmPlan gmm_plan(int N, int O, int kk, int gs) {
  const int g_half = kk / gs / 2;
  const int tiles = ((O + GM_BN - 1) / GM_BN) * ((N + GM_BM - 1) / GM_BM);
  int splits = (GM_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > g_half ? g_half : splits);
  const int gps = (g_half + splits - 1) / splits;
  return {gps, (g_half + gps - 1) / gps};
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
  return x_dt == DT_BF16 ? dispatch_gmm<__nv_bfloat16>(a, s_dt, st)
                         : dispatch_gmm<float>(a, s_dt, st);
}

// Bytes of f32 partials sq_int4_gmm_stacked needs for these shapes (0 when
// the tiles alone fill the card and no split is made).
SQ_EXPORT long long sq_gmm_stacked_workspace_bytes(int N, int O, int kk, int gs) {
  const int n_split = gmm_plan(N, O, kk, gs).n_split;
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
  const GmmPlan p = gmm_plan(N, O, kk, gs);
  GmmArgs a{xq, xs, w, ws, xsal, wsal, out, workspace, N, O, kk, gs, k_s,
            kk, gs, G, 1, p.gps, p.n_split};
  if (pre_laid) {
    a.x_rs = gs;
    a.x_gs = pre_laid * gs;
    a.s_rs = 1;
    a.s_gs = pre_laid;
  }
  return x_dt == DT_BF16 ? dispatch_gmm<__nv_bfloat16>(a, s_dt, st)
                         : dispatch_gmm<float>(a, s_dt, st);
}
