// The int8 tensor-core group-matmul tile kernel for the shapes the faster
// bodies do not take: K8's and K5's beyond the stream body (stream_gmm.cuh:
// more than 64 rows; K8's single group, whose int32 partial may pass the
// 2^22 its exact conversion needs, and group sizes other than 16/32/64/128;
// K5's group size 48; O % 16 != 0), and K6's beyond its wgmma body
// (wg_gmm_kernel).  At the decode rows the stream body now takes, this
// kernel read 7-11× its byte bound: a 64-row token tile at any N, one
// unit's loads waited on before its mma, 4-byte weight loads, an I2F per
// scaling, and split-K partials through device memory and a second launch.
// Layout: 64×64 output tiles,
// 4 warps of 32×32, mma.sync m16n8k32 on operand tiles staged in shared
// memory (rows padded to 17 words, so fragment loads hit 32 distinct
// banks), an int32 partial per group scaled into f32 accumulators seeded by
// the salient fp dot.  The template flag NIBBLE names the weight storage:
//   * true  — split-half biased nibbles (K/2, O): one unit of work is the
//     group pair (g, g + G/2), unpacked into lo / hi tiles, and the +8 bias
//     leaves −8·Σx_q in each partial: acc += ((p − 8Σx)·s_x)·s_w;
//   * false — int8 containers (K, O) holding int4- or int8-range values: the
//     groups in plain order g = 0 … G−1, acc = fma(f32(p)·s_x, s_w, acc) per
//     group, the jitted order of the TPU kernel's body (int_group_matmul.py:
//     35-45).  Groups of at most 64 channels go two to a unit (lo = g,
//     hi = g + 1); larger groups (up to 128, or G = 1 with any K) stage 128
//     channels a step into lo + hi and carry one int32 partial across the
//     steps of the group (|p| < 2^31 for K ≤ 11008 of int8 codes), converted
//     once, to nearest (__int2float_rn, as XLA's astype).
#pragma once

#include "rawx.cuh"

namespace {

// Element i of (N, O) from f32 partials: rawx_reduce_at's fixed split order.
template <typename T>
__global__ void rawx_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                                   int NO, int n_int_splits, int n_sal_splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NO) return;
  out[i] = from_f<T>(rawx_reduce_at(part, (size_t)NO, (size_t)i, n_int_splits, n_sal_splits));
}

constexpr int GM_BM = 64, GM_BN = 64, GM_THREADS = 128;  // 4 warps, 32×32 each
constexpr int GM_MAX_GS = 64;               // channels a lo / hi tile holds
constexpr int GM_WORDS = GM_MAX_GS / 4 + 1; // padded row stride (words)
constexpr int GM_SAL_K = 32;
constexpr int GM_TARGET_BLOCKS = 792;       // ~6 blocks per SM (smem allows 6)

// p[mt][nt] += the warp's 32×32 share of xt · wt over `words` 4-byte k words
// (one 32-byte mma k step at a time; a 16-byte tail zero-fills)
__device__ __forceinline__ void gm_mma_tile(int (&p)[2][4][4], const int (*xt)[GM_WORDS],
                                            const int (*wt)[GM_WORDS], int words, int wm,
                                            int wn, int gid, int tig) {
  for (int kw = 0; kw < words; kw += 8) {
    const bool full = kw + 4 < words;
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
}

__device__ __forceinline__ void gm_zero(int (&p)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0;
}

// int8 path: `words` words a row of codes from channel c0 of rows n0.. into
// xt; a word at channel >= c_end, or of a row >= N, reads 0 (the caller pads
// x's rows to whole words)
__device__ __forceinline__ void gm_stage_x8(int (*xt)[GM_WORDS], const int8_t* __restrict__ xq,
                                            int x_rs, int n0, int N, int c0, int c_end,
                                            int words, int tid) {
  constexpr int X_ITEMS = GM_BM * (GM_MAX_GS / 4) / GM_THREADS;
  int v[X_ITEMS];
#pragma unroll
  for (int i = 0; i < X_ITEMS; ++i) {
    const int e = tid + i * GM_THREADS;
    const int r = e / words, ch = c0 + (e % words) * 4, n = n0 + r;
    v[i] = (e < GM_BM * words && n < N && ch < c_end)
               ? *reinterpret_cast<const int*>(xq + (size_t)n * x_rs + ch)
               : 0;
  }
#pragma unroll
  for (int i = 0; i < X_ITEMS; ++i) {
    const int e = tid + i * GM_THREADS;
    if (e < GM_BM * words) xt[e / words][e % words] = v[i];
  }
}

// int8 path: weight rows c0 + 4q + k (q < words, k < 4; rows >= r_end read
// 0) of columns o0.. of the (K, O) int8 matrix, transposed to one K-packed
// word per column (the column-major B operand)
__device__ __forceinline__ void gm_stage_w8(int (*wt)[GM_WORDS], const int8_t* __restrict__ w,
                                            int O, int o0, int c0, int r_end, int words,
                                            int tid) {
  for (int e = tid; e < words * (GM_BN / 4); e += GM_THREADS) {
    const int q = e / (GM_BN / 4), cq = e % (GM_BN / 4);
    const int o = o0 + cq * 4, r0 = c0 + q * 4;
    uint32_t rw[4] = {0u, 0u, 0u, 0u};
    if (o < O) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r0 + k < r_end)
          rw[k] = __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)(r0 + k) * O + o));
    }
    uint32_t cw[4];
    transpose4(rw[0], rw[1], rw[2], rw[3], cw);
#pragma unroll
    for (int c = 0; c < 4; ++c) wt[cq * 4 + c][q] = (int)cw[c];
  }
}

// int8 path: acc = fma(f32(p)·s_x, s_w, acc) with the row scales sx and the
// column scales sw of one group
__device__ __forceinline__ void gm_epilogue8(float (&acc)[2][4][4], const int (&p)[2][4][4],
                                             const float* sx, const float* sw, int wm, int wn,
                                             int gid, int tig) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float rs = sx[wm + 16 * mt + gid + 8 * (e >> 1)];
        const float cs = sw[wn + 8 * nt + 2 * tig + (e & 1)];
        acc[mt][nt][e] =
            __fmaf_rn(__fmul_rn(__int2float_rn(p[mt][nt][e]), rs), cs, acc[mt][nt][e]);
      }
}

// Thread (warp, lane) owns acc[mt][nt][e] at tile row
// wm + 16·mt + lane/4 + 8·(e/2) and tile column wn + 8·nt + 2·(lane%4) + e%2
// (the mma accumulator layout).
//
// Code (n, channel g·gs + i) lies at xq[n·x_rs + g·x_gs + i] and its group
// scale at xs[n·s_rs + g·s_gs]: (N, K) row-major codes with (N, G) scales
// (x_rs = K, x_gs = gs, s_rs = G, s_gs = 1), or, nibble path only, K7a's
// pre-laid (G, N_pad, gs) / (G, N_pad) (x_rs = gs, x_gs = N_pad·gs, s_rs = 1,
// s_gs = N_pad).  The int8 path reads row-major codes at x_rs ≥ K (rows
// padded to whole 16-byte runs) and kk is the true K.  blockIdx.z splits the
// units (gm_units) gps at a time; with one split the block writes out in T,
// with more each split writes its f32 partial (the salient dot seeds split
// 0) and rawx_reduce_kernel adds them in split order.
template <bool NIBBLE, typename S, typename T>
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
  const int G = kk / gs;
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

  if constexpr (NIBBLE) {
    const int g_half = G / 2, words = gs / 4;
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
        const int* sum = hf ? sum_hi : sum_lo;
        const float* sx = hf ? sx_hi : sx_lo;
        const float* sw = hf ? sw_hi : sw_lo;
        int p[2][4][4];
        gm_zero(p);
        gm_mma_tile(p, hf ? x_hi : x_lo, hf ? w_hi : w_lo, words, wm, wn, gid, tig);
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
  } else {
    const bool pair = gs <= GM_MAX_GS && G > 1;
    const int n_units = pair ? (G + 1) / 2 : G;
    const int words = pair ? gs / 4 : GM_MAX_GS / 4;   // per lo / hi tile
    const int u_end = min(n_units, (split + 1) * gps);
    for (int u = split * gps; u < u_end; ++u) {
      const int g0 = pair ? 2 * u : u;
      const int n_g = pair ? min(2, G - g0) : 1;
      const int c_beg = g0 * gs;
      const int c_end = pair ? c_beg + n_g * gs : min(c_beg + gs, kk);
      if (tid < GM_BM) {
        const int n = n0 + tid;
        sx_lo[tid] = n < N ? xs[(size_t)n * s_rs + (size_t)g0 * s_gs] : 0.0f;
        sx_hi[tid] = (n < N && n_g > 1) ? xs[(size_t)n * s_rs + (size_t)(g0 + 1) * s_gs] : 0.0f;
      } else if (tid < GM_BM + GM_BN) {
        const int c = tid - GM_BM, o = o0 + c;
        sw_lo[c] = o < O ? to_f<S>(ws[(size_t)g0 * O + o]) : 0.0f;
        sw_hi[c] = (o < O && n_g > 1) ? to_f<S>(ws[(size_t)(g0 + 1) * O + o]) : 0.0f;
      }
      int p[2][4][4];
      gm_zero(p);
      // pair: one step, lo = group g0, hi = g0 + 1; long: 128 channels a step
      for (int c0 = c_beg; c0 < c_end; c0 += 8 * words) {
        const int c1 = c0 + 4 * words;
        gm_stage_x8(x_lo, xq, x_rs, n0, N, c0, c_end, words, tid);
        gm_stage_x8(x_hi, xq, x_rs, n0, N, c1, c_end, words, tid);
        gm_stage_w8(w_lo, w, O, o0, c0, c_end, words, tid);
        gm_stage_w8(w_hi, w, O, o0, c1, c_end, words, tid);
        __syncthreads();
        if (pair) {
          gm_mma_tile(p, x_lo, w_lo, words, wm, wn, gid, tig);
          gm_epilogue8(acc, p, sx_lo, sw_lo, wm, wn, gid, tig);
          if (n_g > 1) {
            gm_zero(p);
            gm_mma_tile(p, x_hi, w_hi, words, wm, wn, gid, tig);
            gm_epilogue8(acc, p, sx_hi, sw_hi, wm, wn, gid, tig);
          }
        } else {
          gm_mma_tile(p, x_lo, w_lo, words, wm, wn, gid, tig);
          gm_mma_tile(p, x_hi, w_hi, words, wm, wn, gid, tig);
        }
        __syncthreads();
      }
      if (!pair) {
        gm_epilogue8(acc, p, sx_lo, sw_lo, wm, wn, gid, tig);
        __syncthreads();  // the next unit rewrites sx_lo / sw_lo
      }
    }
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

struct GmmArgs {
  const void *xq, *xs, *w, *ws, *xsal, *wsal;
  void *out, *part;
  int N, O, kk, gs, k_s, x_rs, x_gs, s_rs, s_gs, gps, n_split;
};

template <bool NIBBLE, typename S, typename T>
int launch_gmm(const GmmArgs& a, cudaStream_t st) {
  dim3 grid((a.O + GM_BN - 1) / GM_BN, (a.N + GM_BM - 1) / GM_BM, a.n_split);
  gmm_kernel<NIBBLE, S, T><<<grid, GM_THREADS, 0, st>>>(
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

template <bool NIBBLE, typename T>
int dispatch_gmm(const GmmArgs& a, int s_dt, cudaStream_t st) {
  return s_dt == DT_BF16 ? launch_gmm<NIBBLE, __nv_bfloat16, T>(a, st)
                         : launch_gmm<NIBBLE, float, T>(a, st);
}

// Units of work along K: the nibble path's group pairs (G/2); the int8
// path's group pairs for groups of at most GM_MAX_GS channels, else its
// groups (one for G = 1).
int gm_units(bool nibble, int kk, int gs) {
  const int G = kk / gs;
  if (nibble) return G / 2;
  return (gs <= GM_MAX_GS && G > 1) ? (G + 1) / 2 : G;
}

// The split of the units, gps a split: enough blocks for ~6 per SM (132
// SMs; the 35.6 KB of shared memory a block allows 6) when the O- and
// N-tiles alone do not give them.  A block waits on each unit's loads
// before its mma (no pipeline yet), so blocks in flight are what hides the
// latency: at 2 a SM K5's first build read 13.7× its byte bound.
struct GmmPlan {
  int gps, n_split;
};

GmmPlan gmm_plan(int N, int O, int n_units) {
  const int tiles = ((O + GM_BN - 1) / GM_BN) * ((N + GM_BM - 1) / GM_BM);
  int splits = (GM_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > n_units ? n_units : splits);
  const int gps = (n_units + splits - 1) / splits;
  return {gps, (n_units + gps - 1) / gps};
}

}  // namespace
