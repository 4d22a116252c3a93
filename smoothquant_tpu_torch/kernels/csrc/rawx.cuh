// K1's device code (int4_group_matmul.cu), shared with K14 (mlp_fused.cu),
// which runs the same pre-pass and __dp4a main loop inside one cooperative
// launch.  The design notes live at the top of int4_group_matmul.cu.
//
//   rawx_prep_item  the pre-pass of one (token row, block of PREP_WARPS
//                   groups) item: optional RMSNorm or 0/1 mask, tail-mode
//                   salient split, per-(row, group) quantize; PREP_WARPS
//                   warps of a block together (it takes a block reduction);
//   rawx_main_warp  one warp's 32·RAWX_COLS output columns of one K-split
//                   (a range of group pairs, or SAL_ROWS salient rows),
//                   written as an f32 partial; warps are independent;
//   rawx_reduce_at  one output element: the salient partials, then the
//                   group partials in K order.
#pragma once

#include "group_quant.cuh"

namespace {

constexpr int RAWX_WARPS = 4;          // warps per K1 main-kernel block
constexpr int RAWX_COLS = 4;           // output columns per lane
constexpr int RAWX_MAX_N = 32;         // token rows the decode linear takes
constexpr int RAWX_CHUNK = 8;          // token rows one main-loop pass holds
constexpr int SAL_ROWS = 64;           // salient rows per K-split
constexpr int RAWX_PF = 4;             // 4-row steps loaded ahead per lane
constexpr int RAWX_TARGET_BLOCKS = 528;  // ~4 main-kernel blocks per SM (132 SMs)
constexpr int PREP_WARPS = 8;          // groups per pre-pass item
constexpr int RAWX_WARP_COLS = 32 * RAWX_COLS;

// The pre-pass item (n, y) of n_y = ceil(G / PREP_WARPS) + 1 per row: y <
// n_y − 1 quantizes groups y·PREP_WARPS .. (one warp a group, its values held
// in registers), y = n_y − 1 writes the salient activations.  Each item
// recomputes the row's RMSNorm factor (a C-long sum) rather than waiting on
// another for it.  Every thread of the block calls it with the same item.
template <typename T>
__device__ __forceinline__ void rawx_prep_item(
    int n, int y, int n_y, const T* __restrict__ x, const float* __restrict__ nw,
    const T* __restrict__ x_sal_ext, int8_t* __restrict__ xq, float* __restrict__ xs,
    int* __restrict__ xsum, float* __restrict__ xsal, int C, int kk, int gs, int k_ns_raw,
    int n_sal, int k_s, int mode, int need_mask, float eps, float inv_qmax,
    double* scratch) {
  const T* xr = x + (size_t)n * C;
  float r = 1.0f;
  if (mode == 1) r = row_rms_factor<T>(xr, C, eps, scratch);  // over the true C channels
  const int G = kk / gs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (y == n_y - 1) {  // the salient activations
    for (int j = threadIdx.x; j < k_s; j += blockDim.x) {
      float v = 0.0f;
      if (x_sal_ext != nullptr) {
        v = to_f<T>(x_sal_ext[(size_t)n * k_s + j]);
      } else if (j < n_sal) {
        const int col = k_ns_raw + j;
        v = to_f<T>(xr[col]);
        if (mode == 1) v = (v * r) * nw[col];
      }
      xsal[(size_t)n * k_s + j] = round_to<T>(v);
    }
    return;
  }
  const int g = y * PREP_WARPS + warp;
  if (g >= G) return;
  float yv[GQ_PER_LANE];
#pragma unroll
  for (int t = 0; t < GQ_PER_LANE; ++t) {
    const int i = lane + 32 * t;
    const int col = g * gs + i;
    float v = 0.0f;
    if (i < gs) {
      v = col < C ? to_f<T>(xr[col]) : 0.0f;
      if (mode == 1) v = (v * r) * (col < C ? nw[col] : 0.0f);
      else if (mode == 2) v = v * (col < C ? nw[col] : 0.0f);
      if (need_mask && col >= k_ns_raw) v = 0.0f;
    }
    yv[t] = v;
  }
  int q[GQ_PER_LANE];
  const float scale = warp_quantize_group(yv, inv_qmax, q);
  int s = 0;
#pragma unroll
  for (int t = 0; t < GQ_PER_LANE; ++t) {
    const int i = lane + 32 * t;
    if (i < gs) {
      xq[(size_t)n * kk + g * gs + i] = (int8_t)q[t];
      s += q[t];
    }
  }
  s = (int)warp_sum((float)s);  // |s| <= 127*gs: exact in f32
  if (lane == 0) {
    xs[(size_t)n * G + g] = scale;
    xsum[(size_t)n * G + g] = s;
  }
}

// one K-packed word per column from 4 row words (byte c of each row word)
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2,
                                           uint32_t w3, uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// One warp's share of the main loop: the lane's RAWX_COLS columns from
// col0, token rows n0 .. n0 + nr − 1 (nr <= NT), K-split `split` (group
// pairs split·gps .. below n_int_splits, else a SAL_ROWS-row slice of the
// salient block), written to its f32 partial.  Each lane loads the weight
// words of RAWX_PF 4-row steps before using any, so a warp keeps RAWX_PF·4
// row reads in flight.
template <int NT, typename S, typename T>
__device__ __forceinline__ void rawx_main_warp(
    int col0, int split, int n0, int nr, const int8_t* __restrict__ xq,
    const float* __restrict__ xs, const int* __restrict__ xsum, const float* __restrict__ xsal,
    const int8_t* __restrict__ w, const S* __restrict__ ws, const T* __restrict__ wsal,
    float* __restrict__ part, int N, int O, int kk, int gs, int k_s, int gps,
    int n_int_splits) {
  if (col0 >= O) return;
  xq += (size_t)n0 * kk;
  xs += (size_t)n0 * (kk / gs);
  xsum += (size_t)n0 * (kk / gs);
  xsal += (size_t)n0 * k_s;
  const int half = kk / 2;
  const int G = kk / gs;
  const int g_half = G / 2;
  float acc[NT][RAWX_COLS];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < RAWX_COLS; ++c) acc[n][c] = 0.0f;

  if (split < n_int_splits) {
    const int g_end = min(g_half, (split + 1) * gps);
    for (int g = split * gps; g < g_end; ++g) {
      int p_lo[NT][RAWX_COLS], p_hi[NT][RAWX_COLS];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < RAWX_COLS; ++c) p_lo[n][c] = p_hi[n][c] = 0;
      const int r0 = g * gs;
      for (int rb = 0; rb < gs; rb += 4 * RAWX_PF) {
        uint32_t wv[RAWX_PF][4];
#pragma unroll
        for (int u = 0; u < RAWX_PF; ++u) {
          const int8_t* wp = w + (size_t)(r0 + rb + 4 * u) * O + col0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wv[u][k] = rb + 4 * u < gs
                           ? __ldg(reinterpret_cast<const uint32_t*>(wp + k * (size_t)O))
                           : 0u;
        }
#pragma unroll
        for (int u = 0; u < RAWX_PF; ++u) {
          const int rr = rb + 4 * u;
          if (rr >= gs) break;
          uint32_t cw[4];
          transpose4(wv[u][0], wv[u][1], wv[u][2], wv[u][3], cw);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n >= nr) break;
            const int xlo = __ldg(reinterpret_cast<const int*>(xq + (size_t)n * kk + r0 + rr));
            const int xhi =
                __ldg(reinterpret_cast<const int*>(xq + (size_t)n * kk + half + r0 + rr));
#pragma unroll
            for (int c = 0; c < RAWX_COLS; ++c) {
              p_lo[n][c] = __dp4a((int)(cw[c] & 0x0F0F0F0Fu), xlo, p_lo[n][c]);
              p_hi[n][c] = __dp4a((int)((cw[c] >> 4) & 0x0F0F0F0Fu), xhi, p_hi[n][c]);
            }
          }
        }
      }
      float ws_lo[RAWX_COLS], ws_hi[RAWX_COLS];
#pragma unroll
      for (int c = 0; c < RAWX_COLS; ++c) {
        ws_lo[c] = to_f<S>(ws[(size_t)g * O + col0 + c]);
        ws_hi[c] = to_f<S>(ws[(size_t)(g + g_half) * O + col0 + c]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nr) break;
        const float sx_lo = xs[(size_t)n * G + g];
        const float sx_hi = xs[(size_t)n * G + g + g_half];
        const int s_lo = xsum[(size_t)n * G + g];
        const int s_hi = xsum[(size_t)n * G + g + g_half];
#pragma unroll
        for (int c = 0; c < RAWX_COLS; ++c) {
          acc[n][c] += ((float)(p_lo[n][c] - 8 * s_lo) * sx_lo) * ws_lo[c];
          acc[n][c] += ((float)(p_hi[n][c] - 8 * s_hi) * sx_hi) * ws_hi[c];
        }
      }
    }
  } else {  // a SAL_ROWS-row slice of the salient fp block, RAWX_PF·2 rows a load round
    const int j0 = (split - n_int_splits) * SAL_ROWS;
    const int j1 = min(k_s, j0 + SAL_ROWS);
    constexpr int JB = 2 * RAWX_PF;
    for (int jb = j0; jb < j1; jb += JB) {
      float wv[JB][RAWX_COLS];
#pragma unroll
      for (int u = 0; u < JB; ++u)
#pragma unroll
        for (int c = 0; c < RAWX_COLS; ++c)
          wv[u][c] = jb + u < j1 ? to_f<T>(wsal[(size_t)(jb + u) * O + col0 + c]) : 0.0f;
#pragma unroll
      for (int u = 0; u < JB; ++u) {
        if (jb + u >= j1) break;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= nr) break;
          const float xv = xsal[(size_t)n * k_s + jb + u];
#pragma unroll
          for (int c = 0; c < RAWX_COLS; ++c) acc[n][c] = fmaf(xv, wv[u][c], acc[n][c]);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= nr) break;
    float* dst = part + ((size_t)split * N + n0 + n) * O + col0;
#pragma unroll
    for (int c = 0; c < RAWX_COLS; ++c) dst[c] = acc[n][c];
  }
}

// Element i of the (N, O) output from the partials of n_int_splits group
// splits and n_sal_splits salient splits: salient first, then K order.  The
// loads of RAWX_RED splits are issued before their adds (in that order).
constexpr int RAWX_RED = 8;

__device__ __forceinline__ float rawx_reduce_at(const float* __restrict__ part, size_t NO,
                                                size_t i, int n_int_splits, int n_sal_splits) {
  const int n = n_int_splits + n_sal_splits;
  float acc = 0.0f;
  for (int k0 = 0; k0 < n; k0 += RAWX_RED) {
    float v[RAWX_RED];
#pragma unroll
    for (int u = 0; u < RAWX_RED; ++u) {
      const int k = k0 + u;
      const int s = k < n_sal_splits ? n_int_splits + k : k - n_sal_splits;
      v[u] = k < n ? part[(size_t)s * NO + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < RAWX_RED; ++u)
      if (k0 + u < n) acc += v[u];
  }
  return acc;
}

// Rows a main-loop pass holds (4, or RAWX_CHUNK above 4) and their chunks.
int rawx_nt(int N) { return N <= 4 ? 4 : RAWX_CHUNK; }
int rawx_chunks(int N) { return (N + rawx_nt(N) - 1) / rawx_nt(N); }

// K1's split of the work and its workspace (int8 codes | f32 group scales |
// int32 code sums | f32 salient activations | f32 partials, 256-B aligned).
struct RawxPlan {
  int gps, n_int, n_sal;
  size_t xq, xs, xsum, xsal, part, bytes;
};

// The workspace of one linear whose group pairs are split `splits` ways
// (at most; whole pairs a split) besides its SAL_ROWS-row salient splits.
RawxPlan rawx_layout(int N, int O, int kk, int gs, int k_s, int splits) {
  RawxPlan p;
  const int g_half = kk / gs / 2;
  splits = splits < 1 ? 1 : splits;
  p.gps = (g_half + splits - 1) / splits > 1 ? (g_half + splits - 1) / splits : 1;
  p.n_int = (g_half + p.gps - 1) / p.gps;
  p.n_sal = (k_s + SAL_ROWS - 1) / SAL_ROWS;
  const size_t G = (size_t)(kk / gs);
  auto up = [](size_t v) { return (v + 255) & ~(size_t)255; };
  size_t off = 0;
  p.xq = off;   off = up(off + (size_t)N * kk);
  p.xs = off;   off = up(off + (size_t)N * G * sizeof(float));
  p.xsum = off; off = up(off + (size_t)N * G * sizeof(int));
  p.xsal = off; off = up(off + (size_t)N * k_s * sizeof(float));
  p.part = off; off = up(off + (size_t)(p.n_int + p.n_sal) * N * O * sizeof(float));
  p.bytes = off;
  return p;
}

// K1's split: about RAWX_TARGET_BLOCKS main-kernel blocks.
RawxPlan rawx_plan(int N, int O, int kk, int gs, int k_s) {
  const int cols_per_block = RAWX_WARPS * RAWX_WARP_COLS;
  const int o_blocks = (O + cols_per_block - 1) / cols_per_block * rawx_chunks(N);
  int splits = RAWX_TARGET_BLOCKS / o_blocks > 1 ? RAWX_TARGET_BLOCKS / o_blocks : 1;
  // the f32 partials grow with N: above 8 rows keep their bytes (written
  // and read once) under about half the weight's
  const int cap = kk / (16 * N) > 2 ? kk / (16 * N) : 2;
  if (N > RAWX_CHUNK && splits > cap) splits = cap;
  return rawx_layout(N, O, kk, gs, k_s, splits);
}

}  // namespace
