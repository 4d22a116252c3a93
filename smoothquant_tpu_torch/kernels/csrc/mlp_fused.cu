// K14: the fused SwiGLU MLP of one decode layer, in one of two bodies.
//
// The stream body (sq_mlp_stream, every bf16 call of 1-8 rows at group size
// 16 / 32 / 64 with O % 16 == 0: each fuse_mlp site of the paths) is two
// launches of the weight-streaming body (stream_gmm.cuh) and no grid
// barrier:
//   1. gate_up on K1's raw-x kind with a paired column map
//      (stream_swiglu_kernel: block tile t takes gate columns 64t .. and up
//      columns inter + 64t ..), the RMSNorm and the per-group quantize
//      folded in as K1's are; its epilogue sums gate and up over the
//      cluster's ranks, takes SiLU(gate)·up in f32 and quantizes each of
//      down's input groups of the tile into row-major codes, scales and the
//      bf16 salient block — the f32 SwiGLU never reaches device memory;
//   2. down on K5's stream kind over those codes (stream_gmm_kernel),
//      launched as a programmatic dependent of launch 1: its
//      producer issues its first weight stages, which launch 1 does not
//      write, before griddepcontrol.wait, so the ring's first fill overlaps
//      launch 1's tail.
// Bound: both linears' nibbles, scales and salient blocks (the codes
// between the launches are N·(K2 + 4·G2 + 2·k_s2) bytes, under 0.1 % of
// them); the design spends two launches where the cooperative body spent
// one launch, five grid barriers and K1's old __ldg / dp4a warp body.
//
// The cooperative body (sq_mlp_fused below: f32 x, group size 128, and any
// call forced onto it) stays as it was:
//
// Replaces smoothquant_tpu/kernels/mlp_fused.py mlp_swiglu_fused_stacked
// (pallas_call at :534): (RMSNorm) + gate_up int4 group matmul + SiLU(gate)
// · up in f32 + group requantize + down_proj int4 group matmul, N <= 8 token
// rows, on layer i of stacked nibble packs with the layout contract of
// mlp_fused.py:22-28 (gate_up rows pre-permuted into down's packed channel
// order, fused [gate | up] columns split at the true intermediate size,
// down's salient channels last).
//
// The TPU kernel keeps gate_up's output in VMEM slabs; at Llama-2-7B width
// that is 8 × 22528 f32 = 0.72 MB, more than one SM's shared memory, and
// down_proj needs all of it.  So this is one cooperative launch of
// co-resident blocks (cudaLaunchCooperativeKernel, the grid sized by the
// occupancy calculator) that walks six phases, a grid-wide barrier
// (cooperative_groups::this_grid().sync()) between each two, with the
// intermediates in a global (L2-resident) workspace:
//   1. gate_up's pre-pass items: RMSNorm, salient split, per-group quantize
//      (K1's rawx_prep_item, rawx.cuh);
//   2. gate_up's main loop: each warp takes (32·RAWX_COLS columns, K-split)
//      items of K1's rawx_main_warp into f32 partials;
//   3. one thread an element of the true intermediate width: gate and up
//      summed from the partials in K1's fixed order (salient splits, then K
//      order; the loads of both issued ahead together), SiLU·up in f32;
//   4. per (row, group of down's input) that group quantized
//      (group_quant.cuh), channels at or past down's non-salient width
//      masked to 0; one item per row writes the salient channels rounded to
//      the compute dtype;
//   5. down's main loop, as phase 2;
//   6. down's partials reduced in the same fixed order, cast to the output.
// Both main loops split K for the grid's warps (mlp_splits), not as K1
// splits it for separate launches (which left gate_up a quarter-full
// second round of items at 4 rows).
// Each intermediate of the workspace is written in one phase and read only
// after the next barrier, and no block touches it before it is written, so
// the later phases may read it through the read-only cache path K1's code
// takes (no block can hold a stale line of it).
// No sum takes atomics, so the order is fixed and the kernel holds to its
// plain version (K1's plain version, silu·up, K1's plain version) at f32
// rounding.  Bound: the bytes of both layers' nibbles, group scales and
// salient blocks, as K1's two launches; the design spends one launch and
// five barriers where the unfused pair spends six launches and the torch
// ops between them.
#include <cooperative_groups.h>

#include "rawx.cuh"
#include "stream_gmm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MLP_WARPS = PREP_WARPS;   // the pre-pass items take 8 warps
constexpr int MLP_THREADS = 32 * MLP_WARPS;
constexpr int MLP_MAX_N = RAWX_CHUNK;   // token rows (one main-loop pass)

struct MlpArgs {
  const void *x, *nw, *w1, *ws1, *wsal1, *w2, *ws2, *wsal2;
  void *workspace, *out;
  int N, C, O1, kk1, k_ns1_raw, n_sal1, k_s1, inter, O2, kk2, k_ns2_raw, n_sal2, k_s2, gs;
  int mode, need_mask1;
  float eps, inv_qmax;
};

struct MlpPlan {
  RawxPlan p1, p2;
  size_t off2, off_h, bytes;
};

// The K-split of one linear for n_warps warps taking its (column slice,
// K-split) items in static rounds: the number of group pairs an item takes
// that minimises rounds × the heaviest item (a salient split of SAL_ROWS
// bf16 rows reads as many bytes as 2·SAL_ROWS/gs group pairs), the larger
// on a tie (fewer partials).  Returns the group splits.
int mlp_splits(int O, int kk, int gs, int k_s, int n_warps) {
  const int wc = (O + RAWX_WARP_COLS - 1) / RAWX_WARP_COLS;
  const int g_half = kk / gs / 2, n_sal = (k_s + SAL_ROWS - 1) / SAL_ROWS;
  const int sal_cost = k_s ? 2 * SAL_ROWS / gs : 0;
  long best = -1;
  int best_gps = 1;
  for (int gps = 1; gps <= g_half; ++gps) {
    const long items = (long)wc * ((g_half + gps - 1) / gps + n_sal);
    const long cost = (items + n_warps - 1) / n_warps * (gps > sal_cost ? gps : sal_cost);
    if (best < 0 || cost <= best) {
      best = cost;
      best_gps = gps;
    }
  }
  return (g_half + best_gps - 1) / best_gps;
}

// The workspace: gate_up's and down's K1 workspaces, then SiLU·up (N, inter)
MlpPlan mlp_plan(int N, int O1, int kk1, int k_s1, int inter, int O2, int kk2, int k_s2,
                 int gs, int n_warps) {
  MlpPlan m;
  m.p1 = rawx_layout(N, O1, kk1, gs, k_s1, mlp_splits(O1, kk1, gs, k_s1, n_warps));
  m.p2 = rawx_layout(N, O2, kk2, gs, k_s2, mlp_splits(O2, kk2, gs, k_s2, n_warps));
  m.off2 = m.p1.bytes;
  m.off_h = m.off2 + m.p2.bytes;
  m.bytes = m.off_h + (size_t)N * inter * sizeof(float);
  return m;
}

// SiLU(gate)·up of one element, gate and up summed from the partials as
// rawx_reduce_at sums them, the loads of both issued RAWX_RED splits ahead
__device__ __forceinline__ float swiglu_at(const float* __restrict__ part, size_t NO,
                                           size_t ig, size_t iu, int n_int, int n_sal) {
  const int n = n_int + n_sal;
  float g = 0.0f, u = 0.0f;
  for (int k0 = 0; k0 < n; k0 += RAWX_RED) {
    float vg[RAWX_RED], vu[RAWX_RED];
#pragma unroll
    for (int j = 0; j < RAWX_RED; ++j) {
      const int k = k0 + j;
      const size_t s = (size_t)(k < n_sal ? n_int + k : k - n_sal) * NO;
      vg[j] = k < n ? part[s + ig] : 0.0f;
      vu[j] = k < n ? part[s + iu] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < RAWX_RED; ++j)
      if (k0 + j < n) {
        g += vg[j];
        u += vu[j];
      }
  }
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))), u);
}

template <int NT, typename S, typename T>
__global__ void __launch_bounds__(MLP_THREADS)
mlp_fused_kernel(MlpArgs a, RawxPlan p1, RawxPlan p2, size_t off2, size_t off_h) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double scratch[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * MLP_WARPS + warp, n_gw = gridDim.x * MLP_WARPS;
  const int N = a.N, gs = a.gs;
  char* w1base = static_cast<char*>(a.workspace);
  char* w2base = w1base + off2;
  int8_t* xq1 = (int8_t*)(w1base + p1.xq);
  float* xs1 = (float*)(w1base + p1.xs);
  int* xsum1 = (int*)(w1base + p1.xsum);
  float* xsal1 = (float*)(w1base + p1.xsal);
  float* part1 = (float*)(w1base + p1.part);
  int8_t* xq2 = (int8_t*)(w2base + p2.xq);
  float* xs2 = (float*)(w2base + p2.xs);
  int* xsum2 = (int*)(w2base + p2.xsum);
  float* xsal2 = (float*)(w2base + p2.xsal);
  float* part2 = (float*)(w2base + p2.part);
  float* h = (float*)(w1base + off_h);

  // 1. gate_up's pre-pass
  const int G1 = a.kk1 / gs;
  const int n_y = (G1 + PREP_WARPS - 1) / PREP_WARPS + 1;
  for (int it = blockIdx.x; it < N * n_y; it += gridDim.x)
    rawx_prep_item<T>(it / n_y, it % n_y, n_y, (const T*)a.x, (const float*)a.nw, nullptr,
                      xq1, xs1, xsum1, xsal1, a.C, a.kk1, gs, a.k_ns1_raw, a.n_sal1, a.k_s1,
                      a.mode, a.need_mask1, a.eps, a.inv_qmax, scratch);
  grid.sync();

  // 2. gate_up's main loop
  const int wc1 = (a.O1 + RAWX_WARP_COLS - 1) / RAWX_WARP_COLS;
  for (int it = gw; it < wc1 * (p1.n_int + p1.n_sal); it += n_gw)
    rawx_main_warp<NT, S, T>((it % wc1) * RAWX_WARP_COLS + lane * RAWX_COLS, it / wc1, 0, N,
                             xq1, xs1, xsum1, xsal1, (const int8_t*)a.w1, (const S*)a.ws1,
                             (const T*)a.wsal1, part1, N, a.O1, a.kk1, gs, a.k_s1, p1.gps,
                             p1.n_int);
  grid.sync();

  // 3. SiLU(gate)·up over the true intermediate width
  const size_t NO1 = (size_t)N * a.O1, NH = (size_t)N * a.inter;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < NH;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t i = (e / a.inter) * a.O1 + e % a.inter;
    h[e] = swiglu_at(part1, NO1, i, i + a.inter, p1.n_int, p1.n_sal);
  }
  grid.sync();

  // 4. down's input quantized per group; item G2 of a row writes its
  //    salient channels
  const int G2 = a.kk2 / gs;
  for (int it = gw; it < N * (G2 + 1); it += n_gw) {
    const int n = it / (G2 + 1), g = it % (G2 + 1);
    const float* hr = h + (size_t)n * a.inter;
    if (g == G2) {
      for (int j = lane; j < a.k_s2; j += 32)
        xsal2[(size_t)n * a.k_s2 + j] = j < a.n_sal2 ? round_to<T>(hr[a.k_ns2_raw + j]) : 0.0f;
      continue;
    }
    float y[GQ_PER_LANE];
#pragma unroll
    for (int t = 0; t < GQ_PER_LANE; ++t) {
      const int i = lane + 32 * t, col = g * gs + i;
      y[t] = i < gs && col < a.k_ns2_raw ? hr[col] : 0.0f;
    }
    int q[GQ_PER_LANE];
    const float scale = warp_quantize_group(y, a.inv_qmax, q);
    int s = 0;
#pragma unroll
    for (int t = 0; t < GQ_PER_LANE; ++t) {
      const int i = lane + 32 * t;
      if (i < gs) {
        xq2[(size_t)n * a.kk2 + g * gs + i] = (int8_t)q[t];
        s += q[t];
      }
    }
    s = (int)warp_sum((float)s);  // |s| <= 127*gs: exact in f32
    if (lane == 0) {
      xs2[(size_t)n * G2 + g] = scale;
      xsum2[(size_t)n * G2 + g] = s;
    }
  }
  grid.sync();

  // 5. down's main loop
  const int wc2 = (a.O2 + RAWX_WARP_COLS - 1) / RAWX_WARP_COLS;
  for (int it = gw; it < wc2 * (p2.n_int + p2.n_sal); it += n_gw)
    rawx_main_warp<NT, S, T>((it % wc2) * RAWX_WARP_COLS + lane * RAWX_COLS, it / wc2, 0, N,
                             xq2, xs2, xsum2, xsal2, (const int8_t*)a.w2, (const S*)a.ws2,
                             (const T*)a.wsal2, part2, N, a.O2, a.kk2, gs, a.k_s2, p2.gps,
                             p2.n_int);
  grid.sync();

  // 6. down's fixed-order reduce
  const size_t NO2 = (size_t)N * a.O2;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < NO2;
       i += (size_t)gridDim.x * blockDim.x)
    ((T*)a.out)[i] = from_f<T>(rawx_reduce_at(part2, NO2, i, p2.n_int, p2.n_sal));
}

// The cooperative grid: as many blocks as the SMs hold at once (0 when the
// device cannot launch cooperatively).
template <int NT, typename S, typename T>
int mlp_grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_fused_kernel<NT, S, T>,
                                                      MLP_THREADS, 0);
  *blocks = coop ? per_sm * sms : 0;
  return (int)e;
}

template <int NT, typename S, typename T>
int launch_mlp(const MlpArgs& a, const MlpPlan& m, int blocks, cudaStream_t st) {
  MlpArgs args = a;
  RawxPlan p1 = m.p1, p2 = m.p2;
  size_t off2 = m.off2, off_h = m.off_h;
  void* params[] = {&args, &p1, &p2, &off2, &off_h};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)mlp_fused_kernel<NT, S, T>, dim3(blocks), dim3(MLP_THREADS), params, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cooperative grid at N token rows (s_dt, x_dt as sq_mlp_fused's).
int mlp_blocks(int N, int s_dt, int x_dt) {
  using bf16 = __nv_bfloat16;
  int blocks = 0;
  switch ((N <= 4 ? 0 : 4) + (s_dt == DT_BF16 ? 2 : 0) + (x_dt == DT_BF16 ? 1 : 0)) {
    case 0: mlp_grid_blocks<4, float, float>(&blocks); break;
    case 1: mlp_grid_blocks<4, float, bf16>(&blocks); break;
    case 2: mlp_grid_blocks<4, bf16, float>(&blocks); break;
    case 3: mlp_grid_blocks<4, bf16, bf16>(&blocks); break;
    case 4: mlp_grid_blocks<RAWX_CHUNK, float, float>(&blocks); break;
    case 5: mlp_grid_blocks<RAWX_CHUNK, float, bf16>(&blocks); break;
    case 6: mlp_grid_blocks<RAWX_CHUNK, bf16, float>(&blocks); break;
    default: mlp_grid_blocks<RAWX_CHUNK, bf16, bf16>(&blocks); break;
  }
  return blocks;
}

template <typename T>
int by_scale(int s_dt, const MlpArgs& a, const MlpPlan& m, int blocks, cudaStream_t st) {
  if (a.N <= 4)
    return s_dt == DT_BF16 ? launch_mlp<4, __nv_bfloat16, T>(a, m, blocks, st)
                           : launch_mlp<4, float, T>(a, m, blocks, st);
  return s_dt == DT_BF16 ? launch_mlp<RAWX_CHUNK, __nv_bfloat16, T>(a, m, blocks, st)
                         : launch_mlp<RAWX_CHUNK, float, T>(a, m, blocks, st);
}

}  // namespace

// Blocks of the cooperative grid at N token rows (s_dt, x_dt as below).
SQ_EXPORT int sq_mlp_fused_grid_blocks(int N, int s_dt, int x_dt) {
  return mlp_blocks(N, s_dt, x_dt);
}

// Bytes of device workspace sq_mlp_fused needs for these shapes.
SQ_EXPORT long long sq_mlp_fused_workspace_bytes(int N, int O1, int kk1, int k_s1, int inter,
                                                 int O2, int kk2, int k_s2, int gs, int s_dt,
                                                 int x_dt) {
  return (long long)mlp_plan(N, O1, kk1, k_s1, inter, O2, kk2, k_s2, gs,
                             mlp_blocks(N, s_dt, x_dt) * MLP_WARPS).bytes;
}

// K14: x (N, C) in the compute dtype (x_dt), nw the (C,) f32 RMSNorm row or
// null (mode 1 / 0); w1 / ws1 / wsal1 gate_up's layer (kk1/2, O1) nibble
// bytes, (kk1/gs, O1) scales (s_dt) and (k_s1, O1) salient block (x_dt);
// w2 / ws2 / wsal2 down's; out (N, O2) in x_dt.
SQ_EXPORT int sq_mlp_fused(const void* x, const void* nw, const void* w1, const void* ws1,
                           const void* wsal1, const void* w2, const void* ws2,
                           const void* wsal2, void* workspace, void* out, int N, int C, int O1,
                           int kk1, int n_sal1, int k_s1, int inter, int O2, int kk2,
                           int n_sal2, int k_s2, int gs, int mode, float eps, float inv_qmax,
                           int s_dt, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || N > MLP_MAX_N || gs > 32 * GQ_PER_LANE || gs % 4 || O1 % 4 || O2 % 4 ||
      2 * inter > O1 || kk2 < inter - n_sal2)
    return (int)cudaErrorInvalidValue;
  const int blocks = mlp_blocks(N, s_dt, x_dt);
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const MlpPlan m = mlp_plan(N, O1, kk1, k_s1, inter, O2, kk2, k_s2, gs, blocks * MLP_WARPS);
  const int k_ns1_raw = C - n_sal1;
  const MlpArgs a{x, nw, w1, ws1, wsal1, w2, ws2, wsal2, workspace, out,
                  N, C, O1, kk1, k_ns1_raw, n_sal1, k_s1, inter, O2, kk2, inter - n_sal2,
                  n_sal2, k_s2, gs, mode, kk1 > k_ns1_raw ? 1 : 0, eps, inv_qmax};
  return x_dt == DT_BF16 ? by_scale<__nv_bfloat16>(s_dt, a, m, blocks, st)
                         : by_scale<float>(s_dt, a, m, blocks, st);
}

namespace {

// launch 2: K5's stream kind over launch 1's codes (N <= 8: one n8 tile)
template <int GS, typename S>
int mlp_down(SgArgs& a, SgMaps& m, const void* xq, int kk, cudaStream_t st) {
  if (!wg_map(&m.x, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kk, a.N, kk, GS, 8, sg_swizzle<GS>()))
    return (int)cudaErrorInvalidValue;
  return sg_launch<true, GS, 1, S>(a, m, st);
}

template <typename S>
int mlp_down_gs(SgArgs& a, SgMaps& m, const void* xq, int kk, int gs, cudaStream_t st) {
  return gs == 16 ? mlp_down<16, S>(a, m, xq, kk, st)
         : gs == 32 ? mlp_down<32, S>(a, m, xq, kk, st)
                    : mlp_down<64, S>(a, m, xq, kk, st);
}

}  // namespace

// K14, stream body.  x (N, C) bf16 (1-8 rows, C a multiple of 8), nw the
// (C,) f32 RMSNorm row (mode 1) or null (mode 0); w1 / ws1 / wsal1
// gate_up's layer: (kk1/2, O1) nibble bytes, (kk1/gs, O1) scales (s_dt),
// (k_s1, O1) bf16 salient block; w2 / ws2 / wsal2 down's; xq2 (N, kk2) int8,
// xs2 (N, kk2/gs) f32 and xsal2 (N, xsal_rs) bf16 the codes between the
// launches (xsal2 null when k_s2 = 0); out (N, O2) bf16.  Group size 16, 32
// or 64, O1, O2 and inter multiples of 16 (the up halves' boxes start at
// column inter + 64t: 16-byte aligned), every pointer 16-byte aligned (TMA);
// split1 / split2 the ranks of each launch's K split (stream_gmm.k1_split,
// stream_gmm.split).  Down is launched as a programmatic dependent of
// gate_up (scripts/mlp_variants.py times it unchained, and each launch
// alone, by editing this entry).
SQ_EXPORT int sq_mlp_stream(const void* x, const void* nw, const void* w1, const void* ws1,
                            const void* wsal1, const void* w2, const void* ws2,
                            const void* wsal2, void* xq2, void* xs2, void* xsal2, void* out,
                            int N, int C, int O1, int kk1, int n_sal1, int k_s1, int inter,
                            int O2, int kk2, int n_sal2, int k_s2, int xsal_rs, int gs, int mode,
                            float eps, float inv_c, float inv_qmax, int s_dt, int split1,
                            int split2, void* stream) {
  const auto split_ok = [](int s, int stages) {
    return (s == 1 || s == 2 || s == 4 || s == 8) && stages >= s;
  };
  const int G1 = kk1 / gs, G2 = kk2 / gs, k_ns2_raw = inter - n_sal2;
  const int st1 = (k_s1 + 31) / 32 + G1 / 2, st2 = (k_s2 + 31) / 32 + G2 / 2;
  if ((gs != 16 && gs != 32 && gs != 64) || N < 1 || N > 8 || C < 8 || C % 8 || O1 < 16 ||
      O1 % 16 || O2 < 16 || O2 % 16 || kk1 < 2 * gs || kk1 % (2 * gs) || kk2 < 2 * gs ||
      kk2 % (2 * gs) || inter < 16 || inter % 16 || 2 * inter > O1 || k_ns2_raw < 0 ||
      kk2 < k_ns2_raw ||
      n_sal2 > k_s2 || xsal_rs < k_s2 || xsal_rs % 8 || (mode != 0 && mode != 1) ||
      (mode != 0) != (nw != nullptr) || (k_s2 > 0) != (xsal2 != nullptr) ||
      !split_ok(split1, st1) || !split_ok(split2, st2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int s_bf16 = s_dt == DT_BF16;
  const CUtensorMapDataType sdt =
      s_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  {  // launch 1: gate_up, SiLU·up and down's codes
    const int n_tiles = (inter + 63) / 64;
    int c_end = 64 * n_tiles;
    const int c_codes = (kk2 + 63) / 64 * 64, c_sal = (k_ns2_raw + xsal_rs + 63) / 64 * 64;
    if (c_codes > c_end) c_end = c_codes;
    if (k_s2 > 0 && c_sal > c_end) c_end = c_sal;
    const int k_ns1_raw = C - n_sal1;
    const SrArgs a{(const __nv_bfloat16*)x, (const float*)nw, nullptr, nullptr,
                   N, C, SG_BO * n_tiles, G1, k_ns1_raw, n_sal1, k_s1, mode,
                   kk1 > k_ns1_raw ? 1 : 0, eps, inv_c, inv_qmax, (k_s1 + 31) / 32, G1 / 2,
                   split1};
    const SwArgs w{(int8_t*)xq2, (float*)xs2, (__nv_bfloat16*)xsal2, inter, kk2, G2, k_ns2_raw,
                   xsal_rs, n_tiles, c_end};
    SrMaps m = {};
    if (!wg_map(&m.w, w1, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O1, kk1 / 2, O1, 64, gs,
                CU_TENSOR_MAP_SWIZZLE_64B, SG_W_PROMO) ||
        !wg_map(&m.ws, ws1, sdt, s_bf16 ? 2 : 4, O1, G1, O1, 64, 1, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        (k_s1 > 0 && !wg_map(&m.wsal, wsal1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O1, k_s1, O1,
                             64, 32, CU_TENSOR_MAP_SWIZZLE_128B, SG_W_PROMO)) ||
        !wg_map(&m.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C, N, C, gs, 8,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
        (mode != 0 && !wg_map(&m.nw, nw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, C, 1, C, gs, 1,
                              CU_TENSOR_MAP_SWIZZLE_NONE)))
      return (int)cudaErrorInvalidValue;
    const int e = s_bf16 ? sw_dispatch<__nv_bfloat16>(a, w, m, gs, st)
                         : sw_dispatch<float>(a, w, m, gs, st);
    if (e != 0) return e;
  }
  {  // launch 2: down over the codes, behind launch 1
    SgArgs a{(const float*)xs2, xsal2, wsal2, out, N, O2, G2, k_s2, xsal_rs, G2, 1, gs, 0,
             kk2 / 2, 0, (k_s2 + 31) / 32, G2 / 2, split2, s_bf16, 1, /*pdl=*/1};
    SgMaps m = {};
    if (!sg_weight_map(&m.w, w2, O2, kk2 / 2, gs) ||
        !sg_common_maps(m, ws2, xsal2, wsal2, s_bf16, N, O2, G2, k_s2, xsal_rs, 8, 32, 1))
      return (int)cudaErrorInvalidValue;
    const int e = s_bf16 ? mlp_down_gs<__nv_bfloat16>(a, m, xq2, kk2, gs, st)
                         : mlp_down_gs<float>(a, m, xq2, kk2, gs, st);
    if (e != 0) return e;
  }
  return 0;
}
