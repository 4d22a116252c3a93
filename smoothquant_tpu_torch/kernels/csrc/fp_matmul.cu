// Stacked bf16 / f32 decode matmul (K13): out = x · W[layer], f32 sums.
//
// Replaces smoothquant_tpu/kernels/fp_matmul.py fp_matmul_stacked
// (pallas_call at :77), the linear of the unquantized (bf16 baseline)
// decode.  At decode N (<= 8 rows) it reads each weight element once for
// 2·N flops, so the weight bytes bound it (405 MB per Llama-2-7B layer in
// bf16, 0.12 ms at 3.35 TB/s).  The wrapper hands the layer's slab of the
// (L, K, O) stack by pointer — nothing is copied.  Two bodies, picked by
// shape alone (fp_matmul.py fp_body):
//   * bf16 x (every bf16 decode step): the weight-streaming body's bf16
//     kind (stream_gmm.cuh stream_bf16_kernel) — a TMA ring of 64- or
//     32-row stages on mbarriers, the slab's columns the M side of mma
//     m16n8k16 by ldmatrix.trans, K split over a cluster and reduced in
//     rank order through distributed shared memory: one launch, no partial
//     through device memory.  Its loads alone take its whole time at the
//     large sites (scripts/stream_variants.py k13_loads_only; PERF.md §6);
//   * f32 x, the __ldg body, in two launches:
//   * fp_matmul_kernel: a block covers 256 columns and one K-split; it
//     first stages its slice of x in shared memory as f32 (a row's FMAs
//     would otherwise wait on N global loads of x); each lane loads 16
//     bytes (8 bf16 columns) of a weight row and accumulates all N rows in
//     f32 registers; its loads run in groups of FM_UNROLL rows held in two
//     register buffers, so one group's loads are in flight while the
//     other's FMAs run; the 8 warps take interleaved rows and are summed
//     in warp order through shared memory into an f32 partial per split;
//   * fp_reduce_kernel adds the splits in order and casts to the output
//     dtype.
#include "stream_gmm.cuh"

namespace {

constexpr int FM_COLS = 8;       // columns per lane
constexpr int FM_WARPS = 8;      // row groups per block
constexpr int FM_BLOCK_COLS = 32 * FM_COLS;
constexpr int FM_UNROLL = 4;     // rows per load group (two groups in flight)
constexpr int FM_MAX_N = 8;
constexpr int FM_TARGET_BLOCKS = 264;  // ~2 blocks per SM (132 SMs)
constexpr int FM_X_BYTES = 32 * 1024;  // the staged x slice (rows · NT · 4 bytes) at most:
                                       // with `red` it stays under the 48 KB default

// 8 consecutive columns of one weight row, raw (16 bytes of bf16, 32 of f32)
template <typename T>
struct Row8 {
  uint4 v[sizeof(T) * FM_COLS / 16];
};

template <typename T>
__device__ __forceinline__ void load_row(Row8<T>& r, const T* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(r.v) / 16); ++i)
    r.v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

template <typename T, int NT>
__global__ void __launch_bounds__(32 * FM_WARPS)
fp_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ part, int N,
                 int K, int O, int rows_per_split) {
  __shared__ float red[FM_WARPS][FM_BLOCK_COLS];
  extern __shared__ float xs[];  // (k_hi - k_lo, NT): this split's x, f32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * FM_BLOCK_COLS + lane * FM_COLS;
  const int k_lo = blockIdx.y * rows_per_split;
  const int k_hi = min(K, k_lo + rows_per_split);
  for (int e = threadIdx.x; e < (k_hi - k_lo) * NT; e += blockDim.x) {
    const int k = k_lo + e / NT, n = e % NT;
    xs[e] = n < N ? to_f<T>(x[(size_t)n * K + k]) : 0.0f;
  }
  __syncthreads();
  // this warp's rows: k_lo + warp + FM_WARPS·j, j < n_j
  const int n_j = k_hi - k_lo - warp > 0 ? (k_hi - k_lo - warp + FM_WARPS - 1) / FM_WARPS : 0;
  float acc[NT][FM_COLS];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < FM_COLS; ++c) acc[n][c] = 0.0f;

  auto load_group = [&](Row8<T> (&r)[FM_UNROLL], int j0) {
#pragma unroll
    for (int u = 0; u < FM_UNROLL; ++u)
      if (j0 + u < n_j) load_row<T>(r[u], w + (size_t)(k_lo + warp + FM_WARPS * (j0 + u)) * O + col0);
  };
  auto fma_group = [&](const Row8<T> (&r)[FM_UNROLL], int j0) {
#pragma unroll
    for (int u = 0; u < FM_UNROLL; ++u) {
      if (j0 + u >= n_j) break;
      const float* xk = xs + (warp + FM_WARPS * (j0 + u)) * NT;
      const T* e = reinterpret_cast<const T*>(r[u].v);
      float wv[FM_COLS];
#pragma unroll
      for (int c = 0; c < FM_COLS; ++c) wv[c] = to_f<T>(e[c]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= N) break;
        const float xv = xk[n];
#pragma unroll
        for (int c = 0; c < FM_COLS; ++c) acc[n][c] = fmaf(xv, wv[c], acc[n][c]);
      }
    }
  };

  // two register buffers of FM_UNROLL rows: the next group's loads are in
  // flight while the current group's FMAs run
  if (col0 < O && n_j > 0) {
    Row8<T> a[FM_UNROLL], b[FM_UNROLL];
    load_group(a, 0);
    for (int j0 = 0;;) {
      if (j0 + FM_UNROLL < n_j) load_group(b, j0 + FM_UNROLL);
      fma_group(a, j0);
      j0 += FM_UNROLL;
      if (j0 >= n_j) break;
      if (j0 + FM_UNROLL < n_j) load_group(a, j0 + FM_UNROLL);
      fma_group(b, j0);
      j0 += FM_UNROLL;
      if (j0 >= n_j) break;
    }
  }
  const int c_out = blockIdx.x * FM_BLOCK_COLS + threadIdx.x;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= N) break;  // N is uniform over the block
#pragma unroll
    for (int c = 0; c < FM_COLS; ++c) red[warp][lane * FM_COLS + c] = acc[n][c];
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int g = 0; g < FM_WARPS; ++g) s += red[g][threadIdx.x];
    if (c_out < O) part[((size_t)blockIdx.y * N + n) * O + c_out] = s;
    __syncthreads();
  }
}

template <typename T>
__global__ void fp_reduce_kernel(const float* __restrict__ part, T* __restrict__ out, int NO,
                                 int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NO) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * NO + i];
  out[i] = from_f<T>(acc);
}

struct Plan {
  int splits, rows;
  size_t smem;
};

Plan plan(int N, int K, int O) {
  const int col_blocks = (O + FM_BLOCK_COLS - 1) / FM_BLOCK_COLS;
  const int nt = N <= 4 ? 4 : FM_MAX_N;
  const int max_rows = FM_X_BYTES / (nt * (int)sizeof(float));
  int splits = FM_TARGET_BLOCKS / col_blocks;
  const int max_splits = K / (FM_WARPS * FM_UNROLL) > 0 ? K / (FM_WARPS * FM_UNROLL) : 1;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  if ((K + splits - 1) / splits > max_rows) splits = (K + max_rows - 1) / max_rows;
  Plan p;
  p.rows = (K + splits - 1) / splits;
  p.splits = (K + p.rows - 1) / p.rows;
  p.smem = (size_t)p.rows * nt * sizeof(float);
  return p;
}

template <typename T>
int launch(const void* x, const void* w, void* workspace, void* out, int N, int K, int O,
           cudaStream_t st) {
  const Plan p = plan(N, K, O);
  const dim3 grid((O + FM_BLOCK_COLS - 1) / FM_BLOCK_COLS, p.splits);
  if (N <= 4)
    fp_matmul_kernel<T, 4><<<grid, 32 * FM_WARPS, p.smem, st>>>(
        (const T*)x, (const T*)w, (float*)workspace, N, K, O, p.rows);
  else
    fp_matmul_kernel<T, FM_MAX_N><<<grid, 32 * FM_WARPS, p.smem, st>>>(
        (const T*)x, (const T*)w, (float*)workspace, N, K, O, p.rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int NO = N * O, threads = 256;
  fp_reduce_kernel<T><<<(NO + threads - 1) / threads, threads, 0, st>>>(
      (const float*)workspace, (T*)out, NO, p.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of f32 partials sq_fp_matmul needs for these shapes.
SQ_EXPORT long long sq_fp_matmul_workspace_bytes(int N, int K, int O) {
  return (long long)plan(N, K, O).splits * N * O * (long long)sizeof(float);
}

// K13: out (N, O) = x (N, K) · w (K, O), one layer's slab.  dt: the dtype
// of x, w and out (0 float32, 1 bfloat16).
SQ_EXPORT int sq_fp_matmul(const void* x, const void* w, void* workspace, void* out, int N, int K,
                           int O, int dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || N > FM_MAX_N || O % FM_COLS) return (int)cudaErrorInvalidValue;
  if (dt == DT_BF16) return launch<__nv_bfloat16>(x, w, workspace, out, N, K, O, st);
  return launch<float>(x, w, workspace, out, N, K, O, st);
}

// K13, stream body (stream_gmm.cuh stream_bf16_kernel): bf16 x (N <= 8 rows,
// K a multiple of 8) and slab (O a multiple of 8), every pointer 16-byte
// aligned (TMA); stages of kb = 64 or 32 weight rows; the split over K in
// n_split ranks (1, 2, 4 or 8, each with a stage at least).
SQ_EXPORT int sq_fp_matmul_stream(const void* x, const void* w, void* out, int N, int K, int O,
                                  int kb, int n_split, void* stream) {
  if (N < 1 || N > FM_MAX_N || K < 8 || K % 8 || O < 8 || O % 8 || (kb != 64 && kb != 32) ||
      (n_split != 1 && n_split != 2 && n_split != 4 && n_split != 8) ||
      (K + kb - 1) / kb < n_split)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return kb == 64 ? sb_launch<64>(x, w, out, N, K, O, n_split, st)
                  : sb_launch<32>(x, w, out, N, K, O, n_split, st);
}
