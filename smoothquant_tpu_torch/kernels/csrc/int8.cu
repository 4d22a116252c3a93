// Static-scale INT8 GEMMs of the real-INT8 OPT path: K15a and K15b.
//
// Replaces smoothquant_tpu/kernels/int8.py int8_linear (pallas_call :105)
// and int8_bmm (pallas_call :162).  One entry point computes, for each of
// `batch` independent products,
//     acc[m,n] = Σ_k a[m,k]·b[n,k]     (b (N, K); or b[k,n] with b_kn: (K, N))
//     y = bias ? fma(f32(acc), α, bias[n]) : f32(acc)·α    (one rounding each)
//     y = relu ? max(y, 0) : y;  out = y (f32), or rint(y) clipped to ±127 (int8)
// the int32 sums exact (|acc| ≤ 127²·K), the epilogue's roundings spelled out
// with __fmaf_rn / __fmul_rn so nvcc contracts nothing else.
//
// What bounds it on the H100, and the design for each case:
//   * M ≤ 8 rows (decode: the six linears at N = 4 rows, the attention
//     products of one query over the cache): the bytes of b (the weight, or
//     the k / v cache) bound it, 2·M ops per byte.  gemv_nk streams each b
//     row once with 16-byte loads, `lpc` lanes per row (32 for K ≥ 512, 4 for
//     head_dim 64) and __dp4a on the int8 words, the a rows coming from L1;
//     gemv_kn (b (K, N), the value cache as it lies) gives each thread a
//     16-column chunk and a stride of k, and sums the partials in shared
//     memory.  No padded row tiles are run.
//   * more rows (prefill): 2·M·N·K int8 operations at 1979 TOP/s, or the
//     f32 output bytes for the QKᵀ logits.  The 128×128 mma.sync s8 tile
//     kernel of K4 (s8_tiles.cuh): cp.async three stages deep, int32
//     accumulators in registers across all of K.  A (K, N) b is staged as
//     64 k-rows × 128 columns and transposed 4×4 bytes at a time
//     (__byte_perm) into the K-major tile the fragments read.
// K must be a multiple of 16 (and N, for a (K, N) b); the wrapper pads.
//
// K15b's own bodies (sq_int8_bmm_attn, after sq_int8_gemm; int8.bmm_body
// picks one by shape, K15a keeps the kernels above):
//   * qk (more than 8 rows, b (N, K), K <= 256, f32 out: the QKᵀ logits).
//     The f32 logits it writes bound it (4 bytes an output against 2·K
//     operations).  A persistent body, two CTAs an SM, walks the (batch,
//     128 × 128 tile) pairs: a tile's operands land by cp.async into one of
//     two buffers while the previous tile is stored; the s8 mma.sync runs
//     over all of K at once; the int32 accumulators start at 0x4B400000
//     (1.5·2^23), so one FADD gives f32(acc) exactly (|acc| <= 127²·256 <
//     2^22: no I2F); the α product rounds once (__fmul_rn); the f32 tile is
//     staged in shared memory (rows padded to 136 words: conflict-free
//     fragment writes) and written by 16-byte coalesced streaming stores
//     (evict-first: the softmax reads the logits once), a warp a row.
//   * pv (more than 8 rows, b (K, N) as the value cache lies, K <= 1024):
//     128 × 64 tiles, as wide as the head dimension, so no half-empty
//     128-column tile runs.  A CTA takes several M tiles of one (batch,
//     column tile), two CTAs an SM: its (K, 64) slice of b lands once and
//     is byte-transposed 4 × 4 (__byte_perm) into K-major tiles before the
//     main loop, off the mma's issue slots, and the a rows of all its M
//     tiles stream through one four-stage cp.async ring; 8 warps of 32 × 32.
//   * kn_gemv (at most 8 rows, b (K, N): PV of one query over the cache).
//     The bytes of b bound it.  K splits over a thread-block cluster of 1-8
//     CTAs (several an SM); each thread's first four consecutive 16-byte
//     rows of b are in flight before the CTA stages its rows of a in shared
//     memory (once), they are transposed 4 × 4 to take __dp4a, and the
//     int32 partials are summed over lanes, warps and (stored into rank 0
//     through distributed shared memory, added in rank order) the ranks.
//   * nk_gemv (at most 8 rows, b (N, K), K <= 256: QKᵀ of one query over
//     the cache).  One b row a thread, its 16-byte chunks all in flight
//     before a is staged; the outputs coalesce along n.
#include <type_traits>

#include "s8_tiles.cuh"
#include "cluster.cuh"   // sg_cluster_sync, sg_ld_rank
#include "wg_gemm.cuh"   // smem_u32, WG_MAGIC

namespace {

using namespace s8;

struct Epi {
  float alpha;
  const float* bias;  // (N,) or null
  int relu;
};

template <typename TO>
__device__ __forceinline__ void store(TO* out, size_t i, int acc, int n, const Epi& e) {
  const float f = __int2float_rn(acc);
  float y = e.bias ? __fmaf_rn(f, e.alpha, e.bias[n]) : __fmul_rn(f, e.alpha);
  if (e.relu) y = fmaxf(y, 0.0f);
  if constexpr (std::is_same<TO, int8_t>::value) {
    out[i] = (int8_t)(int)fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  } else {
    out[i] = y;
  }
}

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

// ------------------------------------------------------------ M ≤ 8, b (N, K)
constexpr int GEMV_THREADS = 256;
constexpr int MAX_M = 8;

template <typename TO>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_nk_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, TO* __restrict__ out,
               int M, int N, int K, int lpc, Epi e) {
  const int z = blockIdx.y;
  const int8_t* a = A + (size_t)z * M * K;
  const int cols = GEMV_THREADS / lpc;
  const int n = blockIdx.x * cols + threadIdx.x / lpc;
  const int g = threadIdx.x % lpc;
  const bool valid = n < N;
  const int8_t* brow = B + ((size_t)z * N + (valid ? n : 0)) * K;
  int acc[MAX_M];
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) acc[m] = 0;
  if (valid) {
    const int chunks = K / 16;
#pragma unroll 4
    for (int c = g; c < chunks; c += lpc) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(brow) + c);
#pragma unroll
      for (int m = 0; m < MAX_M; ++m)
        if (m < M) acc[m] = dot16(__ldg(reinterpret_cast<const int4*>(a + (size_t)m * K) + c), w,
                                  acc[m]);
    }
  }
  // the lpc lanes of a row are aligned neighbours: xor-shuffles stay inside
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) {
    if (m >= M) break;
    for (int off = lpc >> 1; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  if (valid && g == 0) {
    TO* o = out + (size_t)z * M * N;
#pragma unroll
    for (int m = 0; m < MAX_M; ++m)
      if (m < M) store<TO>(o, (size_t)m * N + n, acc[m], n, e);
  }
}

// ------------------------------------------------------------ M ≤ 8, b (K, N)
// Each thread owns one 16-column chunk (ng chunks in a block) and the rows
// k ≡ kr (mod 256 / ng); the partial sums meet in shared memory.
template <typename TO>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kn_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, TO* __restrict__ out,
               int M, int N, int K, int ng, Epi e) {
  __shared__ int red[GEMV_THREADS * 16];
  const int z = blockIdx.y;
  const int8_t* a = A + (size_t)z * M * K;
  const int8_t* b = B + (size_t)z * K * N;
  const int cg = threadIdx.x % ng, kr = threadIdx.x / ng, n_kr = GEMV_THREADS / ng;
  const int n0 = (blockIdx.x * ng + cg) * 16;
  const bool valid = n0 < N;
  for (int m = 0; m < M; ++m) {
    int acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0;
    if (valid) {
#pragma unroll 4
      for (int k = kr; k < K; k += n_kr) {
        const int p = (int)__ldg(a + (size_t)m * K + k);
        const int4 w = __ldg(reinterpret_cast<const int4*>(b + (size_t)k * N + n0));
        const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * q + j] += p * ((ws[q] << (24 - 8 * j)) >> 24);
      }
    }
    __syncthreads();  // the previous row's sums have been read
#pragma unroll
    for (int j = 0; j < 16; ++j) red[kr * (ng * 16) + cg * 16 + j] = acc[j];
    __syncthreads();
    const int c = threadIdx.x;  // one output column per thread
    const int n = blockIdx.x * ng * 16 + c;
    if (c < ng * 16 && n < N) {
      int s = 0;
      for (int r = 0; r < n_kr; ++r) s += red[r * (ng * 16) + c];
      store<TO>(out + (size_t)z * M * N, (size_t)m * N + n, s, n, e);
    }
  }
}

// ------------------------------------------------------------ tile kernel
// 64 k-rows × 128 columns of a (K, N) byte matrix, unswizzled, 32 words a row
__device__ __forceinline__ void load_kn(uint32_t* raw, const int8_t* b, int k0, int K, int n0,
                                        int N, int tid) {
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e >> 3, c = e & 7;
    const int k = k0 + r, n = n0 + c * 16;
    const bool ok = k < K && n < N;
    cp_async16(raw + r * 32 + c * 4, ok ? b + (size_t)k * N + n : b, ok);
  }
}

// raw [64 k][128 n] bytes → swizzled tile [128 n][64 k bytes], 4×4 bytes a step
__device__ __forceinline__ void transpose_kn(uint32_t* tile, const uint32_t* raw, int tid) {
#pragma unroll
  for (int i = 0; i < (BK / 4) * (BN / 4) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int kg = e >> 5, ng = e & 31;
    const uint32_t w0 = raw[(4 * kg) * 32 + ng], w1 = raw[(4 * kg + 1) * 32 + ng];
    const uint32_t w2 = raw[(4 * kg + 2) * 32 + ng], w3 = raw[(4 * kg + 3) * 32 + ng];
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
    tile[swz(4 * ng, kg)] = __byte_perm(lo01, lo23, 0x5410);
    tile[swz(4 * ng + 1, kg)] = __byte_perm(lo01, lo23, 0x7632);
    tile[swz(4 * ng + 2, kg)] = __byte_perm(hi01, hi23, 0x5410);
    tile[swz(4 * ng + 3, kg)] = __byte_perm(hi01, hi23, 0x7632);
  }
}

template <bool B_KN, typename TO>
__global__ void __launch_bounds__(THREADS, 2)
tile_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, TO* __restrict__ out,
            int M, int N, int K, Epi e) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* a_tiles = smem;
  uint32_t* b_tiles = smem + STAGES * TILE_WORDS;       // (N, K) tiles, or raw (K, N) stages
  uint32_t* b_t = smem + 2 * STAGES * TILE_WORDS;       // the transposed tile (b_kn)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int8_t* a = A + (size_t)z * M * K;
  const int8_t* b = B + (size_t)z * N * K;

  auto load = [&](int kt, int buf) {
    load_tile(a_tiles + buf * TILE_WORDS, a, m0, M, kt * BK, K, (size_t)K, tid);
    if constexpr (B_KN)
      load_kn(b_tiles + buf * TILE_WORDS, b, kt * BK, K, n0, N, tid);
    else
      load_tile(b_tiles + buf * TILE_WORDS, b, n0, N, kt * BK, K, (size_t)K, tid);
  };

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const uint32_t* bt = b_tiles + (kt % STAGES) * TILE_WORDS;
    if constexpr (B_KN) {
      transpose_kn(b_t, bt, tid);
      bt = b_t;
    }
    const int pf = kt + STAGES - 1;
    if (pf < nk) load(pf, pf % STAGES);
    cp_async_commit();
    if constexpr (B_KN) __syncthreads();  // the transposed tile is complete
    mma_step(acc, a_tiles + (kt % STAGES) * TILE_WORDS, bt, wm, wn, gid, tig);
  }
  cp_async_wait<0>();

  TO* o = out + (size_t)z * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * mt + gid + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn + 8 * nt + 2 * tig + c;
          if (n < N) store<TO>(o, (size_t)m * N + n, acc[mt][nt][2 * h + c], n, e);
        }
    }
}

template <bool B_KN, typename TO>
int launch_tile(const int8_t* a, const int8_t* b, TO* out, int batch, int M, int N, int K,
                const Epi& e, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const size_t smem = ((B_KN ? 2 * STAGES + 1 : 2 * STAGES) * TILE_WORDS) * sizeof(uint32_t);
  auto kern = tile_kernel<B_KN, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, THREADS, smem, st>>>(a, b, out, M, N, K, e);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch(const int8_t* a, const int8_t* b, TO* out, int batch, int M, int N, int K, int b_kn,
           const Epi& e, cudaStream_t st) {
  if (M > MAX_M) {
    return b_kn ? launch_tile<true, TO>(a, b, out, batch, M, N, K, e, st)
                : launch_tile<false, TO>(a, b, out, batch, M, N, K, e, st);
  }
  if (b_kn) {
    int ng = 1;  // 16-column chunks in a block: a power of two up to 16
    while (ng < 16 && ng * 16 < N) ng *= 2;
    const dim3 grid((N + ng * 16 - 1) / (ng * 16), batch);
    gemv_kn_kernel<TO><<<grid, GEMV_THREADS, 0, st>>>(a, b, out, M, N, K, ng, e);
  } else {
    int lpc = 1;  // lanes per b row: a power of two up to 32, at most K / 16
    while (lpc < 32 && lpc * 2 <= K / 16) lpc *= 2;
    const int cols = GEMV_THREADS / lpc;
    const dim3 grid((N + cols - 1) / cols, batch);
    gemv_nk_kernel<TO><<<grid, GEMV_THREADS, 0, st>>>(a, b, out, M, N, K, lpc, e);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K15a / K15b: out (batch, M, N) from a (batch, M, K) and b (batch, N, K), or
// (batch, K, N) with b_kn; bias (N,) f32 or null; out_dt 0 float32, 2 int8.
SQ_EXPORT int sq_int8_gemm(const void* a, const void* b, const void* bias, void* out, int batch,
                           int M, int N, int K, float alpha, int relu, int b_kn, int out_dt,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch < 1 || M < 1 || N < 1 || K < 16 || K % 16 || (b_kn && N % 16))
    return (int)cudaErrorInvalidValue;
  const Epi e{alpha, (const float*)bias, relu};
  const int8_t* a8 = (const int8_t*)a;
  const int8_t* b8 = (const int8_t*)b;
  if (out_dt == DT_I8) return launch<int8_t>(a8, b8, (int8_t*)out, batch, M, N, K, b_kn, e, st);
  if (out_dt == DT_F32) return launch<float>(a8, b8, (float*)out, batch, M, N, K, b_kn, e, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ K15b's bodies
namespace {

using namespace s8;

constexpr int QK_MAX_K = 256;
constexpr int QK_LD = BN + 8;            // f32 row stride of the staged output tile
constexpr int PV_BN = 64;                // the pv tile's columns
constexpr int PV_STAGES = 4;             // the pv body's a ring
constexpr int PV_MAX_K = 1024;
constexpr int KN_COLS = 64;              // the kn GEMV's columns a CTA
constexpr int KN_MAX_ROWS = 4096;        // k rows a rank of the kn GEMV stages at most
constexpr int NK_MAX_K = 256;            // the nk GEMV's K: a b row in registers
constexpr uint32_t QK_MAGIC_BITS = 0x4B400000u;   // 1.5·2^23

struct QkArgs {
  const int8_t* a;
  const int8_t* b;
  float* out;
  int M, N, K, nk;                 // nk: 64-byte k stages
  int tiles_n, per_z, total;       // column tiles, tiles a batch, tiles in all
  uint32_t mag_n, mag_z;           // x / tiles_n and x / per_z as umulhi(x, mag)
  float alpha;
};

// the tile's (batch, first row, first column); a divisor of 1 has no 32-bit magic
__device__ __forceinline__ void qk_coords(const QkArgs& p, int t, int& z, int& m0, int& n0) {
  z = p.per_z == 1 ? t : (int)__umulhi((uint32_t)t, p.mag_z);
  const int rem = t - z * p.per_z;
  const int tm = p.tiles_n == 1 ? rem : (int)__umulhi((uint32_t)rem, p.mag_n);
  m0 = tm * BM;
  n0 = (rem - tm * p.tiles_n) * BN;
}

__global__ void __launch_bounds__(THREADS, 2) qk_tile_kernel(const QkArgs p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int buf_words = p.nk * 2 * TILE_WORDS;
  float* stage = reinterpret_cast<float*>(smem + 2 * buf_words);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  auto load = [&](int t, int buf) {
    int z, m0, n0;
    qk_coords(p, t, z, m0, n0);
    const int8_t* a = p.a + (size_t)z * p.M * p.K;
    const int8_t* b = p.b + (size_t)z * p.N * p.K;
    uint32_t* base = smem + buf * buf_words;
    for (int s = 0; s < p.nk; ++s) {
      load_tile(base + 2 * s * TILE_WORDS, a, m0, p.M, s * BK, p.K, (size_t)p.K, tid);
      load_tile(base + (2 * s + 1) * TILE_WORDS, b, n0, p.N, s * BK, p.K, (size_t)p.K, tid);
    }
    cp_async_commit();
  };

  int t = blockIdx.x;
  if (t < p.total) load(t, 0);
  for (int it = 0; t < p.total; t += gridDim.x, ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();   // this tile's operands landed; the last tile's stage is stored
    if (t + (int)gridDim.x < p.total) load(t + gridDim.x, buf ^ 1);

    int acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = (int)QK_MAGIC_BITS;
    const uint32_t* base = smem + buf * buf_words;
    for (int s = 0; s < p.nk; ++s)
      mma_step(acc, base + 2 * s * TILE_WORDS, base + (2 * s + 1) * TILE_WORDS, wm, wn, gid,
               tig);

#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = wm + 16 * mt + gid + 8 * h, c = wn + 8 * nt + 2 * tig;
          const float f0 = __fsub_rn(__int_as_float(acc[mt][nt][2 * h]), WG_MAGIC);
          const float f1 = __fsub_rn(__int_as_float(acc[mt][nt][2 * h + 1]), WG_MAGIC);
          *reinterpret_cast<float2*>(stage + r * QK_LD + c) =
              make_float2(__fmul_rn(f0, p.alpha), __fmul_rn(f1, p.alpha));
        }
    __syncthreads();

    int z, m0, n0;
    qk_coords(p, t, z, m0, n0);
    float* o = p.out + (size_t)z * p.M * p.N;
    const int cols = min(BN, p.N - n0), c = 4 * lane;
    for (int r = warp; r < BM && m0 + r < p.M; r += THREADS / 32) {
      float* row = o + (size_t)(m0 + r) * p.N + n0;
      const float* src = stage + r * QK_LD + c;
      if ((p.N & 3) == 0) {
        if (c < cols) __stcs(reinterpret_cast<float4*>(row + c), *reinterpret_cast<const float4*>(src));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < cols) row[c + j] = src[j];
      }
    }
  }
}

// acc += a warp's 32 × 32 share of one 64-byte k step: A rows wm.., B^T rows
// (columns) wn..
__device__ __forceinline__ void mma_step_32(int (&acc)[2][4][4], const uint32_t* at,
                                            const uint32_t* bt, int wm, int wn, int gid, int tig) {
#pragma unroll
  for (int kw = 0; kw < 16; kw += 8) {
    int a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) frag_a(a[mt], at, wm + 16 * mt, kw, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) frag_b(b[nt], bt, wn + 8 * nt, kw, gid, tig);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
  }
}

// grid (N / 64, batch, msplit); CTA (x, z, j) takes the M tiles j, j +
// msplit, ... of its column tile, streaming their a rows through one
// PV_STAGES-deep cp.async ring (stage g: M tile g / nk, k step g % nk), so
// the block's (K, 64) slice of b lands and is transposed once for all of
// them.  smem: the a ring, the raw (nk·64, 64) b slice, its K-major tiles
// (nk × 64 columns × 64 k bytes).
template <typename TO>
__global__ void __launch_bounds__(THREADS, 2)
pv_tile_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, TO* __restrict__ out,
               int M, int N, int K, Epi e) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nk = (K + BK - 1) / BK;
  uint32_t* a_ring = smem;
  uint32_t* raw = smem + PV_STAGES * TILE_WORDS;   // nk·64 k rows × 16 words
  uint32_t* bt = raw + nk * 64 * 16;               // nk tiles of 64 columns × 16 words
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * PV_BN, z = blockIdx.y, msplit = gridDim.z;
  const int tiles_m = (M + BM - 1) / BM;
  const int total = (tiles_m - (int)blockIdx.z + msplit - 1) / msplit * nk;   // a stages
  const int8_t* a = A + (size_t)z * M * K;
  const int8_t* b = B + (size_t)z * K * N;
  auto m_of = [&](int g) { return ((int)blockIdx.z + g / nk * msplit) * BM; };
  auto load_a = [&](int g) {
    load_tile(a_ring + (g % PV_STAGES) * TILE_WORDS, a, m_of(g), M, g % nk * BK, K, (size_t)K,
              tid);
  };

  for (int i = tid; i < nk * 64 * 4; i += THREADS) {
    const int k = i >> 2, c = i & 3, n = n0 + 16 * c;
    const bool ok = k < K && n < N;
    cp_async16(raw + k * 16 + c * 4, ok ? b + (size_t)k * N + n : b, ok);
  }
  if (total > 0) load_a(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < PV_STAGES - 1; ++s) {
    if (s < total) load_a(s);
    cp_async_commit();
  }
  cp_async_wait<PV_STAGES - 2>();
  __syncthreads();   // the raw b slice (and a's first stage) landed
  for (int i = tid; i < nk * 16 * 16; i += THREADS) {
    const int kg = i >> 4, ng = i & 15;
    const uint32_t w0 = raw[(4 * kg) * 16 + ng], w1 = raw[(4 * kg + 1) * 16 + ng];
    const uint32_t w2 = raw[(4 * kg + 2) * 16 + ng], w3 = raw[(4 * kg + 3) * 16 + ng];
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
    uint32_t* tile = bt + (kg >> 4) * 64 * 16;
    const int kw = kg & 15;
    tile[swz(4 * ng, kw)] = __byte_perm(lo01, lo23, 0x5410);
    tile[swz(4 * ng + 1, kw)] = __byte_perm(lo01, lo23, 0x7632);
    tile[swz(4 * ng + 2, kw)] = __byte_perm(hi01, hi23, 0x5410);
    tile[swz(4 * ng + 3, kw)] = __byte_perm(hi01, hi23, 0x7632);
  }

  int acc[2][4][4];
  TO* o = out + (size_t)z * M * N;
  for (int g = 0; g < total; ++g) {
    const int kt = g % nk;
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
    }
    cp_async_wait<PV_STAGES - 2>();
    __syncthreads();   // stage g landed (and the transposed tiles are written)
    if (g + PV_STAGES - 1 < total) load_a(g + PV_STAGES - 1);
    cp_async_commit();
    mma_step_32(acc, a_ring + (g % PV_STAGES) * TILE_WORDS, bt + kt * 64 * 16, wm, wn, gid, tig);
    if (kt != nk - 1) continue;
    const int m0 = m_of(g);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mt + gid + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n0 + wn + 8 * nt + 2 * tig + c;
            if (n < N) store<TO>(o, (size_t)m * N + n, acc[mt][nt][2 * h + c], n, e);
          }
      }
  }
  cp_async_wait<0>();
}

// shared memory of the kn GEMV: a's (M, kc) bytes, the warps' sums (8, M,
// 64), and, on rank 0, every rank's sums (ranks, M, 64)
struct KnLayout {
  int red, pin, total;
};
__host__ __device__ inline KnLayout kn_layout(int M, int kc, int ranks) {
  KnLayout L;
  L.red = (M * kc + 15) / 16 * 16;
  L.pin = L.red + (THREADS / 32) * M * KN_COLS * 4;
  L.total = L.pin + ranks * M * KN_COLS * 4;
  return L;
}

// grid (ranks, N / 64, batch), cluster (ranks, 1, 1); rank q takes k rows
// [q·kc, (q + 1)·kc); thread (kr, cg) the 16 columns n0 + 16·cg and the
// four-row groups kr, kr + 64, ...; MM: the rows the registers hold (1 or
// MAX_M).  Each thread's first two groups of b rows are in flight before a
// is staged; the ranks' sums are stored into rank 0, which writes them.
template <typename TO, int MM>
__global__ void __launch_bounds__(THREADS)
kn_gemv_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, TO* __restrict__ out,
               int M, int N, int K, int kc, Epi e) {
  extern __shared__ __align__(16) uint32_t smem[];
  const KnLayout L = kn_layout(M, kc, gridDim.x);
  uint32_t* a_s = smem;
  int* red = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + L.red);
  int* pin = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + L.pin);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, z = blockIdx.z, C = gridDim.x;
  const int n0 = blockIdx.y * KN_COLS, cg = tid & 3, kr = tid >> 2;
  const int k0 = rank * kc, ng = kc / 4;
  const int8_t* a = A + (size_t)z * M * K + k0;
  const int8_t* b = B + ((size_t)z * K + k0) * N + n0 + 16 * cg;
  const bool valid = n0 + 16 * cg < N;
  cl_arrive_relaxed();   // waited for before the first store into rank 0

  // two four-row groups a thread in flight: groups kr and kr + 64 first
  uint4 w[2][4];
  auto fetch = [&](int h, int gg) {
    if (gg < ng) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[h][i] = __ldg(reinterpret_cast<const uint4*>(b + (size_t)(4 * gg + i) * N));
    }
  };
  if (valid) {
    fetch(0, kr);
    fetch(1, kr + THREADS / 4);
  }
  for (int i = tid; i < M * (kc / 16); i += THREADS) {
    const int m = i / (kc / 16), c = i - m * (kc / 16);
    reinterpret_cast<uint4*>(a_s)[(m * kc) / 16 + c] =
        __ldg(reinterpret_cast<const uint4*>(a + (size_t)m * K) + c);
  }
  __syncthreads();

  int acc[MM][16];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0;
  if (valid) {
    for (int g0 = kr; g0 < ng; g0 += THREADS / 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = g0 + h * (THREADS / 4);
        if (g >= ng) break;
        const uint32_t r0[4] = {w[h][0].x, w[h][0].y, w[h][0].z, w[h][0].w};
        const uint32_t r1[4] = {w[h][1].x, w[h][1].y, w[h][1].z, w[h][1].w};
        const uint32_t r2[4] = {w[h][2].x, w[h][2].y, w[h][2].z, w[h][2].w};
        const uint32_t r3[4] = {w[h][3].x, w[h][3].y, w[h][3].z, w[h][3].w};
        fetch(h, g + THREADS / 2);   // the group after next, in flight during this one's math
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // column 4q + j's four k bytes as one word
          const uint32_t lo01 = __byte_perm(r0[q], r1[q], 0x5140);
          const uint32_t lo23 = __byte_perm(r2[q], r3[q], 0x5140);
          const uint32_t hi01 = __byte_perm(r0[q], r1[q], 0x7362);
          const uint32_t hi23 = __byte_perm(r2[q], r3[q], 0x7362);
          const int col[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                              (int)__byte_perm(lo01, lo23, 0x7632),
                              (int)__byte_perm(hi01, hi23, 0x5410),
                              (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
          for (int m = 0; m < MM; ++m) {
            if (m >= M) break;
            const int av = (int)a_s[(m * kc) / 4 + g];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[m][4 * q + j] = __dp4a(av, col[j], acc[m][4 * q + j]);
          }
        }
      }
    }
  }
  // lanes with the same cg (lane % 4) in the warp, then the warps, then the ranks
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) red[(warp * M + m) * KN_COLS + 16 * lane + j] = acc[m][j];
    }
  }
  __syncthreads();
  cl_wait();
  for (int i = 4 * tid; i < M * KN_COLS; i += 4 * THREADS) {
    int4 s = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int w8 = 0; w8 < THREADS / 32; ++w8) {
      const int4 v = *reinterpret_cast<const int4*>(red + w8 * M * KN_COLS + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    cl_st_rank_f32x4(smem_u32(pin + rank * M * KN_COLS + i), 0,
                     make_float4(__int_as_float(s.x), __int_as_float(s.y), __int_as_float(s.z),
                                 __int_as_float(s.w)));
  }
  sg_cluster_sync();   // every rank's sums have landed in rank 0
  if (rank != 0) return;
  TO* o = out + (size_t)z * M * N;
  for (int i = tid; i < M * KN_COLS; i += THREADS) {
    int s = 0;
    for (int q = 0; q < C; ++q) s += pin[q * M * KN_COLS + i];
    const int m = i >> 6, n = n0 + (i & 63);
    if (n < N) store<TO>(o, (size_t)m * N + n, s, n, e);
  }
}

// One b (N, K) row a thread (K <= NK_MAX_K): its 16-byte chunks all in
// flight before a's M rows are staged in shared memory (read as broadcasts),
// then __dp4a; grid (N / THREADS, batch), outputs coalesced along n.
template <typename TO, int MM>
__global__ void __launch_bounds__(THREADS)
nk_gemv_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, TO* __restrict__ out,
               int M, int N, int K, Epi e) {
  __shared__ __align__(16) int4 a_s[MAX_M * NK_MAX_K / 16];
  const int tid = threadIdx.x, z = blockIdx.y;
  const int n = blockIdx.x * THREADS + tid, nc = K >> 4;
  const bool valid = n < N;
  const int4* brow = reinterpret_cast<const int4*>(B + ((size_t)z * N + (valid ? n : 0)) * K);
  int4 w[NK_MAX_K / 16];
#pragma unroll
  for (int c = 0; c < NK_MAX_K / 16; ++c)
    if (c < nc && valid) w[c] = __ldg(brow + c);
  const int4* a = reinterpret_cast<const int4*>(A + (size_t)z * M * K);
  for (int i = tid; i < M * nc; i += THREADS) a_s[i] = __ldg(a + i);
  __syncthreads();
  if (!valid) return;
  int acc[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m) acc[m] = 0;
#pragma unroll
  for (int c = 0; c < NK_MAX_K / 16; ++c) {
    if (c >= nc) break;
#pragma unroll
    for (int m = 0; m < MM; ++m)
      if (m < M) acc[m] = dot16(a_s[m * nc + c], w[c], acc[m]);
  }
  TO* o = out + (size_t)z * M * N;
#pragma unroll
  for (int m = 0; m < MM; ++m)
    if (m < M) store<TO>(o, (size_t)m * N + n, acc[m], n, e);
}

int qk_blocks_per_sm(int smem) { return smem <= 113 * 1024 ? 2 : 1; }

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// ceil(2^32 / d) for d >= 2, with whether umulhi(x, it) == x / d for
// every x <= x_max (x · (mag · d − 2^32) < 2^32)
bool fast_div(uint32_t d, uint32_t x_max, uint32_t& mag) {
  mag = (uint32_t)((0x100000000ull + d - 1) / d);
  return (uint64_t)x_max * ((uint64_t)mag * d - 0x100000000ull) < 0x100000000ull;
}

int launch_qk(const int8_t* a, const int8_t* b, float* out, int batch, int M, int N, int K,
              float alpha, cudaStream_t st) {
  QkArgs p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.nk = (K + BK - 1) / BK;
  p.tiles_n = (N + BN - 1) / BN;
  p.per_z = (M + BM - 1) / BM * p.tiles_n;
  p.total = p.per_z * batch;
  p.alpha = alpha;
  p.mag_n = p.mag_z = 0u;
  if ((p.tiles_n > 1 && !fast_div(p.tiles_n, p.per_z, p.mag_n)) ||
      (p.per_z > 1 && !fast_div(p.per_z, p.total, p.mag_z)))
    return (int)cudaErrorInvalidValue;
  const int smem = (2 * p.nk * 2 * TILE_WORDS) * 4 + BM * QK_LD * 4;
  static const cudaError_t ready =
      cudaFuncSetAttribute(qk_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (ready != cudaSuccess) return (int)ready;
  const int grid = min(p.total, qk_blocks_per_sm(smem) * sm_count());
  qk_tile_kernel<<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_pv(const int8_t* a, const int8_t* b, TO* out, int batch, int M, int N, int K,
              const Epi& e, cudaStream_t st) {
  const int nk = (K + BK - 1) / BK;
  const int smem = (PV_STAGES * TILE_WORDS + 2 * nk * 64 * 16) * 4;
  auto kern = pv_tile_kernel<TO>;
  static const cudaError_t ready =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (ready != cudaSuccess) return (int)ready;
  // M tiles split over msplit CTAs a (batch, column tile): two CTAs an SM
  const int tiles_n = (N + PV_BN - 1) / PV_BN, tiles_m = (M + BM - 1) / BM;
  const int msplit = max(1, min(tiles_m, 2 * sm_count() / max(1, batch * tiles_n)));
  kern<<<dim3(tiles_n, batch, msplit), THREADS, smem, st>>>(a, b, out, M, N, K, e);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_kn(const int8_t* a, const int8_t* b, TO* out, int batch, int M, int N, int K,
              int ranks, const Epi& e, cudaStream_t st) {
  const int kc = K / ranks;
  const int smem = kn_layout(M, kc, ranks).total;
  auto kern = M == 1 ? kn_gemv_kernel<TO, 1> : kn_gemv_kernel<TO, MAX_M>;
  static const cudaError_t ready = [] {
    const cudaError_t e1 = cudaFuncSetAttribute(
        kn_gemv_kernel<TO, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    return e1 != cudaSuccess ? e1
                             : cudaFuncSetAttribute(kn_gemv_kernel<TO, MAX_M>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    227 * 1024);
  }();
  if (ready != cudaSuccess) return (int)ready;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (N + KN_COLS - 1) / KN_COLS, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a, b, out, M, N, K, kc, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_nk(const int8_t* a, const int8_t* b, TO* out, int batch, int M, int N, int K,
              const Epi& e, cudaStream_t st) {
  auto kern = M == 1 ? nk_gemv_kernel<TO, 1> : nk_gemv_kernel<TO, MAX_M>;
  kern<<<dim3((N + THREADS - 1) / THREADS, batch), THREADS, 0, st>>>(a, b, out, M, N, K, e);
  return (int)cudaGetLastError();
}

}  // namespace

// K15b's bodies: body 0 qk (b (N, K), M > 8, K <= 256, f32 out), 1 pv
// (b (K, N), M > 8, K <= 1024), 2 kn_gemv (b (K, N), M <= 8, K split over
// `ranks` cluster ranks of K / ranks rows, a multiple of 16 and at most
// KN_MAX_ROWS), 3 nk_gemv (b (N, K), M <= 8, K <= 256).  out (batch, M, N);
// K a multiple of 16, and N for a (K, N) b.
SQ_EXPORT int sq_int8_bmm_attn(const void* a, const void* b, void* out, int batch, int M, int N,
                               int K, float alpha, int body, int ranks, int out_dt,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch < 1 || M < 1 || N < 1 || K < 16 || K % 16) return (int)cudaErrorInvalidValue;
  const Epi e{alpha, nullptr, 0};
  const int8_t* a8 = (const int8_t*)a;
  const int8_t* b8 = (const int8_t*)b;
  if (body == 0) {
    if (M <= MAX_M || K > QK_MAX_K || out_dt != DT_F32) return (int)cudaErrorInvalidValue;
    return launch_qk(a8, b8, (float*)out, batch, M, N, K, alpha, st);
  }
  if (body == 3) {
    if (M > MAX_M || K > NK_MAX_K) return (int)cudaErrorInvalidValue;
    if (out_dt == DT_I8) return launch_nk<int8_t>(a8, b8, (int8_t*)out, batch, M, N, K, e, st);
    if (out_dt == DT_F32) return launch_nk<float>(a8, b8, (float*)out, batch, M, N, K, e, st);
    return (int)cudaErrorInvalidValue;
  }
  if (N % 16) return (int)cudaErrorInvalidValue;
  if (body == 1) {
    if (M <= MAX_M || K > PV_MAX_K) return (int)cudaErrorInvalidValue;
    if (out_dt == DT_I8) return launch_pv<int8_t>(a8, b8, (int8_t*)out, batch, M, N, K, e, st);
    if (out_dt == DT_F32) return launch_pv<float>(a8, b8, (float*)out, batch, M, N, K, e, st);
    return (int)cudaErrorInvalidValue;
  }
  if (body == 2) {
    if (M > MAX_M || (ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) ||
        K % (16 * ranks) || K / ranks > KN_MAX_ROWS)
      return (int)cudaErrorInvalidValue;
    if (out_dt == DT_I8)
      return launch_kn<int8_t>(a8, b8, (int8_t*)out, batch, M, N, K, ranks, e, st);
    if (out_dt == DT_F32)
      return launch_kn<float>(a8, b8, (float*)out, batch, M, N, K, ranks, e, st);
  }
  return (int)cudaErrorInvalidValue;
}
