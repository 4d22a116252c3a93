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
#include <type_traits>

#include "s8_tiles.cuh"

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
