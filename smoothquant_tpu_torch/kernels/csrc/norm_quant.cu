// LayerNorm / RMSNorm → int8 with a static scale (K16).
//
// Replaces smoothquant_tpu/kernels/norm_quant.py norm_quant (pallas_call
// :61), torch_int's LayerNormQ:
//     LayerNorm: μ = Σx / C, var = Σ(x − μ)² / C (two passes, f32),
//                y = fma((x − μ)·r, γ, β);  RMSNorm: y = fma(x·r, γ, β = 0),
//                r = 1/√(var + eps) resp. 1/√(Σx²/C + eps)
//     out = rint(y · f32(1/scale)) clipped to ±127
// r is __frcp_rn(__fsqrt_rn(v)) — the square root and the reciprocal each
// correctly rounded, as the plain version on the card computes it; every
// other rounding is spelled out (__fadd_rn, __fmul_rn, __fmaf_rn) so nvcc
// contracts nothing the JAX kernel does not.
//
// It reads each x once and writes int8 once: the bytes bound it (C = 2048:
// 8 KB in and 2 KB out a row in f32; 4 × 512 rows of OPT-1.3B's prefill move
// 21 MB, 6.3 µs at 3.35 TB/s).  Two bodies, C a multiple of 8, at most 8192:
//
// The row body (norm_quant_rows_kernel, every call): a row held in
// registers.  W warps take a row (W the least power of two with 32·W lanes
// of at most four 8-channel chunks each: C = 2048 → 2 warps, 8192 → 8), and
// every 16-byte load of the row is issued before the first add.  A lane sums
// its chunks in order, the warp by an xor-shuffle tree, and the row's W
// warps exchange their sums through shared memory under a named barrier of
// their 32·W threads (bar.sync 1 + the row's place in the block): a block
// holds R rows (norm_quant.k16_plan: enough blocks for two an SM where the
// rows allow) and no row waits on another.  At fewer rows than SMs the plan
// gives a row spare warps (shorter chains a lane) and γ, β load beside x, so
// one memory round trip precedes the sums and none follows them.  The mean, then Σ(x − μ)² from
// the registers (the two-pass variance of jnp.var), no second read and no
// copy of the row in shared memory.  At a few rows the bound is one launch
// and one load round trip, and no sum goes through device memory.
//
// The block body (norm_quant_kernel, body="block" only: timed beside the
// row body): one block of 256 threads a row, the row staged in shared
// memory as f32 between the passes, block sums through common.cuh's
// block_reduce — at C = 2048 one pair of 16-byte loads a thread in flight,
// two block-wide barriers a row, and at 4 rows 4 blocks on 132 SMs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NQ_CHUNKS = 4;        // 8-channel chunks a lane of the row body holds at most
constexpr int NQ_MAX_WARPS = 8;     // warps a block of the row body holds

template <typename TX>
__device__ __forceinline__ void load8(const TX* p, float (&v)[8]);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename TX>
__global__ void __launch_bounds__(THREADS)
norm_quant_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, int8_t* __restrict__ out, int C, float eps,
                  float scale, int rms) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * C;
  const int step = THREADS * 8;

  float s = 0.0f;
  for (int i = threadIdx.x * 8; i < C; i += step) {
    float v[8];
    load8<TX>(x + base + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row[i + j] = v[j];
      s = __fadd_rn(s, rms ? __fmul_rn(v[j], v[j]) : v[j]);
    }
  }
  const float tot = block_reduce<false>(s, red);
  float mean = 0.0f, var;
  if (rms) {
    var = __fdiv_rn(tot, (float)C);
  } else {
    mean = __fdiv_rn(tot, (float)C);
    float s2 = 0.0f;
    for (int i = threadIdx.x * 8; i < C; i += step)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c = __fsub_rn(row[i + j], mean);
        s2 = __fadd_rn(s2, __fmul_rn(c, c));
      }
    var = __fdiv_rn(block_reduce<false>(s2, red), (float)C);
  }
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  const float inv = __frcp_rn(scale);

  for (int i = threadIdx.x * 8; i < C; i += step) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = __fmul_rn(rms ? row[i + j] : __fsub_rn(row[i + j], mean), r);
      const float y = __fmaf_rn(t, __ldg(gamma + i + j), __ldg(beta + i + j));
      const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f);
      packed[j >> 2] |= ((uint32_t)(int)q & 0xffu) << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(out + base + i) = make_uint2(packed[0], packed[1]);
  }
}

// γ and β of channels c .. c + 7 as f32, from f32 or bf16 rows (bf16 → f32
// is exact, so either gives the plain version's γ·t + β)
__device__ __forceinline__ void nq_load_gb(const void* gamma, const void* beta, int g_bf16,
                                           int c, float (&g)[8], float (&b)[8]) {
  if (g_bf16) {
    load8<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(gamma) + c, g);
    load8<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(beta) + c, b);
  } else {
    load8<float>(static_cast<const float*>(gamma) + c, g);
    load8<float>(static_cast<const float*>(beta) + c, b);
  }
}

// Σ over the W warps of a row: the warp's xor-shuffle tree (every lane ends
// with the same bits: each step adds the same two values in either order),
// then, for W > 1, each warp's sum through buf and the row's named barrier,
// added in warp order
template <int W>
__device__ __forceinline__ float nq_row_sum(float s, float* buf, int wr, int lane, int bar) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if constexpr (W == 1) {
    return s;
  } else {
    if (lane == 0) buf[wr] = s;
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(32 * W) : "memory");
    float t = buf[0];
#pragma unroll
    for (int w = 1; w < W; ++w) t = __fadd_rn(t, buf[w]);
    return t;
  }
}

// R rows a block (blockDim.x = 32·W·R; cf = C as f32, converted on the
// host: no I2F); PF: γ and β loaded beside x, before the sums (a few rows:
// their load leaves the chain after the second sum), else after; row
// blockIdx.x·R + rg by warps
// rg·W .. rg·W + W − 1; lane l of the row's warp wr holds chunks lw, lw +
// 32·W, lw + 64·W, lw + 96·W (lw = 32·wr + l) of the row's C / 8.
template <typename TX, int W, bool PF>
__global__ void __launch_bounds__(32 * NQ_MAX_WARPS)
norm_quant_rows_kernel(const TX* __restrict__ x, const void* __restrict__ gamma,
                       const void* __restrict__ beta, int g_bf16, int8_t* __restrict__ out,
                       int N, int C, float cf, int R, float eps, float scale, int rms) {
  __shared__ float red[2][NQ_MAX_WARPS];   // per pass, each warp's sum (a row's W in a row)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / W, wr = warp % W;
  const int row = blockIdx.x * R + rg;
  if (row >= N) return;   // the row's whole group of warps leaves: its barrier has no member
  const int c8 = C >> 3, lw = 32 * wr + lane;
  const size_t base = (size_t)row * C;
  float v[NQ_CHUNKS][8], g[PF ? NQ_CHUNKS : 1][8], b[PF ? NQ_CHUNKS : 1][8];
#pragma unroll
  for (int k = 0; k < NQ_CHUNKS; ++k) {
    const int ci = lw + 32 * W * k;
    if (ci < c8) {
      load8<TX>(x + base + 8 * ci, v[k]);
      if constexpr (PF) {
        nq_load_gb(gamma, beta, g_bf16, 8 * ci, g[k], b[k]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[k][j] = 0.0f;
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NQ_CHUNKS; ++k)
    if (lw + 32 * W * k < c8)
#pragma unroll
      for (int j = 0; j < 8; ++j) s = __fadd_rn(s, rms ? __fmul_rn(v[k][j], v[k][j]) : v[k][j]);
  const int bar = 1 + rg;
  float* buf = red[0] + rg * W;
  const float tot = nq_row_sum<W>(s, buf, wr, lane, bar);
  float mean = 0.0f, var;
  if (rms) {
    var = __fdiv_rn(tot, cf);
  } else {
    mean = __fdiv_rn(tot, cf);
    float s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ_CHUNKS; ++k)
      if (lw + 32 * W * k < c8)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float c = __fsub_rn(v[k][j], mean);
          s2 = __fadd_rn(s2, __fmul_rn(c, c));
        }
    var = __fdiv_rn(nq_row_sum<W>(s2, red[1] + rg * W, wr, lane, bar), cf);
  }
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  const float inv = __frcp_rn(scale);
#pragma unroll
  for (int k = 0; k < NQ_CHUNKS; ++k) {
    const int ci = lw + 32 * W * k;
    if (ci >= c8) continue;
    if constexpr (!PF) {
      nq_load_gb(gamma, beta, g_bf16, 8 * ci, g[0], b[0]);
    }
    const float(&gk)[8] = g[PF ? k : 0];
    const float(&bk)[8] = b[PF ? k : 0];
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = __fmul_rn(rms ? v[k][j] : __fsub_rn(v[k][j], mean), r);
      const float y = __fmaf_rn(t, gk[j], bk[j]);
      const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f);
      packed[j >> 2] |= ((uint32_t)(int)q & 0xffu) << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(out + base + 8 * ci) = make_uint2(packed[0], packed[1]);
  }
}

template <typename TX, bool PF>
int launch_rows(const void* x, const void* gamma, const void* beta, int g_bf16, void* out, int N,
                int C, int W, int R, float eps, float scale, int rms, cudaStream_t st) {
  const auto kernel = W == 1   ? norm_quant_rows_kernel<TX, 1, PF>
                      : W == 2 ? norm_quant_rows_kernel<TX, 2, PF>
                      : W == 4 ? norm_quant_rows_kernel<TX, 4, PF>
                               : norm_quant_rows_kernel<TX, 8, PF>;
  kernel<<<(N + R - 1) / R, 32 * W * R, 0, st>>>((const TX*)x, gamma, beta, g_bf16,
                                                 (int8_t*)out, N, C, (float)C, R, eps, scale,
                                                 rms);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch(const void* x, const void* gamma, const void* beta, void* out, int N, int C,
           float eps, float scale, int rms, cudaStream_t st) {
  norm_quant_kernel<TX><<<N, THREADS, C * sizeof(float), st>>>(
      (const TX*)x, (const float*)gamma, (const float*)beta, (int8_t*)out, C, eps, scale, rms);
  return (int)cudaGetLastError();
}

}  // namespace

// K16, row body: as sq_norm_quant, γ and β in g_dt (f32 or bf16: read as
// they are stored, no conversion launch), W warps a row (1, 2, 4 or 8, with
// 32·W·4 chunks of 8 channels covering C), R rows a block (R·W <= 8), pf
// to load γ and β beside x; x, γ and β 16-byte aligned.
SQ_EXPORT int sq_norm_quant_rows(const void* x, const void* gamma, const void* beta, void* out,
                                 int N, int C, int W, int R, int pf, float eps, float scale,
                                 int rms, int x_dt, int g_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || C < 8 || C % 8 || C > 8192 || (W != 1 && W != 2 && W != 4 && W != 8) ||
      32 * W * NQ_CHUNKS * 8 < C || R < 1 || R * W > NQ_MAX_WARPS ||
      (x_dt != DT_BF16 && x_dt != DT_F32) || (g_dt != DT_BF16 && g_dt != DT_F32))
    return (int)cudaErrorInvalidValue;
  const auto go = x_dt == DT_BF16 ? (pf ? launch_rows<__nv_bfloat16, true>
                                        : launch_rows<__nv_bfloat16, false>)
                                  : (pf ? launch_rows<float, true> : launch_rows<float, false>);
  return go(x, gamma, beta, g_dt == DT_BF16, out, N, C, W, R, eps, scale, rms, st);
}

// K16, block body: out (N, C) int8 from x (N, C) (x_dt 0 float32, 1
// bfloat16), f32 gamma / beta (C,), the static scale; rms selects RMSNorm.
SQ_EXPORT int sq_norm_quant(const void* x, const void* gamma, const void* beta, void* out, int N,
                            int C, float eps, float scale, int rms, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || C < 8 || C % 8 || C > 8192) return (int)cudaErrorInvalidValue;
  if (x_dt == DT_BF16)
    return launch<__nv_bfloat16>(x, gamma, beta, out, N, C, eps, scale, rms, st);
  if (x_dt == DT_F32) return launch<float>(x, gamma, beta, out, N, C, eps, scale, rms, st);
  return (int)cudaErrorInvalidValue;
}
