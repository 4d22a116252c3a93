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
// 8 KB in and 2 KB out a row in f32).  One block of 256 threads takes one
// row; 16-byte loads, the row kept in shared memory as f32 between the
// passes (each thread rereads only the elements it wrote), block sums through
// common.cuh's block_reduce.  C must be a multiple of 8, at most 8192.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

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

template <typename TX>
int launch(const void* x, const void* gamma, const void* beta, void* out, int N, int C,
           float eps, float scale, int rms, cudaStream_t st) {
  norm_quant_kernel<TX><<<N, THREADS, C * sizeof(float), st>>>(
      (const TX*)x, (const float*)gamma, (const float*)beta, (int8_t*)out, C, eps, scale, rms);
  return (int)cudaGetLastError();
}

}  // namespace

// K16: out (N, C) int8 from x (N, C) (x_dt 0 float32, 1 bfloat16), f32
// gamma / beta (C,), the static scale; rms selects RMSNorm.
SQ_EXPORT int sq_norm_quant(const void* x, const void* gamma, const void* beta, void* out, int N,
                            int C, float eps, float scale, int rms, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || C < 8 || C % 8 || C > 8192) return (int)cudaErrorInvalidValue;
  if (x_dt == DT_BF16)
    return launch<__nv_bfloat16>(x, gamma, beta, out, N, C, eps, scale, rms, st);
  if (x_dt == DT_F32) return launch<float>(x, gamma, beta, out, N, C, eps, scale, rms, st);
  return (int)cudaErrorInvalidValue;
}
