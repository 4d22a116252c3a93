// K10: the decode cache writer of the stacked HEAD-MAJOR int8 cache.
//
// Replaces smoothquant_tpu/kernels/cache_write.py write_quant_cache_stacked
// (pallas_call at :114).  Cache layout (as the JAX package): values
// (L, B, H_kv, S, D) int8, scales (L, B, H_kv, S) f32; the wrapper passes
// pointers already offset to one layer.  One decode position's k / v
// (B, H_kv, D) go in: rotary on k in f32 (fused into one fma, as jitted XLA
// compiles the JAX body), per-(slot, head) int8 quantize and an IN-PLACE
// write of row min(pos[b], S-1) — a dead slot of the continuous batch keeps
// decoding past the cache end and lands on the last, masked row.  The
// position comes from a device tensor ((B,) per slot, or a scalar the
// wrapper broadcasts), so the host never waits on it.
//
// What bounds it on the H100: nothing but launch latency.  It moves a few
// KB a call (B·H_kv·D values in, as many int8 bytes out).  Two bodies: the
// row body K2 shares (kv_quant.cuh kv_rows_kernel, head-major rows: q, k
// and v read in place from the qkv rows, q's rotary in the same launch, a
// row in registers), which takes every call the wrapper's shape rule
// allows; and K2's first design as body="warps" (write_cache_hm_kernel: a
// block per slot and 8 kv heads, a warp per head, k then v).
#include "kv_quant.cuh"

namespace {

template <typename T>
__global__ void write_cache_hm_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                                      const float* __restrict__ cos_t,
                                      const float* __restrict__ sin_t,
                                      const int* __restrict__ pos, int8_t* __restrict__ kq,
                                      int8_t* __restrict__ vq, float* __restrict__ ks,
                                      float* __restrict__ vs, int S, int H, int D, int rotary) {
  const int b = blockIdx.x;
  const int h = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (h >= H) return;
  int p = pos[b];
  p = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
  const size_t sc = ((size_t)b * H + h) * S + p;
  const size_t row = sc * D;
  const size_t src = ((size_t)b * H + h) * D;
  // with rotary off the tables may be null: no row of them is formed or read
  warp_quantize_kv<T, true>(k_new + src, D, rotary != 0,
                            rotary ? cos_t + (size_t)b * D : nullptr,
                            rotary ? sin_t + (size_t)b * D : nullptr, kq + row, ks + sc);
  warp_quantize_kv<T, true>(v_new + src, D, false, nullptr, nullptr, vq + row, vs + sc);
}

}  // namespace

// K10: rotary-k + int8 quantize + in-place head-major row write at clamped pos.
SQ_EXPORT int sq_write_cache_hm(const void* k_new, const void* v_new, const void* cos_t,
                                const void* sin_t, const void* pos, void* kq, void* vq,
                                void* ks, void* vs, int B, int S, int H, int D, int rotary,
                                int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D > 32 * KVQ_MAX_D_PER_LANE) return (int)cudaErrorInvalidValue;
  const int warps = H < 8 ? H : 8;
  const dim3 grid(B, (H + warps - 1) / warps);
  if (x_dt == DT_BF16)
    write_cache_hm_kernel<__nv_bfloat16><<<grid, 32 * warps, 0, st>>>(
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const float*)cos_t,
        (const float*)sin_t, (const int*)pos, (int8_t*)kq, (int8_t*)vq, (float*)ks,
        (float*)vs, S, H, D, rotary);
  else
    write_cache_hm_kernel<float><<<grid, 32 * warps, 0, st>>>(
        (const float*)k_new, (const float*)v_new, (const float*)cos_t, (const float*)sin_t,
        (const int*)pos, (int8_t*)kq, (int8_t*)vq, (float*)ks, (float*)vs, S, H, D, rotary);
  return (int)cudaGetLastError();
}

// K10's row body (kv_quant.cuh, head-major rows, k's rotary as one fma).
SQ_EXPORT int sq_kv_rows_hm(const void* q, const void* k, const void* v,
                            const void* cos_t, const void* sin_t, const void* pos,
                            void* q_out, void* kq, void* vq, void* ks, void* vs,
                            long long q_sb, long long q_sh, long long k_sb,
                            long long k_sh, long long v_sb, long long v_sh, int t_sb,
                            int pos_sb, int B, int S, int Hq, int Hkv, int D,
                            int rotary, int vec, int threads, int x_dt, void* stream) {
  return kv_rows_entry<false>(q, k, v, cos_t, sin_t, pos, q_out, kq, vq, ks, vs, q_sb,
                              q_sh, k_sb, k_sh, v_sb, v_sh, t_sb, pos_sb, B, S, Hq, Hkv, D,
                              rotary, vec, threads, x_dt, (cudaStream_t)stream);
}
