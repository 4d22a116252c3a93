// S-major int8 KV cache kernels for Hopper: the decode cache writer (K2)
// and single-query decode attention (K3).
//
// Cache layout (as the JAX package): values (L, B, S, H_kv*D) int8 — one
// row holds every kv head's vector for one position — and scales
// (L, B, H_kv, S) f32.  The wrappers pass pointers already offset to one
// layer.
//
// K2 replaces smoothquant_tpu/kernels/attn_smajor.py
// write_quant_cache_smajor (pallas_call at :340).  It moves a few KB per
// call (B·H_kv·D values in, the same count of int8 bytes out), so launch
// latency, not bytes or operations, bounds it.  A block per batch row and
// 8 kv heads, a warp per head (k, then v): warp_quantize_kv (kv_quant.cuh,
// shared with K10) with the rounded rotary products kept apart, as the
// Pallas body rounds them, and an IN-PLACE write of row min(pos[b], S-1) — the
// position is read from a device tensor and clamped on the device, because
// the batcher keeps advancing dead slots past the cache length.
//
// K3 replaces decode_attention_smajor_stacked (pallas_call at :213).  At
// decode it reads the layer's whole int8 cache (2·B·S·H_kv·D bytes) for
// 4·B·H·S·D flops, so the bytes bound it.  One block of 16 warps per
// (b, kv head) serves that head's `rep` query heads, so each cache byte is
// read once; every warp keeps 4 cache rows in flight (a lane reads its
// D/32 consecutive bytes of a row, so a warp reads the row whole):
//   phase 1  scores = (q·k)·sm_scale·k_scale + bias, one warp per position,
//            held in shared memory (rep·S floats);
//   phase 2  exact max, p = exp(s − max), l = Σp, p·v_scale rounded to
//            bf16 (the TPU kernel's rounding point);
//   phase 3  out = Σ p·v / l: each warp sums its positions for its lanes'
//            dims, the 16 partials are added in warp order; a row with
//            l == 0 (all keys masked) outputs 0.
// With the whole score row in shared memory the max is exact, which is what
// the TPU kernel's online softmax computes at S ≤ 512 (one 512-wide tile).
// Split-S flash decoding is later work.
#include "kv_quant.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ATTN_WARPS = 16;
constexpr int ATTN_THREADS = 32 * ATTN_WARPS;
constexpr int UNROLL = 4;          // cache rows each warp has in flight
constexpr int MAX_REP = 8;

template <typename T>
__global__ void write_cache_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
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
  const size_t row = ((size_t)b * S + p) * H * D + (size_t)h * D;
  const size_t sc = ((size_t)b * H + h) * S + p;
  const size_t src = ((size_t)b * H + h) * D;
  // with rotary off the tables may be null: no row of them is formed or read
  warp_quantize_kv<T, false>(k_new + src, D, rotary != 0,
                             rotary ? cos_t + (size_t)b * D : nullptr,
                             rotary ? sin_t + (size_t)b * D : nullptr, kq + row, ks + sc);
  warp_quantize_kv<T, false>(v_new + src, D, false, nullptr, nullptr, vq + row, vs + sc);
}

// K3 for head_dim = 32·DPL: lane l of a warp owns dims [l·DPL, l·DPL+DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(ATTN_THREADS)
decode_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                   const int8_t* __restrict__ vq, const float* __restrict__ ks,
                   const float* __restrict__ vs, const float* __restrict__ bias,
                   T* __restrict__ out, int H, int Hkv, int S, float sm_scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  float* sc = smem;                      // (rep, S) scores, then rounded p·v_scale
  float* part = smem + (H / Hkv) * S;    // (ATTN_WARPS, rep, D) PV partials
  __shared__ float scratch[32];
  __shared__ float denom[MAX_REP];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int rep = H / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = Hkv * D;
  const int8_t* k_base = kq + (size_t)b * S * hd + (size_t)kvh * D + lane * DPL;
  const int8_t* v_base = vq + (size_t)b * S * hd + (size_t)kvh * D + lane * DPL;
  const float* ks_row = ks + ((size_t)b * Hkv + kvh) * S;
  const float* vs_row = vs + ((size_t)b * Hkv + kvh) * S;
  const float* bias_row = bias + (size_t)b * S;

  float qv[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      qv[r][t] = r < rep ? to_f<T>(q[((size_t)b * H + kvh * rep + r) * D + lane * DPL + t])
                         : 0.0f;

  // phase 1: warp w scores positions w, w + ATTN_WARPS, ...; UNROLL rows are
  // loaded before any is used so that several loads are in flight per warp
  for (int s0 = warp; s0 < S; s0 += ATTN_WARPS * UNROLL) {
    float kr[UNROLL][DPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * ATTN_WARPS;
#pragma unroll
      for (int t = 0; t < DPL; ++t) kr[u][t] = s < S ? (float)k_base[(size_t)s * hd + t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * ATTN_WARPS;
      if (s >= S) break;
      const float k_scale = ks_row[s], bs = bias_row[s];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        float dot = 0.0f;
#pragma unroll
        for (int t = 0; t < DPL; ++t) dot = fmaf(qv[r][t], kr[u][t], dot);
        dot = warp_sum(dot);
        if (lane == 0)
          sc[r * S + s] = __fadd_rn(__fmul_rn(__fmul_rn(dot, sm_scale), k_scale), bs);
      }
    }
  }
  __syncthreads();

  // phase 2: exact max, p = exp(s - max), l = sum p, p·v_scale rounded to bf16
  for (int r = 0; r < rep; ++r) {
    float m = -INFINITY;
    for (int s = threadIdx.x; s < S; s += blockDim.x) m = fmaxf(m, sc[r * S + s]);
    m = block_reduce<true>(m, scratch);
    const float m_safe = fmaxf(m, NEG_INF / 2);
    float l = 0.0f;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float p = expf(sc[r * S + s] - m_safe);
      l += p;
      sc[r * S + s] = round_to<__nv_bfloat16>(p * vs_row[s]);
    }
    l = block_reduce<false>(l, scratch);
    if (threadIdx.x == 0) denom[r] = l > 0.0f ? l : 1.0f;
  }
  __syncthreads();

  // phase 3: warp w accumulates p·v over its positions for its lane's dims,
  // then the warps' partials are summed in warp order
  float acc[MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.0f;
  for (int s0 = warp; s0 < S; s0 += ATTN_WARPS * UNROLL) {
    float vr[UNROLL][DPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * ATTN_WARPS;
#pragma unroll
      for (int t = 0; t < DPL; ++t) vr[u][t] = s < S ? (float)v_base[(size_t)s * hd + t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * ATTN_WARPS;
      if (s >= S) break;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        const float p = sc[r * S + s];
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[r][t] = fmaf(p, vr[u][t], acc[r][t]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int t = 0; t < DPL; ++t) part[(warp * rep + r) * D + lane * DPL + t] = acc[r][t];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    float sum = 0.0f;
    for (int w = 0; w < ATTN_WARPS; ++w) sum += part[(w * rep + r) * D + d];
    out[((size_t)b * H + kvh * rep + r) * D + d] = from_f<T>(sum / denom[r]);
  }
}

template <typename T, int DPL>
int launch_attn(const void* q, const void* kq, const void* vq, const void* ks,
                const void* vs, const void* bias, void* out, int B, int H, int Hkv, int S,
                float sm_scale, cudaStream_t st) {
  const size_t smem = ((size_t)(H / Hkv) * S + (size_t)ATTN_WARPS * (H / Hkv) * 32 * DPL) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attn_kernel<T, DPL><<<dim3(B, Hkv), ATTN_THREADS, smem, st>>>(
      (const T*)q, (const int8_t*)kq, (const int8_t*)vq, (const float*)ks, (const float*)vs,
      (const float*)bias, (T*)out, H, Hkv, S, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_attn(int D, const void* q, const void* kq, const void* vq, const void* ks,
                  const void* vs, const void* bias, void* out, int B, int H, int Hkv, int S,
                  float sm_scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_attn<T, 2>(q, kq, vq, ks, vs, bias, out, B, H, Hkv, S, sm_scale, st);
    case 128:
      return launch_attn<T, 4>(q, kq, vq, ks, vs, bias, out, B, H, Hkv, S, sm_scale, st);
    case 256:
      return launch_attn<T, 8>(q, kq, vq, ks, vs, bias, out, B, H, Hkv, S, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2: rotary-k + int8 quantize + in-place S-major row write at clamped pos.
SQ_EXPORT int sq_write_cache_smajor(const void* k_new, const void* v_new, const void* cos_t,
                                    const void* sin_t, const void* pos, void* kq, void* vq,
                                    void* ks, void* vs, int B, int S, int H, int D,
                                    int rotary, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D > 32 * KVQ_MAX_D_PER_LANE) return (int)cudaErrorInvalidValue;
  const int warps = H < 8 ? H : 8;
  const dim3 grid(B, (H + warps - 1) / warps);
  if (x_dt == DT_BF16)
    write_cache_kernel<__nv_bfloat16><<<grid, 32 * warps, 0, st>>>(
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const float*)cos_t,
        (const float*)sin_t, (const int*)pos, (int8_t*)kq, (int8_t*)vq, (float*)ks,
        (float*)vs, S, H, D, rotary);
  else
    write_cache_kernel<float><<<grid, 32 * warps, 0, st>>>(
        (const float*)k_new, (const float*)v_new, (const float*)cos_t, (const float*)sin_t,
        (const int*)pos, (int8_t*)kq, (int8_t*)vq, (float*)ks, (float*)vs, S, H, D, rotary);
  return (int)cudaGetLastError();
}

// K3: single-query decode attention over one layer of the S-major cache.
SQ_EXPORT int sq_decode_attn_smajor(const void* q, const void* kq, const void* vq,
                                    const void* ks, const void* vs, const void* bias,
                                    void* out, int B, int H, int Hkv, int S, int D,
                                    float sm_scale, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H % Hkv || H / Hkv > MAX_REP) return (int)cudaErrorInvalidValue;
  if (x_dt == DT_BF16)
    return dispatch_attn<__nv_bfloat16>(D, q, kq, vq, ks, vs, bias, out, B, H, Hkv, S,
                                        sm_scale, st);
  return dispatch_attn<float>(D, q, kq, vq, ks, vs, bias, out, B, H, Hkv, S, sm_scale, st);
}
