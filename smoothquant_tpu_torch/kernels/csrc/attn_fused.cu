// K12: virtual-tile decode attention over the stacked head-major int8 cache.
//
// Replaces smoothquant_tpu/kernels/attn_fused.py _fused_attn_call
// (pallas_call at :345, the inline bodies: fused_virtual_attn_flat and
// fused_virtual_attn_stacked; at :491, the phased body with the row write:
// fused_rope_write_attn_stacked).  One aligned decode position `pos` (a
// device scalar, the layer's entry of the cache's (L,) positions), no mask:
// attention reads the OLD cache, columns < pos, and folds the new position
// in last, from registers.  The new k / v (B, H_kv, D) are rotated (k) and
// quantized in the kernel by kv_quant.cuh with the fma flag K10 uses, so the
// virtual row's int8 values and scales are bit-identical to the row K10
// writes.  Three bodies, one kernel:
//   stacked  q (B, H, D) already rotated (GQA or MHA), no write;
//   flat     q (B, 1, H·D) PRE-rotary, MHA only: the rotary runs here in f32,
//            fma(q, cos, rot(q)·sin), rounded to q's dtype before the dot;
//   write    the stacked body that also writes the int8 row and its scale at
//            pos (clamped to S − 1, as K10 clamps it) in place.
// The output (B, H, D) has the flat body's (B, 1, H·D) memory layout too.
//
// Bound: as K11, the bytes of the cache positions below pos (and their
// scales).  Two designs, picked by a Python shape rule (attn_fused.
// fused_body):
//   split  bf16 queries at head_dim 64 / 128 (sq_fused_attn_split):
//          split_decode.cuh in modes SD_VIRT / SD_VIRT_FLAT / SD_VIRT_WRITE —
//          S split over a cluster of 1-8 CTAs a (slot, kv head), each rank's
//          row range [0, pos − c0) known from the scalar at once (no bias
//          staged: only the k and v scales), the rows streamed through a
//          ring of bulk copies, tile maxima exchanged and partials reduced in
//          rank order through distributed shared memory, then the virtual
//          step folded into every rank's slice of the outputs, and the write
//          body's row written by the rank whose chunk holds it;
//   flash  f32 queries and head_dim 256 (sq_fused_attn, this file's
//          kernel): K11's old design (flash_decode.cuh), one block of 16
//          warps per (slot, kv head), the mask computed from the scalar
//          position (no bias tensor), the masked positions never loaded;
//          then the virtual step, the online softmax's m, α, l, acc as
//          attn_fused.py:114-152 folds it in:
//   s_v = (q·k_new)·sm_scale·k_scale_new,  m' = max(m, s_v),
//   m_safe = max(m', NEG_INF/2),  α = exp(m − m_safe),  p = exp(s_v − m_safe),
//   l' = l·α + p,  acc' = acc·α + bf16(p·v_scale_new)·v_new,
// and out = acc' / l'.  The flash write body writes its row after every read
// of the block: no other block of its group reads (slot, kv head)'s rows,
// and the row at pos is masked for attention in any case (its probability
// would be exactly 0).
//
// Any GQA rep (the JAX kernel pads rep to a multiple of 8): above 8 query
// rows a kv head both designs run the rows in groups of 8 as grid z, a
// block (flash, its shared memory sized by the group) or a cluster (split)
// each, every group reading the kv head's old rows again (from the L2 after
// the first).  Each group quantizes the new k / v itself and folds the new
// position in from registers and shared memory, never from the cache; only
// group 0 stores the row and its scales, after its own last read.  The row
// lies at pos, which no group reads while pos < S; at a clamped position
// (pos >= S, the cache full, which the Generator and the batcher refuse
// before it happens) another group may read row S - 1 after group 0 stored
// it.  A rep of 8 or less is one group: the bodies and bits of before.  The
// softmax scale is the caller's (default 1/√D).
#include "flash_decode.cuh"
#include "kv_quant.cuh"
#include "split_decode.cuh"

namespace {

template <typename TQ, bool FLAT, bool WRITE, int DPL>
__global__ void __launch_bounds__(FLASH_THREADS)
fused_attn_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                  const TQ* __restrict__ v_new, const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t, const int* __restrict__ pos_p,
                  int8_t* __restrict__ kq, int8_t* __restrict__ vq, float* __restrict__ ks,
                  float* __restrict__ vs, TQ* __restrict__ out, int H, int Hkv, int S, int ts,
                  int rotary, int tab_stride, float sm_scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  const int rep_all = H / Hkv;
  const int r0 = blockIdx.z * FLASH_MAX_REP;      // the group's first query row
  const int rep = min(rep_all - r0, FLASH_MAX_REP);
  float* sc = smem;                              // (rep, S) scores, then rounded p
  float* part = sc + rep * S;                    // (WARPS, rep, D) PV partials
  float* alpha = part + FLASH_WARPS * rep * D;   // (rep, n_tiles) tile rescale factors
  __shared__ float scratch[32];
  __shared__ float m_run[FLASH_MAX_REP], l_run[FLASH_MAX_REP];
  __shared__ float a_v[FLASH_MAX_REP], p_v[FLASH_MAX_REP], denom[FLASH_MAX_REP];
  __shared__ int8_t k8[32 * KVQ_MAX_D_PER_LANE], v8[32 * KVQ_MAX_D_PER_LANE];
  __shared__ float k8_scale, v8_scale;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t head = (size_t)b * Hkv + kvh;
  const int pos = *pos_p;
  const float* cos_row = cos_t + (size_t)b * tab_stride;
  const float* sin_row = sin_t + (size_t)b * tab_stride;

  // the new position: K10's rotary + quantize, into shared memory
  if (warp == 0)
    warp_quantize_kv<TQ, true>(k_new + head * D, D, rotary != 0, cos_row, sin_row, k8,
                               &k8_scale);
  else if (warp == 1)
    warp_quantize_kv<TQ, true>(v_new + head * D, D, false, nullptr, nullptr, v8, &v8_scale);

  float qv[FLASH_MAX_REP][DPL];
#pragma unroll
  for (int r = 0; r < FLASH_MAX_REP; ++r)
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane * DPL + t;
      const TQ* qr = q + ((size_t)b * H + kvh * rep_all + r0 + r) * D;
      float x = 0.0f;
      if (r < rep) {
        x = to_f<TQ>(qr[d]);
        if (FLAT && rotary) {
          const float partner = d < D / 2 ? -to_f<TQ>(qr[d + D / 2]) : to_f<TQ>(qr[d - D / 2]);
          x = round_to<TQ>(__fmaf_rn(x, cos_row[d], __fmul_rn(partner, sin_row[d])));
        }
      }
      qv[r][t] = x;
    }

  auto bias_at = [pos](int s) { return s < pos ? 0.0f : FLASH_NEG_INF; };
  flash_scores<int8_t, true, DPL>(qv, kq + head * S * D + lane * DPL, D, ks + head * S,
                                  bias_at, sc, rep, S, sm_scale);
  __syncthreads();
  flash_softmax<__nv_bfloat16, true>(sc, vs + head * S, alpha, m_run, l_run, rep, S, ts,
                                     scratch);
  __syncthreads();

  // the virtual step: warp r folds the new position into query row r
  if (warp < rep) {
    float dot = 0.0f;
#pragma unroll
    for (int r = 0; r < FLASH_MAX_REP; ++r) {
      if (r != warp) continue;
#pragma unroll
      for (int t = 0; t < DPL; ++t) dot = fmaf(qv[r][t], (float)k8[lane * DPL + t], dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) {
      const float s_v = __fmul_rn(__fmul_rn(dot, sm_scale), k8_scale);
      const float m_new = fmaxf(m_run[warp], s_v);
      const float m_safe = fmaxf(m_new, FLASH_NEG_INF / 2);
      const float a = expf(m_run[warp] - m_safe);
      const float p = expf(s_v - m_safe);
      const float l = __fadd_rn(__fmul_rn(l_run[warp], a), p);
      a_v[warp] = a;
      p_v[warp] = round_to<__nv_bfloat16>(p * v8_scale);
      denom[warp] = l > 0.0f ? l : 1.0f;
    }
  }
  __syncthreads();
  flash_pv<int8_t, DPL>(sc, alpha, a_v, vq + head * S * D + lane * DPL, D, bias_at, part, rep,
                        S, ts);
  __syncthreads();
  for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    float sum = 0.0f;
    for (int w = 0; w < FLASH_WARPS; ++w) sum += part[(w * rep + r) * D + d];
    sum = fmaf(p_v[r], (float)v8[d], sum);
    out[((size_t)b * H + kvh * rep_all + r0 + r) * D + d] = from_f<TQ>(sum / denom[r]);
  }
  if (WRITE && blockIdx.z == 0) {  // group 0 only, after its last read of the cache
    const int row = pos < 0 ? 0 : (pos > S - 1 ? S - 1 : pos);
    const size_t at = head * S + row;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      kq[at * D + d] = k8[d];
      vq[at * D + d] = v8[d];
    }
    if (threadIdx.x == 0) {
      ks[at] = k8_scale;
      vs[at] = v8_scale;
    }
  }
}

struct FusedAttnArgs {
  const void *q, *k_new, *v_new, *cos_t, *sin_t, *pos;
  void *kq, *vq, *ks, *vs, *out;
  int B, H, Hkv, S, ts, rotary, tab_stride;
  float sm_scale;
};

template <typename TQ, bool FLAT, bool WRITE, int DPL>
int launch_fused(const FusedAttnArgs& a, cudaStream_t st) {
  const int rep = a.H / a.Hkv, groups = (rep + FLASH_MAX_REP - 1) / FLASH_MAX_REP;
  const size_t smem =
      flash_smem_bytes(rep < FLASH_MAX_REP ? rep : FLASH_MAX_REP, a.S, 32 * DPL, a.ts);
  auto kern = fused_attn_kernel<TQ, FLAT, WRITE, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.B, a.Hkv, groups), FLASH_THREADS, smem, st>>>(
      (const TQ*)a.q, (const TQ*)a.k_new, (const TQ*)a.v_new, (const float*)a.cos_t,
      (const float*)a.sin_t, (const int*)a.pos, (int8_t*)a.kq, (int8_t*)a.vq, (float*)a.ks,
      (float*)a.vs, (TQ*)a.out, a.H, a.Hkv, a.S, a.ts, a.rotary, a.tab_stride, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename TQ, bool FLAT, bool WRITE>
int by_dim(int D, const FusedAttnArgs& a, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_fused<TQ, FLAT, WRITE, 2>(a, st);
    case 128:
      return launch_fused<TQ, FLAT, WRITE, 4>(a, st);
    case 256:
      return launch_fused<TQ, FLAT, WRITE, 8>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ>
int by_body(int D, int flat, int write, const FusedAttnArgs& a, cudaStream_t st) {
  if (flat) return by_dim<TQ, true, false>(D, a, st);
  if (write) return by_dim<TQ, false, true>(D, a, st);
  return by_dim<TQ, false, false>(D, a, st);
}

}  // namespace

// K12: one layer of virtual-tile attention; kq / vq / ks / vs point at the
// layer's (B, H_kv, S, D) int8 rows and (B, H_kv, S) f32 scales, pos at its
// int32 position; cos / sin f32 rotary tables, rows tab_stride apart (0: one
// row for every slot).  flat: q pre-rotary (MHA only);
// write: also write the row at pos (not with flat).  q_dt: 0 float32, 1
// bfloat16 (q, k_new, v_new and out share it).
SQ_EXPORT int sq_fused_attn(const void* q, const void* k_new, const void* v_new,
                            const void* cos_t, const void* sin_t, const void* pos, void* kq,
                            void* vq, void* ks, void* vs, void* out, int B, int H, int Hkv,
                            int S, int D, int ts, int rotary, int tab_stride, int flat,
                            int write, float sm_scale, int q_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!flash_shape_ok(H, Hkv, S, ts) || D > 32 * KVQ_MAX_D_PER_LANE ||
      (flat && (write || H != Hkv)))
    return (int)cudaErrorInvalidValue;
  const FusedAttnArgs a{q, k_new, v_new, cos_t, sin_t, pos, kq, vq, ks, vs, out,
                        B, H, Hkv, S, ts, rotary, tab_stride, sm_scale};
  return q_dt == DT_BF16 ? by_body<__nv_bfloat16>(D, flat, write, a, st)
                         : by_body<float>(D, flat, write, a, st);
}

// K12's split body (split_decode.cuh): bf16 q, k_new, v_new and out, D 64 or
// 128; the layer's head-major int8 rows and f32 scales, the tables and
// tab_stride as sq_fused_attn; S split over (1 << lsplit) cluster ranks,
// softmax tiles of ts positions; rotary off: cos / sin unread.
SQ_EXPORT int sq_fused_attn_split(const void* q, const void* k_new, const void* v_new,
                                  const void* cos_t, const void* sin_t, const void* pos, void* kq,
                                  void* vq, void* ks, void* vs, void* out, int B, int H, int Hkv,
                                  int S, int D, int ts, int lsplit, int rotary, int tab_stride,
                                  int flat, int write, float sm_scale, void* stream) {
  SdArgs a = {};
  if (!sd_plan(a, B, H, Hkv, S, ts, lsplit) || (flat && (write || H != Hkv)))
    return (int)cudaErrorInvalidValue;
  a.q = (const __nv_bfloat16*)q;
  a.k = kq;
  a.v = vq;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.pos = (const int*)pos;
  a.k_new = (const __nv_bfloat16*)k_new;
  a.v_new = (const __nv_bfloat16*)v_new;
  a.cos = rotary ? (const float*)cos_t : nullptr;
  a.sin = rotary ? (const float*)sin_t : nullptr;
  a.tab_stride = tab_stride;
  a.out = (__nv_bfloat16*)out;
  a.sm_scale = sm_scale;
  const SdMaps maps = {};
  cudaStream_t st = (cudaStream_t)stream;
  if (flat) return sd_by_dim<int8_t, true, SD_VIRT_FLAT>(D, a, maps, B, st);
  if (write) return sd_by_dim<int8_t, true, SD_VIRT_WRITE>(D, a, maps, B, st);
  return sd_by_dim<int8_t, true, SD_VIRT>(D, a, maps, B, st);
}
