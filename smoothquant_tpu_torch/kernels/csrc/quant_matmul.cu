// Dual-path dequant matmul (K9).
//
// Replaces smoothquant_tpu/kernels/quant_matmul.py dual_path_matmul
// (pallas_call at :248 and :255), all four bodies:
//   grouped (_kernel :71, _kernel_nosal :87):
//     out = x_sal·w_sal + x_ns·T(f32(w_q)·f32(s[c/gs, o]))
//     — the salient product seeds the f32 accumulator, the K-tiles add to it;
//   single group (_kernel_colscale :98, _kernel_colscale_nosal :127):
//     acc = x_ns·T(w_q) (exact operands: |w_q| ≤ 127), then
//     out = fma(acc, s[o], x_sal·w_sal) once at the end.
// x_ns arrives already Q-DQ'd in T (bf16, or f32), w_q (K, O) int8, scales
// (G, O) f32 or bf16, the salient block (k_s, O) in T.
//
// What bounds it on the H100: it is the prefill linear above the int path's
// crossover, so N is in the hundreds to thousands and every weight byte is
// reused N times: the bf16 operations (2·N·K·O at 989 TFLOP/s; 0.19 ms for
// a 2048-row Llama-2-7B gate_proj) bound it, not the one byte a weight
// element it reads.  The bf16 body keeps the tensor cores fed and the
// dequant off their path:
//   * 128×128 output tiles, 8 warps of 64×32, mma.sync m16n8k16 with f32
//     accumulators, k steps of 32;
//   * each step's operands double-buffered in shared memory as k-pair words
//     (rows padded to 20 words, so fragment loads hit 32 distinct banks),
//     and the next step's global loads — x rows, the int8 weight rows and
//     their group scales — issued into registers before this step's mma, so
//     one barrier a step separates the two;
//   * the weight dequantized once per block and step on the CUDA cores:
//     int8 → f32 by one add (the byte in the mantissa of 2^23, no I2F),
//     × the group scale, two values rounded to bf16 (nearest even, as
//     astype) by one cvt.
//
// f32 activations (the TPU tests' dtype) take a CUDA-core body — 64×64
// tiles of f32 FMAs, never TF32, which would round the operands to 10 bits.
#include "common.cuh"

namespace {

enum { SRC_T = 0, SRC_DEQ = 1, SRC_INT = 2 };  // B operand: T values, w_q·s, w_q

// byte c of `word` as a signed int8, exactly, in f32: the byte with its sign
// bit flipped sits in the mantissa of 2^23, so one add recovers it (no I2F)
__device__ __forceinline__ float s8_to_f(uint32_t word, int c) {
  const uint32_t u = ((word >> (8 * c)) & 0xFFu) ^ 0x80u;
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388736.0f);
}

// (bf16(lo), bf16(hi)), each rounded to nearest even, in one cvt
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------ bf16 body
constexpr int TB_M = 128, TB_N = 128, TB_K = 32, TB_THREADS = 256;
constexpr int TB_W = TB_K / 2 + 4;       // k-pair words a tile row, padded
constexpr int TB_TILE = TB_M * TB_W;     // words of one operand tile (A or B)

struct TbTile {
  int tid, gid, tig, wm, wn, n0, o0;
};

// One thread's share of a k step's global operands, held in registers
// between the loads and the shared-memory stores: A row tid/2, 16 bf16 at
// column (tid%2)·16; B rows 2·kp, 2·kp + 1 (kp = tid % 16) at 8 columns
// cg·8 (cg = tid / 16) — 8 int8 bytes a row (in .x, .y) or 8 bf16 (SRC_T) —
// and their 8 group scales (SRC_DEQ).
struct TbRegs {
  uint4 a[2];
  uint4 b[2];
  float s[8];
};

template <int SRC, typename S>
__device__ __forceinline__ void tb_load(TbRegs& r, const __nv_bfloat16* __restrict__ A, int lda,
                                        int N, const void* __restrict__ B,
                                        const S* __restrict__ scales, int O, int k_rows, int k0,
                                        int gs, const TbTile& t) {
  const int ra = t.n0 + (t.tid >> 1);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  if (ra < N) {
    const uint4* p = reinterpret_cast<const uint4*>(A + (size_t)ra * lda + k0 + (t.tid & 1) * 16);
    r.a[0] = p[0];
    r.a[1] = p[1];
  } else {
    r.a[0] = r.a[1] = z;
  }
  const int kp = t.tid & 15, o = t.o0 + (t.tid >> 4) * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + 2 * kp + h;
    r.b[h] = z;
    if (o < O && k < k_rows) {
      if constexpr (SRC == SRC_T) {
        r.b[h] = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(B) + (size_t)k * O + o));
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const int8_t*>(B) + (size_t)k * O + o));
        r.b[h].x = v.x;
        r.b[h].y = v.y;
      }
    }
  }
  if constexpr (SRC == SRC_DEQ) {
    const int k = k0 + 2 * kp;   // rows k and k + 1 share a group (gs even)
    const S* sp = scales + (size_t)(k / gs) * O + o;
#pragma unroll
    for (int c = 0; c < 8; ++c) r.s[c] = (o < O && k < k_rows) ? to_f<S>(sp[c]) : 0.0f;
  }
}

// The registers' operands into stage buffers sa / sb: A rows as they are
// (k-pair words), B dequantized and rounded to bf16, pairs (k, k + 1) of a
// column in one word.
template <int SRC>
__device__ __forceinline__ void tb_store(uint32_t* sa, uint32_t* sb, const TbRegs& r,
                                         const TbTile& t) {
  uint4* da = reinterpret_cast<uint4*>(sa + (t.tid >> 1) * TB_W + (t.tid & 1) * 8);
  da[0] = r.a[0];
  da[1] = r.a[1];
  const int kp = t.tid & 15, c0 = (t.tid >> 4) * 8;
  if constexpr (SRC == SRC_T) {
    const uint32_t w0[4] = {r.b[0].x, r.b[0].y, r.b[0].z, r.b[0].w};
    const uint32_t w1[4] = {r.b[1].x, r.b[1].y, r.b[1].z, r.b[1].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sb[(c0 + 2 * j) * TB_W + kp] = __byte_perm(w0[j], w1[j], 0x5410);
      sb[(c0 + 2 * j + 1) * TB_W + kp] = __byte_perm(w0[j], w1[j], 0x7632);
    }
  } else {
    const uint32_t w0[2] = {r.b[0].x, r.b[0].y}, w1[2] = {r.b[1].x, r.b[1].y};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v0 = s8_to_f(w0[c >> 2], c & 3), v1 = s8_to_f(w1[c >> 2], c & 3);
      if constexpr (SRC == SRC_DEQ) {
        v0 = __fmul_rn(v0, r.s[c]);
        v1 = __fmul_rn(v1, r.s[c]);
      }
      sb[(c0 + c) * TB_W + kp] = bf16_pair(v0, v1);
    }
  }
}

// acc += the warp's 64×32 share of one staged k step
__device__ __forceinline__ void tb_mma(float (&acc)[4][4][4], const uint32_t* sa,
                                       const uint32_t* sb, const TbTile& t) {
#pragma unroll
  for (int kw = 0; kw < TB_K / 2; kw += 8) {  // one k16 step: 8 pair words
    int a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = t.wm + 16 * mt + t.gid;
      a[mt][0] = (int)sa[r * TB_W + kw + t.tig];
      a[mt][1] = (int)sa[(r + 8) * TB_W + kw + t.tig];
      a[mt][2] = (int)sa[r * TB_W + kw + 4 + t.tig];
      a[mt][3] = (int)sa[(r + 8) * TB_W + kw + 4 + t.tig];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = t.wn + 8 * nt + t.gid;
      b[nt][0] = (int)sb[c * TB_W + kw + t.tig];
      b[nt][1] = (int)sb[c * TB_W + kw + 4 + t.tig];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
  }
}

// acc += A (N, k_steps·32 bf16, row stride lda) · B (rows < k_rows, O
// columns; SRC as above) for the block's tile: the k steps pipelined through
// two stage buffers with one barrier a step.  Ends with a barrier, so the
// buffers may be reused.
template <int SRC, typename S>
__device__ __forceinline__ void tb_gemm(float (&acc)[4][4][4], uint32_t* smem,
                                        const __nv_bfloat16* __restrict__ A, int lda, int N,
                                        const void* __restrict__ B, const S* __restrict__ scales,
                                        int O, int k_rows, int k_steps, int gs, const TbTile& t) {
  if (k_steps == 0) return;
  TbRegs r;
  tb_load<SRC, S>(r, A, lda, N, B, scales, O, k_rows, 0, gs, t);
  tb_store<SRC>(smem, smem + TB_TILE, r, t);
  __syncthreads();
  for (int s = 0; s < k_steps; ++s) {
    uint32_t* cur = smem + (s & 1) * 2 * TB_TILE;
    uint32_t* nxt = smem + ((s + 1) & 1) * 2 * TB_TILE;
    if (s + 1 < k_steps)
      tb_load<SRC, S>(r, A, lda, N, B, scales, O, k_rows, (s + 1) * TB_K, gs, t);
    tb_mma(acc, cur, cur + TB_TILE, t);
    if (s + 1 < k_steps) tb_store<SRC>(nxt, nxt + TB_TILE, r, t);
    __syncthreads();
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

template <typename S, bool GROUPED>
__global__ void __launch_bounds__(TB_THREADS)
dual_path_bf16_kernel(const __nv_bfloat16* __restrict__ x_ns,
                      const __nv_bfloat16* __restrict__ x_sal, const int8_t* __restrict__ w,
                      const S* __restrict__ scales, const __nv_bfloat16* __restrict__ w_sal,
                      __nv_bfloat16* __restrict__ out, int N, int O, int K, int x_ld, int gs,
                      int ks) {
  __shared__ __align__(16) uint32_t smem[4 * TB_TILE];
  TbTile t;
  t.tid = threadIdx.x;
  const int lane = t.tid & 31, warp = t.tid >> 5;
  t.gid = lane >> 2;
  t.tig = lane & 3;
  t.wm = (warp >> 2) * 64;
  t.wn = (warp & 3) * 32;
  t.n0 = blockIdx.y * TB_M;
  t.o0 = blockIdx.x * TB_N;

  float acc[4][4][4], sal[4][4][4];
  zero4(acc);
  if constexpr (GROUPED) {
    // the salient product seeds the accumulator, the K steps add to it
    tb_gemm<SRC_T, S>(acc, smem, x_sal, ks, N, w_sal, scales, O, ks, ks / TB_K, gs, t);
    tb_gemm<SRC_DEQ, S>(acc, smem, x_ns, x_ld, N, w, scales, O, K, x_ld / TB_K, gs, t);
  } else {
    // x_ns·w_q, then apart x_sal·w_sal, added after the column scale
    tb_gemm<SRC_INT, S>(acc, smem, x_ns, x_ld, N, w, scales, O, K, x_ld / TB_K, gs, t);
    zero4(sal);
    tb_gemm<SRC_T, S>(sal, smem, x_sal, ks, N, w_sal, scales, O, ks, ks / TB_K, gs, t);
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = t.n0 + t.wm + 16 * mt + t.gid + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = t.o0 + t.wn + 8 * nt + 2 * t.tig;
        if (o >= O) continue;
        float y0 = acc[mt][nt][2 * h], y1 = acc[mt][nt][2 * h + 1];
        if constexpr (!GROUPED) {
          y0 = __fmaf_rn(y0, to_f<S>(scales[o]), sal[mt][nt][2 * h]);
          y1 = __fmaf_rn(y1, to_f<S>(scales[o + 1]), sal[mt][nt][2 * h + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)n * O + o) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
}

// ------------------------------------------------------------- f32 body
constexpr int DP_BM = 64, DP_BN = 64, DP_BK = 32, DP_THREADS = 128;
constexpr int DP_AF = DP_BK + 1;           // A tile row stride (floats)

// Thread (warp, lane) owns acc[mt][nt][e] at tile row
// wm + 16·mt + lane/4 + 8·(e/2) and column wn + 8·nt + 2·(lane%4) + e%2.
struct DpTile {
  int tid, gid, tig, wm, wn, n0, o0;
};

// A tile: rows n0.. (< N, others 0), k0 .. k0 + 31 of a row-major (·, ld)
// matrix whose rows are zero-padded to whole DP_BK steps.
__device__ __forceinline__ void stage_a_f32(float* fa, const float* __restrict__ src, int ld,
                                            int N, int k0, const DpTile& t) {
#pragma unroll
  for (int i = 0; i < DP_BM * DP_BK / DP_THREADS; ++i) {
    const int e = t.tid + i * DP_THREADS;
    const int r = e / DP_BK, j = e % DP_BK, n = t.n0 + r;
    fa[r * DP_AF + j] = n < N ? src[(size_t)n * ld + k0 + j] : 0.0f;
  }
}

// B tile [k][column]: rows k0 .. k0 + 31 (< k_end) and columns o0 .. (< O)
// of the B source as f32: SRC_T a (rows, O) f32 matrix; SRC_INT f32(w_q);
// SRC_DEQ f32(w_q)·f32(s[k/gs]).
template <int SRC, typename S>
__device__ __forceinline__ void stage_b_f32(float* fb, const void* __restrict__ src,
                                            const S* __restrict__ scales, int O, int k0,
                                            int k_end, int gs, const DpTile& t) {
#pragma unroll
  for (int i = 0; i < DP_BK * (DP_BN / 4) / DP_THREADS; ++i) {
    const int e = t.tid + i * DP_THREADS;
    const int j = e / (DP_BN / 4), cq = e % (DP_BN / 4), o = t.o0 + cq * 4, k = k0 + j;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (o < O && k < k_end) {
      if constexpr (SRC == SRC_T) {
        const float* p = static_cast<const float*>(src) + (size_t)k * O + o;
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = p[c];
      } else {
        const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(
            static_cast<const int8_t*>(src) + (size_t)k * O + o));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = s8_to_f(word, c);
          if constexpr (SRC == SRC_DEQ)
            v[c] = __fmul_rn(v[c], to_f<S>(scales[(size_t)(k / gs) * O + o + c]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) fb[j * DP_BN + cq * 4 + c] = v[c];
  }
}

// acc += the warp's 32×32 share of the staged A (64 × 32) · B (32 × 64).
__device__ __forceinline__ void fma_tile(float (&acc)[2][4][4], const float* fa, const float* fb,
                                         const DpTile& t) {
#pragma unroll 4
  for (int j = 0; j < DP_BK; ++j) {
    float xv[2][2], wv[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) xv[mt][h] = fa[(t.wm + 16 * mt + t.gid + 8 * h) * DP_AF + j];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) wv[nt][h] = fb[j * DP_BN + t.wn + 8 * nt + 2 * t.tig + h];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = __fmaf_rn(xv[mt][e >> 1], wv[nt][e & 1], acc[mt][nt][e]);
  }
}

template <int SRC, typename S>
__device__ __forceinline__ void fma_gemm(float (&acc)[2][4][4], float* fa, float* fb,
                                         const float* __restrict__ A, int lda, int N,
                                         const void* __restrict__ B, const S* __restrict__ scales,
                                         int O, int k_rows, int k_cols, int gs, const DpTile& t) {
  for (int k0 = 0; k0 < k_cols; k0 += DP_BK) {
    stage_a_f32(fa, A, lda, N, k0, t);
    stage_b_f32<SRC, S>(fb, B, scales, O, k0, k_rows, gs, t);
    __syncthreads();
    fma_tile(acc, fa, fb, t);
    __syncthreads();
  }
}

template <typename S, bool GROUPED>
__global__ void __launch_bounds__(DP_THREADS)
dual_path_f32_kernel(const float* __restrict__ x_ns, const float* __restrict__ x_sal,
                     const int8_t* __restrict__ w, const S* __restrict__ scales,
                     const float* __restrict__ w_sal, float* __restrict__ out, int N, int O,
                     int K, int x_ld, int gs, int ks) {
  __shared__ float fa[DP_BM * DP_AF];
  __shared__ float fb[DP_BK * DP_BN];
  DpTile t;
  t.tid = threadIdx.x;
  const int lane = t.tid & 31, warp = t.tid >> 5;
  t.gid = lane >> 2;
  t.tig = lane & 3;
  t.wm = (warp >> 1) * 32;
  t.wn = (warp & 1) * 32;
  t.n0 = blockIdx.y * DP_BM;
  t.o0 = blockIdx.x * DP_BN;

  float acc[2][4][4], sal[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = sal[mt][nt][e] = 0.0f;
  if constexpr (GROUPED) {
    // the salient product seeds the accumulator, the K tiles add to it
    fma_gemm<SRC_T, S>(acc, fa, fb, x_sal, ks, N, w_sal, scales, O, ks, ks, gs, t);
    fma_gemm<SRC_DEQ, S>(acc, fa, fb, x_ns, x_ld, N, w, scales, O, K, x_ld, gs, t);
  } else {
    fma_gemm<SRC_INT, S>(acc, fa, fb, x_ns, x_ld, N, w, scales, O, K, x_ld, gs, t);
    fma_gemm<SRC_T, S>(sal, fa, fb, x_sal, ks, N, w_sal, scales, O, ks, ks, gs, t);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = t.n0 + t.wm + 16 * mt + t.gid + 8 * (e >> 1);
        const int o = t.o0 + t.wn + 8 * nt + 2 * t.tig + (e & 1);
        if (n >= N || o >= O) continue;
        float y = acc[mt][nt][e];
        if (!GROUPED) y = __fmaf_rn(y, to_f<S>(scales[o]), sal[mt][nt][e]);
        out[(size_t)n * O + o] = y;
      }
}

template <typename S>
int launch(const void* x_ns, const void* x_sal, const void* w, const void* scales,
           const void* w_sal, void* out, int N, int O, int K, int x_ld, int gs, int ks,
           int grouped, int x_dt, cudaStream_t st) {
  if (x_dt == DT_BF16) {
    const dim3 grid((O + TB_N - 1) / TB_N, (N + TB_M - 1) / TB_M);
    auto kern = grouped ? dual_path_bf16_kernel<S, true> : dual_path_bf16_kernel<S, false>;
    kern<<<grid, TB_THREADS, 0, st>>>(
        (const __nv_bfloat16*)x_ns, (const __nv_bfloat16*)x_sal, (const int8_t*)w,
        (const S*)scales, (const __nv_bfloat16*)w_sal, (__nv_bfloat16*)out, N, O, K, x_ld, gs,
        ks);
  } else {
    const dim3 grid((O + DP_BN - 1) / DP_BN, (N + DP_BM - 1) / DP_BM);
    auto kern = grouped ? dual_path_f32_kernel<S, true> : dual_path_f32_kernel<S, false>;
    kern<<<grid, DP_THREADS, 0, st>>>((const float*)x_ns, (const float*)x_sal,
                                      (const int8_t*)w, (const S*)scales, (const float*)w_sal,
                                      (float*)out, N, O, K, x_ld, gs, ks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K9: out (N, O) in the activation dtype.  x_ns (N, x_ld) and x_sal (N, ks)
// in that dtype (x_dt: 0 f32, 1 bf16), rows zero-padded to multiples of 32;
// w (K, O) int8; scales (G, O) (s_dt), G = K / gs, or (1, O) with grouped = 0
// (the column-scale bodies); w_sal (ks, O).  O must be a multiple of 8.
SQ_EXPORT int sq_dual_path(const void* x_ns, const void* x_sal, const void* w,
                           const void* scales, const void* w_sal, void* out, int N, int O,
                           int K, int x_ld, int gs, int ks, int grouped, int s_dt, int x_dt,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || O % 8 || x_ld % TB_K || x_ld < K || ks % TB_K ||
      (grouped && (gs % 2 || K % gs)))
    return (int)cudaErrorInvalidValue;
  return s_dt == DT_BF16 ? launch<__nv_bfloat16>(x_ns, x_sal, w, scales, w_sal, out, N, O, K,
                                                 x_ld, gs, ks, grouped, x_dt, st)
                         : launch<float>(x_ns, x_sal, w, scales, w_sal, out, N, O, K, x_ld, gs,
                                         ks, grouped, x_dt, st);
}
