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
// element it reads.  The bf16 body (dual_path_wg_kernel) is a
// warp-specialized wgmma kernel that keeps the dequantization off the
// tensor cores' path:
//   * output tiles of 192 × 128 (grouped; three consumer warpgroups) or
//     128 × 128 (single group; two, whose two accumulators fit their
//     registers); each consumer runs wgmma.mma_async m64n128k16 bf16 on its
//     64 rows with f32 accumulators, the salient stages first (into the same
//     accumulator, or into a second one the epilogue joins with
//     fma(acc, s[o], sal)), and meets the producers only at named barriers;
//   * two producer warpgroups copy each 64-column stage — x_ns (K-major, as
//     it lies: TMA, 128-byte swizzle, which the wgmma descriptor names), the
//     raw int8 weight rows (TMA where O % 16 == 0, else cp.async) and the
//     stage's group-scale rows — into a ring of three slots on mbarriers, two
//     stages ahead, and dequantize stage t + 1 while the consumers' wgmma run
//     stage t, with the plain version's rule: int8 → f32 by a byte permute
//     and one add (the byte in the mantissa of 2^23, no I2F), × the f32
//     group scale, rounded to bf16 to nearest even, written K-major as
//     (k, k + 1) pairs.
// scripts/wg_variants.py times the designs it did not take on the H100:
// every thread issuing wgmma and dequantizing (four warpgroups grouped,
// one barrier a stage), and four consumers (ptxas cannot fit the
// accumulator in 80 registers a thread).
// chip_smoke.py's sass phase holds the build to HGMMA in every K9 wgmma
// kernel.  Times beside the bound: PERF.md §6.
//
// f32 activations (the TPU tests' dtype) take a CUDA-core body — 64×64
// tiles of f32 FMAs, never TF32, which would round the operands to 10 bits.
#include "wg_gemm.cuh"

namespace {

enum { SRC_T = 0, SRC_DEQ = 1, SRC_INT = 2 };  // B operand: T values, w_q·s, w_q

// ------------------------------------------------------------ bf16 body
// DqShape<CWG>: CWG consumer warpgroups (64 output rows each) run the wgmma;
// two producer warpgroups copy the stages in (TMA) and dequantize each
// stage's weight into the K-major tile wgmma reads, a stage ahead.  The
// grouped bodies take three consumers (192-row tiles: the dequantization of
// a weight stage is paid once per 192 rows; a fourth consumer leaves ptxas
// 80 registers a thread at launch, too few for the accumulator), the
// single-group bodies two (whose second accumulator takes setmaxnreg's
// registers from the producers).  A slot of the ring: the A stage (64 bf16
// columns of x_ns or x_sal, one 128-byte SWIZZLE_128B row per tile row) and
// the raw B rows (64 int8 rows of 128 bytes, SWIZZLE_128B, or of 144 bytes
// where cp.async copies them; or salient bf16 rows in two halves),
// 1024-byte aligned as the swizzle needs; past the slots, each slot's
// group-scale rows (SCS), sized for the most a stage can need: 33 f32 rows
// at group size 2.  The slots' mbarriers sit past the two Bt buffers.
constexpr int DQ_RAW8_LD = 144;     // a raw int8 row copied by cp.async (padded)
constexpr int DQ_SC_BYTES = 16896;  // a slot's group-scale rows: (63 / 2 + 2) × 128 × 4
template <int CWG>
struct DqShape {
  static constexpr int CONSUMERS = 128 * CWG, THREADS = CONSUMERS + 256, BM = 64 * CWG;
  static constexpr int STAGES = 3;
  static constexpr int REGS = (65536 / THREADS) & ~7;   // at launch
  static constexpr int PRODUCER_REGS = 96;
  static constexpr int CONSUMER_REGS = REGS + (REGS - PRODUCER_REGS) * 256 / CONSUMERS;
  static constexpr int A = 0, RAW = BM * 128, SLOT = RAW + 16384;
  static constexpr int SCS = STAGES * SLOT, BT = SCS + STAGES * DQ_SC_BYTES;
  static constexpr int BAR = BT + 2 * WG_BT_BYTES, SMEM = BAR + 8 * STAGES;
  static_assert(SMEM <= 227 * 1024, "the H100's shared memory per block");
};
// named barriers: Bt buffer b ready (DQ_FULL + b) / a stage of its parity consumed (DQ_EMPTY + b)
constexpr int DQ_FULL = 1, DQ_EMPTY = 3;

struct DqArgs {
  const int8_t* w;
  int N, O, K, x_ld, gs, ks;
  int G;              // groups (grouped bodies)
  uint32_t gs_magic;  // ceil(2^32 / gs): k / gs = umulhi(k, gs_magic) for the k that occur
  int sc_rows;        // scale rows a stage's box holds: groups k0 / gs .. (k0 + 63) / gs
};

struct DqMaps {   // x_ns (N, x_ld), x_sal (N, ks), w_sal (ks, O), w (K, O), scales (G, O)
  CUtensorMap x, xsal, wsal, w, sc;
};

// the scale rows a grouped stage may need: groups k0 / gs .. (k0 + 63) / gs
__host__ __device__ __forceinline__ int dq_scale_rows(int gs) { return 63 / gs + 2; }

// Stage t into its slot, by the producers (pt: their thread, 0-255):
// salient stages (t < n_sal) take 64 columns of x_sal and 64 rows of w_sal;
// stage n_sal + j columns 64·j.. of x_ns, the int8 weight rows 64·j.. and
// (GROUPED) the scale rows of their groups — by TMA from thread 0, the
// weight rows by cp.async where TMA cannot take them (TMA_B false:
// O % 16 != 0).  Each producer thread then reports its copies to the
// slot's mbarrier.
template <int CWG, typename S, bool GROUPED, bool TMA_B>
__device__ __forceinline__ void dq_load(const DqArgs& a, const DqMaps& m, char* smem, int t,
                                        int n_sal, int n0, int o0, int pt) {
  using D = DqShape<CWG>;
  const int slot = t % D::STAGES;
  const uint32_t s = smem_u32(smem + slot * D::SLOT);
  const uint32_t bar = smem_u32(smem + D::BAR + 8 * slot);
  const int k0 = (t - n_sal) * WG_KB;
  if (pt == 0) {
    if (t < n_sal) {
      mbar_expect_tx(bar, D::BM * 128 + 2 * WG_RAW16_HALF);
      tma_2d(s + D::A, m.xsal, bar, t * WG_KB, n0);
      tma_2d(s + D::RAW, m.wsal, bar, o0, t * WG_KB);
      tma_2d(s + D::RAW + WG_RAW16_HALF, m.wsal, bar, o0 + 64, t * WG_KB);
    } else {
      mbar_expect_tx(bar, D::BM * 128 + (TMA_B ? WG_KB * WG_BN : 0) +
                              (GROUPED ? a.sc_rows * WG_BN * (int)sizeof(S) : 0));
      tma_2d(s + D::A, m.x, bar, k0, n0);
      if (TMA_B) tma_2d(s + D::RAW, m.w, bar, o0, k0);
      if (GROUPED)
        tma_2d(smem_u32(smem + D::SCS + slot * DQ_SC_BYTES), m.sc, bar, o0,
               (int)__umulhi(k0, a.gs_magic));
    }
  }
  if (!TMA_B && t >= n_sal) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = pt + i * 256, q = e >> 4, c8 = e & 15;
      const int k = k0 + q, o = o0 + 8 * c8;
      const bool ok = k < a.K && o < a.O;
      cp8(s + D::RAW + q * DQ_RAW8_LD + c8 * 8, ok ? a.w + (size_t)k * a.O + o : a.w, ok);
    }
  }
  cp_async_arrive(bar);
}

// Stage t's B into a Bt buffer as bf16 pairs (k, k + 1) of a column, by the
// producers: the salient rows as they are; the int8 rows dequantized as the
// plain version does, f32(w_q) (no I2F) × the f32 group scale (GROUPED),
// rounded to bf16 to nearest even.  A lane's items share its four columns;
// rows ≥ K were copied as zeros and take the last group's (finite) scale.
template <int CWG, typename S, bool GROUPED, bool TMA_B>
__device__ __forceinline__ void dq_transform(char* bt, const char* smem, int t, int n_sal,
                                             const DqArgs& a, const WgLane& l) {
  using D = DqShape<CWG>;
  const char* slot = smem + (t % D::STAGES) * D::SLOT;
  if (t < n_sal) {
    wg_transform_b16<256>(bt, slot + D::RAW, l);
    return;
  }
  const int k0 = (t - n_sal) * WG_KB;
  const char* raw = slot + D::RAW;
  const S* sc =
      reinterpret_cast<const S*>(smem + D::SCS + (t % D::STAGES) * DQ_SC_BYTES) + 4 * l.cq;
  const int g0 = GROUPED ? (int)__umulhi(k0, a.gs_magic) : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = l.u0 + 8 * i, r = 2 * kp;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
        raw + (TMA_B ? wg_sw128(r, 4 * l.cq) : r * DQ_RAW8_LD + 4 * l.cq));
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
        raw + (TMA_B ? wg_sw128(r + 1, 4 * l.cq) : (r + 1) * DQ_RAW8_LD + 4 * l.cq));
    const uint32_t x0 = w0 ^ 0x80808080u, x1 = w1 ^ 0x80808080u;
    int srow = 0;
    if constexpr (GROUPED)   // rows k and k + 1 share a group (gs even)
      srow = (min((int)__umulhi(k0 + r, a.gs_magic), a.G - 1) - g0) * WG_BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l.c[j];
      const uint32_t sel = 0x7440 | c;   // byte c under 0x4B: s8_to_f's bit pattern
      float v0 = __fsub_rn(__uint_as_float(__byte_perm(x0, 0x4B000000u, sel)), 8388736.0f);
      float v1 = __fsub_rn(__uint_as_float(__byte_perm(x1, 0x4B000000u, sel)), 8388736.0f);
      if constexpr (GROUPED) {
        const float sv = to_f<S>(sc[srow + c]);
        v0 = __fmul_rn(v0, sv);
        v1 = __fmul_rn(v1, sv);
      }
      *reinterpret_cast<uint32_t*>(bt + wg_kmajor_off(4 * l.cq + c, kp, WG_A16_SBO)) =
          bf16_pair(v0, v1);
    }
  }
}

// The producers: stage t is dequantized into Bt buffer t % 2 and handed
// over; then they wait for the consumers to release stage t − 1, whose Bt
// buffer stage t + 1 takes and whose slot stage t + 2's copies take.  So the
// dequantization of stage t runs beside the consumers' wgmma of stage t − 1.
template <int CWG, typename S, bool GROUPED, bool TMA_B>
__device__ __forceinline__ void dq_producer(const DqArgs& a, const DqMaps& m, char* smem, int T,
                                            int n_sal, int n0, int o0, int pt) {
  using D = DqShape<CWG>;
  const WgLane l = wg_lane(pt);
  if (pt == 0) {
    tma_prefetch(m.x);
    if (TMA_B) tma_prefetch(m.w);
    if (GROUPED) tma_prefetch(m.sc);
    if (n_sal) {
      tma_prefetch(m.xsal);
      tma_prefetch(m.wsal);
    }
  }
  for (int s = 0; s < 2 && s < T; ++s)
    dq_load<CWG, S, GROUPED, TMA_B>(a, m, smem, s, n_sal, n0, o0, pt);
  for (int t = 0; t < T; ++t) {
    mbar_wait(smem_u32(smem + D::BAR + 8 * (t % D::STAGES)), (t / D::STAGES) & 1);
    dq_transform<CWG, S, GROUPED, TMA_B>(smem + D::BT + (t & 1) * WG_BT_BYTES, smem, t, n_sal,
                                         a, l);
    fence_async_smem();
    named_arrive<D::THREADS>(DQ_FULL + (t & 1));
    if (t >= 1 && t + 1 < T) named_sync<D::THREADS>(DQ_EMPTY + ((t - 1) & 1));
    if (t + 2 < T) dq_load<CWG, S, GROUPED, TMA_B>(a, m, smem, t + 2, n_sal, n0, o0, pt);
  }
}

// The consumers: stage t's four k16 wgmma into d once the producers hand it
// over, then its release (only the stages the producers wait for: 0 .. T − 3).
template <int CWG>
__device__ __forceinline__ void dq_consume(float (&d)[64], char* smem, int t, int T, int wg) {
  using D = DqShape<CWG>;
  named_sync<D::THREADS>(DQ_FULL + (t & 1));
  wg_mma_bf16(d, smem_u32(smem + (t % D::STAGES) * D::SLOT) + D::A + wg * 64 * 128,
              smem_u32(smem + D::BT + (t & 1) * WG_BT_BYTES));
  wg_wait<0>();
  wg_fence_regs(d);
  if (t <= T - 3) named_arrive<D::THREADS>(DQ_EMPTY + (t & 1));
}

// Stages: ks / 64 salient stages, then x_ld / 64 of x_ns · w.  GROUPED:
// everything into one f32 accumulator, seeded by the salient stages; else
// x_sal · w_sal and x_ns · T(w_q) into two, joined by out = fma(acc, s[o],
// sal).  No wgmma, commit or wait sits in a branch.
template <int CWG, typename S, bool GROUPED>
__device__ __forceinline__ void dq_consumer(const DqArgs& a, const S* __restrict__ scales,
                                            __nv_bfloat16* __restrict__ out, char* smem, int T,
                                            int n_sal, int n0, int o0, int tid) {
  const int wg = tid >> 7, lane = tid & 31;
  const int row = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  float acc[64], sal[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sal[i] = 0.0f;
  for (int t = 0; t < n_sal; ++t) {
    if constexpr (GROUPED)
      dq_consume<CWG>(acc, smem, t, T, wg);
    else
      dq_consume<CWG>(sal, smem, t, T, wg);
  }
  for (int t = n_sal; t < T; ++t) dq_consume<CWG>(acc, smem, t, T, wg);

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int o = o0 + 8 * i + 2 * (lane & 3);
    if (o >= a.O) continue;
    float2 s = make_float2(0.0f, 0.0f);
    if constexpr (!GROUPED) s = load2_f(scales + o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + row + 8 * h;
      if (n >= a.N) continue;
      float y0 = acc[4 * i + 2 * h], y1 = acc[4 * i + 2 * h + 1];
      if constexpr (!GROUPED) {
        y0 = __fmaf_rn(y0, s.x, sal[4 * i + 2 * h]);
        y1 = __fmaf_rn(y1, s.y, sal[4 * i + 2 * h + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)n * a.O + o) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int CWG, typename S, bool GROUPED, bool TMA_B>
__global__ void __launch_bounds__(DqShape<CWG>::THREADS, 1)
dual_path_wg_kernel(const DqArgs a, const __grid_constant__ DqMaps m,
                    const S* __restrict__ scales, __nv_bfloat16* __restrict__ out) {
  using D = DqShape<CWG>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x;
  int n0, o0;
  wg_tile<D::BM>(n0, o0);
  const int n_sal = a.ks / WG_KB, T = n_sal + a.x_ld / WG_KB;
  if (tid == 0) {
    for (int s = 0; s < D::STAGES; ++s) mbar_init(smem_u32(smem + D::BAR + 8 * s), 1 + 256);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= D::CONSUMERS) {
    regs_dec<D::PRODUCER_REGS>();
    dq_producer<CWG, S, GROUPED, TMA_B>(a, m, smem, T, n_sal, n0, o0, tid - D::CONSUMERS);
  } else {
    regs_inc<D::CONSUMER_REGS>();
    dq_consumer<CWG, S, GROUPED>(a, scales, out, smem, T, n_sal, n0, o0, tid);
  }
}

template <int CWG, typename S, bool GROUPED, bool TMA_B>
int launch_dual_path_wg(const DqArgs& a, const DqMaps& m, const void* scales, void* out,
                        cudaStream_t st) {
  using D = DqShape<CWG>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(dual_path_wg_kernel<CWG, S, GROUPED, TMA_B>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid = wg_grid(a.N, a.O, D::BM);
  dual_path_wg_kernel<CWG, S, GROUPED, TMA_B><<<grid, D::THREADS, D::SMEM, st>>>(
      a, m, static_cast<const S*>(scales), static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The bf16 body: its maps, the weight by TMA where O % 16 == 0 and it is
// 16-byte aligned, and the body for the group layout (256-row tiles for the
// grouped bodies, 128-row ones for the single-group bodies).
template <typename S>
int launch_bf16(const void* x_ns, const void* x_sal, const void* w, const void* scales,
                const void* w_sal, void* out, int N, int O, int K, int x_ld, int gs, int ks,
                int grouped, cudaStream_t st) {
  // k / gs as umulhi(k, ceil(2^32 / gs)) is exact while k·(magic·gs − 2^32) < 2^32
  const uint32_t magic = grouped ? (uint32_t)((0x100000000ull + gs - 1) / gs) : 0u;
  const int rows = grouped ? dq_scale_rows(gs) : 0;
  if (grouped && ((uint64_t)x_ld * ((uint64_t)magic * gs - 0x100000000ull) >= 0x100000000ull ||
                  rows * WG_BN * (int)sizeof(S) > DQ_SC_BYTES))
    return (int)cudaErrorInvalidValue;
  const DqArgs a{(const int8_t*)w, N, O, K, x_ld, gs, ks, grouped ? K / gs : 1, magic, rows};
  const bool tma_b = O % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int bm = grouped ? DqShape<3>::BM : DqShape<2>::BM;
  constexpr CUtensorMapDataType sdt =
      sizeof(S) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  DqMaps m = {};
  bool ok = wg_map(&m.x, x_ns, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x_ld, N, x_ld, WG_KB, bm,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (ok && ks > 0)
    ok = wg_map(&m.xsal, x_sal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ks, N, ks, WG_KB, bm,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         wg_map(&m.wsal, w_sal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, ks, O, 64, WG_KB,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (ok && tma_b)
    ok = wg_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, K, O, WG_BN, WG_KB,
                CU_TENSOR_MAP_SWIZZLE_128B);
  if (ok && grouped)
    ok = wg_map(&m.sc, scales, sdt, sizeof(S), O, K / gs, O, WG_BN, rows,
                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (grouped)
    return tma_b ? launch_dual_path_wg<3, S, true, true>(a, m, scales, out, st)
                 : launch_dual_path_wg<3, S, true, false>(a, m, scales, out, st);
  return tma_b ? launch_dual_path_wg<2, S, false, true>(a, m, scales, out, st)
               : launch_dual_path_wg<2, S, false, false>(a, m, scales, out, st);
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
  if (x_dt == DT_BF16)
    return launch_bf16<S>(x_ns, x_sal, w, scales, w_sal, out, N, O, K, x_ld, gs, ks, grouped, st);
  const dim3 grid((O + DP_BN - 1) / DP_BN, (N + DP_BM - 1) / DP_BM);
  auto kern = grouped ? dual_path_f32_kernel<S, true> : dual_path_f32_kernel<S, false>;
  kern<<<grid, DP_THREADS, 0, st>>>((const float*)x_ns, (const float*)x_sal, (const int8_t*)w,
                                    (const S*)scales, (const float*)w_sal, (float*)out, N, O,
                                    K, x_ld, gs, ks);
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
  if (N < 1 || O % 8 || x_ld % WG_KB || x_ld < K || ks % WG_KB ||
      (grouped && (gs % 2 || K % gs)))
    return (int)cudaErrorInvalidValue;
  return s_dt == DT_BF16 ? launch<__nv_bfloat16>(x_ns, x_sal, w, scales, w_sal, out, N, O, K,
                                                 x_ld, gs, ks, grouped, x_dt, st)
                         : launch<float>(x_ns, x_sal, w, scales, w_sal, out, N, O, K, x_ld, gs,
                                         ks, grouped, x_dt, st);
}
