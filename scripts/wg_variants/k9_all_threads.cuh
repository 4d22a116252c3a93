// K9's bf16 body with every thread on both jobs: a design the committed
// body (csrc/quant_matmul.cu) did not take.  Four warpgroups (grouped;
// two for one group), each issues its wgmma for stage t, then dequantizes
// stage t + 1 while they run; one barrier a stage.  scripts/wg_variants.py
// splices this section in place of the committed one (from its "bf16 body"
// rule to the host's launch_bf16) and times it against it.
// ------------------------------------------------------------ bf16 body
// DqShape<WGS>: WGS warpgroups, a tile of 64·WGS × 128 outputs.  A slot of
// the ring: the A stage (64 bf16 columns of x_ns or x_sal, one 128-byte
// SWIZZLE_128B row per tile row) and the raw B rows (64 int8 rows of 128
// bytes, SWIZZLE_128B, or of 144 bytes where cp.async copies them; or
// salient bf16 rows in two halves), 1024-byte aligned as the swizzle needs;
// past the slots, each slot's group-scale rows (SCS), sized for the most a
// stage can need: 33 f32 rows at group size 2.  The slots' mbarriers sit
// past the two Bt buffers.  The grouped bodies take four warpgroups
// (256-row tiles): the dequantization of a weight stage, which bounds a
// 128-row tile, is then spread over twice the rows and sixteen warps, and
// runs beside twice the tensor-core work.  The single-group bodies keep two
// (their second accumulator would not fit 512 threads' registers).
constexpr int DQ_RAW8_LD = 144;     // a raw int8 row copied by cp.async (padded)
constexpr int DQ_SC_BYTES = 16896;  // a slot's group-scale rows: (63 / 2 + 2) × 128 × 4
template <int WGS>
struct DqShape {
  static constexpr int THREADS = 128 * WGS, BM = 64 * WGS;
  static constexpr int STAGES = WGS == 4 ? 3 : 4;
  static constexpr int A = 0, RAW = BM * 128, SLOT = RAW + 16384;
  static constexpr int SCS = STAGES * SLOT, BT = SCS + STAGES * DQ_SC_BYTES;
  static constexpr int BAR = BT + 2 * WG_BT_BYTES, SMEM = BAR + 8 * STAGES;
  static_assert(SMEM <= 227 * 1024, "the H100's shared memory per block");
};

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

// Stage t into its slot: salient stages (t < n_sal) take 64 columns of x_sal
// and 64 rows of w_sal; stage n_sal + j columns 64·j.. of x_ns, the int8
// weight rows 64·j.. and (GROUPED) the scale rows of their groups — by TMA
// from thread 0, the weight rows by cp.async where TMA cannot take them
// (TMA_B false: O % 16 != 0).  Every thread then reports its copies to the
// slot's mbarrier.
template <int WGS, typename S, bool GROUPED, bool TMA_B>
__device__ __forceinline__ void dq_load(const DqArgs& a, const DqMaps& m, char* smem, int t,
                                        int n_sal, int n0, int o0, int tid) {
  using D = DqShape<WGS>;
  const int slot = t % D::STAGES;
  const uint32_t s = smem_u32(smem + slot * D::SLOT);
  const uint32_t bar = smem_u32(smem + D::BAR + 8 * slot);
  const int k0 = (t - n_sal) * WG_KB;
  if (tid == 0) {
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
    for (int i = 0; i < 1024 / D::THREADS; ++i) {
      const int e = tid + i * D::THREADS, q = e >> 4, c8 = e & 15;
      const int k = k0 + q, o = o0 + 8 * c8;
      const bool ok = k < a.K && o < a.O;
      cp8(s + D::RAW + q * DQ_RAW8_LD + c8 * 8, ok ? a.w + (size_t)k * a.O + o : a.w, ok);
    }
  }
  cp_async_arrive(bar);
}

// Stage t's B into a Bt buffer as bf16 pairs (k, k + 1) of a column: the
// salient rows as they are; the int8 rows dequantized as the plain version
// does, f32(w_q) (no I2F) × the f32 group scale (GROUPED), rounded to bf16 to
// nearest even.  A lane's items share its four columns; rows ≥ K were
// copied as zeros and take the last group's (finite) scale.
template <int WGS, typename S, bool GROUPED, bool TMA_B>
__device__ __forceinline__ void dq_transform(char* bt, const char* smem, int t, int n_sal,
                                             const DqArgs& a, const WgLane& l) {
  using D = DqShape<WGS>;
  const char* slot = smem + (t % D::STAGES) * D::SLOT;
  if (t < n_sal) {
    wg_transform_b16<D::THREADS>(bt, slot + D::RAW, l);
    return;
  }
  const int k0 = (t - n_sal) * WG_KB;
  const char* raw = slot + D::RAW;
  const S* sc =
      reinterpret_cast<const S*>(smem + D::SCS + (t % D::STAGES) * DQ_SC_BYTES) + 4 * l.cq;
  const int g0 = GROUPED ? (int)__umulhi(k0, a.gs_magic) : 0;
#pragma unroll
  for (int i = 0; i < 1024 / D::THREADS; ++i) {
    const int kp = l.u0 + D::THREADS / 32 * i, r = 2 * kp;
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

// Iteration t: issue stage t's four k16 wgmma into d; while the tensor
// cores run them, wait for stage t + 1's copies, dequantize it into the other
// Bt buffer and start the copies of stage t + STAGES − 1 into the slot stage
// t − 1 has freed; wait for the wgmma; one barrier.  That barrier is the
// only one: it orders stage t's Bt and slot before their next writers, and
// the slot's mbarrier orders the copies.
template <int WGS, typename S, bool GROUPED, bool TMA_B>
__device__ __forceinline__ void dq_step(float (&d)[64], const DqArgs& a, const DqMaps& m,
                                        char* smem, int t, int T, int n_sal, int n0, int o0,
                                        int tid, int wg, const WgLane& l) {
  using D = DqShape<WGS>;
  wg_mma_bf16(d, smem_u32(smem + (t % D::STAGES) * D::SLOT) + D::A + wg * 64 * 128,
              smem_u32(smem + D::BT + (t & 1) * WG_BT_BYTES));
  if (t + 1 < T) {
    mbar_wait(smem_u32(smem + D::BAR + 8 * ((t + 1) % D::STAGES)), ((t + 1) / D::STAGES) & 1);
    dq_transform<WGS, S, GROUPED, TMA_B>(smem + D::BT + ((t + 1) & 1) * WG_BT_BYTES, smem,
                                         t + 1, n_sal, a, l);
  }
  fence_async_smem();
  if (t + D::STAGES - 1 < T)
    dq_load<WGS, S, GROUPED, TMA_B>(a, m, smem, t + D::STAGES - 1, n_sal, n0, o0, tid);
  wg_wait<0>();
  wg_fence_regs(d);
  __syncthreads();
}

// Stages: ks / 64 salient stages, then x_ld / 64 of x_ns · w (dq_step).
// GROUPED: everything into one f32 accumulator, seeded by the salient
// stages; else x_sal · w_sal and x_ns · T(w_q) into two, joined by
// out = fma(acc, s[o], sal).  No wgmma, commit or wait sits in a branch.
template <int WGS, typename S, bool GROUPED, bool TMA_B>
__global__ void __launch_bounds__(128 * WGS, 1)
dual_path_wg_kernel(const DqArgs a, const __grid_constant__ DqMaps m,
                    const S* __restrict__ scales, __nv_bfloat16* __restrict__ out) {
  using D = DqShape<WGS>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int row = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  int n0, o0;
  wg_tile<D::BM>(n0, o0);
  const int n_sal = a.ks / WG_KB, T = n_sal + a.x_ld / WG_KB;
  const WgLane l = wg_lane(tid);
  float acc[64], sal[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sal[i] = 0.0f;

  if (tid == 0) {
    for (int s = 0; s < D::STAGES; ++s) mbar_init(smem_u32(smem + D::BAR + 8 * s), 1 + D::THREADS);
    mbar_init_fence();
    tma_prefetch(m.x);
    if (TMA_B) tma_prefetch(m.w);
    if (GROUPED) tma_prefetch(m.sc);
  }
  __syncthreads();
  for (int s = 0; s < D::STAGES - 1 && s < T; ++s)
    dq_load<WGS, S, GROUPED, TMA_B>(a, m, smem, s, n_sal, n0, o0, tid);
  mbar_wait(smem_u32(smem + D::BAR), 0);
  dq_transform<WGS, S, GROUPED, TMA_B>(smem + D::BT, smem, 0, n_sal, a, l);
  fence_async_smem();
  __syncthreads();

  for (int t = 0; t < n_sal; ++t) {
    if constexpr (GROUPED)
      dq_step<WGS, S, GROUPED, TMA_B>(acc, a, m, smem, t, T, n_sal, n0, o0, tid, wg, l);
    else
      dq_step<WGS, S, GROUPED, TMA_B>(sal, a, m, smem, t, T, n_sal, n0, o0, tid, wg, l);
  }
  for (int t = n_sal; t < T; ++t)
    dq_step<WGS, S, GROUPED, TMA_B>(acc, a, m, smem, t, T, n_sal, n0, o0, tid, wg, l);

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

template <int WGS, typename S, bool GROUPED, bool TMA_B>
int launch_dual_path_wg(const DqArgs& a, const DqMaps& m, const void* scales, void* out,
                        cudaStream_t st) {
  using D = DqShape<WGS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(dual_path_wg_kernel<WGS, S, GROUPED, TMA_B>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dual_path_wg_kernel<WGS, S, GROUPED, TMA_B><<<wg_grid(a.N, a.O, D::BM), D::THREADS, D::SMEM, st>>>(
      a, m, static_cast<const S*>(scales), static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
