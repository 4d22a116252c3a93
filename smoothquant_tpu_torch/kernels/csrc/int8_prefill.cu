// Prefill int8 matmul with the scale epilogue and the salient dot fused (K4).
//
// Replaces smoothquant_tpu/kernels/int8_prefill.py int8_prefill_matmul
// (pallas_call at :282), pre-quantized mode:
//     out[n,o] = s_x[n]·s_w[o]·Σ_k x8[n,k]·w8[k,o] + Σ_s x_sal[n,s]·w_sal[s,o]
// At prefill N (1024 rows) every weight byte is reused N times, so the int8
// operations bound it (2·N·K·O at 1979 TOP/s; ~0.05 ms for the 4096→12288
// qkv), not the bytes.  The design keeps the int8 tensor cores fed:
//   * 128×128 output tiles, 8 warps of 64×32, int32 accumulators in
//     registers across all of K (mma.sync m16n8k32.s8), so the accumulator
//     never touches memory; at most 128 registers a thread, so two blocks
//     share an SM;
//   * the weight arrives K-major — (O, K) storage, which is what the port's
//     identity-int8 packs hold behind their (K, O) view — so the x rows and
//     the weight columns are both 64-byte runs per k step: both stream into
//     shared memory by cp.async 16-byte copies, three stages deep, with the
//     16-byte chunks of row r stored at chunk ^ ((r >> 1) & 3), which keeps
//     the fragment loads on 32 distinct banks;
//   * the epilogue computes fma(acc·s_x, s_w, salient) in f32 — the JAX
//     operation order (int8_prefill.py:66-74) with the multiply-add XLA
//     fuses — and writes the tile once.
//     The salient dot runs first, on the bf16 tensor cores (m16n8k16, f32
//     accumulators; the (k_s, O) salient block is transposed into k-pairs
//     while it is staged) or, for f32 operands, as f32 FMAs, and its tile
//     waits in shared memory (64 KB) while the int8 loop runs.
// Rows past N and columns past O are zero-filled and not stored; K and k_s
// must be multiples of 16 and O of 8 (the wrapper pads other shapes).
//
// The raw-x mode (int8_prefill.py:44-57, taken when ns_mask is given): x
// arrives as raw bf16 / f32 (N, K), with the (K,) 0/1 non-salient mask and
// the per-token scales s_x computed outside, and the kernel quantizes it in
// its own prologue: code = rint((x·mask) / s_x), the product and the true
// division each rounded as the XLA prologue rounds them.  Tiling for the
// card: the same 128×128 tiles and 3-stage ring as the pre-quantized mode;
// only the x operand's stage is filled differently — each thread loads its
// two 16-element runs of the next stage's raw x slab into registers before
// the current stage's mma.sync (the loads fly under it), then quantizes and
// stores them as the 16-byte swizzled chunks cp.async would have written.
// So the int8 tiles entering the mma are the pre-quantized mode's bytes, and
// the output is the same bit for bit.  The cost of the design: every
// 128-column tile re-reads and re-quantizes the x slab (O/128 times over,
// from L2), a division per element each time.
#include <type_traits>

#include "s8_tiles.cuh"

namespace {

using namespace s8;

struct Tile {
  int tid, gid, tig, wm, wn, n0, o0;
};

// (row, column) of the 128×128 f32 salient tile in shared memory; column
// pairs XOR-swizzled by row so a warp's float2 stores spread over the banks
__device__ __forceinline__ int sal_idx(int r, int c) { return r * BN + (c ^ ((r & 3) << 3)); }

// Σ_s x_sal[n,s]·w_sal[s,o] for the block's tile into sal (f32), staged
// through the first A and B tiles.
template <typename TS>
__device__ void salient_dot(float (&sal)[4][4][4], const TS* __restrict__ xsal,
                            const TS* __restrict__ wsal, uint32_t* at, uint32_t* bt, int N, int O,
                            int ks, const Tile& T) {
  if constexpr (std::is_same<TS, float>::value) {
    float* wt = reinterpret_cast<float*>(bt);  // [16 k][128 columns]
    for (int j0 = 0; j0 < ks; j0 += 16) {
      load_tile(at, xsal, T.n0, N, 4 * j0, 4 * ks, (size_t)4 * ks, T.tid);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < 16 * BN / THREADS; ++i) {
        const int e = T.tid + i * THREADS;
        const int k = e >> 7, c = e & 127, o = T.o0 + c;
        wt[e] = (j0 + k < ks && o < O) ? wsal[(size_t)(j0 + k) * O + o] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        float xv[4][2], wv[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[mt][h] = __uint_as_float(at[swz(T.wm + 16 * mt + T.gid + 8 * h, j)]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) wv[nt][h] = wt[j * BN + T.wn + 8 * nt + 2 * T.tig + h];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sal[mt][nt][e] = fmaf(xv[mt][e >> 1], wv[nt][e & 1], sal[mt][nt][e]);
      }
      __syncthreads();
    }
  } else {
    for (int j0 = 0; j0 < ks; j0 += 32) {
      load_tile(at, xsal, T.n0, N, 2 * j0, 2 * ks, (size_t)2 * ks, T.tid);
      cp_async_commit();
      // rows j0..j0+31 of the (ks, O) block → [column][k-pair word]
#pragma unroll
      for (int i = 0; i < 16 * (BN / 2) / THREADS; ++i) {
        const int e = T.tid + i * THREADS;
        const int cp = e & 63, kp = e >> 6;
        const int o = T.o0 + 2 * cp, k = j0 + 2 * kp;
        uint32_t r0 = 0u, r1 = 0u;
        if (o < O) {
          if (k < ks) r0 = __ldg(reinterpret_cast<const uint32_t*>(wsal + (size_t)k * O + o));
          if (k + 1 < ks)
            r1 = __ldg(reinterpret_cast<const uint32_t*>(wsal + (size_t)(k + 1) * O + o));
        }
        bt[swz(2 * cp, kp)] = __byte_perm(r0, r1, 0x5410);
        bt[swz(2 * cp + 1, kp)] = __byte_perm(r0, r1, 0x7632);
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < 16; kw += 8) {
        int a[4][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) frag_a(a[mt], at, T.wm + 16 * mt, kw, T.gid, T.tig);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) frag_b(b[nt], bt, T.wn + 8 * nt, kw, T.gid, T.tig);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(sal[mt][nt], a[mt], b[nt]);
      }
      __syncthreads();
    }
  }
}

// The raw-x mode's x operand: a thread's two (row, 16-element run) items of
// one 128×64 stage, held in registers between the load and the quantize.
template <typename TX>
struct RawRuns {
  static constexpr int U4 = 16 * (int)sizeof(TX) / 16;  // uint4 words a run
  uint4 v[BM * 4 / THREADS][U4];
};

template <typename TX>
__device__ __forceinline__ void load_raw(RawRuns<TX>& runs, const TX* __restrict__ x, int n0,
                                         int N, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < BM * 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int row = n0 + (e >> 2), k = k0 + (e & 3) * 16;
#pragma unroll
    for (int j = 0; j < RawRuns<TX>::U4; ++j) runs.v[i][j] = make_uint4(0u, 0u, 0u, 0u);
    if (row < N && k < K) {
      const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)row * K + k);
#pragma unroll
      for (int j = 0; j < RawRuns<TX>::U4; ++j) runs.v[i][j] = __ldg(p + j);
    }
  }
}

__device__ __forceinline__ uint32_t u4_word(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// element j of a run, as f32 (j a compile-time index once unrolled, so the
// run stays in registers)
template <typename TX>
__device__ __forceinline__ float raw_elem(const uint4 (&v)[RawRuns<TX>::U4], int j) {
  if constexpr (std::is_same<TX, float>::value) {
    return __uint_as_float(u4_word(v[j >> 2], j & 3));
  } else {  // bf16: the upper half of an f32
    const uint32_t w = u4_word(v[j >> 3], (j >> 1) & 3);
    return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
}

// rint((x·mask) / s_x) of the loaded runs, stored as the stage's swizzled
// int8 chunks (rows past N and columns past K give code 0)
template <typename TX>
__device__ __forceinline__ void quantize_raw(uint32_t* tile, const RawRuns<TX>& runs,
                                             const float* __restrict__ mask,
                                             const float* __restrict__ sx, int n0, int N, int k0,
                                             int K, int tid) {
#pragma unroll
  for (int i = 0; i < BM * 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e >> 2, c = e & 3;
    const int row = n0 + r, k = k0 + c * 16;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < N && k < K) {
      const float s = sx[row];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float y = __fmul_rn(raw_elem<TX>(runs.v[i], j), mask[k + j]);
        const int q = (int)rintf(__fdiv_rn(y, s));
        w[j >> 2] |= ((uint32_t)q & 0xFFu) << (8 * (j & 3));
      }
    }
    *reinterpret_cast<uint4*>(tile + swz(r, c * 4)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// TX: int8_t for pre-quantized codes, else the raw x dtype (raw-x mode,
// with mask given)
template <typename TX, typename TS, typename TO>
__global__ void __launch_bounds__(THREADS, 2)
int8_prefill_kernel(const TX* __restrict__ xq, const float* __restrict__ mask,
                    const float* __restrict__ sx, const int8_t* __restrict__ w_ok,
                    const float* __restrict__ sw, const TS* __restrict__ xsal,
                    const TS* __restrict__ wsal, TO* __restrict__ out, int N, int K, int O,
                    int ks) {
  constexpr bool RAW = !std::is_same<TX, int8_t>::value;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* a_tiles = smem;
  uint32_t* b_tiles = smem + STAGES * TILE_WORDS;
  Tile T;
  T.tid = threadIdx.x;
  const int lane = T.tid & 31, warp = T.tid >> 5;
  T.gid = lane >> 2;
  T.tig = lane & 3;
  T.wm = (warp >> 2) * 64;
  T.wn = (warp & 3) * 32;
  T.n0 = blockIdx.y * BM;
  T.o0 = blockIdx.x * BN;

  // the salient tile's dot first, parked in shared memory (sal_s) so the
  // main loop holds only the int32 accumulators
  float* sal_s = reinterpret_cast<float*>(smem + 2 * STAGES * TILE_WORDS);
  if (ks > 0) {
    float sal[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sal[mt][nt][e] = 0.0f;
    salient_dot<TS>(sal, xsal, wsal, a_tiles, b_tiles, N, O, ks, T);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = T.wm + 16 * mt + T.gid + 8 * h, c = T.wn + 8 * nt + 2 * T.tig;
          *reinterpret_cast<float2*>(sal_s + sal_idx(r, c)) =
              make_float2(sal[mt][nt][2 * h], sal[mt][nt][2 * h + 1]);
        }
  }

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int nk = (K + BK - 1) / BK;
  RawRuns<TX> runs;  // the raw-x mode's next x stage, between load and quantize
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      if constexpr (RAW) {
        load_raw(runs, xq, T.n0, N, s * BK, K, T.tid);
        quantize_raw(a_tiles + s * TILE_WORDS, runs, mask, sx, T.n0, N, s * BK, K, T.tid);
      } else {
        load_tile(a_tiles + s * TILE_WORDS, xq, T.n0, N, s * BK, K, (size_t)K, T.tid);
      }
      load_tile(b_tiles + s * TILE_WORDS, w_ok, T.o0, O, s * BK, K, (size_t)K, T.tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int pf = kt + STAGES - 1;
    const int buf = pf % STAGES;
    if (pf < nk) {
      if constexpr (RAW)
        load_raw(runs, xq, T.n0, N, pf * BK, K, T.tid);  // in flight under the mma below
      else
        load_tile(a_tiles + buf * TILE_WORDS, xq, T.n0, N, pf * BK, K, (size_t)K, T.tid);
      load_tile(b_tiles + buf * TILE_WORDS, w_ok, T.o0, O, pf * BK, K, (size_t)K, T.tid);
    }
    cp_async_commit();
    mma_step(acc, a_tiles + (kt % STAGES) * TILE_WORDS, b_tiles + (kt % STAGES) * TILE_WORDS,
             T.wm, T.wn, T.gid, T.tig);
    // stage pf's buffer held stage kt − 1, which every warp finished before
    // this iteration's barrier; the barriers before stage pf's mma publish it
    if constexpr (RAW) {
      if (pf < nk)
        quantize_raw(a_tiles + buf * TILE_WORDS, runs, mask, sx, T.n0, N, pf * BK, K, T.tid);
    }
  }
  cp_async_wait<0>();

  // epilogue: fma(acc · s_x, s_w, salient) in f32, written once
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = T.n0 + T.wm + 16 * mt + T.gid + 8 * h;
      if (n >= N) continue;
      const float sxn = sx[n];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = T.o0 + T.wn + 8 * nt + 2 * T.tig + c;
          if (o >= O) continue;
          const int e = 2 * h + c;
          const int c_in = T.wn + 8 * nt + 2 * T.tig + c;
          const float sal = ks > 0 ? sal_s[sal_idx(T.wm + 16 * mt + T.gid + 8 * h, c_in)] : 0.0f;
          const float y = __fmul_rn((float)acc[mt][nt][e], sxn);
          out[(size_t)n * O + o] = from_f<TO>(__fmaf_rn(y, sw[o], sal));
        }
    }
}

template <typename TX, typename TS, typename TO>
int launch(const void* xq, const void* mask, const void* sx, const void* w_ok, const void* sw,
           const void* xsal, const void* wsal, void* out, int N, int K, int O, int ks,
           cudaStream_t st) {
  const dim3 grid((O + BN - 1) / BN, (N + BM - 1) / BM);
  // the operand ring (48 KB) and, with salient channels, the f32 salient
  // tile (64 KB): two blocks fit an SM's 228 KB
  const size_t smem = (2 * STAGES * TILE_WORDS + (ks > 0 ? BM * BN : 0)) * sizeof(uint32_t);
  auto kern = int8_prefill_kernel<TX, TS, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, THREADS, smem, st>>>(
      (const TX*)xq, (const float*)mask, (const float*)sx, (const int8_t*)w_ok, (const float*)sw,
      (const TS*)xsal, (const TS*)wsal, (TO*)out, N, K, O, ks);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: out (N, O) = (x8 · w8)·s_x·s_w + x_sal · w_sal.  w_ok is the weight
// stored K-major, (O, K); sal_dt / out_dt: 0 float32, 1 bfloat16.
SQ_EXPORT int sq_int8_prefill(const void* xq, const void* sx, const void* w_ok, const void* sw,
                              const void* xsal, const void* wsal, void* out, int N, int K, int O,
                              int ks, int sal_dt, int out_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K % 16 || ks % 16 || O % 8 || N < 1) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (sal_dt == DT_BF16 && out_dt == DT_BF16)
    return launch<int8_t, bf16, bf16>(xq, nullptr, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks,
                                      st);
  if (sal_dt == DT_BF16)
    return launch<int8_t, bf16, float>(xq, nullptr, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks,
                                       st);
  if (out_dt == DT_BF16)
    return launch<int8_t, float, bf16>(xq, nullptr, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks,
                                       st);
  return launch<int8_t, float, float>(xq, nullptr, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks,
                                      st);
}

// K4's raw-x mode: x (N, K) raw in x_dt (0 float32, 1 bfloat16; the
// salient x and block share it), mask (K,) f32, quantized in the kernel.
SQ_EXPORT int sq_int8_prefill_rawx(const void* x, const void* mask, const void* sx,
                                   const void* w_ok, const void* sw, const void* xsal,
                                   const void* wsal, void* out, int N, int K, int O, int ks,
                                   int x_dt, int out_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K % 16 || ks % 16 || O % 8 || N < 1) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_dt == DT_BF16 && out_dt == DT_BF16)
    return launch<bf16, bf16, bf16>(x, mask, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks, st);
  if (x_dt == DT_BF16)
    return launch<bf16, bf16, float>(x, mask, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks, st);
  if (out_dt == DT_BF16)
    return launch<float, float, bf16>(x, mask, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks, st);
  return launch<float, float, float>(x, mask, sx, w_ok, sw, xsal, wsal, out, N, K, O, ks, st);
}
