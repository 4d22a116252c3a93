// One warp-specialized s8 wgmma GEMM body over a TMA ring, for K-major int8
// operands: K4's pre-quantized prefill matmul (int8_wg.cu sq_int8_prefill_wg)
// and K15a's static-scale linear above its stream rows (sq_int8_linear_wg).
//
//     acc[n, o] = Σ_k x[n, k]·w[o, k]     x (N, K) int8, w (O, K) int8 storage
//
// exact in int32, then an epilogue of the caller's kind (S8_K4: fma(f32(acc)
// ·s_x[n], s_w[o], sal) with the bf16 salient dot sal; S8_LINEAR: fma(f32(acc),
// α, bias[o]), ReLU, f32 or int8 out).
//
// What bounds it on the H100: at prefill N every weight byte is reused N
// times, so the int8 operations (2·N·K·O at 1979 TOP/s) bound it.  Only
// wgmma reaches that rate (mma.sync does not), and both operands here are
// already K-major — the one layout `wgmma ... .s8.s8` takes — so each stage
// goes from device memory to shared memory by TMA and straight into the
// tensor cores, with nothing rewritten on the way:
//   * 128 × BN output tiles (BN 128 where a 64 × 128 s32 accumulator shares
//     a consumer thread's registers with K4's f32 salient one, else 256:
//     fewer bytes from L2 per operation); two consumer warpgroups of 64 rows
//     each run wgmma.mma_async m64nBNk32 s8 from shared memory;
//   * one producer thread issues a stage's two TMA boxes — the x tile (128
//     rows × 128 bytes of K) and the weight tile (BN rows of the (O, K)
//     storage × 128 bytes of K), both SWIZZLE_128B, which the descriptors
//     name (SBO 1024, the k32 step 32 bytes into the row) — against the
//     slot's full mbarrier; each consumer warpgroup releases the slot on its
//     empty mbarrier once its wgmma group for it has retired.  TMA zero-fills
//     past N, O and K, so ragged shapes need no special case;
//   * persistent: one block an SM walks the tiles row tile fastest (the
//     blocks in flight share a few weight column tiles, which stream from
//     DRAM about once while the activations stay in L2), and the producer
//     runs on into the next tile's stages while the consumers store this
//     one, so the epilogue overlaps the next tile's loads;
//   * K4's salient dot (bf16 x_sal (N, k_s), w_sal (k_s, O) O-contiguous, as
//     the pack holds it) runs first, as stages of the same ring: the x_sal
//     tile K-major like x, the w_sal rows as BN / 64 boxes of 64 k rows × 64
//     columns read MN-major (the descriptor's transpose bit for B, which
//     16-bit types allow; LBO the 64-column block stride, SBO the 8-row
//     group's), by wgmma m64n128k16 bf16 into a second, f32 accumulator;
//   * f32(acc) is the int32 rounded to nearest even as cvt.rn.f32.s32 does
//     (|acc| reaches 127²·11008 > 2^24), with no conversion instruction:
//     the high and low 16 bits are each exact in f32 and one fma joins them
//     with a single rounding (wg_gemm.cuh s32_f32_rn).
// setmaxnreg gives each consumer thread 232 registers and the producer
// warpgroup 40.  scripts/s8_variants.py times the pieces (loads only, math
// only, no epilogue) and the designs not taken — 128 × 128 tiles without
// salient channels, other ring depths, one tile a block, a wgmma group kept
// in flight, the weight tile multicast to a 2-CTA cluster — beside this one
// (PERF.md §6).
#pragma once

#include "wg_gemm.cuh"

namespace {

constexpr int S8_BM = 128;              // tile rows: two consumer warpgroups of 64
constexpr int S8_KB = 128;              // k bytes an int8 stage takes (one swizzled row)
constexpr int S8_SAL_K = 64;            // salient k a bf16 stage takes (128 bytes a row)
constexpr int S8_THREADS = 384;         // two consumer warpgroups, then the producer's
constexpr int S8_LAUNCH_REGS = 168;     // (65536 / 384) & ~7: what a thread gets at launch
constexpr int S8_CONSUMER_REGS = 232, S8_PRODUCER_REGS = 40;
constexpr int S8_STAGES = 5;            // ring slots at BN 128 (32 KB each)
constexpr int S8_STG_LD = 72;           // f32 row stride of a warp's staged 16 × 64 output chunk
constexpr int S8_STG = 16 * S8_STG_LD * 4;   // the bytes a consumer warp stages

enum { S8_K4 = 0, S8_LINEAR = 1 };      // the epilogue kinds

template <int BN, int STAGES>
struct S8Geo {
  static constexpr int A = S8_BM * 128;   // the x (or x_sal) tile
  static constexpr int B = BN * 128;      // the w tile, or BN / 64 w_sal boxes of 8 KB
  static constexpr int SLOT = A + B;
  static constexpr int BAR = STAGES * SLOT;   // full mbarriers, then empty ones
  static constexpr int COL = BAR + 16 * STAGES;   // each warpgroup's column constants, two tiles
  static constexpr int STG = COL + 2 * 2 * BN * 4;   // each consumer warp's output chunk
  static constexpr int SMEM = STG + 8 * S8_STG;
  static_assert(SMEM <= 227 * 1024, "the H100's shared memory per block");
};

struct S8Args {
  int N, O;
  int n_sal, n_s8;          // stages of a tile: salient (64 k), int8 (128 k bytes)
  int tiles_m, tiles;       // row tiles, tiles in all
  uint32_t mag_m;           // t / tiles_m as umulhi(t, mag_m) (tiles_m > 1)
  const float* sx;          // S8_K4: (N,) row scales
  const float* sw;          // S8_K4: (O,) column scales
  const float* bias;        // S8_LINEAR: (O,) or null
  float alpha;
  int relu;
  void* out;                // (N, O)
};

struct S8Maps {   // x (N, K), w (O, K), x_sal (N, k_s), w_sal (k_s, O)
  CUtensorMap x, w, xsal, wsal;
};

__device__ __forceinline__ void s8_release(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// D (64 × 256 per warpgroup) = A · B (+ D): s8 · s8 → s32, k32, both K-major
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// bf16 · bf16 → f32, k16: A K-major, B MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_bf16_bt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// after a wait: no read of the 64 × 256 accumulators may move above it
__device__ __forceinline__ void wg_fence_regs(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the descriptor of a 128-byte-row SWIZZLE_128B K-major tile at addr (8-row
// groups 1024 bytes apart; LBO unused)
__device__ __forceinline__ uint64_t s8_desc(uint32_t addr) {
  return wg_desc(addr, 16, 1024, wg_swizzle_layout(128));
}

// tile t's first row and column: row tile t % tiles_m, column tile t / tiles_m
template <int BN>
__device__ __forceinline__ void s8_tile(const S8Args& a, int t, int& n0, int& o0) {
  const int tn = a.tiles_m == 1 ? t : (int)__umulhi((uint32_t)t, a.mag_m);
  n0 = (t - tn * a.tiles_m) * S8_BM;
  o0 = tn * BN;
}

// The producer thread: every stage of every tile of this block, in order,
// into slot g % STAGES once both consumer warpgroups have freed it.
template <int BN, int STAGES>
__device__ __forceinline__ void s8_produce(const S8Args& a, const S8Maps& m, char* smem) {
  using G = S8Geo<BN, STAGES>;
  tma_prefetch(m.x);
  tma_prefetch(m.w);
  if (a.n_sal) {
    tma_prefetch(m.xsal);
    tma_prefetch(m.wsal);
  }
  const int T = a.n_sal + a.n_s8;
  int g = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    int n0, o0;
    s8_tile<BN>(a, t, n0, o0);
    for (int s = 0; s < T; ++s, ++g) {
      const int slot = g % STAGES;
      const uint32_t su = smem_u32(smem + slot * G::SLOT);
      const uint32_t full = smem_u32(smem + G::BAR + 8 * slot);
      if (g >= STAGES) mbar_wait(smem_u32(smem + G::BAR + 8 * (STAGES + slot)), (g / STAGES - 1) & 1);
      mbar_expect_tx(full, G::SLOT);
      if (s < a.n_sal) {
        tma_2d(su, m.xsal, full, s * S8_SAL_K, n0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_2d(su + G::A + h * 8192, m.wsal, full, o0 + 64 * h, s * S8_SAL_K);
      } else {
        const int k0 = (s - a.n_sal) * S8_KB;
        tma_2d(su, m.x, full, k0, n0);
        tma_2d(su + G::A, m.w, full, k0, o0);
      }
    }
  }
}

// acc (64 × BN per warpgroup) += one int8 stage: four k32 steps, one commit
// group (s8_issue), retired before the slot is released (s8_mma)
template <int BN>
__device__ __forceinline__ void s8_issue(int (&acc)[BN / 2], uint32_t a, uint32_t b) {
  wg_arrive();
#pragma unroll
  for (int k = 0; k < S8_KB / 32; ++k) {
    if constexpr (BN == 256)
      wgmma_s8_n256(acc, s8_desc(a + 32 * k), s8_desc(b + 32 * k));
    else
      wgmma_s8(acc, s8_desc(a + 32 * k), s8_desc(b + 32 * k), 1);
  }
  wg_commit();
}
template <int BN>
__device__ __forceinline__ void s8_mma(int (&acc)[BN / 2], uint32_t a, uint32_t b) {
  s8_issue<BN>(acc, a, b);
  wg_wait<0>();
  wg_fence_regs(acc);
}

// sal (64 × 128 per warpgroup) += one salient stage: four k16 steps of the
// x_sal tile (K-major) against the two w_sal boxes (MN-major: 64-column
// blocks 8 KB apart, k rows 128 bytes apart, the k16 step 16 rows on)
__device__ __forceinline__ void s8_mma_sal(float (&sal)[64], uint32_t a, uint32_t b) {
  wg_arrive();
#pragma unroll
  for (int k = 0; k < S8_SAL_K / 16; ++k)
    wgmma_bf16_bt(sal, s8_desc(a + 32 * k),
                  wg_desc(b + 2048 * k, 8192, 1024, wg_swizzle_layout(128)));
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(sal);
}

template <typename TO>
__device__ __forceinline__ void s8_put(TO* p, float v) {
  if constexpr (sizeof(TO) == 1) *p = (int8_t)(int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  else *p = from_f<TO>(v);
}
// V values of the staged f32 chunk at src into out at p (16 bytes): f32 as
// they are, bf16 rounded to nearest even, int8 as round-half-even clipped
// to ±127
template <typename TO>
__device__ __forceinline__ void s8_put16(TO* p, const float* src) {
  if constexpr (sizeof(TO) == 4) {
    *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(src);
  } else if constexpr (sizeof(TO) == 2) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    const float4 v = *reinterpret_cast<const float4*>(src + 4);
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(u.x, u.y), bf16_pair(u.z, u.w),
                                              bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(src + 4 * q);
      const float f[4] = {u.x, u.y, u.z, u.w};
      w[q] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[q] |= ((uint32_t)(int)fminf(fmaxf(rintf(f[j]), -127.0f), 127.0f) & 0xFFu) << (8 * j);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The tile's outputs from the accumulators, 64 columns at a time (the
// m64nBN D fragment: value 4i + 2h + j of a thread is row 16·warp + lane /
// 4 + 8h of its warpgroup, column 8i + 2·(lane % 4) + j): S8_K4 fma(f32(acc)
// ·s_x, s_w, sal) (the product alone without salient channels), S8_LINEAR
// fma(f32(acc), α, bias) (or the product) and ReLU; each warp stages its 16
// rows of the chunk in f32 and stores them as 16-byte runs of a row (the
// fragment's own pairs wrote 8 of a 32-byte sector at a time: PERF.md §6).
template <int BN, bool SAL, int KIND, typename TO>
__device__ __forceinline__ void s8_epilogue(const S8Args& a, const int (&acc)[BN / 2],
                                            const float (&sal)[SAL ? 64 : 1],
                                            const float* col, const float (&sxv)[2], float* stg,
                                            int n0, int o0, int tid) {
  constexpr int V = 16 / (int)sizeof(TO), LPR = 64 / V, RPI = 32 / LPR;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int w0 = n0 + 64 * (tid >> 7) + 16 * ((tid >> 5) & 3);   // the warp's first row
  TO* out = static_cast<TO*>(a.out);
  const bool vec = (a.O * (int)sizeof(TO)) % 16 == 0;
#pragma unroll
  for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const int i = 8 * c + ii;
      const float2 cc = *reinterpret_cast<const float2*>(col + 8 * i + 2 * tig);
      const float cv[2] = {cc.x, cc.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float f = s32_f32_rn(acc[4 * i + 2 * h + j]);
          if constexpr (KIND == S8_K4) {
            const float p = __fmul_rn(f, sxv[h]);
            if constexpr (SAL) y[j] = a.n_sal ? __fmaf_rn(p, cv[j], sal[4 * i + 2 * h + j]) : __fmul_rn(p, cv[j]);
            else y[j] = __fmul_rn(p, cv[j]);
          } else {
            y[j] = a.bias ? __fmaf_rn(f, a.alpha, cv[j]) : __fmul_rn(f, a.alpha);
            if (a.relu) y[j] = fmaxf(y[j], 0.0f);
          }
        }
        *reinterpret_cast<float2*>(stg + (gid + 8 * h) * S8_STG_LD + 8 * ii + 2 * tig) =
            make_float2(y[0], y[1]);
      }
    }
    __syncwarp();
    // lane l stores row r0 + l / LPR of the chunk, columns V·(l % LPR) ..
#pragma unroll
    for (int r0 = 0; r0 < 16; r0 += RPI) {
      const int r = r0 + lane / LPR, cl = V * (lane % LPR);
      const int n = w0 + r, o = o0 + 64 * c + cl;
      if (n < a.N && o < a.O) {
        const float* src = stg + r * S8_STG_LD + cl;
        TO* p = out + (size_t)n * a.O + o;
        if (vec && o + V <= a.O) {
          s8_put16<TO>(p, src);
        } else {
          for (int j = 0; j < V && o + j < a.O; ++j) s8_put<TO>(p + j, src[j]);
        }
      }
    }
    __syncwarp();
  }
}

// The consumer warpgroups: per tile, the salient stages into sal, the int8
// stages into acc, each slot released after its wgmma group retired, then the
// epilogue (while the producer already loads the next tile's stages).
template <int BN, int STAGES, bool SAL, int KIND, typename TO>
__device__ __forceinline__ void s8_consume(const S8Args& a, char* smem, int tid) {
  using G = S8Geo<BN, STAGES>;
  const int wg = tid >> 7, r_in = 64 * wg + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
  const bool leader = (tid & 127) == 0;
  const float* cv = KIND == S8_K4 ? a.sw : a.bias;
  float* stg = reinterpret_cast<float*>(smem + G::STG + (tid >> 5) * S8_STG);
  int acc[BN / 2];
  float sal[SAL ? 64 : 1];
  int g = 0, it = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++it) {
    int n0, o0;
    s8_tile<BN>(a, t, n0, o0);
    // this tile's column constants (s_w, or the bias) into this warpgroup's
    // buffer of its parity — its last reader was tile it − 2's epilogue,
    // which every thread of the warpgroup left before tile it − 1's barrier
    // — and the rows' s_x into registers
    float* col = reinterpret_cast<float*>(smem + G::COL) + (2 * wg + (it & 1)) * BN;
    for (int c = tid & 127; c < BN; c += 128)
      col[c] = cv != nullptr && o0 + c < a.O ? cv[o0 + c] : 0.0f;
    float sxv[2] = {0.0f, 0.0f};
    if constexpr (KIND == S8_K4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) sxv[h] = n0 + r_in + 8 * h < a.N ? a.sx[n0 + r_in + 8 * h] : 0.0f;
    }
    named_sync<128>(1 + wg);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    if constexpr (SAL) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sal[i] = 0.0f;
      for (int s = 0; s < a.n_sal; ++s, ++g) {
        const int slot = g % STAGES;
        const uint32_t su = smem_u32(smem + slot * G::SLOT);
        mbar_wait(smem_u32(smem + G::BAR + 8 * slot), (g / STAGES) & 1);
        s8_mma_sal(sal, su + wg * 64 * 128, su + G::A);
        if (leader) s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + slot)));
      }
    }
    for (int s = 0; s < a.n_s8; ++s, ++g) {
      const int slot = g % STAGES;
      const uint32_t su = smem_u32(smem + slot * G::SLOT);
      mbar_wait(smem_u32(smem + G::BAR + 8 * slot), (g / STAGES) & 1);
      s8_mma<BN>(acc, su + wg * 64 * 128, su + G::A);
      if (leader) s8_release(smem_u32(smem + G::BAR + 8 * (STAGES + slot)));
    }
    s8_epilogue<BN, SAL, KIND, TO>(a, acc, sal, col, sxv, stg, n0, o0, tid);
  }
}

template <int BN, int STAGES, bool SAL, int KIND, typename TO>
__global__ void __launch_bounds__(S8_THREADS, 1)
s8_gemm_kernel(const S8Args a, const __grid_constant__ S8Maps m) {
  using G = S8Geo<BN, STAGES>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(smem + G::BAR + 8 * s), 1);
      mbar_init(smem_u32(smem + G::BAR + 8 * (STAGES + s)), 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 256) {
    regs_dec<S8_PRODUCER_REGS>();
    if (tid == 256) s8_produce<BN, STAGES>(a, m, smem);
    return;
  }
  regs_inc<S8_CONSUMER_REGS>();
  s8_consume<BN, STAGES, SAL, KIND, TO>(a, smem, tid);
}

// ---------------------------------------------------------------- host side

// ceil(2^32 / d) for d >= 2, with whether umulhi(x, it) == x / d for every
// x <= x_max (x · (mag · d − 2^32) < 2^32)
inline bool s8_fast_div(uint32_t d, uint32_t x_max, uint32_t& mag) {
  mag = (uint32_t)((0x100000000ull + d - 1) / d);
  return (uint64_t)x_max * ((uint64_t)mag * d - 0x100000000ull) < 0x100000000ull;
}

// The tile plan of an (N, O) output into a's fields; false where t / tiles_m
// has no exact magic over the tiles.
template <int BN>
bool s8_plan(S8Args& a, int N, int O) {
  a.N = N;
  a.O = O;
  a.tiles_m = (N + S8_BM - 1) / S8_BM;
  a.tiles = a.tiles_m * ((O + BN - 1) / BN);
  a.mag_m = 0u;
  return a.tiles_m == 1 || s8_fast_div(a.tiles_m, a.tiles, a.mag_m);
}

// x (N, K) and w (O, K) int8 maps (K a multiple of 16, both 16-byte aligned)
template <int BN>
bool s8_maps(S8Maps& m, const void* x, const void* w, int N, int K, int O) {
  return wg_map(&m.x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, K, S8_KB, S8_BM,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         wg_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, O, K, S8_KB, BN,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// one block an SM (`blocks`, from the caller), at most one a tile
template <int BN, int STAGES, bool SAL, int KIND, typename TO>
int s8_launch(const S8Args& a, const S8Maps& m, int blocks, cudaStream_t st) {
  using G = S8Geo<BN, STAGES>;
  auto kern = s8_gemm_kernel<BN, STAGES, SAL, KIND, TO>;
  static const cudaError_t ready = wg_kernel_ready(kern, G::SMEM, S8_LAUNCH_REGS);
  if (ready != cudaSuccess) return (int)ready;
  const int grid = blocks < a.tiles ? blocks : a.tiles;
  kern<<<grid, S8_THREADS, G::SMEM, st>>>(a, m);
  return (int)cudaGetLastError();
}

}  // namespace
