// The weight-streaming body of the decode row counts (N <= 64 token rows):
// the group matmul K8 (int_group_matmul.cu, int8-container weights) and K5
// (int4_group_matmul.cu, split-half nibble weights) share, and two more
// weight kinds at the end of this file — K13's bf16 slab (fp_matmul.cu),
// K1's nibbles on raw, unquantized x (int4_group_matmul.cu) and K15a's
// (O, K) int8 rows (int8_wg.cu) — on the same ring, lane maps and cluster
// epilogue.
//
// What bounds these calls on the H100: the weight's bytes.  At N <= 64 each
// weight byte takes at most 2·64 int8 operations (~230 a byte for nibbles),
// below the card's ~590, so the least time is the weight at 3.35 TB/s, with
// the per-group scaling on the CUDA cores (N·O·G of them) beside it.  The
// tiles body (gmm_tiles.cuh) missed that by 7-11×: a 64-row token tile at
// any N (15 of 16 rows zero at N = 4), no load in flight while a block
// computes, 4-byte weight loads, an I2F per scaling and a split over K whose
// f32 partials went through device memory and a second launch.  This body:
//
//   * Swaps the operands.  The weight's output columns are the mma's M side
//     (m16 tiles), the tokens its n side, padded to 8·NT (NT n8 tiles: 1, 2,
//     4 or 8, a template).  s8 mma takes K-major operands only, so each
//     consumer thread turns the (K, O) rows TMA wrote into K-major A
//     fragments in registers: four 4-byte rows of one 4-column quad, loaded
//     in an order rotated by the lane (so a warp's loads from the 128-byte
//     swizzled rows hit 32 banks) and byte-transposed with __byte_perm (the
//     rotation folded into two per-lane selectors).  A thread's quad fills
//     two m16 tiles, so a warp covers 32 columns and four consumer warps a
//     128-column block tile.  The tokens' codes are the B operand as they
//     lie (row-major, K-major), by ldmatrix from the x tile.
//   * Streams the weight through a ring of SG_STAGES slots on mbarriers.  A
//     producer warp issues each stage's TMA copies (the weight slab, the x
//     tiles, the column scales; the activation scales by cp.async) as soon
//     as the consumers free the slot; four stages of 8-16 KB of weight, two
//     blocks an SM, keep ~48-96 KB in flight an SM, above the ~25-30 KB
//     that 3.35 TB/s × ~1 µs of latency asks of each of the 132 SMs.
//   * Scales with no I2F.  The int32 accumulator of each group starts at
//     0x4B400000 (the same constant register quad for every mma), so after
//     the mma its bits are the f32 1.5·2^23 + p (|p| < 2^22), and one
//     subtract of 1.5·2^23 gives f32(p) exactly; then fma(f32(p)·s_x, s_w,
//     acc) — three f32 instructions, and for K8 the same bits as
//     __int2float_rn.  K5's biased nibbles b enter the mma as the signed
//     s8 16·(b − 8) (the nibble moved to the byte's top, its top bit
//     flipped: one logic op), so p needs no −8Σx term, and s_x/16 (exact)
//     takes the ×16 back out.
//   * Addresses every shared load as a per-lane offset (computed once) plus
//     a constant: the weight rows a k step reads start on 16-row blocks and
//     the x rows on 8-row groups, so each lane's swizzle phase is its own.
//   * Splits K over the blocks of a thread-block cluster (n_split = 1, 2, 4
//     or 8, planned by the caller from the shapes): each rank takes a
//     contiguous range of stages, writes its f32 tile into its own shared
//     memory, and after a cluster barrier each rank sums a share of the tile
//     over the ranks in rank order (distributed shared memory) and stores
//     it: one launch, nothing through device memory, the same bits on every
//     call.
//   * Seeds the accumulator with the salient dot: in bf16 as stages of the
//     same ring (mma m16n8k16 from w_sal rows pair-transposed the same way),
//     in f32 on the CUDA cores from global memory before the ring's first
//     stage (the f32 instantiations are the checks', not a path's).
// The scale dtype is a template, so the scaling has no branch.  setmaxnreg
// gives the consumer warpgroup 200 registers a thread (its f32 and s32
// accumulators take 128 at NT = 8) and the producer one 56, two blocks an SM.
// Where it stands (PERF.md §6): at a few rows the ring binds, within 1.6× of
// the byte bound; at 64 rows the consumers' math binds (the scaling, the
// transpose and the mma issue of eight n8 tiles take longer than the ring
// alone), the next thing to cut.
#pragma once

#include "cluster.cuh"
#include "wg_gemm.cuh"

namespace {

constexpr int SG_BO = 128;          // output columns a block tile takes
constexpr int SG_STAGES = 4;        // ring slots
constexpr int SG_THREADS = 256;     // a consumer warpgroup, then a producer one
constexpr int SG_CONSUMER_REGS = 200, SG_PRODUCER_REGS = 56;
constexpr int SG_PART_LD = SG_BO + 4;   // f32 row stride of a rank's partial tile
constexpr int SG_BAR_DRAINED = 1;       // named barrier: every stage consumed
constexpr uint32_t SG_MAGIC_BITS = 0x4B400000u;   // the bits of 1.5·2^23

__host__ __device__ constexpr int sg_max(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int sg_align(int v, int a) { return (v + a - 1) / a * a; }

// The slot geometry of one instantiation: NIB (nibble pack, K5) or int8
// containers (K8), group size GS, NT n8 token tiles.
template <bool NIB, int GS, int NT>
struct SgGeo {
  static constexpr int N_BOX = 8 * NT;                 // token rows a tile holds
  static constexpr int KW = NIB ? GS : 128;            // weight rows of a group stage
  static constexpr int SG = NIB ? 2 : 128 / GS;        // groups of a group stage
  static constexpr int KSTEP = GS % 32 == 0 ? 32 : 16; // k of one int8 mma
  static constexpr int KSAL = NIB ? 32 : 64;           // salient k of a salient stage
  static constexpr int XROW = NIB ? GS : 128;          // bytes of an x tile row
  static constexpr int SALROW = 2 * KSAL;              // bytes of an x_sal tile row
  static constexpr int XH = sg_align(N_BOX * XROW, 1024);   // one x tile
  static constexpr int W_BYTES = sg_max(KW * SG_BO, 2 * KSAL * 128);
  static constexpr int X_BYTES = sg_max((NIB ? 2 : 1) * XH, N_BOX * SALROW);
  static constexpr int SW_BYTES = SG * SG_BO * 4;      // column scales (f32 at most)
  static constexpr int SX_BYTES = SG * N_BOX * 4;      // activation scales
  static constexpr int OFF_X = W_BYTES;
  static constexpr int OFF_SW = OFF_X + X_BYTES;
  static constexpr int OFF_SX = OFF_SW + SW_BYTES;
  static constexpr int SLOT = sg_align(OFF_SX + SX_BYTES, 1024);
  static constexpr int OFF_BAR = SG_STAGES * SLOT;     // full, then empty mbarriers
  static constexpr int SMEM = OFF_BAR + 2 * 8 * SG_STAGES;
  static_assert(N_BOX * SG_PART_LD * 4 <= OFF_BAR, "the partial tile reuses the ring");
};

struct SgArgs {
  const float* xs;          // activation scales: element (n, g) at n·s_rs + g·s_gs
  const void* xsal;         // (N, xsal_rs) salient activations (f32 path)
  const void* wsal;         // (k_s, O) salient block (f32 path)
  void* out;                // (N, O) in the output dtype
  int N, O, G, k_s, xsal_rs;
  int s_rs, s_gs;
  int x_dx, x_dy, x_hx, x_hy;   // x box of group (stage) j at (j·x_dx, j·x_dy); K5's hi + (x_hx, x_hy)
  int n_sal, n_grp, n_split;    // stages (salient, group) and ranks a tile splits into
  int s_bf16, t_bf16;           // column scales / salient operands and output in bf16
  int pdl;                      // launched behind a primary grid (programmatic dependent
                                // launch): the first stages' weight copies go out before
                                // griddepcontrol.wait, every activation copy after it
};

struct SgMaps {   // the weight, x codes, column scales, x_sal, w_sal
  CUtensorMap w, x, ws, xsal, wsal;
};

__device__ __forceinline__ void sg_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// programmatic dependent launch: a secondary grid's wait for its primary to
// finish and flush its writes (a no-op in a grid launched without the
// attribute), and a primary block's signal that the secondary may start
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// byte offset of (row r, byte b) in a tile TMA wrote with rows of ROW bytes
// and the swizzle that row width takes (128 / 64 / 32 bytes: the 16-byte
// chunk index xor address bits 7-9 / 7-8 / 7; 16 bytes: none)
template <int ROW>
__device__ __forceinline__ int sg_swz(int r, int b) {
  if constexpr (ROW == 128) return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
  if constexpr (ROW == 64) return r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
  if constexpr (ROW == 32) return r * 32 + ((((b >> 4) ^ (r >> 2)) & 1) << 4) + (b & 15);
  return r * ROW + b;
}
template <int ROW>
__host__ constexpr CUtensorMapSwizzle sg_swizzle() {
  return ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : ROW == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                     : CU_TENSOR_MAP_SWIZZLE_NONE;
}

__device__ __forceinline__ void ldsm_x4(int (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(int (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x1(int& r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r) : "r"(addr));
}

// D = A·B + C, s8 → s32: m16n8k32 (A 4 registers, B 2) and m16n8k16 (A 2, B 1)
__device__ __forceinline__ void sg_mma32(int (&d)[4], const int (&a)[4], int b0, int b1,
                                         const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c[0]), "r"(c[1]),
        "r"(c[2]), "r"(c[3]));
}
__device__ __forceinline__ void sg_mma16(int (&d)[4], int a0, int a1, int b0, const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// A consumer lane's place: warp w (0-3) takes tile columns 32w.., its lane
// the quad quad_b = 32w + 4·gid .. + 3 (column 4·gid + 2·mt + h of the warp
// is row gid + 8h of m16 tile mt) and the tokens 2·tig, 2·tig + 1 of each
// n8 tile.  sel0 / sel1 finish the byte transpose of four rotated row words;
// q_off[j] is the byte offset of word j of the quad's rows in any 16-row
// block of a 128-byte-row SWIZZLE_128B tile (the block's rows are 16-row
// aligned, so the swizzle phase is the lane's own).
struct SgLane {
  int lane, w, gid, tig, quad_b;
  uint32_t sel0, sel1;
  uint32_t q_off[4];
};

// The lane's place and its byte selectors where word j of its quad holds
// row (j + rot) & 3 (q_off is the caller's)
__device__ __forceinline__ SgLane sg_lane_at(int tid, int rot) {
  SgLane l;
  l.lane = tid & 31;
  l.w = tid >> 5;
  l.gid = l.lane >> 2;
  l.tig = l.lane & 3;
  l.quad_b = 32 * l.w + 4 * l.gid;
  // row i of the quad sits in word j = (i − rot) & 3; after the first
  // permute level its byte of column 0 is at index {0, 1, 4, 5}[j]
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t j = (uint32_t)(i - rot) & 3u;
    s |= ((j & 1u) | ((j & 2u) << 1)) << (4 * i);
  }
  l.sel0 = s;
  l.sel1 = s + 0x2222u;
  return l;
}

__device__ __forceinline__ SgLane sg_lane(int tid) {
  SgLane l = sg_lane_at(tid, tid & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    l.q_off[j] = (uint32_t)sg_swz<128>(4 * l.tig + ((j + l.tig) & 3), l.quad_b);
  return l;
}

// The lane map of a weight tile held as two 64-column halves of GS rows of
// 64 bytes each (SWIZZLE_64B; warps 0-1 read the first half, 2-3 the
// second): in 64-byte rows a row's parity picks the 16 banks and bit 1 of
// tig the 16-byte chunk pair, so lanes tig and tig + 2 take rows of
// opposite parity — word j of the quad holds row (j + tig / 2) & 3 — and a
// warp's four loads of one instruction again hit 32 distinct banks.
template <int GS>
__device__ __forceinline__ SgLane sg_lane_halves(int tid) {
  SgLane l = sg_lane_at(tid, (tid & 3) >> 1);
  const int h = l.w >> 1, b = l.quad_b - 64 * h;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    l.q_off[j] = (uint32_t)(h * GS * 64 + sg_swz<64>(4 * l.tig + ((j + (l.tig >> 1)) & 3), b));
  return l;
}

// A lane's ldmatrix row addresses in an x tile of ROW-byte rows, one per
// 16-byte chunk a k step can start at (the swizzle is fixed by the lane's
// row within its 8-row group): KSTEP 32 — matrix m = lane / 8 is n8 tile
// m / 2, k half m % 2; KSTEP 16 — n8 tile m.
template <int ROW, int KSTEP>
struct SgXOff {
  static constexpr int C = KSTEP == 32 ? ROW / 32 : ROW / 16;
  uint32_t o[C];
};

template <int ROW, int KSTEP>
__device__ __forceinline__ SgXOff<ROW, KSTEP> sg_xoff(int lane) {
  const int r = lane & 7, m = lane >> 3;
  const int f = ROW == 128 ? r : ROW == 64 ? (r >> 1) & 3 : ROW == 32 ? (r >> 2) & 1 : 0;
  SgXOff<ROW, KSTEP> x;
  if constexpr (KSTEP == 32) {
    const int base = (8 * (m >> 1) + r) * ROW, h = (m & 1) ^ f;
#pragma unroll
    for (int k = 0; k < x.C; ++k) x.o[k] = (uint32_t)(base + (((2 * k) ^ h) << 4));
  } else {
    const int base = (8 * m + r) * ROW;
#pragma unroll
    for (int c = 0; c < x.C; ++c) x.o[c] = (uint32_t)(base + ((c ^ f) << 4));
  }
  return x;
}

// The four columns of the lane's quad over weight rows rb .. rb + 3 (rb a
// multiple of 16 plus 4·tig: `blk` is the 16-row block's byte offset) of a
// 128-byte-row SWIZZLE_128B tile (or of sg_lane_halves' two halves), each
// as one K-packed word (byte i = row rb + i).  Lane tig loads row rb +
// ((j + tig) & 3) as word j (the halves: ((j + tig / 2) & 3)): a warp's four
// loads of one instruction then fall on distinct banks, whatever the row's
// swizzle phase.
__device__ __forceinline__ void sg_quad(uint32_t (&c)[4], const char* tile, int blk,
                                        const SgLane& l) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = *reinterpret_cast<const uint32_t*>(tile + blk + l.q_off[j]);
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140), t3 = __byte_perm(v[2], v[3], 0x7362);
  c[0] = __byte_perm(t0, t2, l.sel0);
  c[1] = __byte_perm(t0, t2, l.sel1);
  c[2] = __byte_perm(t1, t3, l.sel0);
  c[3] = __byte_perm(t1, t3, l.sel1);
}

// The A operand of K-packed weight words: int8 containers as they are; a
// nibble half h (0: low, 1: high nibbles, biased codes b) as the signed
// s8 16·(b − 8) — the nibble in the byte's top four bits, its bias bit
// flipped (one logic op; the ×16 leaves the product exact and is taken out
// of the activation scale).
template <bool NIB>
__device__ __forceinline__ int sg_a(uint32_t v, int h) {
  if constexpr (!NIB) return (int)v;
  return (int)(((h ? v : v << 4) & 0xF0F0F0F0u) ^ 0x80808080u);
}

// B fragments of one k step, n8 tiles 0 .. NT − 1, from the x tile at `tile`
// (ROW-byte rows) at chunk choice `ci` of the lane's offsets
template <int ROW, int KSTEP, int NT>
__device__ __forceinline__ void sg_load_b(int (&b)[NT][2], uint32_t tile,
                                          const SgXOff<ROW, KSTEP>& xo, int ci) {
  const uint32_t base = tile + xo.o[ci];
  if constexpr (KSTEP == 32) {
    if constexpr (NT == 1) {
      ldsm_x2(b[0], base);
    } else {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        int t[4];
        ldsm_x4(t, base + 16 * p * ROW);
        b[2 * p][0] = t[0];
        b[2 * p][1] = t[1];
        b[2 * p + 1][0] = t[2];
        b[2 * p + 1][1] = t[3];
      }
    }
  } else {
    if constexpr (NT == 1) {
      ldsm_x1(b[0][0], base);
    } else if constexpr (NT == 2) {
      int t[2];
      ldsm_x2(t, base);
      b[0][0] = t[0];
      b[1][0] = t[1];
    } else {
#pragma unroll
      for (int p = 0; p < NT / 4; ++p) {
        int t[4];
        ldsm_x4(t, base + 32 * p * ROW);
#pragma unroll
        for (int i = 0; i < 4; ++i) b[4 * p + i][0] = t[i];
      }
    }
  }
}

// p[mt][nt] = 0x4B400000 + one group's int8 product: weight rows r0 ..
// r0 + GS − 1 of the slot's W tile (rows of WROW bytes: 128, or 64 in
// sg_lane_halves' halves; nibble half h) against the x tile `xt` (ROW-byte
// rows) from row byte r0 % ROW, GS / KSTEP mma k steps.  r0 is a multiple
// of 16 known once the loops are unrolled, so every shared address is a
// lane offset plus a constant.
template <bool NIB, int GS, int NT, int ROW, int WROW = 128>
__device__ __forceinline__ void sg_group_mma(int (&p)[2][NT][4], const char* wtile, int r0, int h,
                                             uint32_t xt, const SgXOff<ROW, GS % 32 ? 16 : 32>& xo,
                                             const SgLane& l) {
  constexpr int KSTEP = GS % 32 == 0 ? 32 : 16;
  const int magic[4] = {(int)SG_MAGIC_BITS, (int)SG_MAGIC_BITS, (int)SG_MAGIC_BITS,
                        (int)SG_MAGIC_BITS};
#pragma unroll
  for (int ks = 0; ks < GS / KSTEP; ++ks) {
    const int rb = r0 + ks * KSTEP;
    uint32_t q0[4], q1[4];
    sg_quad(q0, wtile, rb * WROW, l);
    if constexpr (KSTEP == 32) sg_quad(q1, wtile, (rb + 16) * WROW, l);
    int b[NT][2];
    sg_load_b<ROW, KSTEP, NT>(b, xt, xo, (rb % ROW) / KSTEP);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      int a[4];
      a[0] = sg_a<NIB>(q0[2 * mt], h);
      a[1] = sg_a<NIB>(q0[2 * mt + 1], h);
      if constexpr (KSTEP == 32) {
        a[2] = sg_a<NIB>(q1[2 * mt], h);
        a[3] = sg_a<NIB>(q1[2 * mt + 1], h);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (KSTEP == 32) {
          if (ks == 0) sg_mma32(p[mt][nt], a, b[nt][0], b[nt][1], magic);
          else sg_mma32(p[mt][nt], a, b[nt][0], b[nt][1], p[mt][nt]);
        } else {
          if (ks == 0) sg_mma16(p[mt][nt], a[0], a[1], b[nt][0], magic);
          else sg_mma16(p[mt][nt], a[0], a[1], b[nt][0], p[mt][nt]);
        }
      }
    }
  }
}

// acc += (f32(p) · s_x) · s_w for one group: p's bits are 1.5·2^23 + its
// value, so one subtract gives f32(p) exactly (no I2F); s_x of the lane's
// tokens from sx (× sx_mul: 1/16 for the nibbles' ×16, exact), s_w of its
// quad from sw
template <int NT, typename S>
__device__ __forceinline__ void sg_scale(float (&acc)[2][NT][4], const int (&p)[2][NT][4],
                                         const float* sx, const S* sw, float sx_mul,
                                         const SgLane& l) {
  float w[4];
  if constexpr (sizeof(S) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(sw + l.quad_b);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    w[0] = lo.x, w[1] = lo.y, w[2] = hi.x, w[3] = hi.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(sw + l.quad_b);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 s = *reinterpret_cast<const float2*>(sx + 8 * nt + 2 * l.tig);
    const float s0 = s.x * sx_mul, s1 = s.y * sx_mul;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __fsub_rn(__int_as_float(p[mt][nt][e]), WG_MAGIC);
        acc[mt][nt][e] = __fmaf_rn(__fmul_rn(v, (e & 1) ? s1 : s0), w[2 * mt + (e >> 1)],
                                   acc[mt][nt][e]);
      }
  }
}

// acc += one bf16 salient stage: KSAL k of w_sal (two 64-column
// SWIZZLE_128B halves at `wtile`) against x_sal (rows of 2·KSAL bytes at
// `xt`), mma m16n8k16.  A's (k, k + 1) pairs of the lane's quad come from
// 8-byte row loads (sal_off: rows 2·tig and 2·tig + 1 of a 16-row block, in
// the lane's half) and two byte permutes a pair of columns.
template <int NT, int KSAL>
__device__ __forceinline__ void sg_salient_bf16(float (&acc)[2][NT][4], const char* wtile,
                                                uint32_t xt, const uint32_t (&sal_off)[2],
                                                const SgXOff<2 * KSAL, 32>& xo) {
#pragma unroll
  for (int s = 0; s < KSAL / 16; ++s) {
    const char* blk = wtile + 16 * s * 128;
    const uint2 r0 = *reinterpret_cast<const uint2*>(blk + sal_off[0]);
    const uint2 r1 = *reinterpret_cast<const uint2*>(blk + sal_off[1]);
    const uint2 r2 = *reinterpret_cast<const uint2*>(blk + 8 * 128 + sal_off[0]);
    const uint2 r3 = *reinterpret_cast<const uint2*>(blk + 8 * 128 + sal_off[1]);
    int a[2][4];
    a[0][0] = (int)__byte_perm(r0.x, r1.x, 0x5410);
    a[0][1] = (int)__byte_perm(r0.x, r1.x, 0x7632);
    a[0][2] = (int)__byte_perm(r2.x, r3.x, 0x5410);
    a[0][3] = (int)__byte_perm(r2.x, r3.x, 0x7632);
    a[1][0] = (int)__byte_perm(r0.y, r1.y, 0x5410);
    a[1][1] = (int)__byte_perm(r0.y, r1.y, 0x7632);
    a[1][2] = (int)__byte_perm(r2.y, r3.y, 0x5410);
    a[1][3] = (int)__byte_perm(r2.y, r3.y, 0x7632);
    int bb[NT][2];
    sg_load_b<2 * KSAL, 32, NT>(bb, xt, xo, s);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], bb[nt]);
  }
}

// acc = the f32 salient dot Σ_k x_sal[n, k]·w_sal[k, o] on the CUDA cores,
// from global memory (the f32 instantiations; rank 0 before its stages,
// after griddepcontrol.wait behind a primary grid)
template <int NT>
__device__ __forceinline__ void sg_salient_f32(float (&acc)[2][NT][4], const SgArgs& a, int o0,
                                               const SgLane& l) {
  const float* xs = static_cast<const float*>(a.xsal);
  const float* ws = static_cast<const float*>(a.wsal);
  const int o = o0 + l.quad_b;
  if (o >= a.O) return;
  for (int k = 0; k < a.k_s; ++k) {
    const float4 w4 = *reinterpret_cast<const float4*>(ws + (size_t)k * a.O + o);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 8 * nt + 2 * l.tig + j;
        x[j] = n < a.N ? xs[(size_t)n * a.xsal_rs + k] : 0.0f;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = fmaf(x[e & 1], w[2 * mt + (e >> 1)], acc[mt][nt][e]);
    }
  }
}

// Stage t's weight side (the weight tile and its column scales, or w_sal),
// against its slot's full barrier with every byte of the stage
template <bool NIB, int GS, int NT, typename S>
__device__ __forceinline__ void sg_produce_weights(const SgArgs& a, const SgMaps& m, int t,
                                                   uint32_t su, uint32_t full, int o0) {
  using Geo = SgGeo<NIB, GS, NT>;
  if (t < a.n_sal) {
    mbar_expect_tx(full, 2 * Geo::KSAL * 128 + Geo::N_BOX * Geo::SALROW);
    tma_2d(su, m.wsal, full, o0, t * Geo::KSAL);
    tma_2d(su + Geo::KSAL * 128, m.wsal, full, o0 + 64, t * Geo::KSAL);
  } else {
    const int j = t - a.n_sal;
    mbar_expect_tx(full, Geo::KW * SG_BO + (NIB ? 2 : 1) * Geo::N_BOX * Geo::XROW +
                             Geo::SG * SG_BO * (int)sizeof(S));
    tma_2d(su, m.w, full, o0, j * Geo::KW);
    if constexpr (NIB) {
      tma_2d(su + Geo::OFF_SW, m.ws, full, o0, j);
      tma_2d(su + Geo::OFF_SW + SG_BO * (int)sizeof(S), m.ws, full, o0, j + a.G / 2);
    } else {
      tma_2d(su + Geo::OFF_SW, m.ws, full, o0, j * Geo::SG);
    }
  }
}

// The producer warp: stage t of the block's range into slot t − t0 mod
// SG_STAGES once the consumers have freed it.  Lane 0 issues the TMA copies
// against the slot's full barrier with their byte count; every lane copies
// its share of the activation scales by cp.async and reports them to the
// same barrier.  Behind a primary grid (a.pdl) the weight side of the first
// SG_STAGES stages (the weight tile, its column scales, w_sal) goes out
// first, then the warp waits for the primary, whose output the activation
// side (x tiles, x_sal, the scales) reads.
template <bool NIB, int GS, int NT, typename S>
__device__ __forceinline__ void sg_produce(const SgArgs& a, const SgMaps& m, char* smem, int t0,
                                           int t1, int o0, int lane) {
  using Geo = SgGeo<NIB, GS, NT>;
  if (lane == 0) {
    tma_prefetch(m.w);
    tma_prefetch(m.x);
    tma_prefetch(m.ws);
    if (a.n_sal) {
      tma_prefetch(m.xsal);
      tma_prefetch(m.wsal);
    }
  }
  const int pre = a.pdl ? (t1 - t0 < SG_STAGES ? t1 - t0 : SG_STAGES) : 0;
  if (lane == 0)
    for (int i = 0; i < pre; ++i)
      sg_produce_weights<NIB, GS, NT, S>(a, m, t0 + i, smem_u32(smem + i * Geo::SLOT),
                                         smem_u32(smem + Geo::OFF_BAR + 8 * i), o0);
  if (a.pdl) griddep_wait();
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, slot = i % SG_STAGES;
    const uint32_t su = smem_u32(smem + slot * Geo::SLOT);
    const uint32_t full = smem_u32(smem + Geo::OFF_BAR + 8 * slot);
    if (i >= pre) {
      if (i >= SG_STAGES)
        mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * (SG_STAGES + slot)), (i / SG_STAGES - 1) & 1);
      if (lane == 0) sg_produce_weights<NIB, GS, NT, S>(a, m, t, su, full, o0);
    }
    if (t < a.n_sal) {
      if (lane == 0) tma_2d(su + Geo::OFF_X, m.xsal, full, t * Geo::KSAL, 0);
    } else {
      const int j = t - a.n_sal;
      if (lane == 0) {
        tma_2d(su + Geo::OFF_X, m.x, full, j * a.x_dx, j * a.x_dy);
        if constexpr (NIB)
          tma_2d(su + Geo::OFF_X + Geo::XH, m.x, full, j * a.x_dx + a.x_hx, j * a.x_dy + a.x_hy);
      }
      // s_x of (group gi of the stage, token n) at sx[gi·N_BOX + n]
      for (int e = lane; e < Geo::SG * Geo::N_BOX; e += 32) {
        const int gi = e / Geo::N_BOX, n = e % Geo::N_BOX;
        const int g = NIB ? j + gi * (a.G / 2) : j * Geo::SG + gi;
        const bool ok = n < a.N && g < a.G;
        cp4(su + Geo::OFF_SX + 4 * e, ok ? a.xs + (size_t)n * a.s_rs + (size_t)g * a.s_gs : a.xs,
            ok);
      }
    }
    cp_async_arrive(full);
  }
}

// The consumers: the f32 salient dot (rank 0), then stages t0 .. t1 − 1 —
// salient stages by bf16 mma into acc, group stages as int8 products into
// p, each group scaled into acc in K order — freeing each slot after it.
template <bool NIB, int GS, int NT, typename S>
__device__ __forceinline__ void sg_consume(float (&acc)[2][NT][4], const SgArgs& a, char* smem,
                                           int t0, int t1, int o0, const SgLane& l) {
  using Geo = SgGeo<NIB, GS, NT>;
  constexpr int KSTEP = Geo::KSTEP;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  if (!a.t_bf16 && t0 == 0 && a.k_s > 0) {
    // x_sal is the primary grid's output, read here from global memory and
    // not through the producer's stages: behind a primary (a.pdl) these
    // warps wait for it too, or they read rows the prep has not written
    if (a.pdl) griddep_wait();
    sg_salient_f32<NT>(acc, a, o0, l);
  }
  const SgXOff<Geo::XROW, KSTEP> xo = sg_xoff<Geo::XROW, KSTEP>(l.lane);
  const SgXOff<Geo::SALROW, 32> xso = sg_xoff<Geo::SALROW, 32>(l.lane);
  uint32_t sal_off[2];
  {
    const int b = 64 * (l.w & 1) + 8 * l.gid;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      sal_off[e] = (uint32_t)((l.w >> 1) * Geo::KSAL * 128 + sg_swz<128>(2 * l.tig + e, b));
  }
  constexpr float sx_mul = NIB ? 0.0625f : 1.0f;
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, slot = i % SG_STAGES;
    const char* s = smem + slot * Geo::SLOT;
    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / SG_STAGES) & 1);
    const float* sx = reinterpret_cast<const float*>(s + Geo::OFF_SX);
    const S* sw = reinterpret_cast<const S*>(s + Geo::OFF_SW);
    if (t < a.n_sal) {
      sg_salient_bf16<NT, Geo::KSAL>(acc, s, smem_u32(s + Geo::OFF_X), sal_off, xso);
    } else if constexpr (NIB) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p[2][NT][4];
        sg_group_mma<true, GS, NT, GS>(p, s, 0, h, smem_u32(s + Geo::OFF_X + h * Geo::XH), xo,
                                        l);
        sg_scale<NT, S>(acc, p, sx + h * Geo::N_BOX, sw + h * SG_BO, sx_mul, l);
      }
    } else {
      const int g0 = (t - a.n_sal) * Geo::SG;
#pragma unroll
      for (int gi = 0; gi < Geo::SG; ++gi) {
        if (g0 + gi < a.G) {
          int p[2][NT][4];
          sg_group_mma<false, GS, NT, 128>(p, s, gi * GS, 0, smem_u32(s + Geo::OFF_X), xo, l);
          sg_scale<NT, S>(acc, p, sx + gi * Geo::N_BOX, sw + gi * SG_BO, sx_mul, l);
        }
      }
    }
    __syncwarp();
    if (l.lane == 0) sg_arrive(smem_u32(smem + Geo::OFF_BAR + 8 * (SG_STAGES + slot)));
  }
}

// A block's place in the grid: rank (its K range) within its tile's
// cluster of 2^lg ranks along x, and the tile's first column.
__device__ __forceinline__ void sg_place(int lg, int& rank, int& o0) {
  rank = blockIdx.x & ((1 << lg) - 1);
  o0 = (blockIdx.x >> lg) * SG_BO;
}

// The partial tile of a consumer lane's accumulators in the quad mapping
// of sg_lane (column 4·gid + 2·mt + h of the warp is row gid + 8h of m16
// tile mt): (N_BOX, SG_PART_LD) f32 at `part`, the ring's start.
template <int NT>
__device__ __forceinline__ void sg_store_partial(float* part, const float (&acc)[2][NT][4],
                                                 const SgLane& l) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(part + (8 * nt + 2 * l.tig + j) * SG_PART_LD + l.quad_b) =
          make_float4(acc[0][nt][j], acc[0][nt][2 + j], acc[1][nt][j], acc[1][nt][2 + j]);
}

// The epilogue every stream kernel shares, after each rank wrote its
// partial tile and passed a barrier (cluster-wide at n_split = cs > 1): this
// rank's share of the tile's quads (row n, columns 4q ..) summed over the
// ranks in rank order and stored in the output dtype (bf16 or f32) — one
// launch, nothing through device memory, the same bits on every call.
__device__ __forceinline__ void sg_reduce_store(const float* part, void* out, int N, int O,
                                                int o0, int rank, int lg, int cs, int tid,
                                                int bf16_out) {
  const int quads = N * (SG_BO / 4);
  const int q_end = ((rank + 1) * quads) >> lg;
  const uint32_t part_u = smem_u32(part);
  for (int q = ((rank * quads) >> lg) + tid; q < q_end; q += 128) {
    const int n = q / (SG_BO / 4), c = 4 * (q % (SG_BO / 4)), o = o0 + c;
    if (o >= O) continue;
    const uint32_t off = part_u + 4 * (n * SG_PART_LD + c);
    float4 v = cs > 1 ? sg_ld_rank(off, 0) : *reinterpret_cast<const float4*>(part + n * SG_PART_LD + c);
    for (int r = 1; r < cs; ++r) {
      const float4 u = sg_ld_rank(off, r);
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    }
    if (bf16_out) {
      uint2 h;
      h.x = bf16_pair(v.x, v.y);
      h.y = bf16_pair(v.z, v.w);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + (size_t)n * O + o) = h;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)n * O + o) = v;
    }
  }
}

// What the producer warpgroup does once its warp 4 has issued every stage:
// wait for the consumers to drain the ring, then pass the barriers of the
// epilogue (two cluster barriers, or the block's one).
__device__ __forceinline__ void sg_producer_tail(int cs) {
  named_sync<SG_THREADS>(SG_BAR_DRAINED);
  if (cs > 1) {
    sg_cluster_sync();
    sg_cluster_sync();
  } else {
    __syncthreads();
  }
}

// Block (tile, rank) of a cluster of n_split ranks along x: output columns
// tile·128 .., stages rank·T/n_split .. (rank + 1)·T/n_split − 1 of the T =
// n_sal + n_grp stages.  Warps 0-3 consume; warp 4 loads.
template <bool NIB, int GS, int NT, typename S>
__global__ void __launch_bounds__(SG_THREADS, 2)
stream_gmm_kernel(const SgArgs a, const __grid_constant__ SgMaps m) {
  using Geo = SgGeo<NIB, GS, NT>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  // n_split is a power of two: shifts, not a division (which compiles to I2F)
  const int cs = a.n_split, lg = __ffs(cs) - 1;
  int rank, o0;
  sg_place(lg, rank, o0);
  const int T = a.n_sal + a.n_grp;
  const int t0 = (rank * T) >> lg, t1 = ((rank + 1) * T) >> lg;
  if (tid == 0) {
    for (int s = 0; s < SG_STAGES; ++s) {
      mbar_init(smem_u32(smem + Geo::OFF_BAR + 8 * s), 1 + 32);
      mbar_init(smem_u32(smem + Geo::OFF_BAR + 8 * (SG_STAGES + s)), 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);   // (N_BOX, SG_PART_LD) f32, after the ring
  if (warp >= 4) {
    regs_dec<SG_PRODUCER_REGS>();
    if (warp == 4) sg_produce<NIB, GS, NT, S>(a, m, smem, t0, t1, o0, tid & 31);
    sg_producer_tail(cs);
    return;
  }
  regs_inc<SG_CONSUMER_REGS>();
  const SgLane l = sg_lane(tid);
  float acc[2][NT][4];
  sg_consume<NIB, GS, NT, S>(acc, a, smem, t0, t1, o0, l);
  named_sync<SG_THREADS>(SG_BAR_DRAINED);   // the ring is free: it takes the partial tile
  sg_store_partial<NT>(part, acc, l);
  if (cs > 1) sg_cluster_sync();
  else __syncthreads();
  sg_reduce_store(part, a.out, a.N, a.O, o0, rank, lg, cs, tid, a.t_bf16);
  if (cs > 1) sg_cluster_sync();   // no rank leaves while another reads its tile
}

// ---------------------------------------------------------------- bf16 weights (K13)
// The body's third weight kind: a layer's (K, O) bf16 slab, x at 1-8 token
// rows (one n8 tile).  A stage is KB weight rows (64, or 32 where a tile's
// K splits over ranks or the tiles outnumber the SMs: finer stages measured
// faster there, stream_gmm.k13_kb) as two TMA boxes of 64 columns × KB rows
// (128-byte rows, SWIZZLE_128B) and the x tile of those k (8 rows of KB
// bf16, zero past N and past K).  The weight's output
// columns are the M side of mma m16n8k16 bf16 → f32: a 16-bit transpose is
// what ldmatrix.trans does, so each A fragment (16 columns × 16 k) is one
// ldmatrix.x4.trans of the rows as TMA wrote them (no byte permutes), the
// tokens the n side by ldmatrix from the x tile.  No scaling: the f32 sums
// run straight through the stage; the split over K is the cluster's, reduced
// as the other kinds are.
constexpr int SB_STAGES = 4;                    // ring slots

// The slot geometry of stages of KB weight rows (64 or 32)
template <int KB>
struct SbGeo {
  static constexpr int HALF = KB * 128;          // one 64-column half of a stage's weight
  static constexpr int W_BYTES = 2 * HALF;
  static constexpr int X_BYTES = 8 * 2 * KB;     // the x tile: 8 rows of KB bf16
  static constexpr int SLOT = sg_align(W_BYTES + X_BYTES, 1024);
  static constexpr int OFF_BAR = SB_STAGES * SLOT;
  static constexpr int SMEM = OFF_BAR + 2 * 8 * SB_STAGES;
  static_assert(8 * SG_PART_LD * 4 <= OFF_BAR, "the partial tile reuses the ring");
};

struct SbArgs {
  void* out;            // (N, O) bf16
  int N, O, n_stages, n_split;
};
struct SbMaps {         // the weight slab (K, O), x (N, K)
  CUtensorMap w, x;
};

__device__ __forceinline__ void ldsm_x4_t(int (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Block (tile, rank) as stream_gmm_kernel's.  Consumer warp w takes the
// tile's columns 32w .. 32w + 31 (half w / 2 of the stage's weight), m16
// tile mt its columns 16mt ..; lane L gives ldmatrix.x4.trans the row of
// matrix L / 8 (k rows 8·(L / 16) .., columns 8·(L / 8 % 2) .. of the m
// tile), so its registers are the m16n8k16 A fragment as they come.
template <int KB>
__global__ void __launch_bounds__(SG_THREADS, 2)
stream_bf16_kernel(const SbArgs a, const __grid_constant__ SbMaps m) {
  using Geo = SbGeo<KB>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.n_split, lg = __ffs(cs) - 1;
  int rank, o0;
  sg_place(lg, rank, o0);
  const int T = a.n_stages;
  const int t0 = (rank * T) >> lg, t1 = ((rank + 1) * T) >> lg;
  if (tid == 0) {
    for (int s = 0; s < SB_STAGES; ++s) {
      mbar_init(smem_u32(smem + Geo::OFF_BAR + 8 * s), 1);
      mbar_init(smem_u32(smem + Geo::OFF_BAR + 8 * (SB_STAGES + s)), 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  if (warp >= 4) {
    regs_dec<SG_PRODUCER_REGS>();
    if (warp == 4 && lane == 0) {
      tma_prefetch(m.w);
      tma_prefetch(m.x);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, slot = i % SB_STAGES;
        const uint32_t su = smem_u32(smem + slot * Geo::SLOT);
        const uint32_t full = smem_u32(smem + Geo::OFF_BAR + 8 * slot);
        if (i >= SB_STAGES)
          mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * (SB_STAGES + slot)), (i / SB_STAGES - 1) & 1);
        mbar_expect_tx(full, Geo::W_BYTES + Geo::X_BYTES);
        tma_2d(su, m.w, full, o0, t * KB);
        tma_2d(su + Geo::HALF, m.w, full, o0 + 64, t * KB);
        tma_2d(su + Geo::W_BYTES, m.x, full, t * KB, 0);
      }
    }
    sg_producer_tail(cs);
    return;
  }
  regs_inc<SG_CONSUMER_REGS>();
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, ri = lane & 7;
  uint32_t a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int chunk = 4 * (warp & 1) + 2 * mt + (mi & 1);   // 16-byte column chunk of the half
    a_off[mt] = (uint32_t)((warp >> 1) * Geo::HALF + (8 * (mi >> 1) + ri) * 128 + ((chunk ^ ri) << 4));
  }
  const SgXOff<2 * KB, 32> xo = sg_xoff<2 * KB, 32>(lane);
  float acc[2][4] = {};
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, slot = i % SB_STAGES;
    const uint32_t su = smem_u32(smem + slot * Geo::SLOT);
    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / SB_STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
      int a0[4], a1[4], b[1][2];
      ldsm_x4_t(a0, su + a_off[0] + ks * 16 * 128);
      ldsm_x4_t(a1, su + a_off[1] + ks * 16 * 128);
      sg_load_b<2 * KB, 32, 1>(b, su + Geo::W_BYTES, xo, ks);
      mma_bf16(acc[0], a0, b[0]);
      mma_bf16(acc[1], a1, b[0]);
    }
    __syncwarp();
    if (lane == 0) sg_arrive(smem_u32(smem + Geo::OFF_BAR + 8 * (SB_STAGES + slot)));
  }
  named_sync<SG_THREADS>(SG_BAR_DRAINED);
  // D row gid + 8h of m tile mt is column 32w + 16mt + 8h + gid, its
  // columns 2·tig + j the tokens
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(2 * tig + (e & 1)) * SG_PART_LD + 32 * warp + 16 * mt + 8 * (e >> 1) + gid] =
          acc[mt][e];
  if (cs > 1) sg_cluster_sync();
  else __syncthreads();
  sg_reduce_store(part, a.out, a.N, a.O, o0, rank, lg, cs, tid, 1);
  if (cs > 1) sg_cluster_sync();
}

// ---------------------------------------------------------------- raw x (K1)
// The nibble kind with K1's pre-pass folded in: x arrives raw (N <= 32 bf16
// rows, before the RMSNorm or mask, before the quantize).  A group stage
// carries, beside the pair's GS packed rows and its two column-scale rows,
// the raw activations of its two groups — x's lo and hi tiles (N_BOX rows
// of GS bf16, zero past N and past C) and the norm row's (GS f32) — all by
// TMA, so the producer warp streams from its first instruction and no
// activation waits on a load of its own.  The producer warpgroup's other
// three warps quantize each stage in its slot as it lands, one warp a
// stage and three stages at once, ahead of the consumers (a per-slot
// "codes ready" mbarrier), as the TPU
// kernel quantizes each K tile at j == 0 into VMEM scratch
// (int4_group_matmul.py:366-397): y = (x·r)·w_norm, x·mask or x in f32
// steps, zero in tail mode from k_ns_raw on; scale = max(absmax, 1e-5) ·
// (1/qmax); codes rint(y / scale) of the true division (sr_code), GS/8
// lanes a (row, group), 8 channels a lane; the codes go to the slot as TMA
// would write an x tile (N_BOX rows of GS bytes, the GS-byte swizzle) and
// their scales beside them, so the consumers' mma and scaling read them as
// the nibble kind's (16·(b − 8) nibbles, the 0x4B400000 accumulator).
// (Quantizing in the consumer warps instead, stage by stage or all before
// the first stage, left K1 consumer-bound: PERF.md §6.)  What a stage
// cannot carry is made before the first stage: the rows' RMS factors (rms
// mode; rms_factor's rule: Σx² in f64 rounded to f32 once, 1/√ by two
// correctly rounded steps, a warp a row; the quantizers' copy, and the
// consumers' own where a tail salient stage needs it) and, by the
// consumers, the salient activations of the
// rank's salient stages (the external x_sal, or the tail's channels times
// r and the norm row, rounded to bf16) as 32-column tiles in the 64-byte
// swizzle of a TMA'd x_sal.  The codes and scales are those of
// rawx_quantize_plain, bit for bit; the cluster reduces in rank order: one
// launch where the dp4a body takes three.
constexpr int SR_BAR_PREP = 2;          // the consumers' named barrier (128 threads)
constexpr int SR_BAR_QUANT = 3;         // the quantizers' (96 threads)
constexpr int SR_QUANTIZERS = 96;       // warps 5-7
// registers a consumer / producer-warpgroup thread holds after setmaxnreg
// (the quantizers need more than the stream body's 56)
constexpr int SR_CONSUMER_REGS = 176, SR_PRODUCER_REGS = 80;
constexpr int SR_SMEM_MAX = 232448;     // a block's dynamic shared memory at most (227 KB)

template <int GS, int NT>
struct SrGeo {
  static constexpr int N_BOX = 8 * NT;
  static constexpr int STAGES = 6;                           // ring slots
  // each slot's every use is one quantizer warp's (stage i is warp i % 3's),
  // so that warp waits on the slot's phases in order
  static_assert(STAGES % 3 == 0, "a slot's stages fall to one quantizer warp");
  static constexpr int W_BYTES = 8192;                       // a pair's GS·128 nibbles or 32 w_sal rows
  static constexpr int OFF_SW = W_BYTES;                     // the pair's column scales (f32 at most)
  static constexpr int OFF_X = OFF_SW + 2 * SG_BO * 4;       // raw x: the lo, then the hi tile
  static constexpr int XT = N_BOX * GS * 2;
  static constexpr int OFF_NW = OFF_X + 2 * XT;              // the norm row's lo and hi GS f32
  static constexpr int NWT = sg_max(GS * 4, 128);            // (each at a 128-byte boundary)
  static constexpr int OFF_Q = OFF_NW + 2 * NWT;             // codes: lo, then hi
  static constexpr int CT = N_BOX * GS;
  static constexpr int OFF_SX = OFF_Q + 2 * CT;              // their scales: lo, then hi
  static constexpr int SLOT = sg_align(OFF_SX + 2 * N_BOX * 4, 1024);
  static constexpr int OFF_R = STAGES * SLOT;                // RMS factors: the consumers', the quantizers'
  static constexpr int OFF_BAR = OFF_R + 2 * N_BOX * 4;      // full, empty, codes-ready mbarriers
  static constexpr int OFF_SAL = sg_align(OFF_BAR + 3 * 8 * STAGES, 128);   // salient tiles
  static constexpr int SAL_T = N_BOX * 64;
  static_assert(N_BOX * SG_PART_LD * 4 <= OFF_R, "the partial tile reuses the ring");
  static constexpr int smem(int sal_stages) { return OFF_SAL + sal_stages * SAL_T; }
};

struct SrArgs {
  const __nv_bfloat16* x;      // (N, C) raw activations
  const float* nw;             // (C,) RMSNorm row (mode 1) or 0/1 mask (mode 2); null in mode 0
  const __nv_bfloat16* xsal;   // (N, k_s) external salient activations, or null (tail mode)
  void* out;                   // (N, O) bf16
  int N, C, O, G, k_ns_raw, num_salient, k_s;
  int mode, need_mask;
  float eps, inv_c, inv_qmax;
  int n_sal, n_grp, n_split;   // stages (salient, group pair) and ranks
};
struct SrMaps {   // the nibble weight, its column scales, the salient block, x, the norm row
  CUtensorMap w, ws, wsal, x, nw;
};

// Σ of the squares of eight bf16 values (a 16-byte word) in f64, in order
__device__ __forceinline__ double sr_sq8(uint4 v, double ss) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xFFFF0000u);
    ss += lo * lo;
    ss += hi * hi;
  }
  return ss;
}

// The rows' RMS factors into rr, a warp a row (WARPS warps, warp w): each
// lane's 16-byte words in order, eight in flight, then the warp's tree (f64
// sums of bf16 squares are exact, so any warp gives the same bits).
template <int WARPS>
__device__ __forceinline__ void sr_rms(const SrArgs& a, float* rr, int w, int lane) {
  const int words = a.C >> 3;
  for (int n = w; n < a.N; n += WARPS) {
    const uint4* row = reinterpret_cast<const uint4*>(a.x + (size_t)n * a.C);
    double ss = 0.0;
    for (int w0 = 0; w0 < words; w0 += 32 * 8) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int wi = w0 + lane + 32 * u;
        v[u] = wi < words ? __ldg(row + wi) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) ss = sr_sq8(v[u], ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0)
      rr[n] = __frcp_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(__double2float_rn(ss), a.inv_c), a.eps)));
  }
}

// rint(y / scale) as a byte, y / scale the true division rounded to f32:
// d = y·(1/scale) lies within 3·2^-24 of it relatively (both roundings), so
// where d is farther than |d|·2^-20 from the nearest half-integer both round
// to the same integer and d serves; only near a tie (rare) does the lane
// divide.  The quotient plus 1.5·2^23 rounds half to even and leaves the
// code in the low byte (|q| < 2^22): no conversion instruction.
__device__ __forceinline__ uint32_t sr_code(float y, float scale, float inv) {
  const float d = __fmul_rn(y, inv);
  const float m = __fadd_rn(d, WG_MAGIC);
  const float frac = __fsub_rn(d, __fsub_rn(m, WG_MAGIC));   // exact: d less its nearest integer
  if (fabsf(fabsf(frac) - 0.5f) <= fmaxf(fabsf(d), 1.0f) * 9.5367431640625e-7f)
    return __float_as_uint(__fadd_rn(__fdiv_rn(y, scale), WG_MAGIC)) & 0xFFu;
  return __float_as_uint(m) & 0xFFu;
}

// Eight code bytes (the low byte of each q) as a word pair, in order
__device__ __forceinline__ uint2 sr_pack8(const uint32_t (&q)[8]) {
  return make_uint2(
      __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(q[4], q[5], 0x0040), __byte_perm(q[6], q[7], 0x0040), 0x5410));
}

// One lane's share of a (row, group) quantize: its eight channels of x (a
// 16-byte word of bf16) through the norm, the group's absmax over the SUB
// lanes of its group (xor shuffles within them), the scale, the eight codes
// as a word pair; returns the scale.
template <int SUB>
__device__ __forceinline__ float sr_quantize8(uint4 xv, const float (&nw)[8], float r, int c0,
                                              const SrArgs& a, uint2& codes) {
  const uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
  float y[8];
  float amax = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float v = __uint_as_float(e & 1 ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
    if (a.mode == 1) v = __fmul_rn(__fmul_rn(v, r), nw[e]);
    else if (a.mode == 2) v = __fmul_rn(v, nw[e]);
    if (a.need_mask && c0 + e >= a.k_ns_raw) v = 0.0f;
    y[e] = v;
    amax = fmaxf(amax, fabsf(v));
  }
#pragma unroll
  for (int o = SUB / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = __fmul_rn(fmaxf(amax, 1e-5f), a.inv_qmax);
  const float inv = __frcp_rn(scale);
  uint32_t q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) q[e] = sr_code(y[e], scale, inv);
  codes = sr_pack8(q);
  return scale;
}

// The consumers' work before the first stage (128 threads): their RMS
// factors, then the salient tiles of the rank's salient stages t0 .. ns − 1
// (a warp a row, a lane a bf16 pair, four pairs' loads in flight).
template <int GS, int NT>
__device__ __forceinline__ void sr_prepass(const SrArgs& a, char* smem, int t0, int t1, int tid) {
  using Geo = SrGeo<GS, NT>;
  float* rr = reinterpret_cast<float*>(smem + Geo::OFF_R);
  char* sal = smem + Geo::OFF_SAL;
  const int lane = tid & 31, warp = tid >> 5;
  const int ns = (t1 < a.n_sal ? t1 : a.n_sal) - t0;
  if (ns <= 0) return;
  if (a.mode == 1 && a.xsal == nullptr) {
    sr_rms<4>(a, rr, warp, lane);
    named_sync<128>(SR_BAR_PREP);
  }
  for (int n = warp; n < a.N; n += 4) {
    const float r = a.mode == 1 && a.xsal == nullptr ? rr[n] : 1.0f;
    for (int p0 = 0; p0 < 16 * ns; p0 += 128) {
      float v[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 32 * t0 + 2 * (p0 + lane + 32 * u) + e;   // salient column
          float x = 0.0f;
          if (a.xsal != nullptr) {
            if (jj < a.k_s) x = __bfloat162float(__ldg(a.xsal + (size_t)n * a.k_s + jj));
          } else if (jj < a.num_salient) {
            const int col = a.k_ns_raw + jj;
            x = __bfloat162float(__ldg(a.x + (size_t)n * a.C + col));
            if (a.mode == 1) x = __fmul_rn(__fmul_rn(x, r), __ldg(a.nw + col));
          }
          v[u][e] = x;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = p0 + lane + 32 * u;
        if (p < 16 * ns)
          *reinterpret_cast<uint32_t*>(sal + (p >> 4) * Geo::SAL_T +
                                       sg_swz<64>(n, 4 * (p & 15))) = bf16_pair(v[u][0], v[u][1]);
      }
    }
  }
  named_sync<128>(SR_BAR_PREP);
}

// The codes and scales of group stage j (pair j: groups j and j + G/2) from
// the raw tiles in its slot `s`, into the same slot, by one quantizer warp:
// item (group h, row n) of the 2N takes the GS/8 lanes of one subgroup,
// 32/SUB items a round (the rounds are the warp's, so every lane reaches
// each shuffle).
template <int GS, int NT>
__device__ __forceinline__ void sr_quantize_stage(const SrArgs& a, char* s, int j, const float* rr,
                                                  int lane) {
  using Geo = SrGeo<GS, NT>;
  constexpr int SUB = GS / 8, IPR = 32 / SUB;
  const int sl = lane % SUB, first = lane / SUB;
  for (int it0 = 0; it0 < 2 * a.N; it0 += IPR) {
    const int it = it0 + first, h = it & 1, n = it >> 1;
    const bool ok = it < 2 * a.N;
    const uint4 xv = *reinterpret_cast<const uint4*>(s + Geo::OFF_X + h * Geo::XT +
                                                     (ok ? n : 0) * 2 * GS + 16 * sl);
    float nw[8] = {};
    if (a.mode != 0) {
      const float4 u0 = *reinterpret_cast<const float4*>(s + Geo::OFF_NW + h * Geo::NWT + 32 * sl);
      const float4 u1 = *reinterpret_cast<const float4*>(s + Geo::OFF_NW + h * Geo::NWT + 32 * sl + 16);
      nw[0] = u0.x, nw[1] = u0.y, nw[2] = u0.z, nw[3] = u0.w;
      nw[4] = u1.x, nw[5] = u1.y, nw[6] = u1.z, nw[7] = u1.w;
    }
    const int c0 = (j + h * (a.G >> 1)) * GS + 8 * sl;
    uint2 codes;
    const float scale =
        sr_quantize8<SUB>(xv, nw, a.mode == 1 && ok ? rr[n] : 1.0f, c0, a, codes);
    if (ok) {
      *reinterpret_cast<uint2*>(s + Geo::OFF_Q + h * Geo::CT + sg_swz<GS>(n, 8 * sl)) = codes;
      if (sl == 0) reinterpret_cast<float*>(s + Geo::OFF_SX)[h * Geo::N_BOX + n] = scale;
    }
  }
}

// The quantizer warps (5-7): their RMS factors, then warp q takes the
// rank's stages q, q + 3, ... in ring order — wait for the stage to land,
// quantize it if it is a group stage, and report the slot's codes ready
// (one arrival, after __syncwarp orders the warp's writes before it; the
// consumers wait for it at every stage, so no slot is refilled before its
// warp is done with it).  Three
// stages are quantized at once: one warp a stage, where all three on one
// stage left each stage's latency chain in turn (PERF.md §6).  The ring's
// depth is a multiple of 3, so every use of a slot is the same warp's and
// it waits on the slot's phases in order (a warp that waited on a later
// use while an earlier one was pending would pass at once).
template <int GS, int NT>
__device__ __forceinline__ void sr_quantizer(const SrArgs& a, char* smem, int t0, int t1, int qtid) {
  using Geo = SrGeo<GS, NT>;
  constexpr int STAGES = Geo::STAGES;
  float* rr = reinterpret_cast<float*>(smem + Geo::OFF_R) + Geo::N_BOX;
  const int qw = qtid >> 5, lane = qtid & 31;
  if (a.mode == 1) {
    sr_rms<3>(a, rr, qw, lane);
    named_sync<SR_QUANTIZERS>(SR_BAR_QUANT);
  }
  for (int t = t0 + qw; t < t1; t += 3) {
    const int i = t - t0, slot = i % STAGES;
    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / STAGES) & 1);
    if (t >= a.n_sal) sr_quantize_stage<GS, NT>(a, smem + slot * Geo::SLOT, t - a.n_sal, rr, lane);
    __syncwarp();
    if (lane == 0) sg_arrive(smem_u32(smem + Geo::OFF_BAR + 8 * (2 * STAGES + slot)));
  }
}

// The producer (warp 4, lane 0): stage t of the rank's range into its slot
// once the consumers have freed it — a salient stage's two 64-column boxes
// of w_sal at columns c_gate and c_up; a group stage's pair of weight rows
// and column scales at the same columns (one 128-column box at c_gate, or,
// HALVES, two 64-column halves of 64-byte rows at c_gate and c_up), the raw
// x tiles of its two groups and their norm rows.
template <int GS, int NT, typename S, bool HALVES>
__device__ __forceinline__ void sr_produce(const SrArgs& a, const SrMaps& m, char* smem, int t0,
                                           int t1, int c_gate, int c_up) {
  using Geo = SrGeo<GS, NT>;
  constexpr int STAGES = Geo::STAGES;
  tma_prefetch(m.w);
  tma_prefetch(m.ws);
  tma_prefetch(m.x);
  if (a.mode) tma_prefetch(m.nw);
  if (a.n_sal) tma_prefetch(m.wsal);
  const int nw_bytes = a.mode ? 2 * GS * 4 : 0;
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, slot = i % STAGES;
    const uint32_t su = smem_u32(smem + slot * Geo::SLOT);
    const uint32_t full = smem_u32(smem + Geo::OFF_BAR + 8 * slot);
    if (i >= STAGES)
      mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * (STAGES + slot)), (i / STAGES - 1) & 1);
    if (t < a.n_sal) {
      mbar_expect_tx(full, 2 * 32 * 128);
      tma_2d(su, m.wsal, full, c_gate, 32 * t);
      tma_2d(su + 32 * 128, m.wsal, full, c_up, 32 * t);
    } else {
      const int j = t - a.n_sal, jh = j + (a.G >> 1);
      mbar_expect_tx(full, GS * SG_BO + 2 * SG_BO * (int)sizeof(S) + 2 * Geo::XT + nw_bytes);
      if constexpr (HALVES) {
        constexpr int HS = 64 * (int)sizeof(S);   // a half's row of column scales
        tma_2d(su, m.w, full, c_gate, j * GS);
        tma_2d(su + GS * 64, m.w, full, c_up, j * GS);
        tma_2d(su + Geo::OFF_SW, m.ws, full, c_gate, j);
        tma_2d(su + Geo::OFF_SW + HS, m.ws, full, c_up, j);
        tma_2d(su + Geo::OFF_SW + 2 * HS, m.ws, full, c_gate, jh);
        tma_2d(su + Geo::OFF_SW + 3 * HS, m.ws, full, c_up, jh);
      } else {
        tma_2d(su, m.w, full, c_gate, j * GS);
        tma_2d(su + Geo::OFF_SW, m.ws, full, c_gate, j);
        tma_2d(su + Geo::OFF_SW + SG_BO * (int)sizeof(S), m.ws, full, c_gate, jh);
      }
      tma_2d(su + Geo::OFF_X, m.x, full, j * GS, 0);
      tma_2d(su + Geo::OFF_X + Geo::XT, m.x, full, jh * GS, 0);
      if (a.mode) {
        tma_2d(su + Geo::OFF_NW, m.nw, full, j * GS, 0);
        tma_2d(su + Geo::OFF_NW + Geo::NWT, m.nw, full, jh * GS, 0);
      }
    }
  }
}

// The consumers' main loop (after sr_prepass): stages t0 .. t1 − 1 into acc
// — a salient stage by bf16 mma from its prepass tile, a group stage's two
// groups as int8 products of the quantizers' codes (weight rows of WROW
// bytes: 128, or 64 in sg_lane_halves' halves), each scaled in K order —
// freeing each slot after it.
template <int GS, int NT, typename S, int WROW>
__device__ __forceinline__ void sr_consume(float (&acc)[2][NT][4], const SrArgs& a, char* smem,
                                           int t0, int t1, const SgLane& l) {
  using Geo = SrGeo<GS, NT>;
  constexpr int STAGES = Geo::STAGES;
  const SgXOff<GS, GS % 32 == 0 ? 32 : 16> xo = sg_xoff<GS, GS % 32 == 0 ? 32 : 16>(l.lane);
  const SgXOff<64, 32> xso = sg_xoff<64, 32>(l.lane);
  uint32_t sal_off[2];
  {
    const int b = 64 * (l.w & 1) + 8 * l.gid;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      sal_off[e] = (uint32_t)((l.w >> 1) * 32 * 128 + sg_swz<128>(2 * l.tig + e, b));
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, slot = i % STAGES;
    const char* s = smem + slot * Geo::SLOT;
    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / STAGES) & 1);
    // every stage's codes-ready phase, the salient stages' too (whose
    // quantizer only reports): a consumer that freed a slot its quantizer
    // had not yet reached would let the producer refill it, and that warp
    // would then wait on a phase already past, and this wait pass early
    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * (2 * STAGES + slot)), (i / STAGES) & 1);
    if (t < a.n_sal) {
      sg_salient_bf16<NT, 32>(acc, s, smem_u32(smem + Geo::OFF_SAL + i * Geo::SAL_T), sal_off,
                              xso);
    } else {
      const float* sx = reinterpret_cast<const float*>(s + Geo::OFF_SX);
      const S* sw = reinterpret_cast<const S*>(s + Geo::OFF_SW);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p[2][NT][4];
        sg_group_mma<true, GS, NT, GS, WROW>(p, s, 0, h, smem_u32(s + Geo::OFF_Q + h * Geo::CT),
                                             xo, l);
        sg_scale<NT, S>(acc, p, sx + h * Geo::N_BOX, sw + h * SG_BO, 0.0625f, l);
      }
    }
    __syncwarp();
    if (l.lane == 0) sg_arrive(smem_u32(smem + Geo::OFF_BAR + 8 * (STAGES + slot)));
  }
}

// The block's mbarriers: a slot's full (the producer's one arrival with its
// bytes), empty (one a consumer warp) and codes-ready (its quantizer warp's)
template <int STAGES>
__device__ __forceinline__ void sr_init_bars(char* smem_bar) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(smem_u32(smem_bar + 8 * s), 1);
    mbar_init(smem_u32(smem_bar + 8 * (STAGES + s)), 4);
    mbar_init(smem_u32(smem_bar + 8 * (2 * STAGES + s)), 1);
  }
  mbar_init_fence();
}

// Block (tile, rank) as stream_gmm_kernel's: warps 0-3 consume, warp 4
// loads from the first instruction on, warps 5-7 quantize.
template <int GS, int NT, typename S>
__global__ void __launch_bounds__(SG_THREADS, 2)
stream_rawx_kernel(const SrArgs a, const __grid_constant__ SrMaps m) {
  using Geo = SrGeo<GS, NT>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.n_split, lg = __ffs(cs) - 1;
  int rank, o0;
  sg_place(lg, rank, o0);
  const int T = a.n_sal + a.n_grp;
  const int t0 = (rank * T) >> lg, t1 = ((rank + 1) * T) >> lg;
  if (tid == 0) sr_init_bars<Geo::STAGES>(smem + Geo::OFF_BAR);
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  if (warp >= 4) {
    regs_dec<SR_PRODUCER_REGS>();
    if (warp > 4) sr_quantizer<GS, NT>(a, smem, t0, t1, tid - 160);
    else if (lane == 0) sr_produce<GS, NT, S, false>(a, m, smem, t0, t1, o0, o0 + 64);
    sg_producer_tail(cs);
    return;
  }
  regs_inc<SR_CONSUMER_REGS>();
  sr_prepass<GS, NT>(a, smem, t0, t1, tid);
  const SgLane l = sg_lane(tid);
  float acc[2][NT][4];
  sr_consume<GS, NT, S, 128>(acc, a, smem, t0, t1, l);
  named_sync<SG_THREADS>(SG_BAR_DRAINED);
  sg_store_partial<NT>(part, acc, l);
  if (cs > 1) sg_cluster_sync();
  else __syncthreads();
  sg_reduce_store(part, a.out, a.N, a.O, o0, rank, lg, cs, tid, 1);
  if (cs > 1) sg_cluster_sync();
}

// ---------------------------------------------------------------- SwiGLU gate_up (K14)
// The raw-x kind with a paired column map and an epilogue of its own: the
// first of K14's two launches (mlp_fused.cu).  Block tile t takes gate_up's
// gate columns 64t .. 64t + 63 and up columns inter + 64t .. (the fused
// [gate | up] columns split at the true intermediate width), each stage's
// weight rows as two 64-column TMA halves of 64-byte rows (sg_lane_halves:
// warps 0-1 the gate half, 2-3 the up half) and the column scales as four
// 64-column boxes, so after the cluster reduce every channel c of the tile
// finds gate[c] and up[c] in one block.  The rest of the kind is K1's: the
// norm folded in, the quantizer warps' codes in the ring slot, the TMA ring,
// the cluster K-split.  The epilogue (sw_epilogue) replaces the cooperative
// body's phases 3-4: gate and up summed over the ranks in rank order (the
// order sg_reduce_store takes), SiLU(gate)·up in f32, then each of down's
// input groups in the tile quantized (channels at or past down's
// non-salient width masked), its codes and scale written row-major (the
// layout K5's stream kind reads) and the salient channels written in bf16 —
// the f32 SwiGLU never goes to device memory.  N <= 8 (one n8 tile).
struct SwArgs {
  int8_t* xq;               // down's codes (N, kk2), row-major
  float* xs;                // their group scales (N, G2)
  __nv_bfloat16* xsal;      // down's salient activations (N, xsal_rs), or null
  int inter, kk2, G2, k_ns2_raw, xsal_rs;
  int n_tiles, c_end;       // tiles of 64 channels; the last one covers up to c_end
};

// SiLU(g)·u of one channel, the cooperative body's expression (mlp_fused.cu
// swiglu_at)
__device__ __forceinline__ float sw_silu_mul(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))), u);
}

// The epilogue of tile `tile` (the 128 consumer threads, after the cluster
// barrier): this rank's share of the tile's items — (64-channel segment,
// group of down's input, row) with the rows padded to 8, groups whole, so
// no group is split over ranks; the last tile's segments past the first
// (channels inter .. c_end, read from no partial) are zero — each taken by
// GS/8 lanes of 8 channels.
template <int GS>
__device__ __forceinline__ void sw_epilogue(const float* part, const SrArgs& a, const SwArgs& w,
                                            int tile, int rank, int lg, int cs, int tid) {
  constexpr int SUB = GS / 8, GPS = 64 / GS;
  const int c_lo = 64 * tile;
  const int segs = tile == w.n_tiles - 1 ? (w.c_end - c_lo) >> 6 : 1;
  const int items = segs * GPS * 8;
  const int q0 = ((rank * items) >> lg) * SUB, q1 = (((rank + 1) * items) >> lg) * SUB;
  const uint32_t part_u = smem_u32(part);
  for (int b = q0; b < q1; b += 128) {   // rounds the whole block takes: every lane shuffles
    const int q = b + tid, it = q / SUB, sl = q % SUB;
    const int n = it & 7, cl = (it >> 3) * GS + 8 * sl, c = c_lo + cl;
    const bool live = q < q1 && n < a.N;
    float h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = 0.0f;
    if (live && cl < 64) {
      // gate lo, gate hi, up lo, up hi: rank 0, then each rank in order
      constexpr int at[4] = {0, 4, 64, 68};
      const int e0 = n * SG_PART_LD + cl;
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = cs > 1 ? sg_ld_rank(part_u + 4 * (e0 + at[k]), 0)
                      : *reinterpret_cast<const float4*>(part + e0 + at[k]);
      for (int r = 1; r < cs; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 u = sg_ld_rank(part_u + 4 * (e0 + at[k]), r);
          v[k].x += u.x, v[k].y += u.y, v[k].z += u.z, v[k].w += u.w;
        }
      const float g[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
      const float u[8] = {v[2].x, v[2].y, v[2].z, v[2].w, v[3].x, v[3].y, v[3].z, v[3].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = sw_silu_mul(g[e], u[e]);
    }
    float y[8], amax = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[e] = c + e < w.k_ns2_raw ? h[e] : 0.0f;
      amax = fmaxf(amax, fabsf(y[e]));
    }
#pragma unroll
    for (int o = SUB / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fmul_rn(fmaxf(amax, 1e-5f), a.inv_qmax);
    const float inv = __frcp_rn(scale);
    uint32_t qc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) qc[e] = sr_code(y[e], scale, inv);
    if (!live) continue;
    if (c < w.kk2) {
      *reinterpret_cast<uint2*>(w.xq + (size_t)n * w.kk2 + c) = sr_pack8(qc);
      if (sl == 0) w.xs[(size_t)n * w.G2 + c / GS] = scale;
    }
    if (w.xsal != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int jj = c + e - w.k_ns2_raw;
        if (jj >= 0 && jj < w.xsal_rs)
          w.xsal[(size_t)n * w.xsal_rs + jj] = __float2bfloat16_rn(c + e < w.inter ? h[e] : 0.0f);
      }
    }
  }
}

// Block (tile, rank) as stream_rawx_kernel's, with sr_produce's halves at
// gate column 64·tile and up column inter + 64·tile, and sw_epilogue in
// place of the store.  Each thread signals the dependent launch (K14's down
// launch) once its part of the stream is done: the producer warp once it
// has issued its last stage, the quantizers and consumers after their loops.
template <int GS, typename S>
__global__ void __launch_bounds__(SG_THREADS, 2)
stream_swiglu_kernel(const SrArgs a, const SwArgs w, const __grid_constant__ SrMaps m) {
  using Geo = SrGeo<GS, 1>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.n_split, lg = __ffs(cs) - 1;
  int rank, o0;
  sg_place(lg, rank, o0);
  const int tile = o0 / SG_BO;
  const int T = a.n_sal + a.n_grp;
  const int t0 = (rank * T) >> lg, t1 = ((rank + 1) * T) >> lg;
  if (tid == 0) sr_init_bars<Geo::STAGES>(smem + Geo::OFF_BAR);
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  if (warp >= 4) {
    regs_dec<SR_PRODUCER_REGS>();
    if (warp > 4) sr_quantizer<GS, 1>(a, smem, t0, t1, tid - 160);
    else if (lane == 0)
      sr_produce<GS, 1, S, true>(a, m, smem, t0, t1, 64 * tile, w.inter + 64 * tile);
    __syncwarp();
    griddep_launch_dependents();
    sg_producer_tail(cs);
    return;
  }
  regs_inc<SR_CONSUMER_REGS>();
  sr_prepass<GS, 1>(a, smem, t0, t1, tid);
  const SgLane l = sg_lane_halves<GS>(tid);
  float acc[2][1][4];
  sr_consume<GS, 1, S, 64>(acc, a, smem, t0, t1, l);
  griddep_launch_dependents();
  named_sync<SG_THREADS>(SG_BAR_DRAINED);
  sg_store_partial<1>(part, acc, l);
  if (cs > 1) sg_cluster_sync();
  else __syncthreads();
  sw_epilogue<GS>(part, a, w, tile, rank, lg, cs, tid);
  if (cs > 1) sg_cluster_sync();
}

// ---------------------------------------------------------------- int8 (O, K) weights (K15a)
// The body's fifth weight kind: K15a's static-scale linear at 1-64 token
// rows (int8.cu's decode rows), the int8 weight in its (O, K) storage.  A
// stage is one TMA box of 128 weight rows (the tile's output columns) × 128
// bytes of K and the x tile of those k (N_BOX rows, zero past N and K), both
// SWIZZLE_128B.  The (O, K) rows are already the row-major A operand of
// mma.sync m16n8k32 s8, so each A fragment is one ldmatrix.x4 of the rows as
// TMA wrote them — none of the (K, O) kinds' byte transpose — and the tokens
// are the n side by ldmatrix from the x tile.  No scaling in the loop: the
// int32 sums run through a rank's stages, the ranks' int32 partials are
// added in rank order through distributed shared memory (exact), then the
// K15a epilogue: f32(acc) rounded once (s32_f32_rn), fma(·, α, bias), ReLU,
// f32 out or int8 as round-half-even clipped to ±127.
constexpr int SK_STAGES = 4;                    // ring slots

template <int NT>
struct SkGeo {
  static constexpr int N_BOX = 8 * NT;
  static constexpr int W_BYTES = SG_BO * 128;    // 128 weight rows × 128 bytes of K
  static constexpr int X_BYTES = N_BOX * 128;
  static constexpr int SLOT = sg_align(W_BYTES + X_BYTES, 1024);
  static constexpr int OFF_BAR = SK_STAGES * SLOT;
  static constexpr int SMEM = OFF_BAR + 2 * 8 * SK_STAGES;
  static_assert(N_BOX * SG_PART_LD * 4 <= OFF_BAR, "the partial tile reuses the ring");
};

struct SkArgs {
  const float* bias;    // (O,) or null
  void* out;            // (N, O) f32 or int8
  float alpha;
  int N, O, n_stages, n_split, relu;
};
struct SkMaps {         // the weight (O, K), x (N, K)
  CUtensorMap w, x;
};

// This rank's share of the tile's quads (row n, columns 4q ..): the ranks'
// int32 partials added in rank order, then the K15a epilogue, stored as one
// 16- or 4-byte word where O % 4 == 0.
template <typename TO>
__device__ __forceinline__ void sk_reduce_store(const int* part, const SkArgs& a, int o0, int rank,
                                                int lg, int cs, int tid) {
  const int quads = a.N * (SG_BO / 4);
  const int q_end = ((rank + 1) * quads) >> lg;
  const uint32_t part_u = smem_u32(part);
  for (int q = ((rank * quads) >> lg) + tid; q < q_end; q += 128) {
    const int n = q / (SG_BO / 4), c = 4 * (q % (SG_BO / 4)), o = o0 + c;
    if (o >= a.O) continue;
    int s[4];
    if (cs > 1) {
      for (int r = 0; r < cs; ++r) {
        const float4 u = sg_ld_rank(part_u + 4 * (n * SG_PART_LD + c), r);
        const int v[4] = {__float_as_int(u.x), __float_as_int(u.y), __float_as_int(u.z),
                          __float_as_int(u.w)};
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = r ? s[j] + v[j] : v[j];
      }
    } else {
      const int4 v = *reinterpret_cast<const int4*>(part + n * SG_PART_LD + c);
      s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
    }
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f = s32_f32_rn(s[j]);
      y[j] = a.bias ? __fmaf_rn(f, a.alpha, o + j < a.O ? a.bias[o + j] : 0.0f)
                    : __fmul_rn(f, a.alpha);
      if (a.relu) y[j] = fmaxf(y[j], 0.0f);
    }
    TO* p = static_cast<TO*>(a.out) + (size_t)n * a.O + o;
    if constexpr (sizeof(TO) == 1) {
      uint32_t w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w |= ((uint32_t)(int)fminf(fmaxf(rintf(y[j]), -127.0f), 127.0f) & 0xFFu) << (8 * j);
      if ((a.O & 3) == 0) {
        *reinterpret_cast<uint32_t*>(p) = w;
      } else {
        for (int j = 0; j < 4 && o + j < a.O; ++j) p[j] = (int8_t)(w >> (8 * j));
      }
    } else {
      if ((a.O & 3) == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int j = 0; j < 4 && o + j < a.O; ++j) p[j] = y[j];
      }
    }
  }
}

// Block (tile, rank) as stream_gmm_kernel's.  Consumer warp w takes the
// tile's columns 32w .. 32w + 31 (two m16 tiles); lane L gives ldmatrix.x4
// the weight row of matrix L / 8 (rows 8·(L / 8 % 2) + L % 8 of the m tile,
// the k step's 16-byte half L / 16), so its registers are the m16n8k32 A
// fragment as they come.
template <int NT, typename TO>
__global__ void __launch_bounds__(SG_THREADS, 2)
stream_s8_kernel(const SkArgs a, const __grid_constant__ SkMaps m) {
  using Geo = SkGeo<NT>;
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = a.n_split, lg = __ffs(cs) - 1;
  int rank, o0;
  sg_place(lg, rank, o0);
  const int T = a.n_stages;
  const int t0 = (rank * T) >> lg, t1 = ((rank + 1) * T) >> lg;
  if (tid == 0) {
    for (int s = 0; s < SK_STAGES; ++s) {
      mbar_init(smem_u32(smem + Geo::OFF_BAR + 8 * s), 1);
      mbar_init(smem_u32(smem + Geo::OFF_BAR + 8 * (SK_STAGES + s)), 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  int* part = reinterpret_cast<int*>(smem);   // (N_BOX, SG_PART_LD) int32, after the ring
  if (warp >= 4) {
    regs_dec<SG_PRODUCER_REGS>();
    if (warp == 4 && lane == 0) {
      tma_prefetch(m.w);
      tma_prefetch(m.x);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, slot = i % SK_STAGES;
        const uint32_t su = smem_u32(smem + slot * Geo::SLOT);
        const uint32_t full = smem_u32(smem + Geo::OFF_BAR + 8 * slot);
        if (i >= SK_STAGES)
          mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * (SK_STAGES + slot)), (i / SK_STAGES - 1) & 1);
        mbar_expect_tx(full, Geo::W_BYTES + Geo::X_BYTES);
        tma_2d(su, m.w, full, t * 128, o0);
        tma_2d(su + Geo::W_BYTES, m.x, full, t * 128, 0);
      }
    }
    sg_producer_tail(cs);
    return;
  }
  regs_inc<SG_CONSUMER_REGS>();
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, ri = lane & 7;
  uint32_t a_row[2], a_chunk[4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_row[mt] = (uint32_t)((32 * warp + 16 * mt + 8 * (mi & 1) + ri) * 128);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) a_chunk[ks] = (uint32_t)(((2 * ks + (mi >> 1)) ^ ri) << 4);
  const SgXOff<128, 32> xo = sg_xoff<128, 32>(lane);
  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, slot = i % SK_STAGES;
    const uint32_t su = smem_u32(smem + slot * Geo::SLOT);
    mbar_wait(smem_u32(smem + Geo::OFF_BAR + 8 * slot), (i / SK_STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      int a0[4], a1[4], b[NT][2];
      ldsm_x4(a0, su + a_row[0] + a_chunk[ks]);
      ldsm_x4(a1, su + a_row[1] + a_chunk[ks]);
      sg_load_b<128, 32, NT>(b, su + Geo::W_BYTES, xo, ks);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sg_mma32(acc[0][nt], a0, b[nt][0], b[nt][1], acc[0][nt]);
        sg_mma32(acc[1][nt], a1, b[nt][0], b[nt][1], acc[1][nt]);
      }
    }
    __syncwarp();
    if (lane == 0) sg_arrive(smem_u32(smem + Geo::OFF_BAR + 8 * (SK_STAGES + slot)));
  }
  named_sync<SG_THREADS>(SG_BAR_DRAINED);
  // D row gid + 8h of m tile mt is column 32w + 16mt + 8h + gid, its column
  // 2·tig + j of n tile nt the token 8nt + 2·tig + j
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(8 * nt + 2 * tig + (e & 1)) * SG_PART_LD + 32 * warp + 16 * mt + 8 * (e >> 1) + gid] =
            acc[mt][nt][e];
  if (cs > 1) sg_cluster_sync();
  else __syncthreads();
  sk_reduce_store<TO>(part, a, o0, rank, lg, cs, tid);
  if (cs > 1) sg_cluster_sync();
}

// ---------------------------------------------------------------- host side

// The weight's map: (rows, O) bytes, boxes of 128 columns × box_rows rows,
// 128-byte swizzle (the rows sg_quad reads).  L2 fills of SG_W_PROMO.
constexpr CUtensorMapL2promotion SG_W_PROMO = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
inline bool sg_weight_map(CUtensorMap* m, const void* w, int O, int rows, int box_rows) {
  return wg_map(m, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, rows, O, SG_BO, box_rows,
                CU_TENSOR_MAP_SWIZZLE_128B, SG_W_PROMO);
}

// The tensor maps the stages read besides the weight's and x's, and the
// launch: a cluster of n_split blocks along x per 128-column tile.
inline bool sg_common_maps(SgMaps& m, const void* ws, const void* xsal, const void* wsal,
                           int s_bf16, int N, int O, int G, int k_s, int xsal_rs, int n_box,
                           int ksal, int ws_rows) {
  const CUtensorMapDataType sdt =
      s_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  bool ok = wg_map(&m.ws, ws, sdt, s_bf16 ? 2 : 4, O, G, O, SG_BO, ws_rows,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && k_s > 0)
    ok = wg_map(&m.xsal, xsal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k_s, N, xsal_rs, ksal, n_box,
                ksal == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) &&
         wg_map(&m.wsal, wsal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, k_s, O, 64, ksal,
                CU_TENSOR_MAP_SWIZZLE_128B, SG_W_PROMO);
  return ok;
}

// A stream kernel's launch: a cluster of n_split blocks along x per
// 128-column tile of O, `smem` bytes of dynamic shared memory; with pdl,
// as a programmatic dependent of the stream's previous kernel (it may start
// once every block of that kernel has run griddepcontrol.launch_dependents,
// and reads that kernel's output only after griddepcontrol.wait).
template <typename... P, typename... A>
int sg_launch_tiles(void (*kernel)(P...), int O, int n_split, int smem, cudaStream_t st, int pdl,
                    const A&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + SG_BO - 1) / SG_BO * n_split);
  cfg.blockDim = dim3(SG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool NIB, int GS, int NT, typename S>
int sg_launch(const SgArgs& a, const SgMaps& m, cudaStream_t st) {
  using Geo = SgGeo<NIB, GS, NT>;
  static const cudaError_t ready =
      wg_kernel_ready(stream_gmm_kernel<NIB, GS, NT, S>, Geo::SMEM, 65536 / (2 * SG_THREADS));
  if (ready != cudaSuccess) return (int)ready;
  return sg_launch_tiles(stream_gmm_kernel<NIB, GS, NT, S>, a.O, a.n_split, Geo::SMEM, st, a.pdl,
                         a, m);
}

// token tiles of the padded width 8·NT for N rows (N <= 64): 1, 2, 4 or 8
inline int sg_tiles_for(int N) { return N <= 8 ? 1 : N <= 16 ? 2 : N <= 32 ? 4 : 8; }

template <bool NIB, int GS, typename S>
int sg_dispatch_nt(const SgArgs& a, const SgMaps& m, cudaStream_t st) {
  switch (sg_tiles_for(a.N)) {
    case 1: return sg_launch<NIB, GS, 1, S>(a, m, st);
    case 2: return sg_launch<NIB, GS, 2, S>(a, m, st);
    case 4: return sg_launch<NIB, GS, 4, S>(a, m, st);
    default: return sg_launch<NIB, GS, 8, S>(a, m, st);
  }
}

// the scale dtype's instantiation
template <bool NIB, int GS>
int sg_dispatch(const SgArgs& a, const SgMaps& m, cudaStream_t st) {
  return a.s_bf16 ? sg_dispatch_nt<NIB, GS, __nv_bfloat16>(a, m, st)
                  : sg_dispatch_nt<NIB, GS, float>(a, m, st);
}

// The arguments the stream body's entry points check in common: 1-64 rows,
// O a multiple of 16 (TMA's 16-byte weight rows), a split of 1, 2, 4 or 8
// that leaves each rank a stage, bf16 salient rows of whole 16 bytes.
inline bool sg_args_ok(int N, int O, int k_s, int xsal_rs, int n_split, int stages, int t_bf16) {
  if (N < 1 || N > 64 || O < 16 || O % 16) return false;
  if (n_split != 1 && n_split != 2 && n_split != 4 && n_split != 8) return false;
  if (stages < n_split || k_s < 0 || xsal_rs < k_s) return false;
  return !(t_bf16 && k_s > 0 && xsal_rs % 8);
}

// K13's launch at stages of KB rows: x (N, K) and the layer's (K, O) slab in
// bf16 (TMA's rules: 16-byte aligned, K and O multiples of 8), out (N, O)
// bf16, N <= 8.  (A template, so only the source that launches it compiles
// the kernel.)
template <int KB>
int sb_launch(const void* x, const void* w, void* out, int N, int K, int O, int n_split,
              cudaStream_t st) {
  using Geo = SbGeo<KB>;
  static const cudaError_t ready =
      wg_kernel_ready(stream_bf16_kernel<KB>, Geo::SMEM, 65536 / (2 * SG_THREADS));
  if (ready != cudaSuccess) return (int)ready;
  SbMaps m = {};
  if (!wg_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, K, O, 64, KB,
              CU_TENSOR_MAP_SWIZZLE_128B, SG_W_PROMO) ||
      !wg_map(&m.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, K, KB, 8,
              KB == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const SbArgs a{out, N, O, (K + KB - 1) / KB, n_split};
  return sg_launch_tiles(stream_bf16_kernel<KB>, O, n_split, Geo::SMEM, st, 0, a, m);
}

// K1's launch at group size GS: the token tiles of N, the dynamic shared
// memory of the ring and of the most salient stages a rank takes (refused
// above a block's 227 KB).
template <int GS, int NT, typename S>
int sr_launch(const SrArgs& a, const SrMaps& m, cudaStream_t st) {
  using Geo = SrGeo<GS, NT>;
  static const cudaError_t ready =
      wg_kernel_ready(stream_rawx_kernel<GS, NT, S>, SR_SMEM_MAX, 65536 / (2 * SG_THREADS));
  if (ready != cudaSuccess) return (int)ready;
  const int T = a.n_sal + a.n_grp, per_rank = (T + a.n_split - 1) / a.n_split;
  const int smem = Geo::smem(a.n_sal < per_rank ? a.n_sal : per_rank);
  if (smem > SR_SMEM_MAX) return (int)cudaErrorInvalidValue;
  return sg_launch_tiles(stream_rawx_kernel<GS, NT, S>, a.O, a.n_split, smem, st, 0, a, m);
}

template <int GS, typename S>
int sr_dispatch_nt(const SrArgs& a, const SrMaps& m, cudaStream_t st) {
  switch (sg_tiles_for(a.N)) {
    case 1: return sr_launch<GS, 1, S>(a, m, st);
    case 2: return sr_launch<GS, 2, S>(a, m, st);
    default: return sr_launch<GS, 4, S>(a, m, st);
  }
}

template <typename S>
int sr_dispatch(const SrArgs& a, const SrMaps& m, int gs, cudaStream_t st) {
  return gs == 16 ? sr_dispatch_nt<16, S>(a, m, st)
         : gs == 32 ? sr_dispatch_nt<32, S>(a, m, st)
                    : sr_dispatch_nt<64, S>(a, m, st);
}

// K14's gate_up launch at group size GS (stream_swiglu_kernel; N <= 8):
// a.O is 128 per tile, the ring's and the salient tiles' shared memory as
// K1's.
template <int GS, typename S>
int sw_launch(const SrArgs& a, const SwArgs& w, const SrMaps& m, cudaStream_t st) {
  using Geo = SrGeo<GS, 1>;
  static const cudaError_t ready =
      wg_kernel_ready(stream_swiglu_kernel<GS, S>, SR_SMEM_MAX, 65536 / (2 * SG_THREADS));
  if (ready != cudaSuccess) return (int)ready;
  const int T = a.n_sal + a.n_grp, per_rank = (T + a.n_split - 1) / a.n_split;
  const int smem = Geo::smem(a.n_sal < per_rank ? a.n_sal : per_rank);
  if (smem > SR_SMEM_MAX) return (int)cudaErrorInvalidValue;
  return sg_launch_tiles(stream_swiglu_kernel<GS, S>, a.O, a.n_split, smem, st, 0, a, w, m);
}

template <typename S>
int sw_dispatch(const SrArgs& a, const SwArgs& w, const SrMaps& m, int gs, cudaStream_t st) {
  return gs == 16 ? sw_launch<16, S>(a, w, m, st)
         : gs == 32 ? sw_launch<32, S>(a, w, m, st)
                    : sw_launch<64, S>(a, w, m, st);
}

// K15a's stream launch: x (N, K) and w (O, K) int8 (K a multiple of 16,
// 16-byte aligned), N <= 64 rows in NT n8 tiles, the K range's 128-byte
// stages split over n_split ranks.
template <int NT, typename TO>
int sk_launch(const void* x, const void* w, const SkArgs& a, int K, cudaStream_t st) {
  using Geo = SkGeo<NT>;
  static const cudaError_t ready =
      wg_kernel_ready(stream_s8_kernel<NT, TO>, Geo::SMEM, 65536 / (2 * SG_THREADS));
  if (ready != cudaSuccess) return (int)ready;
  SkMaps m = {};
  if (!wg_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, a.O, K, 128, SG_BO,
              CU_TENSOR_MAP_SWIZZLE_128B, SG_W_PROMO) ||
      !wg_map(&m.x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, a.N, K, 128, Geo::N_BOX,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  return sg_launch_tiles(stream_s8_kernel<NT, TO>, a.O, a.n_split, Geo::SMEM, st, 0, a, m);
}

template <typename TO>
int sk_dispatch(const void* x, const void* w, const SkArgs& a, int K, cudaStream_t st) {
  switch (sg_tiles_for(a.N)) {
    case 1: return sk_launch<1, TO>(x, w, a, K, st);
    case 2: return sk_launch<2, TO>(x, w, a, K, st);
    case 4: return sk_launch<4, TO>(x, w, a, K, st);
    default: return sk_launch<8, TO>(x, w, a, K, st);
  }
}

}  // namespace
