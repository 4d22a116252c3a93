// Split-S single-query decode attention, the body of three kernels for bf16
// queries at head_dim 64 and 128, each the TPU kernel's function to the f32
// summation order.  The MODE template says where the rows and the mask come
// from and what follows the reduce:
//   SD_HM_BIAS     K11 (decode_attention.cu; smoothquant_tpu/kernels/
//                  decode_attention.py:218, pallas_call :306): a head-major
//                  cache (B, H_kv, S, D), bf16 or int8, and a (B, S) bias;
//   SD_SM_BIAS     K3 (attn_smajor.cu; attn_smajor.py:169, pallas_call :213):
//                  the S-major int8 cache (B, S, H_kv·D) — one (slot, kv
//                  head)'s rows D bytes every H_kv·D — whose stages come as
//                  2-D TMA boxes of SD_ROWS positions × D bytes (a tensor map
//                  a layer, encoded per call on the host), and a (B, S) bias;
//   SD_VIRT[_FLAT|_WRITE]  K12 (attn_fused.cu; attn_fused.py:293, pallas_call
//                  :345 / :491): a head-major int8 cache, columns < pos from
//                  one device scalar (no bias is staged: each rank knows its
//                  row range from pos), then the new position folded in last
//                  as one more online-softmax step (attn_fused.py:114-152);
//                  _FLAT rotates the pre-rotary q in the kernel, _WRITE also
//                  writes the new row and its scales at min(pos, S − 1).
//
// What bounds it on the H100: the bytes of the k / v rows the bias leaves
// unmasked.  The flash body (flash_decode.cuh) missed that bound by 10-15×:
// one block a (slot, kv head) — 128 blocks for 132 SMs at B = 4 — a global
// load of the bias (and k_scale) before each row load, 4-8-byte loads a lane
// with a 5-shuffle warp sum a position, K streamed, then a block-wide
// softmax with memory idle, then V, and an I2F for every int8 byte.  This
// body:
//
//   * Splits S over a thread-block cluster.  Cluster (1 << lsplit) CTAs
//     serve one (slot, kv head); rank j takes the contiguous chunk
//     [j·chunk, (j + 1)·chunk) of the positions (decode_attention.
//     split_ranks plans it from B·H_kv and S).  A CTA whose chunk the bias
//     masks entirely reads no K or V row.
//   * Stages before the rows.  One bulk copy (cp.async.bulk, on an
//     mbarrier) brings the chunk's bias, and for int8 its k_scale and
//     v_scale, into shared memory; the CTA then bounds its row range by the
//     first and last unmasked position (lo, hi), and one thread streams the
//     K rows, then the V rows, of [lo, hi] through a ring of SD_SLOTS stages
//     of SD_ROWS positions (one bulk copy a stage: rows are contiguous in
//     the head-major cache).  No row load waits on another global load, and
//     V's first stages are in flight while the scores are reduced.  Sizing
//     (Little's law: ~25-30 KB in flight an SM at 3.35 TB/s and ~1 µs):
//     a stage is 4 KB (int8, D = 128) or 8 KB (bf16), two slots a CTA, and
//     at the paths' shapes 4-11 CTAs an SM are resident (B = 4: 128 heads ×
//     4 ranks; B = 64: 2048 heads × 1 rank): 32-90 KB issued an SM.  A
//     deeper ring (4 or 8 slots) or 64-position stages measured slower: the
//     shared memory they take costs resident CTAs (PERF.md §6).
//   * Loads 16 bytes a lane.  LPR = D·sizeof(cache) / 16 lanes hold a row
//     (8 for int8 at D = 128, 16 for bf16), so a position's dot costs
//     log2(LPR) = 3-4 shuffles, shared by the 32 / LPR rows a warp holds.
//     The register arrays are sized by the REP template (1, 2, 4, 8 query
//     rows a kv head), not by the flash body's largest rep.  K11, K3 and
//     K12 take any rep (Falcon-7B: 71 query heads over one kv head; a
//     Llama of 32 query heads over 2 kv heads: 16): the rep query rows
//     of a kv head split into groups of up to SD_MAX_REP (grid z), each
//     group a cluster of its own that reads the same k / v rows — a
//     (slot, kv head)'s rows are read ⌈rep / 8⌉ times, from the L2 after
//     the first (one layer's cache is at most a few MB at the paths'
//     shapes), and the registers and shared memory stay those of rep 8.
//   * Converts int8 with no I2F: the bytes with their sign bits flipped are
//     permuted into 0x4B0000xx (2^23 + b + 128) and one FADD takes 2^23 + 128
//     off — exact, as the TPU kernel's int8 → bf16 cast is.  The ALiBi
//     position takes the same route (2^23 + s).
//   * Keeps the TPU kernel's online softmax over tiles of ts positions.  Its
//     p is exp(score − m_safe) with m_safe the running max up to and
//     including the tile (guarded at NEG_INF / 2), rounded to bf16 (after
//     the v_scale product) before PV.  A CTA forms p against that same
//     m_safe: each rank stores the maxima of its positions in each tile it
//     touches into every rank's shared memory, and after one cluster
//     barrier every rank scans the tiles' maxima for their prefix
//     (m_safe_t, α_t = exp(m_{t−1} − m_safe_t)) and the factor F_t = Π_{u>t}
//     α_u that the TPU kernel's rescales apply to tile t by the end.  l and
//     the p·v partials (each p weighted by its tile's F_t) are summed in the
//     CTA in a fixed order and across the cluster in rank order through
//     distributed shared memory: no atomics, the same bits on every call.
//     Every exchange is a store into the reading rank's shared memory
//     (st.shared::cluster) before a cluster barrier, so no rank waits on a
//     remote load and none waits for another to finish reading it.  A
//     fully masked row gives 0 (l = 0 → denominator 1).  A position whose
//     bias is at or below FLASH_SKIP_AT keeps the bias as its score, as in
//     the flash body, and adds no p·v.
// K12's virtual row: warps 1 and 2 of every rank quantize the new k (rotated)
// and v with kv_quant.cuh's warp_quantize_kv, K10's rotary and quantize, while
// the rows stream, so the row is bit-identical to the one K10 writes; after
// the reduce every rank folds it into its slice of the outputs — m' = max(m,
// s_v), α = exp(m − m_safe'), p_v = exp(s_v − m_safe'), l' = l·α + p_v, acc' =
// acc·α + bf16(p_v·v_scale)·v — with m the TPU kernel's running max after the
// last tile, which every rank scans anyway.  Folding on every rank costs two
// warps a D-vector each and keeps the rank-sliced output stores; one rank
// folding would first gather every slice.  The write body's row belongs to
// one rank's chunk: that rank of group 0 writes it after its last read of
// the cache (no other CTA of the group reads the rows of its chunk, and
// every group folds the row in from its own registers; at a clamped
// position, pos >= S, another group may read row S − 1 after it is written).
// Above SD_MAX_REP query rows a kv head, K3 and K12 run groups as K11 does.
// No runtime integer division anywhere (it compiles to I2F): the split and
// the tile width are powers of two, taken by shifts.
#pragma once

#include "flash_decode.cuh"   // FLASH_NEG_INF, FLASH_SKIP_AT, warp_max / warp_sum
#include "cluster.cuh"       // cluster barrier, remote loads, bulk copies
#include "kv_quant.cuh"      // warp_quantize_kv (K12's virtual row)
#include "wg_gemm.cuh"       // mbarrier helpers, TMA boxes, tensor maps, smem_u32, bf16_pair

namespace {

constexpr int SD_WARPS = 4;
constexpr int SD_THREADS = 32 * SD_WARPS;
constexpr int SD_ROWS = 32;          // positions a ring stage holds
constexpr int SD_LOG_ROWS = 5;
constexpr int SD_SLOTS = 2;          // ring depth (a power of two; 4 measured slower)
constexpr int SD_LOG_SLOTS = 1;
constexpr int SD_MAX_TILES = 64;     // softmax tiles of S (as the flash body)
constexpr int SD_MAX_SPLIT = 8;      // cluster ranks
constexpr int SD_MAX_REP = 8;        // query rows a kv head
constexpr int SD_MAX_CHUNK = 2048;   // positions a rank takes at most
constexpr int SD_SMEM_MAX = 227 * 1024;

// the kernels of the body (see the note above)
constexpr int SD_HM_BIAS = 0, SD_SM_BIAS = 1, SD_VIRT = 2, SD_VIRT_FLAT = 3, SD_VIRT_WRITE = 4;

template <int MODE>
struct SdMode {
  static constexpr bool smajor = MODE == SD_SM_BIAS;   // rows by 2-D TMA boxes
  static constexpr bool bias = MODE <= SD_SM_BIAS;     // a staged (B, S) bias, else columns < pos
  static constexpr bool virt = MODE >= SD_VIRT;        // the new position folded in last
  static constexpr bool flat = MODE == SD_VIRT_FLAT;   // q rotated in the kernel
  static constexpr bool write = MODE == SD_VIRT_WRITE; // the new row written
};

struct SdArgs {
  const __nv_bfloat16* q;   // (B, H, D) (the flat body's (B, 1, H·D) is the same memory)
  const void* k;            // this layer's rows: (B, H_kv, S, D) head-major, (B, S, H_kv·D) S-major
  const void* v;
  const float* ks;          // (B, H_kv, S) int8 cache scales, or null
  const float* vs;
  const float* bias;        // (B, S) (SD_HM_BIAS, SD_SM_BIAS)
  const float* slopes;      // (H,) ALiBi slopes (H == H_kv), or null
  const int* pos;           // K12: the aligned position
  const __nv_bfloat16* k_new;   // K12: (B, H_kv, D) the new k (pre-rotary) and v
  const __nv_bfloat16* v_new;
  const float* cos;         // K12: f32 rotary tables, rows tab_stride apart (0: one row
  const float* sin;         // for every slot), or null with rotary off
  __nv_bfloat16* out;       // (B, H, D)
  int H, Hkv, S, rep, tab_stride;  // rep: query rows a kv head (all groups)
  int chunk, lsplit, lts, n_tiles;   // positions a rank, log2 ranks, log2 tile width, tiles
  float sm_scale;
};

// SD_SM_BIAS: k and v of the layer as (B·S, H_kv·D) byte matrices, boxes of
// D bytes × SD_ROWS positions (unused by the other modes)
struct SdMaps {
  CUtensorMap k, v;
};

// Shared-memory carve-up of one CTA (byte offsets; every region 16-byte
// aligned since the chunk is a multiple of 16 positions)
struct SdLayout {
  int ring, bias, ks, vs, sc, tall, tm, tf, red, lred, pin, lin, virt, ints, total;
};

// K12's region: the new k and v codes (D bytes each), their scales (16
// bytes), then per query row s_v, the running max m, α, bf16(p_v·v_scale)
// and the denominator (SD_MAX_REP floats each)
constexpr int SD_VROW = 5 * SD_MAX_REP;

template <int D, int ES, int REP, bool QUANT, int MODE>
__host__ __device__ inline SdLayout sd_layout(int n) {
  using M = SdMode<MODE>;
  SdLayout L;
  int o = 128;                                   // mbarriers: the staging one, then SD_SLOTS
  L.ring = o;  o += SD_SLOTS * SD_ROWS * D * ES;
  L.bias = o;  o += M::bias ? n * 4 : 0;
  L.ks = o;    o += QUANT ? n * 4 : 0;
  L.vs = o;    o += QUANT ? n * 4 : 0;
  L.sc = o;    o += REP * n * 4;                 // scores, then the weights F_t · bf16(p)
  L.tall = o;  o += SD_MAX_SPLIT * REP * SD_MAX_TILES * 4;   // every rank's tile maxima
  L.tm = o;    o += REP * SD_MAX_TILES * 4;      // m_safe of each tile
  L.tf = o;    o += REP * SD_MAX_TILES * 4;      // F_t of each tile
  L.red = o;   o += SD_WARPS * REP * D * 4;      // the warps' p·v partials
  L.lred = o;  o += SD_WARPS * REP * 4;
  L.pin = o;   o += REP * D * 4;                 // every rank's p·v partial of this rank's slice
  L.lin = o;   o += SD_MAX_SPLIT * REP * 4;      // every rank's l
  L.virt = o;  o += M::virt ? 2 * D + 16 + SD_VROW * 4 : 0;
  L.ints = o;  o += 16;                          // lo, hi
  L.total = o;
  return L;
}

// f32 of a non-negative int below 2^23, exactly, with no I2F
__device__ __forceinline__ float sd_u2f(uint32_t s) {
  return __fsub_rn(__uint_as_float(0x4B000000u | s), 8388608.0f);
}

// the 4 int8 of w as f32, exactly, with no I2F: 2^23 + (b ^ 0x80) − (2^23 + 128)
__device__ __forceinline__ void sd_s8x4(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    f[c] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + c)), 8388736.0f);
}

// The 16 bytes at p as f32: 16 int8 or 8 bf16
template <typename TC>
__device__ __forceinline__ void sd_vals(const void* p, float (&f)[16 / sizeof(TC)]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(TC) == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sd_s8x4(ws[i], f + 4 * i);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(ws[i] << 16);
      f[2 * i + 1] = __uint_as_float(ws[i] & 0xFFFF0000u);
    }
  }
}

// TC: cache element (int8 with QUANT, else bf16); D head_dim; REP query rows
// a kv head the registers hold (a group's rows <= REP at run time); MODE the
// kernel (see above).  Grid (H_kv << lsplit, B, ⌈rep / SD_MAX_REP⌉), cluster
// (1 << lsplit, 1, 1), SD_THREADS threads; block z serves query rows
// [z·SD_MAX_REP, min(rep, (z + 1)·SD_MAX_REP)) of its kv head.
template <typename TC, int D, int REP, bool QUANT, int MODE>
__global__ void __launch_bounds__(SD_THREADS)
split_decode_kernel(const SdArgs a, const __grid_constant__ SdMaps maps) {
  using M = SdMode<MODE>;
  constexpr int ES = sizeof(TC);
  constexpr int ROWB = D * ES;            // bytes of a cache row
  constexpr int LPR = ROWB / 16;          // lanes a row
  constexpr int EPL = 16 / ES;            // elements a lane
  constexpr int RPW = 32 / LPR;           // rows a warp holds at once
  constexpr int RPP = SD_WARPS * RPW;     // rows a CTA holds at once
  constexpr int STAGE = SD_ROWS * ROWB;
  static_assert(SD_ROWS % RPP == 0, "a stage is whole passes");
  static_assert(!M::virt || (QUANT && ES == 1), "K12 reads an int8 cache");

  extern __shared__ __align__(128) unsigned char sd_smem[];
  const int n = a.chunk;
  const SdLayout L = sd_layout<D, ES, REP, QUANT, MODE>(n);
  unsigned char* ring = sd_smem + L.ring;
  float* bias_s = reinterpret_cast<float*>(sd_smem + L.bias);
  float* ks_s = reinterpret_cast<float*>(sd_smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(sd_smem + L.vs);
  float* sc = reinterpret_cast<float*>(sd_smem + L.sc);
  float* tall = reinterpret_cast<float*>(sd_smem + L.tall);
  float* tm = reinterpret_cast<float*>(sd_smem + L.tm);
  float* tf = reinterpret_cast<float*>(sd_smem + L.tf);
  float* red = reinterpret_cast<float*>(sd_smem + L.red);
  float* lred = reinterpret_cast<float*>(sd_smem + L.lred);
  float* pin = reinterpret_cast<float*>(sd_smem + L.pin);
  float* lin = reinterpret_cast<float*>(sd_smem + L.lin);
  int8_t* k8 = reinterpret_cast<int8_t*>(sd_smem + L.virt);      // K12's new row
  int8_t* v8 = k8 + D;
  float* kvsc = reinterpret_cast<float*>(sd_smem + L.virt + 2 * D);   // its k, v scales
  float* vrow = kvsc + 4;                                          // per row, SD_VROW floats
  int* ints = reinterpret_cast<int*>(sd_smem + L.ints);
  const uint32_t bar0 = smem_u32(sd_smem);        // the staging barrier; slot i's at + 8 (i + 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & (LPR - 1);               // the lane's 16 bytes of a row
  const int C = 1 << a.lsplit;
  const int rank = blockIdx.x & (C - 1), kvh = blockIdx.x >> a.lsplit, b = blockIdx.y;
  const int r0 = blockIdx.z * SD_MAX_REP;        // the group's first query row
  const int rep = min(a.rep - r0, SD_MAX_REP);    // its rows
  const size_t q_row0 = (size_t)b * a.H + (size_t)kvh * a.rep + r0;   // (B, H) row of row 0
  const size_t head = (size_t)b * a.Hkv + kvh;
  const int c0 = rank * n;                        // the chunk's first position
  const TC* kc = static_cast<const TC*>(a.k) + (head * a.S + c0) * D;   // head-major rows
  const TC* vc = static_cast<const TC*>(a.v) + (head * a.S + c0) * D;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= SD_SLOTS; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
    ints[0] = n;
    ints[1] = -1;
  }
  __syncthreads();
  cl_arrive_relaxed();   // waited for before the first store into another rank
  if (tid == 0) {
    if constexpr (M::smajor) {
      tma_prefetch(maps.k);
      tma_prefetch(maps.v);
    }
    mbar_expect_tx(bar0, n * 4 * ((M::bias ? 1 : 0) + (QUANT ? 2 : 0)));
    if constexpr (M::bias) cl_bulk_g2s(smem_u32(bias_s), a.bias + (size_t)b * a.S + c0, n * 4, bar0);
    if constexpr (QUANT) {
      cl_bulk_g2s(smem_u32(ks_s), a.ks + head * a.S + c0, n * 4, bar0);
      cl_bulk_g2s(smem_u32(vs_s), a.vs + head * a.S + c0, n * 4, bar0);
    }
  }

  // the lane's slice of the rep query rows; the flat body rotates q in f32,
  // fma(q, cos, rot(q)·sin) rounded to bf16, as K12's plain version
  float qv[REP][EPL];
  auto load_q = [&]() {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const __nv_bfloat16* qr = a.q + (q_row0 + r) * D;
#pragma unroll
      for (int h = 0; h < EPL / 8; ++h) {
        const int d0 = sub * EPL + 8 * h;
        float f[8];
        if (r < rep) {
          sd_vals<__nv_bfloat16>(qr + d0, f);
          if (M::flat && a.cos != nullptr) {
            float g[8];
            sd_vals<__nv_bfloat16>(qr + (d0 < D / 2 ? d0 + D / 2 : d0 - D / 2), g);
            const float* cr = a.cos + (size_t)b * a.tab_stride + d0;
            const float* sr = a.sin + (size_t)b * a.tab_stride + d0;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float partner = d0 < D / 2 ? -g[e] : g[e];
              f[e] = round_to<__nv_bfloat16>(__fmaf_rn(f[e], cr[e], __fmul_rn(partner, sr[e])));
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) qv[r][8 * h + e] = f[e];
      }
    }
  };
  const bool alibi = a.slopes != nullptr;
  const float slope = alibi ? a.slopes[kvh] : 0.0f;

  // the unmasked range [lo, hi] of the chunk: from the bias once it lands
  // (every score starts as the bias), or from the position at once
  int lo = 0, hi = -1, pos = 0;
  if constexpr (M::bias) {
    load_q();   // while the bias lands
    mbar_wait(bar0, 0);
    int l0 = n, h0 = -1;
    for (int i = tid; i < n; i += SD_THREADS) {
      const float bv = bias_s[i];
      if (bv > FLASH_SKIP_AT) {
        l0 = min(l0, i);
        h0 = max(h0, i);
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r * n + i] = bv;
    }
    l0 = __reduce_min_sync(0xffffffffu, l0);
    h0 = __reduce_max_sync(0xffffffffu, h0);
    if (lane == 0) {
      atomicMin(&ints[0], l0);
      atomicMax(&ints[1], h0);
    }
    __syncthreads();
    lo = ints[0];
    hi = ints[1];
  } else {
    pos = *a.pos;
    hi = max(min(pos - c0, n), 0) - 1;   // columns < pos
  }
  const int j0 = hi >= 0 ? lo >> SD_LOG_ROWS : 0;
  const int n_st = hi >= 0 ? (hi >> SD_LOG_ROWS) - j0 + 1 : 0;   // K stages (as many V)
  const int items = 2 * n_st;

  // ring item g: K stage j0 + g (g < n_st), then V stage j0 + g − n_st.  Head-
  // major rows are contiguous: one bulk copy of the stage's rows of [lo, hi];
  // S-major rows come as one TMA box of the stage's SD_ROWS positions
  auto issue = [&](int g) {
    const bool is_k = g < n_st;
    const int j = j0 + (is_k ? g : g - n_st);
    const int slot = g & (SD_SLOTS - 1);
    const uint32_t bar = bar0 + 8 * (slot + 1);
    if constexpr (M::smajor) {
      mbar_expect_tx(bar, STAGE);
      tma_2d(smem_u32(ring + slot * STAGE), is_k ? maps.k : maps.v, bar, kvh * ROWB,
             b * a.S + c0 + j * SD_ROWS);
    } else {
      const int r0 = max(j * SD_ROWS, lo), r1 = min((j + 1) * SD_ROWS, hi + 1);
      const TC* src = (is_k ? kc : vc) + (size_t)r0 * D;
      mbar_expect_tx(bar, (r1 - r0) * ROWB);
      cl_bulk_g2s(smem_u32(ring + slot * STAGE + (r0 - j * SD_ROWS) * ROWB), src,
                  (r1 - r0) * ROWB, bar);
    }
  };
  if (tid == 0)
    for (int g = 0; g < items && g < SD_SLOTS; ++g) issue(g);
  if constexpr (!M::bias) {
    load_q();
    // the new position: K10's rotary + quantize (warps 1 and 2)
    const size_t nv = head * D;
    const float* cr = a.cos != nullptr ? a.cos + (size_t)b * a.tab_stride : nullptr;
    const float* sr = a.cos != nullptr ? a.sin + (size_t)b * a.tab_stride : nullptr;
    if (warp == 1)
      warp_quantize_kv<__nv_bfloat16, true>(a.k_new + nv, D, cr != nullptr, cr, sr, k8, kvsc);
    else if (warp == 2)
      warp_quantize_kv<__nv_bfloat16, true>(a.v_new + nv, D, false, nullptr, nullptr, v8,
                                            kvsc + 1);
    for (int i = tid; i < n; i += SD_THREADS)
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r * n + i] = FLASH_NEG_INF;
    __syncthreads();
    mbar_wait(bar0, 0);   // the scales
  }
  auto release = [&](int g) {   // after every thread is done with item g's slot
    __syncthreads();
    if (tid == 0 && g + SD_SLOTS < items) {
      fence_async_smem();
      issue(g + SD_SLOTS);
    }
  };
  auto live = [&](int i) {
    return i >= lo && i <= hi && (!M::bias || bias_s[i] > FLASH_SKIP_AT);
  };
  const int row_in_pass = warp * RPW + (lane / LPR);

  // scores of the unmasked positions: (q·k)·sm_scale [·k_scale] [+ slope·s] [+ bias]
  for (int g = 0; g < n_st; ++g) {
    const int slot = g & (SD_SLOTS - 1);
    mbar_wait(bar0 + 8 * (slot + 1), (g >> SD_LOG_SLOTS) & 1);
    const unsigned char* st = ring + slot * STAGE;
    const int i_base = (j0 + g) * SD_ROWS;
#pragma unroll
    for (int p = 0; p < SD_ROWS / RPP; ++p) {
      const int ri = p * RPP + row_in_pass;
      const int i = i_base + ri;
      const bool on = live(i);
      float kv[EPL];
      if (on) {
        sd_vals<TC>(st + ri * ROWB + sub * 16, kv);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[e] = 0.0f;
      }
      float dot[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qv[r][e], kv[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        dot[r] = d;
      }
      if (on && sub == 0) {
        float extra = 0.0f;
        if (alibi) extra = __fmul_rn(slope, sd_u2f((uint32_t)(c0 + i)));
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          if (r >= rep) break;
          float x = __fmul_rn(dot[r], a.sm_scale);
          if (QUANT) x = __fmul_rn(x, ks_s[i]);
          if (alibi) x = __fadd_rn(x, extra);
          sc[r * n + i] = M::bias ? __fadd_rn(x, bias_s[i]) : x;
        }
      }
    }
    release(g);
  }

  // the maxima of this rank's positions in each tile it touches, stored
  // into every rank's shared memory
  cl_wait();
  const int t_a = c0 >> a.lts, t_b = (c0 + n - 1) >> a.lts;
  for (int t = t_a + warp; t <= t_b; t += SD_WARPS) {
    const int i0 = max((t << a.lts) - c0, 0), i1 = min(((t + 1) << a.lts) - c0, n);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
      float m = -INFINITY;
      for (int i = i0 + lane; i < i1; i += 32) m = fmaxf(m, sc[r * n + i]);
      m = warp_max(m);
      if (lane < C)
        cl_st_rank_f32(smem_u32(tall + (rank * REP + r) * SD_MAX_TILES + t), lane, m);
    }
  }
  sg_cluster_sync();   // every rank's tile maxima have landed

  // each tile's max over the ranks that hold its positions
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) break;
    for (int t = tid; t < a.n_tiles; t += SD_THREADS) {
      float m = -INFINITY;
      for (int q = 0; q < C; ++q)
        if (q * n < ((t + 1) << a.lts) && (q + 1) * n > (t << a.lts))
          m = fmaxf(m, tall[(q * REP + r) * SD_MAX_TILES + t]);
      tm[r * SD_MAX_TILES + t] = m;
    }
  }
  __syncthreads();
  // the TPU kernel's running max, m_safe and rescale α per tile, then F_t;
  // K12 keeps the running max after the last tile for its virtual step
  if (tid < rep) {
    float* mt = tm + tid * SD_MAX_TILES;
    float* ft = tf + tid * SD_MAX_TILES;
    float m_run = 0.0f;
    for (int t = 0; t < a.n_tiles; ++t) {
      const float m_new = t == 0 ? mt[t] : fmaxf(m_run, mt[t]);
      const float m_safe = fmaxf(m_new, FLASH_NEG_INF / 2);
      ft[t] = t == 0 ? 0.0f : expf(m_run - m_safe);   // α_t, for now
      mt[t] = m_safe;
      m_run = m_new;
    }
    float f = 1.0f;
    for (int t = a.n_tiles - 1; t >= 0; --t) {
      const float alpha = ft[t];
      ft[t] = f;
      f *= alpha;
    }
    if constexpr (M::virt) vrow[SD_MAX_REP + tid] = m_run;
  }
  // K12: s_v = (q·k_new)·sm_scale·k_scale_new of each query row (warp 0;
  // the new row landed before the scores)
  if constexpr (M::virt) {
    if (warp == 0) {
      float kn[EPL];
      sd_vals<TC>(k8 + sub * 16, kn);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= rep) break;
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qv[r][e], kn[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (lane == 0) vrow[r] = __fmul_rn(__fmul_rn(d, a.sm_scale), kvsc[0]);
      }
    }
  }
  __syncthreads();

  // p against its tile's m_safe; l += F_t·p; the weight F_t·bf16(p [·v_scale])
  float lsum[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    lsum[r] = 0.0f;
    if (r >= rep) continue;
    for (int i = tid; i < n; i += SD_THREADS) {
      const int t = (c0 + i) >> a.lts;
      const float p = expf(sc[r * n + i] - tm[r * SD_MAX_TILES + t]);
      const float f = tf[r * SD_MAX_TILES + t];
      lsum[r] = fmaf(f, p, lsum[r]);
      const float pv = QUANT ? __fmul_rn(p, vs_s[i]) : p;
      sc[r * n + i] = __fmul_rn(f, round_to<__nv_bfloat16>(pv));
    }
    lsum[r] = warp_sum(lsum[r]);
    if (lane == 0) lred[warp * REP + r] = lsum[r];
  }
  __syncthreads();

  // p·v over the unmasked positions
  float acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.0f;
  for (int g = n_st; g < items; ++g) {
    const int slot = g & (SD_SLOTS - 1);
    mbar_wait(bar0 + 8 * (slot + 1), (g >> SD_LOG_SLOTS) & 1);
    const unsigned char* st = ring + slot * STAGE;
    const int i_base = (j0 + g - n_st) * SD_ROWS;
#pragma unroll
    for (int p = 0; p < SD_ROWS / RPP; ++p) {
      const int ri = p * RPP + row_in_pass;
      const int i = i_base + ri;
      if (live(i)) {
        float vv[EPL];
        sd_vals<TC>(st + ri * ROWB + sub * 16, vv);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          if (r >= rep) break;
          const float w = sc[r * n + i];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(w, vv[e], acc[r][e]);
        }
      }
    }
    release(g);
  }

  // the warp's rows summed (lanes 0 .. LPR − 1 hold them), then the warps in order
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
#pragma unroll
      for (int e = 0; e < EPL; e += 4)
        *reinterpret_cast<float4*>(red + (warp * REP + r) * D + sub * EPL + e) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
    }
  }
  __syncthreads();
  // the CTA's partial, the warps in order, stored slice by slice into the
  // rank that writes the slice's outputs (rank j: elements [j·slice,
  // (j + 1)·slice) of the (rep, D) outputs); l into every rank
  const int slice = (rep * D) >> a.lsplit;
  for (int j = 0; j < C; ++j)
    for (int u = tid; u < slice / 4; u += SD_THREADS) {
      const int e = j * slice + 4 * u;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < SD_WARPS; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(red + w * REP * D + e);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      cl_st_rank_f32x4(smem_u32(pin + rank * slice + 4 * u), j, s);
    }
  if (tid < rep) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < SD_WARPS; ++w) s += lred[w * REP + tid];
    for (int q = 0; q < C; ++q) cl_st_rank_f32(smem_u32(lin + rank * REP + tid), q, s);
  }
  sg_cluster_sync();   // every rank's partials have landed; no remote access follows

  // K12: the virtual step of each query row, from l summed in rank order
  if constexpr (M::virt) {
    if (tid < rep) {
      float l = 0.0f;
      for (int q = 0; q < C; ++q) l += lin[q * REP + tid];
      const float s_v = vrow[tid], m = vrow[SD_MAX_REP + tid];
      const float m_safe = fmaxf(fmaxf(m, s_v), FLASH_NEG_INF / 2);
      const float alpha = expf(m - m_safe), p = expf(s_v - m_safe);
      const float l2 = __fadd_rn(__fmul_rn(l, alpha), p);
      vrow[2 * SD_MAX_REP + tid] = alpha;
      vrow[3 * SD_MAX_REP + tid] = round_to<__nv_bfloat16>(__fmul_rn(p, kvsc[1]));
      vrow[4 * SD_MAX_REP + tid] = l2 > 0.0f ? l2 : 1.0f;
    }
    __syncthreads();
  }

  // this rank's slice of the outputs: the ranks' partials in rank order over
  // their l in rank order (K12: with the new position folded in)
  for (int u = tid; u < slice / 4; u += SD_THREADS) {
    const int e = rank * slice + 4 * u, r = e / D, d = e % D;   // D a constant: shifts
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float l = 0.0f;
    for (int q = 0; q < C; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(pin + q * slice + 4 * u);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
      l += lin[q * REP + r];
    }
    float den = l > 0.0f ? l : 1.0f;
    if constexpr (M::virt) {
      const float alpha = vrow[2 * SD_MAX_REP + r], pw = vrow[3 * SD_MAX_REP + r];
      den = vrow[4 * SD_MAX_REP + r];
      float vn[4];
      sd_s8x4(*reinterpret_cast<const uint32_t*>(v8 + d), vn);
      s.x = __fadd_rn(__fmul_rn(s.x, alpha), __fmul_rn(pw, vn[0]));
      s.y = __fadd_rn(__fmul_rn(s.y, alpha), __fmul_rn(pw, vn[1]));
      s.z = __fadd_rn(__fmul_rn(s.z, alpha), __fmul_rn(pw, vn[2]));
      s.w = __fadd_rn(__fmul_rn(s.w, alpha), __fmul_rn(pw, vn[3]));
    }
    __nv_bfloat16* o = a.out + (q_row0 + r) * D + d;
    *reinterpret_cast<uint2*>(o) = make_uint2(bf16_pair(s.x / den, s.y / den),
                                              bf16_pair(s.z / den, s.w / den));
  }

  // K12's write body: the new row at min(pos, S − 1), by the rank of group 0
  // whose chunk holds it, after its last read of the cache
  if constexpr (M::write) {
    const int w = min(max(pos, 0), a.S - 1) - c0;
    if (blockIdx.z == 0 && w >= 0 && w < n) {   // group 0 only (every group folds it in)
      const size_t at = head * a.S + c0 + w;
      if (tid < D / 16) {
        reinterpret_cast<uint4*>(const_cast<void*>(a.k))[at * (D / 16) + tid] =
            reinterpret_cast<const uint4*>(k8)[tid];
        reinterpret_cast<uint4*>(const_cast<void*>(a.v))[at * (D / 16) + tid] =
            reinterpret_cast<const uint4*>(v8)[tid];
      }
      if (tid == 0) {
        const_cast<float*>(a.ks)[at] = kvsc[0];
        const_cast<float*>(a.vs)[at] = kvsc[1];
      }
    }
  }
}

template <typename TC, int D, int REP, bool QUANT, int MODE>
int sd_launch(const SdArgs& a, const SdMaps& maps, int B, cudaStream_t st) {
  auto kern = split_decode_kernel<TC, D, REP, QUANT, MODE>;
  static const cudaError_t ready =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SD_SMEM_MAX);
  if (ready != cudaSuccess) return (int)ready;
  const int smem = sd_layout<D, sizeof(TC), REP, QUANT, MODE>(a.chunk).total;
  if (smem > SD_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv << a.lsplit, B, (a.rep + SD_MAX_REP - 1) / SD_MAX_REP);
  cfg.blockDim = dim3(SD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << a.lsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, maps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the kernel for a's rep (the flat body is MHA: REP 1 only; above
// SD_MAX_REP rows, groups of SD_MAX_REP) and D
template <typename TC, bool QUANT, int MODE, int D>
int sd_by_rep(const SdArgs& a, const SdMaps& m, int B, cudaStream_t st) {
  if (a.rep <= 1) return sd_launch<TC, D, 1, QUANT, MODE>(a, m, B, st);
  if constexpr (MODE == SD_VIRT_FLAT) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (a.rep <= 2) return sd_launch<TC, D, 2, QUANT, MODE>(a, m, B, st);
    if (a.rep <= 4) return sd_launch<TC, D, 4, QUANT, MODE>(a, m, B, st);
    return sd_launch<TC, D, 8, QUANT, MODE>(a, m, B, st);
  }
}

template <typename TC, bool QUANT, int MODE>
int sd_by_dim(int D, const SdArgs& a, const SdMaps& m, int B, cudaStream_t st) {
  if (D == 64) return sd_by_rep<TC, QUANT, MODE, 64>(a, m, B, st);
  if (D == 128) return sd_by_rep<TC, QUANT, MODE, 128>(a, m, B, st);
  return (int)cudaErrorInvalidValue;
}

// The shape checks every mode shares, and the planned split into a's
// chunk / lsplit / lts / n_tiles: S split over (1 << lsplit) ranks of chunks
// that are multiples of 16 positions (at most SD_MAX_CHUNK), softmax tiles
// of ts (a power of two) positions; any rep (groups of SD_MAX_REP rows run
// as grid z)
inline bool sd_plan(SdArgs& a, int B, int H, int Hkv, int S, int ts, int lsplit) {
  int lts = 0;
  while ((1 << lts) < ts) ++lts;
  const int chunk = lsplit >= 0 && lsplit <= 3 ? S >> lsplit : 0;
  if (B < 1 || Hkv < 1 || H % Hkv || chunk < 16 ||
      (1 << lts) != ts || S % ts || S / ts > SD_MAX_TILES || (chunk << lsplit) != S ||
      chunk % 16 || chunk > SD_MAX_CHUNK)
    return false;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.rep = H / Hkv;
  a.chunk = chunk;
  a.lsplit = lsplit;
  a.lts = lts;
  a.n_tiles = S / ts;
  return true;
}

}  // namespace
