// Split-S single-query decode attention over a head-major cache: K11's body
// for bf16 queries at head_dim 64 and 128 (decode_attention.cu), the
// TPU kernel's function (smoothquant_tpu/kernels/decode_attention.py:218,
// pallas_call :306) to the f32 summation order.
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
//     rows a kv head), not by the flash body's largest rep.
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
// No runtime integer division anywhere (it compiles to I2F): the split and
// the tile width are powers of two, taken by shifts.
#pragma once

#include "flash_decode.cuh"   // FLASH_NEG_INF, FLASH_SKIP_AT, warp_max / warp_sum
#include "cluster.cuh"       // cluster barrier, remote loads, bulk copies
#include "wg_gemm.cuh"       // mbarrier helpers, smem_u32, bf16_pair

namespace {

constexpr int SD_WARPS = 4;
constexpr int SD_THREADS = 32 * SD_WARPS;
constexpr int SD_ROWS = 32;          // positions a ring stage holds
constexpr int SD_LOG_ROWS = 5;
constexpr int SD_SLOTS = 2;          // ring depth (a power of two; 4 measured slower)
constexpr int SD_LOG_SLOTS = 1;
constexpr int SD_MAX_TILES = 64;     // softmax tiles of S (as the flash body)
constexpr int SD_MAX_SPLIT = 8;      // cluster ranks
constexpr int SD_MAX_CHUNK = 2048;   // positions a rank takes at most
constexpr int SD_SMEM_MAX = 227 * 1024;

struct SdArgs {
  const __nv_bfloat16* q;   // (B, H, D)
  const void* k;            // (B, H_kv, S, D) this layer
  const void* v;
  const float* ks;          // (B, H_kv, S) int8 cache scales, or null
  const float* vs;
  const float* bias;        // (B, S)
  const float* slopes;      // (H,) ALiBi slopes (H == H_kv), or null
  __nv_bfloat16* out;       // (B, H, D)
  int H, Hkv, S, rep;
  int chunk, lsplit, lts, n_tiles;   // positions a rank, log2 ranks, log2 tile width, tiles
  float sm_scale;
};

// Shared-memory carve-up of one CTA (byte offsets; every region 16-byte
// aligned since the chunk is a multiple of 16 positions)
struct SdLayout {
  int ring, bias, ks, vs, sc, tall, tm, tf, red, lred, pin, lin, ints, total;
};

template <int D, int ES, int REP, bool QUANT>
__host__ __device__ inline SdLayout sd_layout(int n) {
  SdLayout L;
  int o = 128;                                   // mbarriers: the staging one, then SD_SLOTS
  L.ring = o;  o += SD_SLOTS * SD_ROWS * D * ES;
  L.bias = o;  o += n * 4;
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
  L.ints = o;  o += 16;                          // lo, hi
  L.total = o;
  return L;
}

// f32 of a non-negative int below 2^23, exactly, with no I2F
__device__ __forceinline__ float sd_u2f(uint32_t s) {
  return __fsub_rn(__uint_as_float(0x4B000000u | s), 8388608.0f);
}

// The 16 bytes at p as f32: 16 int8 (no I2F: 2^23 + (b ^ 0x80) − (2^23 + 128))
// or 8 bf16
template <typename TC>
__device__ __forceinline__ void sd_vals(const void* p, float (&f)[16 / sizeof(TC)]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(TC) == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = ws[i] ^ 0x80808080u;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f[4 * i + c] =
            __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + c)), 8388736.0f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(ws[i] << 16);
      f[2 * i + 1] = __uint_as_float(ws[i] & 0xFFFF0000u);
    }
  }
}

// TC: cache element (int8 with QUANT, else bf16); D head_dim; REP query rows
// a kv head the registers hold (rep <= REP at run time).  Grid (H_kv << lsplit,
// B), cluster (1 << lsplit, 1, 1), SD_THREADS threads.
template <typename TC, int D, int REP, bool QUANT>
__global__ void __launch_bounds__(SD_THREADS)
split_decode_kernel(const SdArgs a) {
  constexpr int ES = sizeof(TC);
  constexpr int ROWB = D * ES;            // bytes of a cache row
  constexpr int LPR = ROWB / 16;          // lanes a row
  constexpr int EPL = 16 / ES;            // elements a lane
  constexpr int RPW = 32 / LPR;           // rows a warp holds at once
  constexpr int RPP = SD_WARPS * RPW;     // rows a CTA holds at once
  constexpr int STAGE = SD_ROWS * ROWB;
  static_assert(SD_ROWS % RPP == 0, "a stage is whole passes");

  extern __shared__ __align__(128) unsigned char sd_smem[];
  const int n = a.chunk;
  const SdLayout L = sd_layout<D, ES, REP, QUANT>(n);
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
  int* ints = reinterpret_cast<int*>(sd_smem + L.ints);
  const uint32_t bar0 = smem_u32(sd_smem);        // the staging barrier; slot i's at + 8 (i + 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & (LPR - 1);               // the lane's 16 bytes of a row
  const int C = 1 << a.lsplit;
  const int rank = blockIdx.x & (C - 1), kvh = blockIdx.x >> a.lsplit, b = blockIdx.y;
  const int rep = a.rep;
  const size_t head = (size_t)b * a.Hkv + kvh;
  const int c0 = rank * n;                        // the chunk's first position
  const TC* kc = static_cast<const TC*>(a.k) + (head * a.S + c0) * D;
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
    mbar_expect_tx(bar0, n * 4 * (QUANT ? 3 : 1));
    cl_bulk_g2s(smem_u32(bias_s), a.bias + (size_t)b * a.S + c0, n * 4, bar0);
    if constexpr (QUANT) {
      cl_bulk_g2s(smem_u32(ks_s), a.ks + head * a.S + c0, n * 4, bar0);
      cl_bulk_g2s(smem_u32(vs_s), a.vs + head * a.S + c0, n * 4, bar0);
    }
  }

  // the lane's slice of the rep query rows, while the bias lands
  float qv[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const __nv_bfloat16* qr = a.q + ((size_t)b * a.H + kvh * rep + r) * D + sub * EPL;
#pragma unroll
    for (int h = 0; h < EPL / 8; ++h) {
      float f[8];
      if (r < rep) {
        sd_vals<__nv_bfloat16>(qr + 8 * h, f);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[r][8 * h + e] = f[e];
    }
  }
  const bool alibi = a.slopes != nullptr;
  const float slope = alibi ? a.slopes[kvh] : 0.0f;

  // the unmasked range [lo, hi] of the chunk; every score starts as the bias
  mbar_wait(bar0, 0);
  {
    int lo = n, hi = -1;
    for (int i = tid; i < n; i += SD_THREADS) {
      const float bv = bias_s[i];
      if (bv > FLASH_SKIP_AT) {
        lo = min(lo, i);
        hi = max(hi, i);
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r * n + i] = bv;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      atomicMin(&ints[0], lo);
      atomicMax(&ints[1], hi);
    }
  }
  __syncthreads();
  const int lo = ints[0], hi = ints[1];
  const int j0 = hi >= 0 ? lo >> SD_LOG_ROWS : 0;
  const int n_st = hi >= 0 ? (hi >> SD_LOG_ROWS) - j0 + 1 : 0;   // K stages (as many V)
  const int items = 2 * n_st;

  // ring item g: K stage j0 + g (g < n_st), then V stage j0 + g − n_st; only
  // the rows of [lo, hi] are copied
  auto issue = [&](int g) {
    const bool is_k = g < n_st;
    const int j = j0 + (is_k ? g : g - n_st);
    const int r0 = max(j * SD_ROWS, lo), r1 = min((j + 1) * SD_ROWS, hi + 1);
    const int slot = g & (SD_SLOTS - 1);
    const uint32_t bar = bar0 + 8 * (slot + 1);
    const TC* src = (is_k ? kc : vc) + (size_t)r0 * D;
    mbar_expect_tx(bar, (r1 - r0) * ROWB);
    cl_bulk_g2s(smem_u32(ring + slot * STAGE + (r0 - j * SD_ROWS) * ROWB), src,
                (r1 - r0) * ROWB, bar);
  };
  if (tid == 0)
    for (int g = 0; g < items && g < SD_SLOTS; ++g) issue(g);
  auto release = [&](int g) {   // after every thread is done with item g's slot
    __syncthreads();
    if (tid == 0 && g + SD_SLOTS < items) {
      fence_async_smem();
      issue(g + SD_SLOTS);
    }
  };
  const int row_in_pass = warp * RPW + (lane / LPR);

  // scores of the unmasked positions: (q·k)·sm_scale [·k_scale] [+ slope·s] + bias
  for (int g = 0; g < n_st; ++g) {
    const int slot = g & (SD_SLOTS - 1);
    mbar_wait(bar0 + 8 * (slot + 1), (g >> SD_LOG_SLOTS) & 1);
    const unsigned char* st = ring + slot * STAGE;
    const int i_base = (j0 + g) * SD_ROWS;
#pragma unroll
    for (int p = 0; p < SD_ROWS / RPP; ++p) {
      const int ri = p * RPP + row_in_pass;
      const int i = i_base + ri;
      const bool live = i >= lo && i <= hi && bias_s[i] > FLASH_SKIP_AT;
      float kv[EPL];
      if (live) {
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
      if (live && sub == 0) {
        float extra = 0.0f;
        if (alibi) extra = __fmul_rn(slope, sd_u2f((uint32_t)(c0 + i)));
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          if (r >= rep) break;
          float x = __fmul_rn(dot[r], a.sm_scale);
          if (QUANT) x = __fmul_rn(x, ks_s[i]);
          if (alibi) x = __fadd_rn(x, extra);
          sc[r * n + i] = __fadd_rn(x, bias_s[i]);
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
  // the TPU kernel's running max, m_safe and rescale α per tile, then F_t
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
      if (i >= lo && i <= hi && bias_s[i] > FLASH_SKIP_AT) {
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

  // this rank's slice of the outputs: the ranks' partials in rank order over
  // their l in rank order
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
    const float den = l > 0.0f ? l : 1.0f;
    __nv_bfloat16* o = a.out + ((size_t)b * a.H + kvh * rep + r) * D + d;
    *reinterpret_cast<uint2*>(o) = make_uint2(bf16_pair(s.x / den, s.y / den),
                                              bf16_pair(s.z / den, s.w / den));
  }
}

template <typename TC, int D, int REP, bool QUANT>
int sd_launch(const SdArgs& a, int B, cudaStream_t st) {
  auto kern = split_decode_kernel<TC, D, REP, QUANT>;
  static const cudaError_t ready =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SD_SMEM_MAX);
  if (ready != cudaSuccess) return (int)ready;
  const int smem = sd_layout<D, sizeof(TC), REP, QUANT>(a.chunk).total;
  if (smem > SD_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv << a.lsplit, B);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TC, bool QUANT, int D>
int sd_by_rep(const SdArgs& a, int B, cudaStream_t st) {
  if (a.rep <= 1) return sd_launch<TC, D, 1, QUANT>(a, B, st);
  if (a.rep <= 2) return sd_launch<TC, D, 2, QUANT>(a, B, st);
  if (a.rep <= 4) return sd_launch<TC, D, 4, QUANT>(a, B, st);
  return sd_launch<TC, D, 8, QUANT>(a, B, st);
}

template <typename TC, bool QUANT>
int sd_by_dim(int D, const SdArgs& a, int B, cudaStream_t st) {
  if (D == 64) return sd_by_rep<TC, QUANT, 64>(a, B, st);
  if (D == 128) return sd_by_rep<TC, QUANT, 128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
