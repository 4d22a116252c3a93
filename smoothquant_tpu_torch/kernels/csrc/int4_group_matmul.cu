// W4A4 group matmul kernels for Hopper: the decode linear (K1), the
// prefill linear (K6) and the stacked linear on quantized activations (K5).
//
// K1 replaces smoothquant_tpu/kernels/int4_group_matmul.py
// int4_group_matmul_stacked_rawx (pallas_call at :649), at N <= 32 token
// rows.  At decode N (the batch) it is bound by the bytes of the layer's
// packed weight: ~0.56 bytes per weight element (nibbles + bf16 group
// scales) plus the bf16 salient block, against 2·N int ops per element.
// Two bodies, picked by shape alone (int4_group_matmul.py rawx_body): bf16
// x at 1-32 rows (every decode linear of the paths) takes one launch of the
// weight-streaming body with the pre-pass folded in (stream_gmm.cuh
// stream_rawx_kernel, sq_rawx_stream: each stage carries its raw x tiles by
// TMA, three quantizer warps make its codes in shared memory ahead of the
// consumers' mma); f32 x and the group sizes the ring lacks keep the
// body below.  It spends nothing on the activations beyond one tiny
// pre-pass and spreads the weight stream over every SM, in three launches
// behind one entry, sq_rawx:
//   * rawx_prep_kernel (a block per token row and 8 groups, a warp per group,
//     plus a block per row for the salient slice) does the optional RMSNorm
//     or 0/1 channel mask, the tail-mode salient split and the per-(row,
//     group) activation quantize ONCE (group_quant.cuh, shared with K7a:
//     scale = max(absmax,1e-5)·(1/qmax), the f32 reciprocal multiply XLA
//     compiles the JAX division to; round half to even), writing int8 codes,
//     f32 scales, int32 code sums and the salient activations rounded to the
//     compute dtype.  (The TPU kernel quantized at j == 0 into VMEM scratch;
//     here one pre-pass serves every O-tile instead of each block redoing it.)
//   * rawx_main_kernel is split over O (4 columns a lane, 512 a block) and over
//     K (group pairs, plus 64-row slices of the salient block), so a
//     Llama-2-7B decode linear launches 250-500 blocks.  Each lane loads
//     the 32-bit words of 16 packed rows of its 4 columns before using
//     any (loads in flight are what a bandwidth-bound kernel needs), its
//     accumulators sized for 4 or 8 token rows; above 8 rows the grid also
//     splits the rows into chunks of 8, the chunk varying fastest so the
//     blocks reading one weight tile run together and L2 serves all but the
//     first (the weight streams from DRAM about once; registers, not the
//     weight, are what a 32-row accumulator would not fit).  It transposes
//     bytes with __byte_perm into one K-packed word per column, masks the
//     biased low/high nibbles (channel r and r + K/2) and feeds __dp4a; the
//     +8 bias leaves the int32 sum as −8·Σx_q per group.  The epilogue is
//     (p − 8Σx)·s_x·s_w in f32.  Each split writes its own f32 partial.
//   * rawx_reduce_kernel sums the salient partials, then the group partials in
//     K order (the TPU kernel seeded its accumulator with the salient dot
//     and added groups in order), and casts to the output dtype.
//
// K6 replaces int4_group_matmul (pallas_call at :950): the same inner
// product on activations that are already quantized.  At prefill N the int8
// products (2·N·K·O at 1979 TOP/s: 0.24 ms for Llama-2-7B's four linears at
// 1024 rows) are not what bounds it: each output element takes one scaling
// a group, acc += ((p − 8Σx)·s_x)·s_w, on the CUDA cores, N·O·G of them
// (roofline.group_scaling_floor_ms: ~0.3 ms at three f32-pipe instructions
// each).  An int → float conversion per scaling (I2F, ~16 a clock an SM)
// alone would cost ~0.8 ms, so the body converts with no I2F: one integer
// add puts p − 8Σx under the exponent of 1.5·2^23 (the row's term
// 0x4B400000 − 8Σx, made once per row and group), one subtract of 1.5·2^23
// gives its exact f32 value (|p − 8Σx| < 2^22), then a multiply and an fma.
// Two bodies, picked by shape alone (int4_group_matmul.py gmm_body):
//   * wg_gmm_kernel (bf16, group size 32 or 64, O % 16 == 0; every row
//     count): a warp-specialized wgmma kernel.  128 × 128 output tiles;
//     two consumer warpgroups (64 rows each) run wgmma.mma_async
//     m64n128k32 s8 into an s32 accumulator a group and scale it into the
//     f32 one, the salient block (bf16 m64n128k16) seeding it first; two
//     producer warpgroups copy each stage (a group pair: the two x tiles as
//     they lie, K-major, the raw nibble rows, the scales) by TMA into a ring
//     of four slots on mbarriers, and transform the nibble weight a stage
//     ahead: unpack lo / hi nibbles (& 0x0F, >> 4), byte-transpose four rows
//     × four columns with __byte_perm and write the two K-major int8 tiles
//     s8 wgmma needs (there is no transpose for 8-bit B), plus the rows' Σx
//     terms and the f32 column scales.  Named barriers hand each stage over
//     and back; setmaxnreg gives each consumer thread 160 registers for its
//     f32 and s32 accumulators (128; at the 128 a thread of 512 has at
//     launch, ptxas spilled them and serialized the wgmma).  A second s32
//     set, to scale one group while the next one's wgmma runs, would not
//     fit beside two producer warpgroups; instead the two consumers take
//     turns to issue (named barriers), so one's product runs on the tensor
//     cores while the other scales.  scripts/wg_variants.py times the
//     designs it did not take on the H100: the second s32 set beside one
//     producer warpgroup of 40 registers (ptxas serializes its wgmma), and
//     the consumers issuing without turns.  The weight keeps its (K/2, O)
//     storage.
//     chip_smoke.py's sass
//     phase holds the build to IGMMA in every K6 wgmma kernel and no I2F in
//     any of them (the H100 build: 0).
//   * gmm_kernel (gmm_tiles.cuh, every other shape: f32, group sizes 16
//     and 48, O % 16 != 0): 64×64 mma.sync tiles, shared with K5 and K8.
// Times beside the bound and the floor: PERF.md §6.
//
// K5 replaces int4_group_matmul_stacked (pallas_call at :807): layer i of a
// stacked (L, K/2, O) pack on quantized activations, the decode linears of
// 33+ token rows (K7a's pre-laid (G, N_pad, gs) codes, or (N, K) row-major
// ones from the identity layout's quantize).  At N = 64 it is bound by the
// weight's bytes (2·64 int ops per ~0.56-byte element, ~230 ops a byte
// against the card's ~590) with the per-group scaling (N·O·G of them) beside
// them on the CUDA cores.  Two bodies, picked by shape alone
// (int4_group_matmul.py stacked_body):
//   * the stream body K8 shares (stream_gmm.cuh) at 1-64 rows, group size
//     16, 32 or 64, O % 16 == 0: a stage is one group pair (gs packed rows
//     by TMA, the two x tiles in either layout); each nibble b enters the
//     int8 mma as 16·(b − 8) (one logic op on the transposed word), so the
//     product needs no −8·Σx term and s_x/16 takes the ×16 back out; K
//     split over a cluster, reduced in rank order through distributed
//     shared memory;
//   * gmm_kernel (gmm_tiles.cuh) for every other shape (more rows, group
//     size 48, O % 16 != 0): K6's tile kernel with strided activation
//     addressing, its split over the group pairs reduced by a second launch.
#include "gmm_tiles.cuh"
#include "stream_gmm.cuh"

namespace {

// K1 pre-pass.  Grid (N, ceil(G / PREP_WARPS) + 1): block (n, y) runs the
// pre-pass item (n, y) of rawx.cuh.
template <typename T>
__global__ void __launch_bounds__(PREP_WARPS * 32)
rawx_prep_kernel(const T* __restrict__ x, const float* __restrict__ nw,
                 const T* __restrict__ x_sal_ext, int8_t* __restrict__ xq,
                 float* __restrict__ xs, int* __restrict__ xsum, float* __restrict__ xsal,
                 int C, int kk, int gs, int k_ns_raw, int n_sal, int k_s, int mode,
                 int need_mask, float eps, float inv_qmax) {
  __shared__ double scratch[32];
  rawx_prep_item<T>(blockIdx.x, blockIdx.y, gridDim.y, x, nw, x_sal_ext, xq, xs, xsum, xsal,
                    C, kk, gs, k_ns_raw, n_sal, k_s, mode, need_mask, eps, inv_qmax, scratch);
}

// NT: token rows the accumulators hold (4, or RAWX_CHUNK = 8).  Above NT
// rows the grid splits the rows into n_chunks chunks of NT, the chunk index
// varying fastest in blockIdx.x, so the blocks that read the same weight
// tile run side by side and the tile comes from DRAM once (L2 serves the
// other chunks).  Each warp takes 32·RAWX_COLS columns (rawx_main_warp).
template <int NT, typename S, typename T>
__global__ void __launch_bounds__(RAWX_WARPS * 32)
rawx_main_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int* __restrict__ xsum, const float* __restrict__ xsal,
                 const int8_t* __restrict__ w, const S* __restrict__ ws,
                 const T* __restrict__ wsal, float* __restrict__ part, int N, int O, int kk,
                 int gs, int k_s, int gps, int n_int_splits, int n_chunks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ob = blockIdx.x / n_chunks;
  const int n0 = (blockIdx.x % n_chunks) * NT;   // this block's first token row
  const int col0 = (ob * RAWX_WARPS + warp) * RAWX_WARP_COLS + lane * RAWX_COLS;
  rawx_main_warp<NT, S, T>(col0, blockIdx.y, n0, min(NT, N - n0), xq, xs, xsum, xsal, w, ws,
                           wsal, part, N, O, kk, gs, k_s, gps, n_int_splits);
}


template <typename T>
void launch_prep(const void* x, const void* nw, const void* x_sal, void* xq, void* xs,
                 void* xsum, void* xsal, int N, int C, int kk, int gs, int k_ns_raw,
                 int n_sal, int k_s, int mode, int need_mask, float eps, float inv_qmax,
                 cudaStream_t st) {
  const dim3 grid(N, (kk / gs + PREP_WARPS - 1) / PREP_WARPS + 1);
  rawx_prep_kernel<T><<<grid, PREP_WARPS * 32, 0, st>>>(
      (const T*)x, (const float*)nw, (const T*)x_sal, (int8_t*)xq, (float*)xs, (int*)xsum,
      (float*)xsal, C, kk, gs, k_ns_raw, n_sal, k_s, mode, need_mask, eps, inv_qmax);
}

template <typename S, typename T>
void launch_main(const void* xq, const void* xs, const void* xsum, const void* xsal,
                 const void* w, const void* ws, const void* wsal, void* part, int N, int O,
                 int kk, int gs, int k_s, int gps, int n_int, int n_sal_splits,
                 cudaStream_t st) {
  const int cols_per_block = RAWX_WARPS * 32 * RAWX_COLS;
  const int chunks = rawx_chunks(N);
  dim3 grid((O + cols_per_block - 1) / cols_per_block * chunks, n_int + n_sal_splits);
  if (N <= 4)
    rawx_main_kernel<4, S, T><<<grid, RAWX_WARPS * 32, 0, st>>>(
        (const int8_t*)xq, (const float*)xs, (const int*)xsum, (const float*)xsal,
        (const int8_t*)w, (const S*)ws, (const T*)wsal, (float*)part, N, O, kk, gs, k_s,
        gps, n_int, chunks);
  else
    rawx_main_kernel<RAWX_CHUNK, S, T><<<grid, RAWX_WARPS * 32, 0, st>>>(
        (const int8_t*)xq, (const float*)xs, (const int*)xsum, (const float*)xsal,
        (const int8_t*)w, (const S*)ws, (const T*)wsal, (float*)part, N, O, kk, gs, k_s,
        gps, n_int, chunks);
}


// ---------------------------------------------------------------- K6, wgmma body
// Four warpgroups: two consumers (64 output rows each) run the wgmma and
// the per-group scaling; two producers copy the stages in (TMA) and rewrite
// each stage's nibble weight into the K-major tiles wgmma reads, a stage
// ahead.  setmaxnreg moves registers from producers to consumers
// (W6_CONSUMER_REGS).  A slot of the ring: the A tiles (a
// pair's x lo at 0 and hi at 128·GS, rows of GS bytes; or a salient stage's
// 64 bf16 columns), the raw B rows (GS nibble rows of 128 bytes, or 64
// salient bf16 rows in two halves; all SWIZZLE_128B), the pair's row scales
// and code-sum terms (lo then hi), its two column-scale rows as copied and
// in f32.  The slots' mbarriers sit past the two Bt buffers.
constexpr int W6_XA = 0, W6_RAW = 16384, W6_SX = 32768, W6_CS = 33792, W6_SW = 34816;
constexpr int W6_SWF = 35840, W6_SLOT = 36864;
constexpr int W6_BT = WG_STAGES * W6_SLOT, W6_BAR = W6_BT + 2 * WG_BT_BYTES;
constexpr int W6_SMEM = W6_BAR + 8 * WG_STAGES;
constexpr int W6_THREADS = 4 * 128, W6_PRODUCER = 256;   // the producers' first thread
// registers a consumer and a producer thread hold after setmaxnreg (128 each
// at launch): the consumers' f32 and s32 accumulators take 128
constexpr int W6_CONSUMER_REGS = 160, W6_PRODUCER_REGS = 96;
// named barriers: Bt buffer b ready (W6_FULL + b) / free (W6_EMPTY + b); consumer c's
// turn to issue its wgmma (W6_TURN + c)
constexpr int W6_FULL = 1, W6_EMPTY = 3, W6_TURN = 5;

struct W6Args {
  const int8_t* xq;
  const float* xs;
  int N, O, kk, ks;
};

struct W6Maps {   // x_q (N, kk), x_sal (N, ks), w_sal (ks, O), w (kk/2, O), w_scales (G, O)
  CUtensorMap xq, xsal, wsal, w, ws;
};

// Stage t into its slot, by the producers (pt: their thread, 0-255):
// salient stages (t < n_sal) take 64 columns of x_sal and 64 rows of w_sal;
// stage n_sal + g the group pair (g, g + G/2): the x tiles, the raw nibble
// rows g·GS.., the column scales (all by TMA, from thread 0) and the f32 row
// scales (a column of x_scales: cp.async, one a thread).  Each producer
// thread then reports its copies to the slot's mbarrier.
template <typename S, int GS>
__device__ __forceinline__ void w6_load(const W6Args& a, const W6Maps& m, char* smem, int t,
                                        int n_sal, int n0, int o0, int pt) {
  const int slot = t % WG_STAGES;
  const uint32_t s = smem_u32(smem + slot * W6_SLOT);
  const uint32_t bar = smem_u32(smem + W6_BAR + 8 * slot);
  const int G = a.kk / GS;
  if (pt == 0) {
    if (t < n_sal) {
      mbar_expect_tx(bar, WG_BM * 128 + 2 * WG_RAW16_HALF);
      tma_2d(s + W6_XA, m.xsal, bar, t * WG_KB, n0);
      tma_2d(s + W6_RAW, m.wsal, bar, o0, t * WG_KB);
      tma_2d(s + W6_RAW + WG_RAW16_HALF, m.wsal, bar, o0 + 64, t * WG_KB);
    } else {
      const int g = t - n_sal;
      mbar_expect_tx(bar, 2 * WG_BM * GS + GS * WG_BN + 2 * WG_BN * (int)sizeof(S));
      tma_2d(s + W6_XA, m.xq, bar, g * GS, n0);
      tma_2d(s + W6_XA + WG_BM * GS, m.xq, bar, a.kk / 2 + g * GS, n0);
      tma_2d(s + W6_RAW, m.w, bar, o0, g * GS);
      tma_2d(s + W6_SW, m.ws, bar, o0, g);
      tma_2d(s + W6_SW + WG_BN * (int)sizeof(S), m.ws, bar, o0, g + G / 2);
    }
  }
  if (t >= n_sal) {
    const int g = t - n_sal, h = pt >> 7, n = n0 + (pt & 127);
    const bool ok = n < a.N;
    cp4(s + W6_SX + pt * 4, ok ? a.xs + (size_t)n * G + g + h * (G / 2) : a.xs, ok);
  }
  cp_async_arrive(bar);
}

// Stage t's B into a Bt buffer, by the producers: salient rows as bf16
// pairs; a pair's nibble rows unpacked (lo & 0x0F, hi >> 4), byte-transposed
// four rows × four columns at a time (each lane builds its rotated column's
// word from the four row words with byte permutes) and written K-major (lo
// at 0, hi at 128·GS, SBO 8·GS); the pair's per-row terms 0x4B400000 − 8·Σx
// and its column scales in f32 (one a thread), so the consumers' scaling
// loads them as they use them.
template <typename S, int GS>
__device__ __forceinline__ void w6_transform(char* bt, char* slot, int t, int n_sal,
                                             const WgLane& l, int pt) {
  if (t < n_sal) {
    wg_transform_b16<256>(bt, slot + W6_RAW, l);
    return;
  }
  const char* raw = slot + W6_RAW;
#pragma unroll
  for (int i = 0; i < GS / 32; ++i) {   // 32 column quads × GS / 4 units over 256 threads
    const int kq = l.u0 + 8 * i, r = 4 * kq;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(raw + wg_sw128(r, 4 * l.cq));
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(raw + wg_sw128(r + 1, 4 * l.cq));
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(raw + wg_sw128(r + 2, 4 * l.cq));
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(raw + wg_sw128(r + 3, 4 * l.cq));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l.c[j];
      const uint32_t sel = c | ((c + 4) << 4);   // byte c of the first word, then of the second
      const uint32_t cw = __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
      char* d = bt + wg_kmajor_off(4 * l.cq + c, kq, 8 * GS);
      *reinterpret_cast<uint32_t*>(d) = cw & 0x0F0F0F0Fu;
      *reinterpret_cast<uint32_t*>(d + WG_BM * GS) = (cw >> 4) & 0x0F0F0F0Fu;
    }
  }
  // Σx of row pt % 128 of tile pt / 128: the +8 bias of the nibbles leaves
  // p − 8Σx in each product; the magic bias makes its f32 one add.  The
  // swizzle only permutes 16-byte chunks within a row.
  const char* xr = slot + W6_XA + pt * GS;   // tile hi follows tile lo's 128 rows
  int sum = 0;
#pragma unroll
  for (int c = 0; c < GS / 16; ++c) {
    const int4 v = *reinterpret_cast<const int4*>(xr + c * 16);
    sum = __dp4a(v.x, 0x01010101, sum);
    sum = __dp4a(v.y, 0x01010101, sum);
    sum = __dp4a(v.z, 0x01010101, sum);
    sum = __dp4a(v.w, 0x01010101, sum);
  }
  reinterpret_cast<int*>(slot + W6_CS)[pt] = 0x4B400000 - 8 * sum;
  reinterpret_cast<float*>(slot + W6_SWF)[pt] = to_f<S>(reinterpret_cast<const S*>(slot + W6_SW)[pt]);
}

// p (64 × 128 per warpgroup) = one group's int8 product: the swizzled x
// tile at `a` (this warpgroup's rows) · the Bt tile at `b`, GS / 32 k32 steps
template <int GS>
__device__ __forceinline__ void w6_mma_group(int (&p)[64], uint32_t a, uint32_t b) {
  wg_arrive();
#pragma unroll
  for (int s = 0; s < GS / 32; ++s)
    wgmma_s8(p, wg_desc(a + s * 32, 16, 8 * GS, wg_swizzle_layout(GS)),
             wg_desc(b + s * 256, 128, 8 * GS), s > 0);
  wg_commit();
}

// acc += ((p − 8Σx)·s_x)·s_w for the group of half h of the pair in `slot`,
// with no int → float conversion: p + (0x4B400000 − 8Σx) is the f32 bit
// pattern of 1.5·2^23 + (p − 8Σx) (|p − 8Σx| < 2^22), so one integer add and
// one subtract give the exact f32 value, then a multiply and an fma.
__device__ __forceinline__ void w6_scale(float (&acc)[64], const int (&p)[64], const char* slot,
                                         int h, int row, int lane) {
  const float* sx = reinterpret_cast<const float*>(slot + W6_SX) + h * WG_BM;
  const int* cs = reinterpret_cast<const int*>(slot + W6_CS) + h * WG_BM;
  const float* sw = reinterpret_cast<const float*>(slot + W6_SWF) + h * WG_BN + 2 * (lane & 3);
  const float sx0 = sx[row], sx1 = sx[row + 8];
  const int c0 = cs[row], c1 = cs[row + 8];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 w = load2_f(sw + 8 * i);
    float* d = acc + 4 * i;
    const int* q = p + 4 * i;
    d[0] = __fmaf_rn(__fmul_rn(__fsub_rn(__int_as_float(q[0] + c0), WG_MAGIC), sx0), w.x, d[0]);
    d[1] = __fmaf_rn(__fmul_rn(__fsub_rn(__int_as_float(q[1] + c0), WG_MAGIC), sx0), w.y, d[1]);
    d[2] = __fmaf_rn(__fmul_rn(__fsub_rn(__int_as_float(q[2] + c1), WG_MAGIC), sx1), w.x, d[2]);
    d[3] = __fmaf_rn(__fmul_rn(__fsub_rn(__int_as_float(q[3] + c1), WG_MAGIC), sx1), w.y, d[3]);
  }
}

// The producers: stage t + 2's copies start once the consumers have freed
// stage t − 2 (its slot and Bt buffer), then stage t is transformed into Bt
// buffer t % 2 and handed over.  The consumers free stage s when they are
// done with it, and signal only the stages the producers wait for.
template <typename S, int GS>
__device__ __forceinline__ void w6_producer(const W6Args& a, const W6Maps& m, char* smem, int T,
                                            int n_sal, int n0, int o0, int pt) {
  const WgLane l = wg_lane(pt);
  if (pt == 0) {
    tma_prefetch(m.xq);
    tma_prefetch(m.w);
    tma_prefetch(m.ws);
    if (n_sal) {
      tma_prefetch(m.xsal);
      tma_prefetch(m.wsal);
    }
  }
  for (int s = 0; s < 2 && s < T; ++s) w6_load<S, GS>(a, m, smem, s, n_sal, n0, o0, pt);
  for (int t = 0; t < T; ++t) {
    if (t >= 2) named_sync<W6_THREADS>(W6_EMPTY + (t & 1));
    if (t + 2 < T) w6_load<S, GS>(a, m, smem, t + 2, n_sal, n0, o0, pt);
    mbar_wait(smem_u32(smem + W6_BAR + 8 * (t % WG_STAGES)), (t / WG_STAGES) & 1);
    w6_transform<S, GS>(smem + W6_BT + (t & 1) * WG_BT_BYTES, smem + (t % WG_STAGES) * W6_SLOT,
                        t, n_sal, l, pt);
    fence_async_smem();
    named_arrive<W6_THREADS>(W6_FULL + (t & 1));
  }
}

// The consumers: ks / 64 salient stages (their wgmma seeds the f32
// accumulator), then the G/2 group pairs, each group's int8 product into
// one s32 accumulator and scaled into the f32 one; the two consumers take
// turns to issue (consumer 0 first), so the tensor cores run one's product
// while the other scales.  The producers' transform of the next stage runs
// beside them.
template <typename S, int GS>
__device__ __forceinline__ void w6_consumer(const W6Args& a, char* smem, int T, int n_sal,
                                            int n0, int o0, int tid,
                                            __nv_bfloat16* __restrict__ out) {
  const int wg = tid >> 7, lane = tid & 31;
  const int row = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);   // this thread's first acc row
  const uint32_t bt_u = smem_u32(smem + W6_BT);
  float acc[64];
  int p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_sal; ++t) {
    named_sync<W6_THREADS>(W6_FULL + (t & 1));
    wg_mma_bf16(acc, smem_u32(smem + (t % WG_STAGES) * W6_SLOT) + W6_XA + wg * 64 * 128,
                bt_u + (t & 1) * WG_BT_BYTES);
    wg_wait<0>();
    wg_fence_regs(acc);
    if (t <= T - 3) named_arrive<W6_THREADS>(W6_EMPTY + (t & 1));
  }
  if (wg == 1 && T > n_sal) named_arrive<256>(W6_TURN);   // consumer 0 issues first
  for (int t = n_sal; t < T; ++t) {
    named_sync<W6_THREADS>(W6_FULL + (t & 1));
    const char* slot = smem + (t % WG_STAGES) * W6_SLOT;
    const uint32_t a_u = smem_u32(slot) + W6_XA + wg * 64 * GS;
    const uint32_t b_u = bt_u + (t & 1) * WG_BT_BYTES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      named_sync<256>(W6_TURN + wg);
      w6_mma_group<GS>(p, a_u + h * WG_BM * GS, b_u + h * WG_BM * GS);
      named_arrive<256>(W6_TURN + (wg ^ 1));
      wg_wait<0>();
      wg_fence_regs(p);
      w6_scale(acc, p, slot, h, row, lane);
    }
    if (t <= T - 3) named_arrive<W6_THREADS>(W6_EMPTY + (t & 1));
  }
  if (wg == 0 && T > n_sal) named_sync<256>(W6_TURN);   // consumer 1's last hand-over

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int o = o0 + 8 * i + 2 * (lane & 3);
    if (o >= a.O) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + row + 8 * h;
      if (n < a.N)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)n * a.O + o) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

template <typename S, int GS>
__global__ void __launch_bounds__(W6_THREADS, 1)
wg_gmm_kernel(const W6Args a, const __grid_constant__ W6Maps m, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x;
  int n0, o0;
  wg_tile<WG_BM>(n0, o0);
  const int n_sal = a.ks / WG_KB, T = n_sal + a.kk / GS / 2;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(smem_u32(smem + W6_BAR + 8 * s), 1 + 256);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= W6_PRODUCER) {
    regs_dec<W6_PRODUCER_REGS>();
    w6_producer<S, GS>(a, m, smem, T, n_sal, n0, o0, tid - W6_PRODUCER);
  } else {
    regs_inc<W6_CONSUMER_REGS>();
    w6_consumer<S, GS>(a, smem, T, n_sal, n0, o0, tid, out);
  }
}

// The five maps of one call (the nibble weight and the scales change with
// the layer, x with the call): false where a base or stride breaks TMA's
// 16-byte rules
template <typename S, int GS>
bool w6_maps(W6Maps& m, const void* xq, const void* xsal, const void* wsal, const void* w,
             const void* ws, int N, int O, int kk, int ks) {
  constexpr CUtensorMapDataType sdt =
      sizeof(S) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle xsw =
      GS == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  bool ok = wg_map(&m.xq, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kk, N, kk, GS, WG_BM, xsw) &&
            wg_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, kk / 2, O, WG_BN, GS,
                   CU_TENSOR_MAP_SWIZZLE_128B) &&
            wg_map(&m.ws, ws, sdt, sizeof(S), O, kk / GS, O, WG_BN, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && ks > 0)
    ok = wg_map(&m.xsal, xsal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ks, N, ks, WG_KB, WG_BM,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         wg_map(&m.wsal, wsal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, ks, O, 64, WG_KB,
                CU_TENSOR_MAP_SWIZZLE_128B);
  return ok;
}

template <typename S, int GS>
int launch_wg_gmm(const W6Args& a, const void* xsal, const void* wsal, const void* w,
                  const void* ws, void* out, cudaStream_t st) {
  static const cudaError_t attr =
      wg_kernel_ready(wg_gmm_kernel<S, GS>, W6_SMEM, 65536 / W6_THREADS);
  if (attr != cudaSuccess) return (int)attr;
  W6Maps m = {};
  if (!w6_maps<S, GS>(m, a.xq, xsal, wsal, w, ws, a.N, a.O, a.kk, a.ks))
    return (int)cudaErrorInvalidValue;
  wg_gmm_kernel<S, GS><<<wg_grid(a.N, a.O, WG_BM), W6_THREADS, W6_SMEM, st>>>(
      a, m, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch_wg_gmm(const W6Args& a, int gs, const void* xsal, const void* wsal, const void* w,
                    const void* ws, void* out, cudaStream_t st) {
  return gs == 32 ? launch_wg_gmm<S, 32>(a, xsal, wsal, w, ws, out, st)
                  : launch_wg_gmm<S, 64>(a, xsal, wsal, w, ws, out, st);
}

// K5's stream body at group size GS: the x map (row-major (N, kk) codes, or
// K7a's (G, N_pad, GS) rows viewed as (G·N_pad, GS)) with the swizzle a row
// of GS bytes takes, then the launch.
template <int GS>
int k5_stream(SgArgs& a, SgMaps& m, const void* xq, int kk, int pre_laid, cudaStream_t st) {
  const int n_box = 8 * sg_tiles_for(a.N);
  const bool ok =
      pre_laid ? wg_map(&m.x, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, GS, (uint64_t)a.G * pre_laid,
                        GS, GS, n_box, sg_swizzle<GS>())
               : wg_map(&m.x, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kk, a.N, kk, GS, n_box,
                        sg_swizzle<GS>());
  if (!ok) return (int)cudaErrorInvalidValue;
  return sg_dispatch<true, GS>(a, m, st);
}

}  // namespace

// Bytes of device workspace sq_rawx needs for these shapes.
SQ_EXPORT long long sq_rawx_workspace_bytes(int N, int O, int kk, int gs, int k_s) {
  return (long long)rawx_plan(N, O, kk, gs, k_s).bytes;
}

// K1: pre-pass (norm / mask, salient split, per-group quantize), split-K /
// split-O nibble dp4a products into f32 partials, fixed-order reduce.
SQ_EXPORT int sq_rawx(const void* x, const void* nw, const void* x_sal, const void* w,
                      const void* ws, const void* wsal, void* workspace, void* out, int N,
                      int C, int O, int kk, int gs, int k_ns_raw, int n_sal, int k_s,
                      int mode, int need_mask, float eps, float inv_qmax, int s_dt, int x_dt,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > RAWX_MAX_N || gs > 32 * GQ_PER_LANE || gs % 4)
    return (int)cudaErrorInvalidValue;
  const RawxPlan p = rawx_plan(N, O, kk, gs, k_s);
  char* base = static_cast<char*>(workspace);
  void *xq = base + p.xq, *xs = base + p.xs, *xsum = base + p.xsum, *xsal = base + p.xsal,
       *part = base + p.part;
  if (x_dt == DT_BF16)
    launch_prep<__nv_bfloat16>(x, nw, x_sal, xq, xs, xsum, xsal, N, C, kk, gs, k_ns_raw,
                               n_sal, k_s, mode, need_mask, eps, inv_qmax, st);
  else
    launch_prep<float>(x, nw, x_sal, xq, xs, xsum, xsal, N, C, kk, gs, k_ns_raw, n_sal,
                       k_s, mode, need_mask, eps, inv_qmax, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (s_dt == DT_BF16 && x_dt == DT_BF16)
    launch_main<__nv_bfloat16, __nv_bfloat16>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O,
                                              kk, gs, k_s, p.gps, p.n_int, p.n_sal, st);
  else if (s_dt == DT_BF16)
    launch_main<__nv_bfloat16, float>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O, kk, gs,
                                      k_s, p.gps, p.n_int, p.n_sal, st);
  else if (x_dt == DT_BF16)
    launch_main<float, __nv_bfloat16>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O, kk, gs,
                                      k_s, p.gps, p.n_int, p.n_sal, st);
  else
    launch_main<float, float>(xq, xs, xsum, xsal, w, ws, wsal, part, N, O, kk, gs, k_s,
                              p.gps, p.n_int, p.n_sal, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int NO = N * O, threads = 256, blocks = (NO + threads - 1) / threads;
  if (x_dt == DT_BF16)
    rawx_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const float*)part, (__nv_bfloat16*)out, NO, p.n_int, p.n_sal);
  else
    rawx_reduce_kernel<float><<<blocks, threads, 0, st>>>((const float*)part, (float*)out,
                                                          NO, p.n_int, p.n_sal);
  return (int)cudaGetLastError();
}

// K6: tiled int4 group matmul on pre-quantized (N, K) activations.
SQ_EXPORT int sq_int4_gmm(const void* xq, const void* xs, const void* w, const void* ws,
                          const void* xsal, const void* wsal, void* out, int N, int O,
                          int kk, int gs, int k_s, int s_dt, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gs > GM_MAX_GS || gs % 16) return (int)cudaErrorInvalidValue;
  const int G = kk / gs;
  const GmmArgs a{xq, xs, w, ws, xsal, wsal, out, nullptr, N, O, kk, gs, k_s,
                  kk, gs, G, 1, G / 2, 1};
  return x_dt == DT_BF16 ? dispatch_gmm<true, __nv_bfloat16>(a, s_dt, st)
                         : dispatch_gmm<true, float>(a, s_dt, st);
}

// K6, wgmma body: bf16 x_sal / w_sal / out, group size 32 or 64, O % 16 == 0,
// ks % 64 == 0; xq, xsal, w, ws and wsal 16-byte aligned (TMA's rules).
SQ_EXPORT int sq_int4_gmm_wg(const void* xq, const void* xs, const void* w, const void* ws,
                             const void* xsal, const void* wsal, void* out, int N, int O,
                             int kk, int gs, int k_s, int s_dt, void* stream) {
  if (N < 1 || (gs != 32 && gs != 64) || kk % (2 * gs) || O % 16 || k_s % WG_KB)
    return (int)cudaErrorInvalidValue;
  const W6Args a{(const int8_t*)xq, (const float*)xs, N, O, kk, k_s};
  cudaStream_t st = (cudaStream_t)stream;
  return s_dt == DT_BF16 ? dispatch_wg_gmm<__nv_bfloat16>(a, gs, xsal, wsal, w, ws, out, st)
                         : dispatch_wg_gmm<float>(a, gs, xsal, wsal, w, ws, out, st);
}

// Bytes of f32 partials sq_int4_gmm_stacked needs for these shapes (0 when
// the tiles alone fill the card and no split is made).
SQ_EXPORT long long sq_gmm_stacked_workspace_bytes(int N, int O, int kk, int gs) {
  const int n_split = gmm_plan(N, O, gm_units(true, kk, gs)).n_split;
  return n_split == 1 ? 0 : (long long)n_split * N * O * (long long)sizeof(float);
}

// K5: one layer of a stacked int4 group matmul on quantized activations,
// row-major (pre_laid = 0: xq (N, K), xs (N, G)) or K7a's layout
// (pre_laid = N_pad: xq (G, N_pad, gs), xs (G, N_pad)); out (N, O) in the
// output dtype, from f32 sums seeded by the salient dot.
SQ_EXPORT int sq_int4_gmm_stacked(const void* xq, const void* xs, const void* w,
                                  const void* ws, const void* xsal, const void* wsal,
                                  void* workspace, void* out, int N, int O, int kk, int gs,
                                  int k_s, int pre_laid, int s_dt, int x_dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gs > GM_MAX_GS || gs % 16 || (pre_laid && pre_laid < N)) return (int)cudaErrorInvalidValue;
  const int G = kk / gs;
  const GmmPlan p = gmm_plan(N, O, gm_units(true, kk, gs));
  GmmArgs a{xq, xs, w, ws, xsal, wsal, out, workspace, N, O, kk, gs, k_s,
            kk, gs, G, 1, p.gps, p.n_split};
  if (pre_laid) {
    a.x_rs = gs;
    a.x_gs = pre_laid * gs;
    a.s_rs = 1;
    a.s_gs = pre_laid;
  }
  return x_dt == DT_BF16 ? dispatch_gmm<true, __nv_bfloat16>(a, s_dt, st)
                         : dispatch_gmm<true, float>(a, s_dt, st);
}

// K5, stream body (stream_gmm.cuh): 1-64 rows, group size 16, 32 or 64,
// O % 16 == 0; xq / xs row-major (pre_laid = 0) or K7a's layout (pre_laid =
// N_pad); xsal (N, xsal_rs) and wsal (k_s, O) in the compute dtype (bf16:
// xsal_rs a multiple of 8); every pointer 16-byte aligned (TMA).  A group
// stage is one group pair (GS packed rows), a bf16 salient stage 32 rows.
SQ_EXPORT int sq_int4_gmm_stacked_stream(const void* xq, const void* xs, const void* w,
                                         const void* ws, const void* xsal, const void* wsal,
                                         void* out, int N, int O, int kk, int gs, int k_s,
                                         int xsal_rs, int pre_laid, int n_split, int s_dt,
                                         int x_dt, void* stream) {
  const int G = kk / gs, s_bf16 = s_dt == DT_BF16, t_bf16 = x_dt == DT_BF16;
  const int n_grp = G / 2, n_sal = t_bf16 ? (k_s + 31) / 32 : 0;
  if ((gs != 16 && gs != 32 && gs != 64) || kk % (2 * gs) || (pre_laid && pre_laid < N) ||
      !sg_args_ok(N, O, k_s, xsal_rs, n_split, n_sal + n_grp, t_bf16))
    return (int)cudaErrorInvalidValue;
  // a programmatic dependent of the stream's previous kernel, always: on the
  // stacked path that is the activation prep (K7a / K7b's row body), whose
  // launch_dependents lets the first weight stages stream while it runs;
  // behind any other kernel the wait at griddepcontrol.wait is its end
  SgArgs a{(const float*)xs, xsal, wsal, out, N, O, G, k_s, xsal_rs, G, 1, gs, 0, kk / 2, 0,
           n_sal, n_grp, n_split, s_bf16, t_bf16, /*pdl=*/1};
  if (pre_laid) {
    a.s_rs = 1;
    a.s_gs = pre_laid;
    a.x_dx = 0;
    a.x_dy = pre_laid;
    a.x_hx = 0;
    a.x_hy = G / 2 * pre_laid;
  }
  SgMaps m = {};
  if (!sg_weight_map(&m.w, w, O, kk / 2, gs) ||
      !sg_common_maps(m, ws, xsal, wsal, s_bf16, N, O, G, n_sal ? k_s : 0, xsal_rs,
                      8 * sg_tiles_for(N), 32, 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return gs == 16 ? k5_stream<16>(a, m, xq, kk, pre_laid, st)
         : gs == 32 ? k5_stream<32>(a, m, xq, kk, pre_laid, st)
                    : k5_stream<64>(a, m, xq, kk, pre_laid, st);
}

// K1, stream body (stream_gmm.cuh stream_rawx_kernel): the pre-pass of
// sq_rawx folded into one launch of the weight-streaming ring.  bf16 x (1-32
// rows, C a multiple of 8), group size 16, 32 or 64, O a multiple of 16, bf16
// w_sal and out, every pointer 16-byte aligned; inv_c = 1/C and inv_qmax =
// 1/qmax in f32; the split over K in n_split ranks, each with a stage at
// least and its salient tiles within a block's shared memory.
SQ_EXPORT int sq_rawx_stream(const void* x, const void* nw, const void* x_sal, const void* w,
                             const void* ws, const void* wsal, void* out, int N, int C, int O,
                             int kk, int gs, int k_ns_raw, int n_sal, int k_s, int mode,
                             int need_mask, float eps, float inv_c, float inv_qmax, int s_dt,
                             int n_split, void* stream) {
  const int G = kk / gs, n_grp = G / 2, n_sal_st = (k_s + 31) / 32;
  if ((gs != 16 && gs != 32 && gs != 64) || kk < 2 * gs || kk % (2 * gs) || N < 1 ||
      N > RAWX_MAX_N || C < 8 || C % 8 || O < 16 || O % 16 || (mode != 0) != (nw != nullptr) ||
      mode < 0 || mode > 2 || (n_split != 1 && n_split != 2 && n_split != 4 && n_split != 8) ||
      n_sal_st + n_grp < n_split)
    return (int)cudaErrorInvalidValue;
  const SrArgs a{(const __nv_bfloat16*)x, (const float*)nw, (const __nv_bfloat16*)x_sal, out,
                 N, C, O, G, k_ns_raw, n_sal, k_s, mode, need_mask, eps, inv_c, inv_qmax,
                 n_sal_st, n_grp, n_split};
  const CUtensorMapDataType sdt =
      s_dt == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  SrMaps m = {};
  if (!sg_weight_map(&m.w, w, O, kk / 2, gs) ||
      !wg_map(&m.ws, ws, sdt, s_dt == DT_BF16 ? 2 : 4, O, G, O, SG_BO, 1,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (k_s > 0 && !wg_map(&m.wsal, wsal, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, k_s, O, 64, 32,
                          CU_TENSOR_MAP_SWIZZLE_128B, SG_W_PROMO)) ||
      !wg_map(&m.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C, N, C, gs, 8 * sg_tiles_for(N),
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (mode != 0 && !wg_map(&m.nw, nw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, C, 1, C, gs, 1,
                            CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return s_dt == DT_BF16 ? sr_dispatch<__nv_bfloat16>(a, m, gs, st)
                         : sr_dispatch<float>(a, m, gs, st);
}
