// Warpgroup-MMA (wgmma) GEMM machinery shared by K6's wgmma body
// (int4_group_matmul.cu) and K9's bf16 body (quant_matmul.cu).
//
// Both kernels compute 64·W × 128 output tiles, one warpgroup per 64 rows,
// with wgmma.mma_async m64n128 (k32 for s8, k16 for bf16) from shared
// memory.  Operand tiles move global → shared through a ring of stages, a
// few stages ahead of the one the tensor cores read: one thread issues a
// stage's TMA tile copies (cp.async.bulk.tensor, zero-filled past the
// matrix edges) against the slot's mbarrier, with the byte count it
// expects; the few pieces no tensor map can describe (a column of row
// scales, weight rows that are not 16-byte multiples) go by per-thread
// cp.async, whose completion each copying thread also reports to that
// mbarrier (cp.async.mbarrier.arrive.noinc), so one wait covers the stage.
// (cp.async alone kept the load issue on every thread, where it stalled:
// on an H100 the requests in flight, not the bytes, were the limit.)
//
// The A tiles land as TMA writes them, in the swizzled K-major layouts wgmma
// reads directly: rows of 128 bytes (bf16, 64 columns; SWIZZLE_128B) or of
// GS bytes (int8 group tiles; SWIZZLE_64B / 32B), 8-row groups SBO = 8 · row
// bytes apart, the next k step 32 bytes further into the row.  The B
// operands wgmma needs K-major (the port's weights are stored O-major and,
// for K6, as nibbles) are rewritten by threads from the stage's raw rows
// into one of two "Bt" buffers a stage ahead, in the no-swizzle K-major
// layout: 8-row × 16-byte core matrices of 128 contiguous bytes, adjacent
// along K (LBO = 128 bytes), the 8-row groups SBO = 128 · (K bytes / 16)
// apart, byte (o, kb) at
//   (o / 8) · SBO + (kb / 16) · 128 + (o % 8) · 16 + kb % 16,
// fenced to the async proxy (fence.proxy.async) before a barrier hands the
// buffer over; the lane → (column, k) map keeps a warp's loads and stores on
// distinct banks (wg_lane).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

#include "common.cuh"

namespace {

constexpr int WG_BM = 128, WG_BN = 128;   // K6's tile; K9 takes 64·W rows
constexpr int WG_STAGES = 4;        // K6's ring depth
constexpr int WG_KB = 64;           // bf16 k values a bf16 stage holds (128 bytes a row)
constexpr int WG_A16_SBO = 1024;    // 8-row group stride of a 64-wide bf16 tile
constexpr int WG_BT_BYTES = 16384;  // one Bt buffer: 128 columns × 128 bytes of K
constexpr int WG_RAW16_HALF = 8192; // a raw bf16 B stage: two 64-column halves, SWIZZLE_128B
constexpr float WG_MAGIC = 12582912.0f;  // 1.5 · 2^23 (0x4B400000)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: no swizzle (layout 0, the Bt
// tiles), or 128 / 64 / 32-byte swizzle (layout 1 / 2 / 3, the TMA tiles,
// whose LBO the hardware ignores)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint32_t layout = 0) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)layout << 62);
}

// the descriptor's layout code for TMA-written rows of `row_bytes` bytes
__host__ __device__ constexpr uint32_t wg_swizzle_layout(int row_bytes) {
  return row_bytes == 128 ? 1u : row_bytes == 64 ? 2u : 3u;
}

// cp.async of 8 / 4 bytes; with ok false nothing is read and the
// destination is zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// mbarrier ring: init (one thread), the TMA issuer's arrival with the bytes
// it expects, each thread's arrival when its cp.async copies land, and the
// wait for a phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWG_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WG_WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box of `map` at (x, y) (x the contiguous dimension) into shared
// memory at dst, its bytes counted against the mbarrier at bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap& map, uint32_t bar, int x,
                                       int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// named barrier `id` (1-15) over N threads: wait for all, or arrive only
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// a warpgroup's registers a thread raised to / lowered to R (setmaxnreg)
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R) : "memory");
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R) : "memory");
}

// the map's descriptor fetched ahead of its first use
__device__ __forceinline__ void tma_prefetch(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
}

// the executing thread's shared-memory writes (st.shared) made visible to
// the async proxy wgmma reads through; a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_arrive() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// after a wait: no read of the accumulators may move above it
__device__ __forceinline__ void wg_fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void wg_fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 × 128 per warpgroup) = A · B (+ D when scale_d): s8 · s8 → s32, k32
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the bf16 twin: bf16 · bf16 → f32, k16, both operands K-major
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// byte c of `word` as a signed int8, exactly, in f32: the byte with its sign
// bit flipped sits in the mantissa of 2^23, so one add recovers it (no I2F)
__device__ __forceinline__ float s8_to_f(uint32_t word, int c) {
  const uint32_t u = ((word >> (8 * c)) & 0xFFu) ^ 0x80u;
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388736.0f);
}

// f32(v) rounded to nearest even, as cvt.rn.f32.s32 rounds it, with no I2F:
// v = (v >> 16)·2^16 + (v & 0xFFFF), each part exact in f32 (under the
// exponent of 1.5·2^23 and of 2^23), joined by one fma that rounds once
__device__ __forceinline__ float s32_f32_rn(int v) {
  const float hi = __fsub_rn(__int_as_float(0x4B400000 + (v >> 16)), WG_MAGIC);
  const float lo = __fsub_rn(__int_as_float(0x4B000000 | (v & 0xFFFF)), 8388608.0f);
  return __fmaf_rn(hi, 65536.0f, lo);
}

// (bf16(lo), bf16(hi)), each rounded to nearest even, in one cvt
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two neighbouring scales as f32 (one 4- or 8-byte load)
__device__ __forceinline__ float2 load2_f(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Block (x, y)'s output tile: row tile x, column tile y.  Blocks start in
// x-fastest order, so the blocks in flight share a few weight column tiles
// (each streamed from DRAM about once) while the activations, re-read by
// every column tile, stay in L2.
template <int BM>
__device__ __forceinline__ void wg_tile(int& n0, int& o0) {
  n0 = blockIdx.x * BM;
  o0 = blockIdx.y * WG_BN;
}

inline dim3 wg_grid(int N, int O, int BM) {
  return dim3((N + BM - 1) / BM, (O + WG_BN - 1) / WG_BN);
}

// A transform lane's items: column quad cq (columns 4·cq .. 4·cq + 3) and k
// units u0 + (threads / 32)·i (a unit is 4 bytes of Bt's K), i < the items a
// stage has.  Lanes 0-7 of a warp take eight neighbouring column quads,
// lanes 8·j.. the next unit.  Store j of an item writes column 4·cq + c_j, c_j = (j + rot) % 4
// with rot = (cq / 2) % 4: with the column's bytes picked by a byte-permute
// selector built from c_j, each lane starts at another column and a warp's
// 4-byte stores into the K-major tile (bank 4·(column % 8) + u % 4) never
// collide, with no word selected at run time.
struct WgLane {
  int cq, u0;
  int c[4];
};

__device__ __forceinline__ WgLane wg_lane(int tid) {
  WgLane l;
  const int lane = tid & 31;
  l.cq = ((tid >> 5) & 3) * 8 + (lane & 7);
  l.u0 = (tid >> 7) * 4 + (lane >> 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) l.c[j] = (j + ((l.cq >> 1) & 3)) & 3;
  return l;
}

// byte offset of 4-byte k unit u of column o in a no-swizzle K-major tile
// whose 8-column groups lie sbo bytes apart
__device__ __forceinline__ int wg_kmajor_off(int o, int u, int sbo) {
  return (o >> 3) * sbo + (u >> 2) * 128 + (o & 7) * 16 + (u & 3) * 4;
}

// byte offset of (row r, byte b) in a 128-byte-row tile TMA wrote with
// SWIZZLE_128B (the 16-byte chunk index xor r % 8)
__device__ __forceinline__ int wg_sw128(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// A raw bf16 stage (64 k rows × 128 columns, two 64-column SWIZZLE_128B
// halves) → a Bt tile: column o's 64 k values K-major, the pair (k, k + 1)
// in one word (SBO 1024), by a block of THREADS threads
template <int THREADS>
__device__ __forceinline__ void wg_transform_b16(char* bt, const char* raw, const WgLane& l) {
  const char* half = raw + (l.cq >> 4) * WG_RAW16_HALF;
  const int b = (l.cq & 15) * 8;   // the quad's byte in its half's row
#pragma unroll
  for (int i = 0; i < 1024 / THREADS; ++i) {
    const int kp = l.u0 + THREADS / 32 * i;
    const uint2 r0 = *reinterpret_cast<const uint2*>(half + wg_sw128(2 * kp, b));
    const uint2 r1 = *reinterpret_cast<const uint2*>(half + wg_sw128(2 * kp + 1, b));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = l.c[j];
      const uint32_t w = __byte_perm(c & 2 ? r0.y : r0.x, c & 2 ? r1.y : r1.x,
                                     c & 1 ? 0x7632 : 0x5410);
      *reinterpret_cast<uint32_t*>(bt + wg_kmajor_off(4 * l.cq + c, kp, WG_A16_SBO)) = w;
    }
  }
}

// acc (64 × 128 per warpgroup) += the bf16 A stage at `a` (this warpgroup's
// 64 rows of a SWIZZLE_128B tile) · the Bt tile at `b`: four k16 steps, one
// commit group
__device__ __forceinline__ void wg_mma_bf16(float (&acc)[64], uint32_t a, uint32_t b) {
  wg_arrive();
#pragma unroll
  for (int s = 0; s < WG_KB / 16; ++s)
    wgmma_bf16(acc, wg_desc(a + s * 32, 16, 1024, wg_swizzle_layout(128)),
               wg_desc(b + s * 256, 128, WG_A16_SBO), 1);
  wg_commit();
}

}  // namespace

// ---------------------------------------------------------------- host side

namespace {

typedef CUresult (*WgEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
inline WgEncodeTiled wg_encoder() {
  static const WgEncodeTiled fn = [] {
    void* p = nullptr;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess
               ? reinterpret_cast<WgEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A warp-specialized kernel's launch check: its dynamic shared memory
// allowed, and the registers a thread gets at launch equal to `regs`, the
// count its setmaxnreg moves assume (with fewer, the consumers' raise would
// wait for registers no producer frees).
template <typename K>
cudaError_t wg_kernel_ready(K kernel, int smem, int regs) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  return fa.numRegs == regs ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// A 2-D map over a row-major (rows, cols) matrix of elements of `dt` (esize
// bytes) with a row stride of ld elements, boxes of box_cols × box_rows,
// zero fill past the edges, L2 fills of `promo`.  Returns false where the
// encoder refuses it (base not 16-byte aligned, ld · esize not a multiple
// of 16, ...).
inline bool wg_map(CUtensorMap* m, const void* base, CUtensorMapDataType dt, int esize,
                   uint64_t cols, uint64_t rows, uint64_t ld, uint32_t box_cols,
                   uint32_t box_rows, CUtensorMapSwizzle sw,
                   CUtensorMapL2promotion promo = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  const WgEncodeTiled fn = wg_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * (uint64_t)esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(m, dt, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, promo, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace
