// The int8 tensor-core tile machinery shared by K4 (int8_prefill.cu) and
// K15 (int8.cu): 128×128 output tiles, 8 warps of 64×32, k in 64-byte
// steps, operand tiles staged by cp.async 16-byte copies with the chunks of
// row r stored at chunk ^ ((r >> 1) & 3), so the mma.sync m16n8k32
// fragment loads fall on 32 distinct banks.
#pragma once

#include "common.cuh"

namespace s8 {

constexpr int BM = 128, BN = 128, BK = 64;   // tile rows, columns, k bytes per stage
constexpr int THREADS = 256;                 // 8 warps: 2 along rows × 4 along columns
constexpr int STAGES = 3;
constexpr int TILE_WORDS = BM * BK / 4;      // one operand tile: 128 rows × 16 words

// word `word` (0..15) of tile row `row`, 16-byte chunks swizzled
__device__ __forceinline__ int swz(int row, int word) {
  return row * 16 + ((((word >> 2) ^ (row >> 1)) & 3) << 2) + (word & 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 128 rows × 64 bytes of a row-major byte matrix (rows r0.., bytes k0.., row
// stride ld) into a swizzled tile; rows >= n_rows and bytes >= k_bytes read 0
__device__ __forceinline__ void load_tile(uint32_t* tile, const void* src, int r0, int n_rows,
                                          int k0, int k_bytes, size_t ld, int tid) {
  const char* base = static_cast<const char*>(src);
#pragma unroll
  for (int i = 0; i < BM * 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e >> 2, c = e & 3;
    const int row = r0 + r, kb = k0 + c * 16;
    const bool ok = row < n_rows && kb < k_bytes;
    cp_async16(tile + swz(r, c * 4), ok ? base + (size_t)row * ld + kb : base, ok);
  }
}

// A fragments (rows base.. base+15) and B fragments (columns base..base+7)
// of one k step (words kw..kw+7) from a swizzled tile
__device__ __forceinline__ void frag_a(int (&a)[4], const uint32_t* t, int base, int kw, int gid,
                                       int tig) {
  a[0] = (int)t[swz(base + gid, kw + tig)];
  a[1] = (int)t[swz(base + gid + 8, kw + tig)];
  a[2] = (int)t[swz(base + gid, kw + 4 + tig)];
  a[3] = (int)t[swz(base + gid + 8, kw + 4 + tig)];
}
__device__ __forceinline__ void frag_b(int (&b)[2], const uint32_t* t, int base, int kw, int gid,
                                       int tig) {
  b[0] = (int)t[swz(base + gid, kw + tig)];
  b[1] = (int)t[swz(base + gid, kw + 4 + tig)];
}

// acc[mt][nt] += the warp's 64×32 share of one 64-byte k step of the tiles
__device__ __forceinline__ void mma_step(int (&acc)[4][4][4], const uint32_t* at,
                                         const uint32_t* bt, int wm, int wn, int gid, int tig) {
#pragma unroll
  for (int kw = 0; kw < 16; kw += 8) {
    int a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) frag_a(a[mt], at, wm + 16 * mt, kw, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) frag_b(b[nt], bt, wn + 8 * nt, kw, gid, tig);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
  }
}

}  // namespace s8
