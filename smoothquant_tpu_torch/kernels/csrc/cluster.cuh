// Thread-block cluster helpers: the cluster barrier, loads from and stores
// into another rank's shared memory (distributed shared memory, mapa +
// ld / st.shared::cluster) and the 1-D bulk copy into shared memory on an
// mbarrier.  The stream body
// (stream_gmm.cuh) reduces its split over K with them, K11's split body
// (split_decode.cuh) exchanges its tile maxima and partials, and K15b's kn
// GEMV (int8.cu) sums its ranks' partials.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void sg_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// f32 x4 at shared address `addr` of cluster rank `rank`
__device__ __forceinline__ float4 sg_ld_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// the cluster barrier in two halves: arrive (relaxed: orders nothing) at
// once, wait later — before the first access to another rank's shared
// memory, which must not come before every rank has started
__device__ __forceinline__ void cl_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// v (one f32, or four) into shared address `addr` of cluster rank `rank`;
// a cluster barrier (release / acquire) makes it visible there
__device__ __forceinline__ void cl_st_rank_f32(uint32_t addr, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}
__device__ __forceinline__ void cl_st_rank_f32x4(uint32_t addr, uint32_t rank, float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// one f32 at shared address `addr` of cluster rank `rank`
__device__ __forceinline__ float cl_ld_rank_f32(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// 1-D bulk copy global → this CTA's shared memory at dst, its bytes counted
// on the mbarrier at bar (addresses 16-byte aligned, bytes a multiple of 16)
__device__ __forceinline__ void cl_bulk_g2s(uint32_t dst, const void* src, int bytes,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace
