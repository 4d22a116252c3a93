// How fast the H100 streams a weight read in column strips, as the stream
// body (kernels/csrc/stream_gmm.cuh) reads it: a ring of TMA boxes on
// mbarriers (box width W bytes × H rows, R slots, the K range split over
// `ksplit` blocks a strip, consumers that only wait and free each slot)
// against plain 16-byte loads, over eight (3904, 11008) u8 matrices cycled
// so every read is cold in L2 (the quick start's gate_proj in int8).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o /tmp/tma_ring_bw scripts/stream_probes/tma_ring_bw.cu && /tmp/tma_ring_bw
//
// One JSON line per configuration: µs a pass and TB/s.
#include <cstdio>
#include <vector>
#include "../../smoothquant_tpu_torch/kernels/csrc/wg_gemm.cuh"

__global__ void ring_probe(const __grid_constant__ CUtensorMap map, int K, int O, int W, int H,
                           int R, int ksplit, int slot_bytes, int* sink) {
  extern __shared__ __align__(1024) char smem[];
  const int tiles = (O + W - 1) / W;
  const int b = blockIdx.x;
  const int tile = b / ksplit, rank = b % ksplit;
  if (tile >= tiles) return;
  const int stages = (K + H - 1) / H;
  const int t0 = rank * stages / ksplit, t1 = (rank + 1) * stages / ksplit;
  uint32_t bars = smem_u32(smem + R * slot_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (R + s), 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    if (lane == 0) {
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, slot = i % R;
        if (i >= R) mbar_wait(bars + 8 * (R + slot), (i / R - 1) & 1);
        const uint32_t dst = smem_u32(smem + slot * slot_bytes);
        mbar_expect_tx(bars + 8 * slot, slot_bytes);
        for (int c = 0; c < W; c += 128) tma_2d(dst + c * H, map, bars + 8 * slot, tile * W + c, t * H);
      }
    }
  } else {
    int acc = 0;
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, slot = i % R;
      mbar_wait(bars + 8 * slot, (i / R) & 1);
      acc += *reinterpret_cast<const int*>(smem + slot * slot_bytes + lane * 4);
      __syncwarp();
      if (lane == 0) asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bars + 8 * (R + slot)) : "memory");
    }
    if (acc == 12345) sink[0] = acc;
  }
}

// plain loads: each warp takes a 128-column strip over a K range, 16 bytes a
// lane (8 lanes a row, 4 rows a warp load), U loads in flight
template <int U>
__global__ void ldg_strip(const int8_t* __restrict__ w, int K, int O, int ksplit, int* sink) {
  const int warps_per_block = blockDim.x / 32;
  const int gw = blockIdx.x * warps_per_block + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int tiles = O / 128;
  const int tile = gw / ksplit, rank = gw % ksplit;
  if (tile >= tiles) return;
  const int r0 = rank * K / ksplit, r1 = (rank + 1) * K / ksplit;
  int4 acc = make_int4(0, 0, 0, 0);
  const int8_t* base = w + (size_t)tile * 128 + (lane & 7) * 16;
  for (int r = r0 + (lane >> 3); r < r1; r += 4 * U) {
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + 4 * u;
      v[u] = rr < r1 ? __ldg(reinterpret_cast<const int4*>(base + (size_t)rr * O)) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc.x ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc.x == 12345) sink[0] = acc.x;
}

__global__ void ldg_flat(const int4* __restrict__ w, size_t n, int* sink) {
  int acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = __ldg(w + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 12345) sink[0] = acc;
}

int main() {
  const int K = 3904, O = 11008, COPIES = 8;
  const size_t bytes = (size_t)K * O;
  std::vector<int8_t*> ws(COPIES);
  for (auto& p : ws) {
    cudaMalloc(&p, bytes);
    cudaMemset(p, 1, bytes);
  }
  int* sink;
  cudaMalloc(&sink, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  auto timeit = [&](auto launch) {
    for (int i = 0; i < 3; ++i) launch(i);
    cudaEventRecord(e0);
    const int reps = 40;
    for (int i = 0; i < reps; ++i) launch(i);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    return ms / reps;
  };
  // flat
  for (int bps : {4, 8, 16}) {
    float ms = timeit([&](int i) { ldg_flat<<<sms * bps, 256>>>((const int4*)ws[i % COPIES], bytes / 16, sink); });
    printf("{\"probe\": \"ldg_flat\", \"blocks_per_sm\": %d, \"us\": %.2f, \"TBps\": %.3f}\n", bps, ms * 1e3, bytes / ms / 1e9);
  }
  for (int ks : {1, 2, 4, 8, 16}) {
    for (int U : {4, 8}) {
      const int warps = (O / 128) * ks;
      float ms = timeit([&](int i) {
        if (U == 4) ldg_strip<4><<<(warps + 7) / 8, 256>>>(ws[i % COPIES], K, O, ks, sink);
        else ldg_strip<8><<<(warps + 7) / 8, 256>>>(ws[i % COPIES], K, O, ks, sink);
      });
      printf("{\"probe\": \"ldg_strip\", \"ksplit\": %d, \"U\": %d, \"warps\": %d, \"us\": %.2f, \"TBps\": %.3f}\n", ks, U, warps, ms * 1e3, bytes / ms / 1e9);
    }
  }
  struct Cfg { int W, H, R; };
  for (Cfg c : {Cfg{128, 128, 4}, Cfg{128, 64, 4}, Cfg{128, 32, 8}, Cfg{128, 128, 2}, Cfg{128, 128, 8},
                Cfg{256, 64, 4}, Cfg{256, 128, 4}, Cfg{512, 32, 4}, Cfg{128, 256, 4}}) {
    const int slot = c.W * c.H;
    const int smem = c.R * slot + 16 * c.R;
    cudaFuncSetAttribute(ring_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    std::vector<CUtensorMap> maps(COPIES);
    bool ok = true;
    for (int i = 0; i < COPIES; ++i)
      ok &= wg_map(&maps[i], ws[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, K, O, 128, c.H,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (!ok) { printf("{\"probe\": \"ring\", \"W\": %d, \"H\": %d, \"error\": \"map\"}\n", c.W, c.H); continue; }
    const int tiles = (O + c.W - 1) / c.W;
    for (int ks : {1, 2, 4, 8}) {
      float ms = timeit([&](int i) { ring_probe<<<tiles * ks, 64, smem>>>(maps[i % COPIES], K, O, c.W, c.H, c.R, ks, slot, sink); });
      cudaError_t err = cudaGetLastError();
      printf("{\"probe\": \"ring\", \"W\": %d, \"H\": %d, \"R\": %d, \"ksplit\": %d, \"blocks\": %d, \"smem\": %d, \"us\": %.2f, \"TBps\": %.3f, \"err\": %d}\n",
             c.W, c.H, c.R, ks, tiles * ks, smem, ms * 1e3, bytes / ms / 1e9, (int)err);
    }
  }
  return 0;
}
