// How fast the H100 runs the stream body's int8 mma.sync (m16n8k32 s8 →
// s32, kernels/csrc/stream_gmm.cuh sg_mma32) and its bf16 salient mma
// (m16n8k16): every warp issues independent mmas back to back into ACC
// accumulators, one block of 4-32 warps an SM.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o /tmp/mma_rate scripts/stream_probes/mma_rate.cu && /tmp/mma_rate
//
// One JSON line per configuration: µs, TOPS (TFLOPS), and int8 MACs a
// clock an SM at 1755 MHz.
#include <cstdio>
#include "../../smoothquant_tpu_torch/kernels/csrc/stream_gmm.cuh"

template <int ACC>
__global__ void imma_rate(int iters, int* sink) {
  int a[4] = {(int)threadIdx.x, 3, 5, 7};
  int d[ACC][4];
#pragma unroll
  for (int i = 0; i < ACC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = i + e;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) sg_mma32(d[i], a, it, i, d[i]);
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < ACC; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  if (s == 123456789) sink[0] = s;
}

__global__ void hmma_rate(int iters, int* sink) {
  int a[4] = {(int)threadIdx.x, 3, 5, 7};
  int b[2] = {1, 2};
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) mma_bf16(d[i], a, b);
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  if (s == 123456789.f) sink[0] = (int)s;
}

int main() {
  int* sink;
  cudaMalloc(&sink, 4);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  for (int warps : {4, 8, 16, 32}) {
    for (int acc : {4, 8, 16}) {
      auto launch = [&]() {
        if (acc == 4) imma_rate<4><<<sms, 32 * warps>>>(iters, sink);
        else if (acc == 8) imma_rate<8><<<sms, 32 * warps>>>(iters, sink);
        else imma_rate<16><<<sms, 32 * warps>>>(iters, sink);
      };
      launch();
      cudaEventRecord(e0);
      launch();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      if (cudaGetLastError() != cudaSuccess) {   // too many registers for the block
        printf("{\"probe\": \"imma\", \"warps_per_sm\": %d, \"acc\": %d, \"launched\": false}\n",
               warps, acc);
        continue;
      }
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      const double macs = (double)sms * warps * iters * acc * 16 * 8 * 32;
      printf("{\"probe\": \"imma\", \"warps_per_sm\": %d, \"acc\": %d, \"us\": %.1f, \"TOPS\": %.1f, \"mac_per_clk_sm_at_1755\": %.0f}\n",
             warps, acc, ms * 1e3, 2 * macs / ms / 1e9, macs / (ms * 1e-3) / sms / 1.755e9);
    }
  }
  for (int warps : {4, 8, 16}) {
    hmma_rate<<<sms, 32 * warps>>>(iters, sink);
    cudaEventRecord(e0);
    hmma_rate<<<sms, 32 * warps>>>(iters, sink);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    const double macs = (double)sms * warps * iters * 8 * 16 * 8 * 16;
    printf("{\"probe\": \"hmma_bf16\", \"warps_per_sm\": %d, \"us\": %.1f, \"TFLOPS\": %.1f}\n", warps, ms * 1e3, 2 * macs / ms / 1e9);
  }
  return 0;
}
