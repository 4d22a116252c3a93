// Native weight-packing library of the port: load-time quantization on the
// host.  The port's own copy of the JAX package's csrc/packlib.cpp: the same
// functions with the same loop bodies, but threaded with std::thread where
// the JAX library uses OpenMP (a g++ installed without libgomp cannot build
// -fopenmp code), so the library builds wherever g++ and libstdc++ do.
//
// Exposed via ctypes (utils/native.py builds this with g++ -O3 at first use
// into kernels/_build/).  All layouts match kernels/pack.py: weights
// (out, in) row-major; per-(row, group) scales; int4 values in int8
// containers, or two-per-byte nibbles in split-half order.
//
// Two group quantizers: group_quant is the JAX package's host rule (the
// scale an IEEE division by q_max, the codes a multiply by 1/scale), kept
// bit for bit; group_quant_rcp is the rule of the port's device pack,
// quant/core.group_quant_params (the scale a multiply by q_max's float32
// reciprocal, the codes an exact division by the scale), which the port's
// host pack runs so that it equals the device pack bit for bit.  Each row
// is computed by one thread, so the thread count changes no bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int g_threads = 1;

// body(i) for i in [0, n), the range split into contiguous chunks, one
// std::thread a chunk (the calling thread takes none).
template <class F>
void parallel_for(int64_t n, F body) {
  const int64_t t = std::min<int64_t>(g_threads, n);
  if (t <= 1) {
    for (int64_t i = 0; i < n; ++i) body(i);
    return;
  }
  const int64_t chunk = (n + t - 1) / t;
  std::vector<std::thread> pool;
  for (int64_t lo = 0; lo < n; lo += chunk) {
    const int64_t hi = std::min(n, lo + chunk);
    pool.emplace_back([lo, hi, &body] {
      for (int64_t i = lo; i < hi; ++i) body(i);
    });
  }
  for (auto& th : pool) th.join();
}

// Transpose a row-major (out, in) matrix to (in, out) in 64 × 64 tiles, one
// row of tiles a task.
template <class T>
void transpose_tiles(const T* src, int64_t out, int64_t in, T* dst) {
  const int64_t TILE = 64;
  parallel_for((out + TILE - 1) / TILE, [&](int64_t tb) {
    const int64_t rb = tb * TILE;
    const int64_t rmax = std::min(rb + TILE, out);
    for (int64_t cb = 0; cb < in; cb += TILE) {
      const int64_t cmax = std::min(cb + TILE, in);
      for (int64_t r = rb; r < rmax; ++r)
        for (int64_t c = cb; c < cmax; ++c)
          dst[c * out + r] = src[r * in + c];
    }
  });
}

}  // namespace

extern "C" {

// Threads of the parallel loops below (the caller passes torch's intra-op
// thread count).
void set_threads(int n) { g_threads = std::max(n, 1); }

// Permute columns of a row-major (out, in) fp32 matrix: dst[:, j] = src[:, perm[j]].
void permute_cols_f32(const float* src, const int32_t* perm,
                      int64_t out, int64_t in, float* dst) {
  parallel_for(out, [&](int64_t r) {
    const float* s = src + r * in;
    float* d = dst + r * in;
    for (int64_t j = 0; j < in; ++j) d[j] = s[perm[j]];
  });
}

// Symmetric absmax group quantization of a row-major (out, in) fp32 matrix.
// in must be a multiple of group.  Writes q (out, in) int8 values in
// [-q_max, q_max] and scales (out, in/group) fp32.
// scale = max(absmax, 1e-5) / q_max, round-half-to-even — the JAX
// package's host rule.
void group_quant(const float* w, int64_t out, int64_t in, int64_t group,
                 int n_bits, int8_t* q, float* scales) {
  const float q_max = (float)((1 << (n_bits - 1)) - 1);
  const int64_t n_groups = in / group;
  parallel_for(out, [&](int64_t r) {
    const float* wr = w + r * in;
    int8_t* qr = q + r * in;
    float* sr = scales + r * n_groups;
    for (int64_t g = 0; g < n_groups; ++g) {
      const float* wg = wr + g * group;
      float absmax = 0.f;
      for (int64_t c = 0; c < group; ++c)
        absmax = std::max(absmax, std::fabs(wg[c]));
      float scale = std::max(absmax, 1e-5f) / q_max;
      sr[g] = scale;
      const float inv = 1.0f / scale;
      int8_t* qg = qr + g * group;
      for (int64_t c = 0; c < group; ++c) {
        // round half to even, matching rintf under default rounding mode
        qg[c] = (int8_t)std::lrintf(wg[c] * inv);
      }
    }
  });
}

// Group quantization by the device pack's rule (quant/core.group_quant_params):
// scale = max(absmax, 1e-5) * float(1 / q_max), q = rint(w / scale), round
// half to even.  Same layouts as group_quant.
void group_quant_rcp(const float* w, int64_t out, int64_t in, int64_t group,
                     int n_bits, int8_t* q, float* scales) {
  const float q_max = (float)((1 << (n_bits - 1)) - 1);
  const float rcp = 1.0f / q_max;
  const int64_t n_groups = in / group;
  parallel_for(out, [&](int64_t r) {
    const float* wr = w + r * in;
    int8_t* qr = q + r * in;
    float* sr = scales + r * n_groups;
    for (int64_t g = 0; g < n_groups; ++g) {
      const float* wg = wr + g * group;
      float absmax = 0.f;
      for (int64_t c = 0; c < group; ++c)
        absmax = std::max(absmax, std::fabs(wg[c]));
      const float scale = std::max(absmax, 1e-5f) * rcp;
      sr[g] = scale;
      int8_t* qg = qr + g * group;
      for (int64_t c = 0; c < group; ++c) qg[c] = (int8_t)std::lrintf(wg[c] / scale);
    }
  });
}

// Split-half nibble packing: byte (r, o) of the packed (K/2, O) output holds
// channel r in the low nibble and channel r + K/2 in the high nibble of the
// TRANSPOSED (K, O) int8 input, each nibble biased by +8 (v in [-8, 7] →
// v + 8 in [0, 15]).
void pack_nibbles_split(const int8_t* qt, int64_t k, int64_t o, int8_t* packed) {
  const int64_t half = k / 2;
  parallel_for(half, [&](int64_t r) {
    const int8_t* lo = qt + r * o;
    const int8_t* hi = qt + (r + half) * o;
    int8_t* dst = packed + r * o;
    for (int64_t c = 0; c < o; ++c) {
      dst[c] = (int8_t)(((lo[c] + 8) & 0x0F) | (((hi[c] + 8) & 0x0F) << 4));
    }
  });
}

// Transpose a row-major (out, in) int8 matrix to (in, out).
void transpose_i8(const int8_t* src, int64_t out, int64_t in, int8_t* dst) {
  transpose_tiles(src, out, in, dst);
}

// Transpose a row-major (out, in) fp32 matrix to (in, out).
void transpose_f32(const float* src, int64_t out, int64_t in, float* dst) {
  transpose_tiles(src, out, in, dst);
}

}  // extern "C"
