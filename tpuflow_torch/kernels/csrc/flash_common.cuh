// Shared by flash_fwd.cu and flash_bwd.cu: the tiling, the mask value and
// the reduction of one row's dot product over the threads that hold it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlock = 64;          // rows of a q tile and of a k/v tile
constexpr int kDimsPerThread = 16;  // head dimensions one thread holds
constexpr size_t kMaxSharedBytes = 232448;  // what one block may use on sm_90

// Threads that share one row: D / 16, so a row's q (or k), its accumulator
// and its output stay in 2 x 16 registers whatever D is.
template <int D>
constexpr int kThreadsPerRow = D / kDimsPerThread;

// Sum over the G neighbouring lanes that hold one row (G a power of 2 that
// divides 32); every lane of the warp must call it, with the same G.
template <int G>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One thread's part of a dot product: its 16 dimensions of a row held in
// registers against 16 dimensions of a row in shared memory (16-byte
// aligned).
__device__ __forceinline__ float dot16(const float (&a)[kDimsPerThread],
                                       const float* b) {
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < kDimsPerThread; e += 4) {
    const float4 w = *reinterpret_cast<const float4*>(b + e);
    acc = fmaf(a[e], w.x, acc);
    acc = fmaf(a[e + 1], w.y, acc);
    acc = fmaf(a[e + 2], w.z, acc);
    acc = fmaf(a[e + 3], w.w, acc);
  }
  return acc;
}

// Copy rows [r0, r0 + n) of a [T, D] slice into shared memory, [n, D].
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int tid,
                                           int nthreads) {
  const float* s = src + (int64_t)r0 * D;
  for (int i = tid; i < n * D; i += nthreads) dst[i] = s[i];
}

// Load 16 dimensions of row `row` of a [T, D] slice into registers (zeros
// for a row past the end).
template <int D>
__device__ __forceinline__ void load_row(float (&dst)[kDimsPerThread],
                                         const float* src, int row, bool ok,
                                         int d0) {
#pragma unroll
  for (int e = 0; e < kDimsPerThread; ++e)
    dst[e] = ok ? src[(int64_t)row * D + d0 + e] : 0.0f;
}

}  // namespace flash
