// What the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu) share: the tiled SIMT
// GEMM that computes a 64 x 64 output tile as sixteen 4 x 4 register tiles
// a warp, through reduction slices of 16 in shared memory, and the copy of
// a W_h slice into such a tile, with the map from the tile's columns to
// W_h's columns as a parameter.
//
// Layout of a slice in shared memory: the B operand (W_h rows, or dz rows
// for the weight gradient) is k-major, b[kk][c] for tile column c; thread
// (tx, ty) reads its four columns 4tx .. 4tx+3 as one float4. The A
// operand is k-major (a[kk][r], ATileK) or row-major (a[r][kk], ATileRow);
// thread (tx, ty) owns tile rows 4ty .. 4ty+3. Each output sums its kSlice
// products of a slice in order of kk, whatever the layout.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm {

constexpr int kTile = 64;          // output rows and columns a block
constexpr int kSlice = 16;         // reduction depth a pass through shared memory
constexpr int kGemmThreads = 256;  // 16 x 16, each a 4 x 4 register tile
constexpr int kPad = 4;            // keeps the float4 reads of a tile row aligned
constexpr int kLoads = kTile * kSlice / kGemmThreads;  // of each operand, a thread

using BTile = float[kSlice][kTile + kPad];
using ATileK = float[kSlice][kTile + kPad];   // a[kk][r]
using ATileRow = float[kTile][kSlice + kPad];  // a[r][kk]

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ar[i][q] = A[4ty + i][4 kk4 + q], for either layout of A.
__device__ __forceinline__ void a_frag(const ATileK& a, int kk4, int ty, float ar[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(&a[4 * kk4 + q][4 * ty]);
    ar[0][q] = v.x;
    ar[1][q] = v.y;
    ar[2][q] = v.z;
    ar[3][q] = v.w;
  }
}

__device__ __forceinline__ void a_frag(const ATileRow& a, int kk4, int ty, float ar[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(&a[4 * ty + i][4 * kk4]);
    ar[i][0] = v.x;
    ar[i][1] = v.y;
    ar[i][2] = v.z;
    ar[i][3] = v.w;
  }
}

// One pass over a slice: acc[i][j] += A[4ty+i][kk] * B[kk][4tx+j], kk in order.
template <class ATile>
__device__ __forceinline__ void mma_slice(const ATile& a, const BTile& b, int tx, int ty,
                                          float acc[4][4]) {
#pragma unroll
  for (int kk4 = 0; kk4 < kSlice / 4; ++kk4) {
    float ar[4][4];
    a_frag(a, kk4, ty, ar);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(&b[4 * kk4 + q][4 * tx]);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i][q], br[j], acc[i][j]);
    }
  }
}

// 4 bytes from global into shared memory, asynchronously, through L1
// (read-only data only); zeros where !in.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}

// 16 bytes, asynchronously, through L2 only (never a stale L1 line); zeros
// where !in.
__device__ __forceinline__ void cp_async_16_cg(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows k0 .. k0+kSlice-1 of W_h [H, 4H] into b: b[kk][c] = W_h[k0+kk,
// col(c)], zero where the row is past H or col(c) < 0 (outside W_h). With
// kAsync the copies are cp.async (committed by the caller), else plain
// loads and stores. Thread tid copies elements tid, tid + 256, ... of the
// slice, c fastest. W_h is indexed in 32 bits: the callers take H only
// while 4 H^2 < 2^31.
template <bool kAsync, class ColOf>
__device__ __forceinline__ void load_w_slice(BTile& b, const float* wh, int k0, int H,
                                             ColOf col, int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = tid + q * kGemmThreads;
    const int kb = e / kTile, c = e & (kTile - 1);
    const int k = k0 + kb, n = col(c);
    const bool in = k < H && n >= 0;
    if constexpr (kAsync) {
      cp_async_4(&b[kb][c], in ? wh + k * 4 * H + n : wh, in);
    } else {
      b[kb][c] = in ? wh[k * 4 * H + n] : 0.0f;
    }
  }
}

}  // namespace lstm
