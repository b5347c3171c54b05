// Shared by flash_fwd.cu, flash_bwd.cu and ring_round.cu: the tiling, the
// reduction of one row's dot product over the threads that hold it, the
// row loads, the cp.async copies, and the 3xTF32 tensor-core products of
// the long-window kernels.
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

// --- cp.async -----------------------------------------------------------

// 16 bytes from global into shared memory, asynchronously, through L2;
// zeros where !in.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool in) {
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

// 4 bytes (one float of a [BH, T] row, whose offsets need not be 16-byte
// aligned), asynchronously; zero where !in.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}

// --- 3xTF32 on the tensor cores (mma.sync.m16n8k8) -------------------------

// The TF32 value nearest a float's bits (ties away from zero): the low 13
// mantissa bits rounded off, a carry running into the exponent.
__device__ __forceinline__ uint32_t tf32_rn(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32: hi is x rounded to TF32, lo the rest (exact in
// f32) rounded to TF32, so hi + lo carries about 22 of x's 24 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(__float_as_uint(x));
  lo = tf32_rn(__float_as_uint(x - __uint_as_float(hi)));
}

// x ~ hi + lo for 3xTF32: hi is x with its low 13 mantissa bits cleared (a
// TF32 value), lo = x - hi exactly, passed as it is; the tensor core reads
// the top 19 bits of a TF32 operand, so lo loses at most 2^-10 of itself,
// 2^-20 of x. Two instructions where rounding both halves (split_tf32)
// takes five (flash_bwd.cu, whose time shows them).
__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, the small products first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// big += a_hi * b_hi and small += a_lo * b_hi + a_hi * b_lo: two chains.
__device__ __forceinline__ void mma_3xtf32_split(float (&big)[4], float (&small)[4],
                                                 const uint32_t (&a_hi)[4],
                                                 const uint32_t (&a_lo)[4],
                                                 const uint32_t (&b_hi)[2],
                                                 const uint32_t (&b_lo)[2]) {
  mma_tf32(small, a_lo, b_hi);
  mma_tf32(big, a_hi, b_hi);
  mma_tf32(small, a_hi, b_lo);
}

}  // namespace flash
