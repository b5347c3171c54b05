// Causal flash-attention forward on Hopper (sm_90a), float32.
//
// Replaces tpuflow/kernels/attention.py::_fwd_kernel, the Pallas TPU kernel
// that tpuflow/kernels/attention.py::_fwd launches with pl.pallas_call for
// flash_attention. Same function: for q, k, v [BH, T, D] (heads folded into
// the batch axis) and each row t,
//     s_j  = scale * q_t . k_j            for j <= t (causal)
//     o_t  = sum_j softmax(s)_j v_j,      lse_t = log sum_j exp(s_j)
// by the online softmax over tiles of 64 keys: per tile, m' = max(m, max s),
// l = l * exp(m - m') + sum exp(s - m'), acc = acc * exp(m - m') +
// exp(s - m') @ V, and at the end o = acc / l, lse = m + log(l), with l = 0
// read as 1 (the reference's l_safe). A masked score is the reference's
// finite -1e30 and its probability is 0, so no inf or NaN can arise.
//
// What bounds it on an H100: per head it reads q, k, v once and writes o and
// lse (about 16 * T * D bytes) and does 4 * D operations for each of the
// T(T+1)/2 causal pairs. At the model's windows (T = 24, D = 16) the bytes
// bound it; from T of about 160 the operations do (f32 on the CUDA cores),
// and on the tensor cores the exponentials (16 a clock an SM).
//
// Two kernels, chosen by T:
//
// 1. T <= 64 (the model's T = 24, in training and serving): the whole
//    window is one tile, and a slice (one bh) is T rows of D / 16 threads.
//    A block of about 256 threads takes whole slices, S = 256 / (T D/16) of
//    them, which are one contiguous span of [BH, T, D]: k and v arrive in
//    shared memory by 16-byte cp.async copies, all in flight at once (each
//    slice padded by 4 floats against bank conflicts), q meanwhile by
//    16-byte loads into registers. A thread holds 16
//    dimensions of its row's q and accumulator, and all T of the row's
//    scores in registers: one pass for the scores and their max, one for
//    the exponentials and P V, with no round trip through shared memory;
//    o is stored as float4. Where BH is small (the train step's 80) a block
//    takes fewer slices, down to one, so that the grid still spreads over
//    the SMs. The old design gave one block to each 64-row tile, so at
//    T = 24 40 of its 64 rows were masked.
// 2. T > 64: a block of 4 warps per (bh, 64-row q tile), the heaviest q
//    tiles first, K/V tiles of 64 keys up to the diagonal double-buffered
//    by cp.async (rows past T zero-filled). Q K^T and P V run on the tensor
//    cores as mma.sync.m16n8k8 in TF32, each f32 operand split into a TF32
//    high part and the TF32 of its residual, three products a tile
//    ("3xTF32": hi*hi + hi*lo + lo*hi), which keeps about f32 accuracy
//    (plain TF32 keeps 3 digits). Each warp owns 16 q rows; its scores and
//    probabilities stay in the mma's registers, and in the diagonal tile it
//    skips the 8-key groups past its last row. The key order inside each
//    k8 step is permuted (logical k = i holds key 2i, k = i + 4 key 2i + 1)
//    so that the score fragment is the probability fragment of P V as it
//    stands, and both fragments load as float2. The split is integer
//    rounding and a subtraction, and only the diagonal tile is masked. P V of a tile
//    starts from zero, its small products and its large ones in separate
//    accumulators, and is added into the running accumulator by f32 FMAs,
//    so each chain of tensor-core sums stays short.
//
// Both kernels take q scaled by scale * log2(e), so the softmax runs on
// exp2 (one MUFU.EX2 each) and lse = m * ln(2) + log(l).

#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::kBlock;
using flash::kDimsPerThread;
constexpr float kNeg = -1e30f;  // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSMs = 132;  // streaming multiprocessors, H100 SXM

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

// --- 1. short windows ------------------------------------------------------

constexpr int kShortT = 64;       // the largest T the short kernel takes
constexpr int kShortThreads = 256;  // what a block aims at
constexpr int kShortMaxThreads = kShortT * 128 / kDimsPerThread;  // one slice

// Up to 32 keys a block has at most kShortThreads threads; its registers
// are capped so that three blocks fit on an SM.
template <int D, int kT>
__global__ void __launch_bounds__(kT > 32 ? kShortMaxThreads : kShortThreads,
                                  kT > 32 ? 1 : 3)
    flash_fwd_short_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int BH, int T, int S,
                           float qscale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  extern __shared__ float4 smem4[];
  const int span = T * D;      // floats of one slice
  const int stride = span + 4;  // a slice in shared memory
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + S * stride;

  const int tid = threadIdx.x;
  const int64_t bh0 = (int64_t)blockIdx.x * S;
  const int n_sl = BH - bh0 < S ? (int)(BH - bh0) : S;
  {
    // All of the block's copies in flight at once.
    const int span4 = span / 4;
    const float* kb = k + bh0 * span;
    const float* vb = v + bh0 * span;
    for (int i = tid; i < n_sl * span4; i += blockDim.x) {
      const int sl = i / span4;
      const int at = sl * stride + 4 * (i - sl * span4);
      cp_async_16(k_s + at, kb + 4 * i, true);
      cp_async_16(v_s + at, vb + 4 * i, true);
    }
    cp_async_commit();
  }
  // This thread's slice, row and dimensions. Threads of slices past BH (in
  // the last block) compute on slice 0 and store nothing.
  const int per_slice = T * G;
  int sl = tid / per_slice;
  const int r = (tid - sl * per_slice) / G;
  const int d0 = (tid % G) * E;
  const bool active = sl < n_sl;
  if (!active) sl = 0;
  const int64_t row = (bh0 + sl) * T + r;

  float qr[E];
  {
    const float4* src = reinterpret_cast<const float4*>(q + row * D + d0);
#pragma unroll
    for (int e = 0; e < E / 4; ++e) {
      const float4 x = src[e];
      qr[4 * e] = x.x * qscale;
      qr[4 * e + 1] = x.y * qscale;
      qr[4 * e + 2] = x.z * qscale;
      qr[4 * e + 3] = x.w * qscale;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const float* ks = k_s + sl * stride + d0;
  const float* vs = v_s + sl * stride + d0;

  // Scores in log2 units (the same trip count in every thread: T is the
  // block's) and their max.
  float s[kT];
  float m = kNeg;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (j < T) {
      const float dot = flash::row_sum<G>(flash::dot16(qr, ks + j * D));
      s[j] = j <= r ? dot : kNeg;
      m = fmaxf(m, s[j]);
    }
  }
  // Probabilities and P V.
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  float l = 0.0f;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (j < T && j <= r) {
      const float p = exp2f(s[j] - m);
      l += p;
      const float* vj = vs + j * D;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 w = *reinterpret_cast<const float4*>(vj + e);
        acc[e] = fmaf(p, w.x, acc[e]);
        acc[e + 1] = fmaf(p, w.y, acc[e + 1]);
        acc[e + 2] = fmaf(p, w.z, acc[e + 2]);
        acc[e + 3] = fmaf(p, w.w, acc[e + 3]);
      }
    }
  }
  if (!active) return;
  const float l_safe = l == 0.0f ? 1.0f : l;
  float4* out = reinterpret_cast<float4*>(o + row * D + d0);
#pragma unroll
  for (int e = 0; e < E / 4; ++e)
    out[e] = make_float4(acc[4 * e] / l_safe, acc[4 * e + 1] / l_safe,
                         acc[4 * e + 2] / l_safe, acc[4 * e + 3] / l_safe);
  if (d0 == 0) lse[row] = m * kLn2 + logf(l_safe);
}

template <int D, int kT>
int launch_short(const float* q, const float* k, const float* v, float* o,
                 float* lse, int BH, int T, float scale, cudaStream_t stream) {
  // Slices a block: as many as fill kShortThreads, but no more than leave
  // two blocks for each SM.
  const int per_slice = T * flash::kThreadsPerRow<D>;
  const int fill = per_slice >= kShortThreads ? 1 : kShortThreads / per_slice;
  const int spread = BH / (2 * kSMs) > 1 ? BH / (2 * kSMs) : 1;
  const int S = fill < spread ? fill : spread;
  const size_t smem = sizeof(float) * 2 * (size_t)S * (T * D + 4);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_short_kernel<D, kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((BH + S - 1) / S);
  flash_fwd_short_kernel<D, kT><<<blocks, S * per_slice, smem, stream>>>(
      q, k, v, o, lse, BH, T, S, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_short(const float* q, const float* k, const float* v, float* o,
                 float* lse, int BH, int T, float scale, cudaStream_t stream) {
  if (T <= 16) return launch_short<D, 16>(q, k, v, o, lse, BH, T, scale, stream);
  if (T <= 32) return launch_short<D, 32>(q, k, v, o, lse, BH, T, scale, stream);
  return launch_short<D, 64>(q, k, v, o, lse, BH, T, scale, stream);
}

// --- 2. long windows: 3xTF32 on the tensor cores ---------------------------

constexpr int kWarps = 4;  // 16 q rows each
constexpr int kTcThreads = 32 * kWarps;

// The padded row strides (floats) of the Q, K and V tiles in shared memory,
// chosen so that each warp's fragment loads hit 32 distinct banks: Q and K
// are read as float2 at (row g, column 2i), V as floats at (row 2i, column g).
template <int D>
constexpr int kQStride = D + 8;
template <int D>
constexpr int kKStride = D + 8;
template <int D>
constexpr int kVStride = D + 4;

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(float) * kBlock * (kQStride<D> + 2 * (kKStride<D> + kVStride<D>));
}

// Rows r0 .. r0 + 63 of a [T, D] slice into a tile of the given stride,
// zeros past T.
template <int D, int kStride>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int r0,
                                           int T, int tid) {
  constexpr int C4 = D / 4;
  for (int i = tid; i < kBlock * C4; i += kTcThreads) {
    const int r = i / C4, c = i - r * C4;
    const bool in = r0 + r < T;
    cp_async_16(dst + r * kStride + 4 * c, in ? src + (int64_t)(r0 + r) * D + 4 * c : src,
                in);
  }
}

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts of mma.m16n8k8 (TF32), lane = 4 g + i: A holds (row g,
// k i), (g + 8, i), (g, i + 4), (g + 8, i + 4); B holds (k i, column g),
// (k i + 4, g); C holds (row g, columns 2i, 2i + 1) and (g + 8, the same).
// At D = 16 (the model's head dim) registers are capped so that five
// blocks fit on an SM; at D = 32 the same cap spills.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 16 ? 5 : 1)
    flash_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int BH, int T, int n_qt,
                        float qscale) {
  constexpr int QS = kQStride<D>, KS = kKStride<D>, VS = kVStride<D>;
  constexpr int ND = D / 8;  // n8 tiles of the output, k8 steps of Q K^T
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [64, QS]
  float* k_s = q_s + kBlock * QS;                 // [2][64, KS]
  float* v_s = k_s + 2 * kBlock * KS;             // [2][64, VS]

  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heaviest tiles first
  const int64_t bh = blockIdx.x % BH;
  const int q0 = qt * kBlock;
  const float* qb = q + bh * T * D;
  const float* kb = k + bh * T * D;
  const float* vb = v + bh * T * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wrow = warp * 16;           // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const int last_row = q0 + wrow + 15;  // the warp's last row

  stage_tile<D, QS>(q_s, qb, q0, T, tid);
  stage_tile<D, KS>(k_s, kb, 0, T, tid);
  stage_tile<D, VS>(v_s, vb, 0, T, tid);
  cp_async_commit();

  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int n_kt = qt + 1;  // causal: key tiles up to the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      stage_tile<D, KS>(k_s + nb * kBlock * KS, kb, (kt + 1) * kBlock, T, tid);
      stage_tile<D, VS>(v_s + nb * kBlock * VS, vb, (kt + 1) * kBlock, T, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = k_s + (kt & 1) * kBlock * KS;
    const float* vs = v_s + (kt & 1) * kBlock * VS;
    const int k0 = kt * kBlock;
    // The 8-key groups any row of this warp can see (all but in the
    // diagonal tile).
    const int n_nt = min(8, (last_row - k0) / 8 + 1);

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const float2 x = *reinterpret_cast<const float2*>(q_s + (wrow + g) * QS + kk * 8 + 2 * i4);
      const float2 y =
          *reinterpret_cast<const float2*>(q_s + (wrow + g + 8) * QS + kk * 8 + 2 * i4);
      uint32_t a_hi[4], a_lo[4];
      split_tf32(x.x * qscale, a_hi[0], a_lo[0]);
      split_tf32(y.x * qscale, a_hi[1], a_lo[1]);
      split_tf32(x.y * qscale, a_hi[2], a_lo[2]);
      split_tf32(y.y * qscale, a_hi[3], a_lo[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < n_nt) {
          const float2 w = *reinterpret_cast<const float2*>(ks + (nt * 8 + g) * KS + kk * 8 + 2 * i4);
          uint32_t b_hi[2], b_lo[2];
          split_tf32(w.x, b_hi[0], b_lo[0]);
          split_tf32(w.y, b_hi[1], b_lo[1]);
          mma_3xtf32(s[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }

    // Mask the diagonal tile (keys past a row, groups past the warp; every
    // key of an earlier tile is allowed), the online softmax update in
    // log2 units, and the probabilities in place of the scores.
    if (kt == qt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * i4 + (e & 1);
          if (!(nt < n_nt && key <= rows[e >> 1])) s[nt][e] = kNeg;
        }
    }
    float m_tile[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[nt][e]);
    float corr[2], l_tile[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(m_tile[h]));
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A masked score is -1e30 below a finite max: exp2 gives exactly 0.
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        l_tile[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + l_tile[h];

    // P V: P's fragment for key group kk is s[kk] permuted (logical k = i
    // is key 2i, k = i + 4 key 2i + 1); V's rows are read in that order.
    // Up to D = 32 the key groups are the outer loop, each group's P split
    // once and its products spread over the ND accumulators; wider heads
    // keep the split P whole and take one n8 tile at a time, so that their
    // accumulators stay in registers.
    if constexpr (ND <= 4) {
      float big[ND][4] = {}, small[ND][4] = {};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < n_nt) {
          uint32_t a_hi[4], a_lo[4];
          split_tf32(s[kk][0], a_hi[0], a_lo[0]);
          split_tf32(s[kk][2], a_hi[1], a_lo[1]);
          split_tf32(s[kk][1], a_hi[2], a_lo[2]);
          split_tf32(s[kk][3], a_hi[3], a_lo[3]);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const float* vr = vs + (kk * 8 + 2 * i4) * VS + n * 8 + g;
            uint32_t b_hi[2], b_lo[2];
            split_tf32(vr[0], b_hi[0], b_lo[0]);
            split_tf32(vr[VS], b_hi[1], b_lo[1]);
            mma_3xtf32_split(big[n], small[n], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], corr[e >> 1], big[n][e] + small[n][e]);
    } else {
      uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        split_tf32(s[kk][0], p_hi[kk][0], p_lo[kk][0]);
        split_tf32(s[kk][2], p_hi[kk][1], p_lo[kk][1]);
        split_tf32(s[kk][1], p_hi[kk][2], p_lo[kk][2]);
        split_tf32(s[kk][3], p_hi[kk][3], p_lo[kk][3]);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float big[4] = {0.0f, 0.0f, 0.0f, 0.0f}, small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk < n_nt) {
            const float* vr = vs + (kk * 8 + 2 * i4) * VS + n * 8 + g;
            uint32_t b_hi[2], b_lo[2];
            split_tf32(vr[0], b_hi[0], b_lo[0]);
            split_tf32(vr[VS], b_hi[1], b_lo[1]);
            mma_3xtf32_split(big, small, p_hi[kk], p_lo[kk], b_hi, b_lo);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], corr[e >> 1], big[e] + small[e]);
      }
    }
    __syncthreads();  // the tile is consumed before it is staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= T) continue;
    const float lt = quad_sum(l[h]);  // the quad's lanes hold one row
    const float l_safe = lt == 0.0f ? 1.0f : lt;
    float* out = o + (bh * T + rows[h]) * D + 2 * i4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[n][2 * h] / l_safe, acc[n][2 * h + 1] / l_safe);
    if (i4 == 0) lse[bh * T + rows[h]] = m[h] * kLn2 + logf(l_safe);
  }
}

template <int D>
int launch_tc(const float* q, const float* k, const float* v, float* o, float* lse,
              int BH, int T, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static_assert(smem <= flash::kMaxSharedBytes, "tiles exceed shared memory");
  const int n_qt = (T + kBlock - 1) / kBlock;
  if ((int64_t)BH * n_qt > 2147483647) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tc_kernel<D><<<(unsigned)(BH * n_qt), kTcThreads, smem, stream>>>(
      q, k, v, o, lse, BH, T, n_qt, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, float* lse,
           int BH, int T, float scale, cudaStream_t stream) {
  if (T <= kShortT) return launch_short<D>(q, k, v, o, lse, BH, T, scale, stream);
  return launch_tc<D>(q, k, v, o, lse, BH, T, scale, stream);
}

}  // namespace

extern "C" {

// o [BH, T, D] and lse [BH, T] from q, k, v [BH, T, D], all contiguous f32
// on one device, 16-byte aligned; D in {16, 32, 64, 128}. Returns 0, or the
// CUDA error code.
int tpuflow_flash_fwd_f32(const float* q, const float* k, const float* v,
                          float* o, float* lse, int BH, int T, int D,
                          float scale, void* stream) {
  if (BH <= 0 || T <= 0) return 0;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, BH, T, scale, s);
    case 32: return launch<32>(q, k, v, o, lse, BH, T, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, BH, T, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, BH, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
