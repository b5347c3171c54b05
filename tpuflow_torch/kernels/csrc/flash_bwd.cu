// Causal flash-attention backward on Hopper (sm_90a), float32: dQ, and dK
// with dV.
//
// Replaces the two Pallas TPU kernels that tpuflow/kernels/attention.py::_bwd
// launches with pl.pallas_call for the custom VJP of flash_attention:
// - flash_dq replaces _dq_kernel:
//     dq_t = scale * sum_{j <= t} dS_tj k_j
// - flash_dkv replaces _dkv_kernel:
//     dk_j = scale * sum_{t >= j} dS_tj q_t,   dv_j = sum_{t >= j} P_tj do_t
// with the probabilities recomputed from the forward's log-sum-exp,
//     P_tj = exp(scale * q_t . k_j - lse_t),
//     dS_tj = P_tj * (do_t . v_j - delta_t),   delta_t = do_t . o_t,
// where delta comes from the caller (the JAX package also computes it
// outside its kernels). A masked pair (j > t) has P = 0, so no exp of a
// masked score and no inf * 0 can reach dS. lse arrives in natural log; the
// kernels take P = exp2(s * scale * log2(e) - lse * log2(e)), one FMA and
// one MUFU.EX2 a pair, and apply the scale of dq and dk once at the end.
//
// What bounds them on an H100: each reads q, k, v, do, lse and delta once
// and writes its gradients, and does 6 * D (dQ) or 8 * D (dK/dV) operations
// and one exponential for each of the T(T+1)/2 causal pairs of a head. At
// the model's windows (T = 24, D = 16) the bytes bound both; at T = 1024
// the tensor cores in 3xTF32 (three TF32 products for each f32 one) do.
//
// Two designs for each kernel, chosen by T (as in flash_fwd.cu):
//
// 1. T <= 64 (the model's T = 24, in training): the whole window is one
//    tile, and a slice (one bh) is T rows of D / 16 threads, each holding
//    16 dimensions of its row. A block of about 256 threads takes whole
//    slices, S = 256 / (T D/16) of them, which are one contiguous span of
//    [BH, T, D]; where BH is small (the train step's 80) a block takes
//    fewer, down to one, so that the grid still spreads over the SMs.
//    - flash_dq: a thread group a q row, q, do and the dq accumulator in
//      registers; the slices' K and V arrive in shared memory by 16-byte
//      cp.async copies, all in flight at once (each slice padded by 4
//      floats against bank conflicts); the row walks keys 0..t.
//    - flash_dkv: a thread group a key row, k, v and the dk and dv
//      accumulators in registers; the slices' Q and dO by cp.async, their
//      lse and delta by plain loads; the row walks queries j..T-1.
//    Each warp's loop runs to its own last (dq) or from its own first
//    (dkv) row, so no masked row is computed. The old design gave one
//    block to each 64-row tile: at T = 24 40 of its 64 rows were masked.
// 2. T > 64: a block of 4 warps per (bh, 64-row tile), each warp 16 rows,
//    the products on the tensor cores as mma.sync.m16n8k8 in 3xTF32: each
//    f32 operand is split into a TF32 high part (its low 13 mantissa bits
//    cleared) and the exact rest, which the tensor core reads to TF32, and
//    hi*hi + hi*lo + lo*hi keeps the gradients within a few 1e-6 of f32
//    (normwise). That split is two instructions; rounding both halves, as
//    flash_fwd.cu does, is five and took 10-16% longer here. Each
//    exponential is one ex2.approx. The streamed
//    tiles are double-buffered by cp.async, rows past T zero-filled; only
//    the diagonal tile is masked, and there each warp skips the 8-row
//    groups that none of its rows can see. Every tile sits in shared memory
//    at a row stride of D + 4 floats, so that both ways a tile is read (16
//    rows by 8 columns, and 8 rows by 8 columns with the row order
//    permuted) hit 32 distinct banks. The second product of each kernel
//    contracts over the rows of a score tile: the order of those rows
//    inside each k8 step is permuted (logical k = i is row 2i, k = i + 4
//    row 2i + 1), so that a score fragment is that product's A operand as
//    it stands.
//    - flash_dq: per q tile, the heaviest tiles first, per K/V tile up to
//      the diagonal: S = Q K^T, P = exp2(..), dP = dO V^T, dS = P (dP -
//      delta), dQ += dS K.
//    - flash_dkv: per k tile, the heaviest (first) tiles first, per Q/dO
//      tile from the diagonal to the end (their lse and delta staged
//      beside them): S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
//      are fragments of the warp's own key rows; dV += P^T dO and dK +=
//      dS^T Q.
//    A tile's keys (queries) go in passes of 4 groups of 8 (8 at D = 32,
//    2 at D = 128), whose scores stay in registers; the second product of
//    a pass starts from zero and is added into the running accumulator by
//    f32 adds, so each chain of tensor-core sums stays short. Registers
//    are capped for 5 blocks an SM at D = 16 and 3 at D = 32; at D = 64
//    and 128 a block takes up to 255 (no spills at any D).
//
// Each block owns its output rows: no atomics, and the same gradients from
// run to run; blocks run in any order and nothing carries over between
// them.

#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::cp_async_16;
using flash::cp_async_4;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::kBlock;
using flash::kDimsPerThread;
using flash::mma_3xtf32;
using flash::split_tf32_rz;

constexpr float kLog2e = 1.4426950408889634f;
// lse (log2 units) of a query row past T: exp2(s - kFar) is 0.
constexpr float kFar = 1e30f;
constexpr int kSMs = 132;  // streaming multiprocessors, H100 SXM

// 2^x by one MUFU.EX2 (relative error about 2^-22; results below 2^-126
// flush to 0, which a probability may).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- 1. short windows ------------------------------------------------------

constexpr int kShortT = 64;         // the largest T the short kernels take
constexpr int kShortThreads = 256;  // what a block aims at
constexpr int kShortMaxThreads = kShortT * 128 / kDimsPerThread;  // one slice

// Slices a block: as many as fill kShortThreads, but no more than leave two
// blocks for each SM.
int short_slices(int BH, int per_slice) {
  const int fill = per_slice >= kShortThreads ? 1 : kShortThreads / per_slice;
  const int spread = BH / (2 * kSMs) > 1 ? BH / (2 * kSMs) : 1;
  return fill < spread ? fill : spread;
}

// Slices bh0 .. bh0 + n_sl - 1 of two [BH, T, D] tensors (span = T D floats
// each) into shared memory at a slice stride of span + 4, all in flight.
__device__ __forceinline__ void stage_slices(float* a_s, float* b_s, const float* a,
                                             const float* b, int64_t bh0, int n_sl,
                                             int span, int tid) {
  const int span4 = span / 4, stride = span + 4;
  const float* ab = a + bh0 * span;
  const float* bb = b + bh0 * span;
  for (int i = tid; i < n_sl * span4; i += blockDim.x) {
    const int sl = i / span4;
    const int at = sl * stride + 4 * (i - sl * span4);
    cp_async_16(a_s + at, ab + 4 * i, true);
    cp_async_16(b_s + at, bb + 4 * i, true);
  }
}

// 16 floats from global memory (16-byte aligned) into registers.
__device__ __forceinline__ void load16(float (&dst)[kDimsPerThread], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int e = 0; e < kDimsPerThread / 4; ++e) {
    const float4 x = s4[e];
    dst[4 * e] = x.x;
    dst[4 * e + 1] = x.y;
    dst[4 * e + 2] = x.z;
    dst[4 * e + 3] = x.w;
  }
}

// acc += w * row (16 floats of a row in shared memory, 16-byte aligned).
__device__ __forceinline__ void axpy16(float (&acc)[kDimsPerThread], float w, const float* row) {
#pragma unroll
  for (int e = 0; e < kDimsPerThread; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + e);
    acc[e] = fmaf(w, x.x, acc[e]);
    acc[e + 1] = fmaf(w, x.y, acc[e + 1]);
    acc[e + 2] = fmaf(w, x.z, acc[e + 2]);
    acc[e + 3] = fmaf(w, x.w, acc[e + 3]);
  }
}

__device__ __forceinline__ void store16(float* dst, const float (&src)[kDimsPerThread], float m) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int e = 0; e < kDimsPerThread / 4; ++e)
    d4[e] = make_float4(src[4 * e] * m, src[4 * e + 1] * m, src[4 * e + 2] * m,
                        src[4 * e + 3] * m);
}

// A thread's place in the short kernels: slice sl of the block, row r of
// the slice, dimensions d0 .. d0 + 15. Threads of slices past BH (in the
// last block) compute on slice 0 and store nothing.
struct ShortPlace {
  int sl, r, d0;
  bool active;
};

template <int D>
__device__ __forceinline__ ShortPlace short_place(int T, int n_sl) {
  constexpr int G = flash::kThreadsPerRow<D>;
  const int tid = threadIdx.x;
  const int per_slice = T * G;
  ShortPlace p;
  p.sl = tid / per_slice;
  p.r = (tid - p.sl * per_slice) / G;
  p.d0 = (tid % G) * kDimsPerThread;
  p.active = p.sl < n_sl;
  if (!p.active) p.sl = 0;
  return p;
}

template <int D>
__global__ void __launch_bounds__(kShortMaxThreads)
    flash_dq_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int BH, int T, int S, float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  extern __shared__ float4 smem4[];
  const unsigned live = __activemask();
  const int span = T * D, stride = span + 4;
  float* k_s = reinterpret_cast<float*>(smem4);  // [S][T, D] + pad
  float* v_s = k_s + S * stride;

  const int64_t bh0 = (int64_t)blockIdx.x * S;
  const int n_sl = BH - bh0 < S ? (int)(BH - bh0) : S;
  stage_slices(k_s, v_s, k, v, bh0, n_sl, span, threadIdx.x);
  cp_async_commit();

  const ShortPlace pl = short_place<D>(T, n_sl);
  const int64_t row = (bh0 + pl.sl) * T + pl.r;
  float qr[E], dor[E], acc[E];
  load16(qr, q + row * D + pl.d0);
  load16(dor, dout + row * D + pl.d0);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  const float lse2 = lse[row] * kLog2e;
  const float dl = delta[row];
  const float c = scale * kLog2e;
  // The warp walks keys up to its last row (the same trip count in every
  // lane, so that the row sums' shuffles meet).
  const int r_last = __reduce_max_sync(live, pl.r);
  cp_async_wait<0>();
  __syncthreads();

  const float* ks = k_s + pl.sl * stride + pl.d0;
  const float* vs = v_s + pl.sl * stride + pl.d0;
  for (int j = 0; j <= r_last; ++j) {
    const float* kj = ks + j * D;
    const float s = flash::row_sum<G>(flash::dot16(qr, kj));
    const float dp = flash::row_sum<G>(flash::dot16(dor, vs + j * D));
    const float p = j <= pl.r ? ex2(fmaf(s, c, -lse2)) : 0.0f;
    axpy16(acc, p * (dp - dl), kj);
  }
  if (pl.active) store16(dq + row * D + pl.d0, acc, scale);
}

template <int D>
__global__ void __launch_bounds__(kShortMaxThreads)
    flash_dkv_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int BH, int T,
                           int S, float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  extern __shared__ float4 smem4[];
  const unsigned live = __activemask();
  const int span = T * D, stride = span + 4;
  float* q_s = reinterpret_cast<float*>(smem4);  // [S][T, D] + pad
  float* do_s = q_s + S * stride;
  float* lse_s = do_s + S * stride;  // [S][T], in log2 units
  float* dl_s = lse_s + S * T;       // [S][T]

  const int64_t bh0 = (int64_t)blockIdx.x * S;
  const int n_sl = BH - bh0 < S ? (int)(BH - bh0) : S;
  stage_slices(q_s, do_s, q, dout, bh0, n_sl, span, threadIdx.x);
  cp_async_commit();
  for (int i = threadIdx.x; i < n_sl * T; i += blockDim.x) {
    lse_s[i] = lse[bh0 * T + i] * kLog2e;
    dl_s[i] = delta[bh0 * T + i];
  }

  const ShortPlace pl = short_place<D>(T, n_sl);
  const int64_t row = (bh0 + pl.sl) * T + pl.r;
  float kr[E], vr[E], dk_acc[E], dv_acc[E];
  load16(kr, k + row * D + pl.d0);
  load16(vr, v + row * D + pl.d0);
#pragma unroll
  for (int e = 0; e < E; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
  const float c = scale * kLog2e;
  // The warp walks queries from its first key row to the end.
  const int r_first = __reduce_min_sync(live, pl.r);
  cp_async_wait<0>();
  __syncthreads();

  const float* qs = q_s + pl.sl * stride + pl.d0;
  const float* dos = do_s + pl.sl * stride + pl.d0;
  const float* ls = lse_s + pl.sl * T;
  const float* dls = dl_s + pl.sl * T;
  for (int i = r_first; i < T; ++i) {
    const float* qi = qs + i * D;
    const float* doi = dos + i * D;
    const float s = flash::row_sum<G>(flash::dot16(kr, qi));
    const float dp = flash::row_sum<G>(flash::dot16(vr, doi));
    const float p = i >= pl.r ? ex2(fmaf(s, c, -ls[i])) : 0.0f;
    axpy16(dv_acc, p, doi);
    axpy16(dk_acc, p * (dp - dls[i]), qi);
  }
  if (!pl.active) return;
  store16(dk + row * D + pl.d0, dk_acc, scale);
  store16(dv + row * D + pl.d0, dv_acc, 1.0f);
}

// Launch a short-window kernel on `args`, then BH, T, S (slices a block)
// and scale, with smem_per_slice bytes of shared memory a slice.
template <typename Kernel, typename... Args>
int launch_short(Kernel kernel, size_t smem_per_slice, int BH, int T, int D, float scale,
                 cudaStream_t stream, Args... args) {
  const int per_slice = T * (D / kDimsPerThread);
  const int S = short_slices(BH, per_slice);
  const size_t smem = smem_per_slice * (size_t)S;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((BH + S - 1) / S), S * per_slice, smem, stream>>>(args..., BH, T, S,
                                                                         scale);
  return (int)cudaGetLastError();
}

// --- 2. long windows: 3xTF32 on the tensor cores ---------------------------

constexpr int kWarps = 4;  // 16 rows each
constexpr int kTcThreads = 32 * kWarps;

template <int D>
constexpr int kStride = D + 4;  // a tile's row stride in shared memory
// 8-row groups of a score tile a pass takes (its scores stay in registers).
template <int D>
constexpr int kPass = D == 32 ? 8 : (D == 128 ? 2 : 4);
// Blocks an SM, which caps the registers a thread: 5 at D = 16 (at most
// 102 registers), 3 at D = 32 (168); one block at D = 64 and 128, whose
// kernels take up to 255 (ptxas reports no spills at any D).
template <int D>
constexpr int kMinBlocks = D == 16 ? 5 : (D == 32 ? 3 : 1);

// Rows r0 .. r0 + 63 of a [T, D] slice into a tile, zeros past T.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int r0, int T,
                                           int tid) {
  constexpr int C4 = D / 4;
  for (int i = tid; i < kBlock * C4; i += kTcThreads) {
    const int r = i / C4, c = i - r * C4;
    const bool in = r0 + r < T;
    cp_async_16(dst + r * kStride<D> + 4 * c,
                in ? src + (int64_t)(r0 + r) * D + 4 * c : src, in);
  }
}

// Rows r0 .. r0 + 63 of two [T] rows (lse and delta of one bh), zeros past T.
__device__ __forceinline__ void stage_rows64(float* l_s, float* d_s, const float* l,
                                             const float* d, int r0, int T, int tid) {
  const int r = tid & (kBlock - 1);
  const bool in = r0 + r < T;
  if (tid < kBlock)
    cp_async_4(l_s + r, in ? l + r0 + r : l, in);
  else
    cp_async_4(d_s + r, in ? d + r0 + r : d, in);
}

// Fragment layouts of mma.m16n8k8 (TF32), lane = 4 g + i: A holds (row g,
// k i), (g + 8, i), (g, i + 4), (g + 8, i + 4); B holds (k i, column g),
// (k i + 4, g); C holds (row g, columns 2i, 2i + 1) and (g + 8, the same).

// A from 16 rows of a tile (t at the first row and the k8 step's column).
__device__ __forceinline__ void load_a(const float* t, int stride, int g, int i,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* r0 = t + g * stride + i;
  const float* r1 = r0 + 8 * stride;
  split_tf32_rz(r0[0], hi[0], lo[0]);
  split_tf32_rz(r1[0], hi[1], lo[1]);
  split_tf32_rz(r0[4], hi[2], lo[2]);
  split_tf32_rz(r1[4], hi[3], lo[3]);
}

// B = tile^T: column n is row n of the tile (t at the first row and the
// k8 step's column).
__device__ __forceinline__ void load_bt(const float* t, int stride, int g, int i,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* r = t + g * stride + i;
  split_tf32_rz(r[0], hi[0], lo[0]);
  split_tf32_rz(r[4], hi[1], lo[1]);
}

// B = 8 rows of a tile in the permuted k order (k i is row 2i, k i + 4 row
// 2i + 1; t at the first row and the n8 tile's column).
__device__ __forceinline__ void load_bp(const float* t, int stride, int g, int i,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* r = t + 2 * i * stride + g;
  split_tf32_rz(r[0], hi[0], lo[0]);
  split_tf32_rz(r[stride], hi[1], lo[1]);
}

// A from a C fragment of a score tile's 8 columns, in the permuted k order.
__device__ __forceinline__ void split_c(const float (&c)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32_rz(c[0], hi[0], lo[0]);
  split_tf32_rz(c[2], hi[1], lo[1]);
  split_tf32_rz(c[1], hi[2], lo[2]);
  split_tf32_rz(c[3], hi[3], lo[3]);
}

// S = A1 B1 and dP = A2 B2 for one warp's 16 rows and the pass's 8-row
// groups [c0, c0 + NP) of a streamed tile (those from `first` to `last`
// exclusive): A1, A2 from the warp's rows of two tiles (a1, a2), B1, B2
// the transposes of the streamed tiles b1, b2, contracted over D.
template <int D, int NP>
__device__ __forceinline__ void two_products(float (&s)[NP][4], float (&dp)[NP][4],
                                             const float* a1, const float* a2,
                                             const float* b1, const float* b2, int c0,
                                             int first, int last, int g, int i) {
  constexpr int TS = kStride<D>;
#pragma unroll
  for (int nt = 0; nt < NP; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t x_hi[4], x_lo[4], y_hi[4], y_lo[4];
    load_a(a1 + kk * 8, TS, g, i, x_hi, x_lo);
    load_a(a2 + kk * 8, TS, g, i, y_hi, y_lo);
#pragma unroll
    for (int nt = 0; nt < NP; ++nt) {
      const int grp = c0 + nt;
      if (grp >= first && grp < last) {
        uint32_t b_hi[2], b_lo[2];
        load_bt(b1 + grp * 8 * TS + kk * 8, TS, g, i, b_hi, b_lo);
        mma_3xtf32(s[nt], x_hi, x_lo, b_hi, b_lo);
        load_bt(b2 + grp * 8 * TS + kk * 8, TS, g, i, b_hi, b_lo);
        mma_3xtf32(dp[nt], y_hi, y_lo, b_hi, b_lo);
      }
    }
  }
}

// acc += A B for each A of `as` (NA of them: score fragments of the pass's
// 8-row groups [c0, c0 + NP), those from `first` to `last` exclusive) and
// its B from `bs` (the groups' rows of a streamed tile, all D columns),
// each product from zero in 3xTF32 and then added by f32 adds. Up to
// D = 32 the groups are the outer loop, each group's fragment split once;
// wider heads split the pass's fragments first and take one n8 tile at a
// time, so that they need no second accumulator of D columns.
template <int D, int NP, int NA>
__device__ __forceinline__ void add_products(float (&acc)[NA][D / 8][4],
                                             const float (&as)[NA][NP][4],
                                             const float* const (&bs)[NA], int c0, int first,
                                             int last, int g, int i) {
  constexpr int TS = kStride<D>;
  constexpr int ND = D / 8;
  if constexpr (ND <= 4) {
    float t[NA][ND][4];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[a][n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
      const int grp = c0 + kk;
      if (grp >= first && grp < last) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          uint32_t a_hi[4], a_lo[4];
          split_c(as[a][kk], a_hi, a_lo);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            uint32_t b_hi[2], b_lo[2];
            load_bp(bs[a] + grp * 8 * TS + n * 8, TS, g, i, b_hi, b_lo);
            mma_3xtf32(t[a][n], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] += t[a][n][e];
  } else {
    uint32_t a_hi[NA][NP][4], a_lo[NA][NP][4];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) split_c(as[a][kk], a_hi[a][kk], a_lo[a][kk]);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          const int grp = c0 + kk;
          if (grp >= first && grp < last) {
            uint32_t b_hi[2], b_lo[2];
            load_bp(bs[a] + grp * 8 * TS + n * 8, TS, g, i, b_hi, b_lo);
            mma_3xtf32(t, a_hi[a][kk], a_lo[a][kk], b_hi, b_lo);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] += t[e];
      }
  }
}

// Six 64-row tiles, and for flash_dkv the staged lse and delta.
template <int D>
constexpr size_t tc_smem_bytes(bool rows) {
  return sizeof(float) * (6 * kBlock * kStride<D> + (rows ? 4 * kBlock : 0));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<D>)
    flash_dq_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int BH, int T, int n_qt, float scale) {
  constexpr int TS = kStride<D>, ND = D / 8, NP = kPass<D>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [64, TS]
  float* do_s = q_s + kBlock * TS;                // [64, TS]
  float* k_s = do_s + kBlock * TS;                // [2][64, TS]
  float* v_s = k_s + 2 * kBlock * TS;             // [2][64, TS]

  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heaviest tiles first
  const int64_t bh = blockIdx.x % BH;
  const int q0 = qt * kBlock;
  const int64_t base = bh * T * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  stage_tile<D>(q_s, q + base, q0, T, tid);
  stage_tile<D>(do_s, dout + base, q0, T, tid);
  stage_tile<D>(k_s, k + base, 0, T, tid);
  stage_tile<D>(v_s, v + base, 0, T, tid);
  cp_async_commit();

  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < T;
    lse2[h] = in ? lse[bh * T + rows[h]] * kLog2e : kFar;
    dl[h] = in ? delta[bh * T + rows[h]] : 0.0f;
  }
  const float c = scale * kLog2e;
  float acc[1][ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.0f;
  const float* qw = q_s + wrow * TS;
  const float* dow = do_s + wrow * TS;

  for (int kt = 0; kt <= qt; ++kt) {  // causal: K/V tiles up to the diagonal
    if (kt < qt) {
      const int nb = (kt + 1) & 1;
      stage_tile<D>(k_s + nb * kBlock * TS, k + base, (kt + 1) * kBlock, T, tid);
      stage_tile<D>(v_s + nb * kBlock * TS, v + base, (kt + 1) * kBlock, T, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = k_s + (kt & 1) * kBlock * TS;
    const float* vs = v_s + (kt & 1) * kBlock * TS;
    const int k0 = kt * kBlock;
    const bool diag = kt == qt;
    // The 8-key groups any row of this warp can see.
    const int last = diag ? 2 * warp + 2 : 8;
#pragma unroll
    for (int c0 = 0; c0 < 8; c0 += NP) {
      if (c0 >= last) continue;
      float s[1][NP][4], dp[NP][4];
      two_products<D, NP>(s[0], dp, qw, dow, ks, vs, c0, 0, last, g, i4);
      // dS in place of the scores; a masked pair (diagonal tile only) is 0.
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][nt][e] = ex2(fmaf(s[0][nt][e], c, -lse2[e >> 1]));
      if (diag) {
#pragma unroll
        for (int nt = 0; nt < NP; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + (c0 + nt) * 8 + 2 * i4 + (e & 1) > rows[e >> 1]) s[0][nt][e] = 0.0f;
      }
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][nt][e] *= dp[nt][e] - dl[e >> 1];
      const float* const bs[1] = {ks};
      add_products<D, NP, 1>(acc, s, bs, c0, 0, last, g, i4);  // dQ += dS K
    }
    __syncthreads();  // the tile is consumed before it is staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= T) continue;
    float* out = dq + base + (int64_t)rows[h] * D + 2 * i4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[0][n][2 * h] * scale, acc[0][n][2 * h + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<D>)
    flash_dkv_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int BH, int T,
                        int n_kt, float scale) {
  constexpr int TS = kStride<D>, ND = D / 8, NP = kPass<D>;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [64, TS]
  float* v_s = k_s + kBlock * TS;                 // [64, TS]
  float* q_s = v_s + kBlock * TS;                 // [2][64, TS]
  float* do_s = q_s + 2 * kBlock * TS;            // [2][64, TS]
  float* l_s = do_s + 2 * kBlock * TS;            // [2][64]
  float* d_s = l_s + 2 * kBlock;                  // [2][64]

  const int kt = (int)(blockIdx.x / BH);  // heaviest (first) tiles first
  const int64_t bh = blockIdx.x % BH;
  const int k0 = kt * kBlock;
  const int64_t base = bh * T * D;
  const float* lb = lse + bh * T;
  const float* db = delta + bh * T;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wrow = warp * 16;
  const int keys[2] = {k0 + wrow + g, k0 + wrow + g + 8};

  stage_tile<D>(k_s, k + base, k0, T, tid);
  stage_tile<D>(v_s, v + base, k0, T, tid);
  stage_tile<D>(q_s, q + base, k0, T, tid);
  stage_tile<D>(do_s, dout + base, k0, T, tid);
  stage_rows64(l_s, d_s, lb, db, k0, T, tid);
  cp_async_commit();

  const float c = scale * kLog2e;
  float acc[2][ND][4];  // dV, dK
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.0f;
  const float* kw = k_s + wrow * TS;
  const float* vw = v_s + wrow * TS;

  for (int qt = kt; qt < n_kt; ++qt) {  // causal: Q/dO tiles from the diagonal
    const int b = (qt - kt) & 1;
    if (qt + 1 < n_kt) {
      const int nb = b ^ 1, r0 = (qt + 1) * kBlock;
      stage_tile<D>(q_s + nb * kBlock * TS, q + base, r0, T, tid);
      stage_tile<D>(do_s + nb * kBlock * TS, dout + base, r0, T, tid);
      stage_rows64(l_s + nb * kBlock, d_s + nb * kBlock, lb, db, r0, T, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = q_s + b * kBlock * TS;
    const float* dos = do_s + b * kBlock * TS;
    const float* ls = l_s + b * kBlock;
    const float* dls = d_s + b * kBlock;
    const int q0 = qt * kBlock;
    const bool diag = qt == kt;
    // The 8-query groups before `first` see none of this warp's keys.
    const int first = diag ? 2 * warp : 0;
#pragma unroll
    for (int c0 = 0; c0 < 8; c0 += NP) {
      if (c0 + NP <= first) continue;
      float sp[2][NP][4];  // P^T, then dS^T
      two_products<D, NP>(sp[0], sp[1], kw, vw, qs, dos, c0, first, 8, g, i4);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + (c0 + nt) * 8 + 2 * i4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sp[0][nt][e] = ex2(fmaf(sp[0][nt][e], c, -((e & 1) ? l2.y : l2.x) * kLog2e));
      }
      if (diag || q0 + kBlock > T) {  // the causal edge, or rows past T
#pragma unroll
        for (int nt = 0; nt < NP; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + (c0 + nt) * 8 + 2 * i4 + (e & 1);
            if ((diag && qpos < keys[e >> 1]) || qpos >= T) sp[0][nt][e] = 0.0f;
          }
      }
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) {
        const float2 d2 = *reinterpret_cast<const float2*>(dls + (c0 + nt) * 8 + 2 * i4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sp[1][nt][e] = sp[0][nt][e] * (sp[1][nt][e] - ((e & 1) ? d2.y : d2.x));
      }
      const float* const bs[2] = {dos, qs};
      add_products<D, NP, 2>(acc, sp, bs, c0, first, 8, g, i4);  // dV, dK
    }
    __syncthreads();  // the tiles are consumed before they are staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= T) continue;
    const int64_t o = base + (int64_t)keys[h] * D + 2 * i4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dv + o + n * 8) =
          make_float2(acc[0][n][2 * h], acc[0][n][2 * h + 1]);
      *reinterpret_cast<float2*>(dk + o + n * 8) =
          make_float2(acc[1][n][2 * h] * scale, acc[1][n][2 * h + 1] * scale);
    }
  }
}

// Launch a long-window kernel on `args`, then BH, T, the tile count and
// scale: one block per (bh, 64-row tile).
template <typename Kernel, typename... Args>
int launch_tc(Kernel kernel, size_t smem, int BH, int T, float scale, cudaStream_t stream,
              Args... args) {
  const int n_tiles = (T + kBlock - 1) / kBlock;
  if ((int64_t)BH * n_tiles > 2147483647 || smem > flash::kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(BH * n_tiles), kTcThreads, smem, stream>>>(args..., BH, T, n_tiles,
                                                                  scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, int BH, int T, float scale,
              cudaStream_t stream) {
  if (T <= kShortT)
    return launch_short(flash_dq_short_kernel<D>, sizeof(float) * 2 * ((size_t)T * D + 4),
                        BH, T, D, scale, stream, q, k, v, dout, lse, delta, dq);
  return launch_tc(flash_dq_tc_kernel<D>, tc_smem_bytes<D>(false), BH, T, scale, stream, q,
                   k, v, dout, lse, delta, dq);
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int BH, int T,
               float scale, cudaStream_t stream) {
  if (T <= kShortT)
    return launch_short(flash_dkv_short_kernel<D>,
                        sizeof(float) * (2 * ((size_t)T * D + 4) + 2 * (size_t)T), BH, T, D,
                        scale, stream, q, k, v, dout, lse, delta, dk, dv);
  return launch_tc(flash_dkv_tc_kernel<D>, tc_smem_bytes<D>(true), BH, T, scale, stream, q,
                   k, v, dout, lse, delta, dk, dv);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// dq [BH, T, D] from q, k, v, do [BH, T, D] and lse, delta [BH, T], all
// contiguous f32 on one device, the [BH, T, D] ones 16-byte aligned; D in
// {16, 32, 64, 128}. Returns 0, or the CUDA error code.
int tpuflow_flash_dq_f32(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, float* dq, int BH, int T, int D,
                         float scale, void* stream) {
  if (BH <= 0 || T <= 0) return 0;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, dout, lse, delta, dq, BH, T, scale, s);
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, T, scale, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, T, scale, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv [BH, T, D] from the same inputs. Returns 0, or the CUDA error code.
int tpuflow_flash_dkv_f32(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* delta, float* dk, float* dv, int BH,
                          int T, int D, float scale, void* stream) {
  if (BH <= 0 || T <= 0) return 0;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dk) &&
        aligned16(dv)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, BH, T, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, T, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, T, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
