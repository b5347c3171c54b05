// One causal context-parallel ring round on Hopper (sm_90a), float32: the
// forward update of the running softmax statistics, and the backward's
// partial gradients.
//
// Replaces the two Pallas TPU kernels at the bottom of
// tpuflow/kernels/attention.py, which parallel/ring_attention.py drives
// round by round while the K/V blocks travel the ring:
// - ring_round_fwd replaces _round_fwd_kernel (launched by ring_round_fwd
//   with pl.pallas_call). For the local q chunk of one batch-head, at
//   global offset q_off, and the visiting K/V block, at global offset k_off
//   (both Tl rows), it updates the running (m, l, acc):
//       s_ij = scale * q_i . k_j   for the allowed pairs k_off + j <= q_off + i
//       m'   = max(m, max_j s_ij),  l = l e^(m - m') + sum_j e^(s_ij - m'),
//       acc  = acc e^(m - m') + sum_j e^(s_ij - m') v_j;
// - ring_round_bwd replaces _round_bwd_kernel (launched by ring_round_bwd).
//   From the final lse and delta = rowsum(do * o), with P_ij = exp(s_ij -
//   lse_i) and dS_ij = P_ij (do_i . v_j - delta_i) over the allowed pairs,
//   it writes this round's partials
//       dq_i = scale sum_j dS_ij k_j,
//       dk_j = scale sum_i dS_ij q_i,   dv_j = sum_i P_ij do_i.
//
// What bounds them on an H100: a round reads its inputs once (q, k, v and
// acc, or q, k, v and do, of Tl x D floats a head, and two rows of stats)
// and writes its outputs once, and does 4 * D (forward) or 10 * D
// (backward) operations for each allowed pair: Tl(Tl+1)/2 on the diagonal
// round, Tl^2 for a block from the past, none for one from the future. At
// the ring training's Tl = 64, D = 16 the bytes bound a round; at Tl = 1024
// the tensor cores in 3xTF32 do.
//
// Only the distance `ahead` = q_off - k_off matters: row i sees key j when
// j <= i + ahead. It is clamped to [-Tl, Tl] (a block Tl or more behind is
// wholly allowed, one Tl or more ahead wholly masked), so that no index
// overflows, and every tile bound divides with floor, not C's truncation.
//
// Two designs of each kernel, chosen by Tl, those of flash_fwd.cu and
// flash_bwd.cu:
//
// 1. Tl <= 64 (the ring training's Tl = 64): a slice (one bh) is Tl rows of
//    D / 16 threads, each holding 16 dimensions of its row. A block takes
//    whole slices, about 256 threads' worth (fewer where BH is small, so
//    that BH = 80 still makes 80 blocks), rounded up to whole warps. The
//    operands a thread walks arrive in shared memory by 16-byte cp.async
//    copies, all in flight at once (each slice padded by 4 floats against
//    bank conflicts), and only the rows some row of the block can reach.
//    - forward: a thread group a q row, its q, acc, m and l in registers,
//      its scores in registers (no round trip through shared memory); the
//      visiting K/V staged.
//    - backward: one launch, the dk/dv blocks first (4/3 the work of a dq
//      block), then the dq blocks. dk/dv: a thread group a key row, Q and
//      dO staged with lse and delta; dq: a thread group a q row, K and V
//      staged. Each warp walks only the pairs its rows reach.
//    A round where every pair is allowed (a past block) runs a kernel that
//    tests no mask.
// 2. Tl > 64: 64-row tiles, a block of 4 warps each owning 16 rows, the
//    products on the tensor cores as mma.sync.m16n8k8 in 3xTF32 (each f32
//    operand split into a TF32 high part and its TF32 rest, three products:
//    about f32 accuracy). The streamed tiles are double-buffered by
//    cp.async, rows past Tl zero-filled. Only the tiles that the causal
//    edge or the chunk's end crosses are masked (two a row of tiles where
//    `ahead` is not a multiple of 64; none in a past round of whole tiles),
//    and there each warp skips the 8-row groups none of its rows reaches.
//    - forward (flash_fwd.cu's tensor-core kernel): a block a (bh, q tile),
//      the heaviest q tiles first; the output fragments start from the
//      incoming acc, m and l sit per row in registers, and Q K^T and P V
//      run with the rounding split (the forward holds 1e-5); the key order
//      in each k8 step is permuted so that a score fragment is P V's A
//      operand as it stands. acc is written unnormalised, and no lse.
//    - backward (flash_bwd.cu's tensor-core kernels, one grid): blocks in
//      ranks by weight, each rank the dk/dv block of k tile t (Q/dO tiles
//      from the first that reaches it, S^T = K Q^T and dP^T = V dO^T, dV +=
//      P^T dO, dK += dS^T Q) and then the dq block of q tile nt - 1 - t
//      (K/V tiles up to the last it reaches, S = Q K^T, dP = dO V^T, dQ +=
//      dS K); the truncating split and one ex2.approx a probability.
//
// In both designs the scale multiplies q once (forward) or sits in the
// exponent and the final store (backward); the forward keeps m in natural
// units, its exponentials as exp2 of s log2(e) - m log2(e), so that a row
// no key reaches keeps its m, l and acc bit for bit. A masked probability
// is 0, whatever the exponential of its score gives, so no inf * 0 arises. A wholly future round runs no tile: the forward copies
// its stats through, the backward writes zeros. Each block owns its output
// rows: no atomics, and the results repeat run to run. The forward's
// outputs may be its inputs: each block reads its rows before it writes
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
using flash::mma_3xtf32_split;
using flash::split_tf32;
using flash::split_tf32_rz;

constexpr float kNeg = -1e30f;  // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
// lse (log2 units) of a query row past Tl: exp2(s - kFar) is 0.
constexpr float kFar = 1e30f;
constexpr int kSMs = 132;  // streaming multiprocessors, H100 SXM

// a // b rounded toward minus infinity, for b > 0.
__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// 2^x by one MUFU.EX2 (relative error about 2^-22; results below 2^-126
// flush to 0, which a probability may).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- 1. short chunks --------------------------------------------------------

constexpr int kShortT = 64;         // the largest Tl the short kernels take
constexpr int kShortThreads = 256;  // what a block aims at
constexpr int kShortMaxThreads = kShortT * 128 / kDimsPerThread;  // one slice

// Slices a block: as many as fill kShortThreads, but no more than leave two
// blocks for each SM.
int short_slices(int BH, int per_slice) {
  const int fill = per_slice >= kShortThreads ? 1 : kShortThreads / per_slice;
  const int spread = BH / (2 * kSMs) > 1 ? BH / (2 * kSMs) : 1;
  return fill < spread ? fill : spread;
}

// Rows [r0, r1) of slices bh0 .. bh0 + n_sl - 1 of two [BH, Tl, D] tensors
// into shared memory, row r of slice sl at sl * (Tl D + 4) + r D, all in
// flight.
template <int D>
__device__ __forceinline__ void stage_slices(float* a_s, float* b_s, const float* a,
                                             const float* b, int64_t bh0, int n_sl, int Tl,
                                             int r0, int r1) {
  const int span = Tl * D, stride = span + 4;
  const int n4 = (r1 - r0) * (D / 4);
  for (int i = threadIdx.x; i < n_sl * n4; i += blockDim.x) {
    const int sl = i / n4;
    const int off = r0 * D + 4 * (i - sl * n4);
    cp_async_16(a_s + sl * stride + off, a + (bh0 + sl) * span + off, true);
    cp_async_16(b_s + sl * stride + off, b + (bh0 + sl) * span + off, true);
  }
}

// 16 floats from global memory (16-byte aligned) into registers, times m.
__device__ __forceinline__ void load16(float (&dst)[kDimsPerThread], const float* src,
                                       float m) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int e = 0; e < kDimsPerThread / 4; ++e) {
    const float4 x = s4[e];
    dst[4 * e] = x.x * m;
    dst[4 * e + 1] = x.y * m;
    dst[4 * e + 2] = x.z * m;
    dst[4 * e + 3] = x.w * m;
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
// last block) and those that round the block up to whole warps compute on
// slice 0 and store nothing.
struct ShortPlace {
  int sl, r, d0;
  bool active;
};

template <int D>
__device__ __forceinline__ ShortPlace short_place(int Tl, int n_sl) {
  constexpr int G = flash::kThreadsPerRow<D>;
  const int tid = threadIdx.x;
  const int per_slice = Tl * G;
  ShortPlace p;
  p.sl = tid / per_slice;
  p.r = (tid - p.sl * per_slice) / G;
  p.d0 = (tid % G) * kDimsPerThread;
  p.active = p.sl < n_sl;
  if (!p.active) p.sl = 0;
  return p;
}

// Up to 32 keys a block has at most kShortThreads threads; its registers
// are capped so that three blocks fit on an SM up to 16 keys, two up to 32
// (where three spill).
template <int D, int kT, bool kAll>
__global__ void __launch_bounds__(kT > 32 ? kShortMaxThreads : kShortThreads,
                                  kT > 32 ? 1 : (kT > 16 ? 2 : 3))
    ring_round_fwd_short(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* m_in, const float* l_in,
                         const float* acc_in, float* m_out, float* l_out, float* acc_out,
                         int BH, int Tl, int S, int ahead, float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  extern __shared__ float4 smem4[];
  const int stride = Tl * D + 4;
  float* k_s = reinterpret_cast<float*>(smem4);  // [S][Tl, D] + pad
  float* v_s = k_s + S * stride;

  const int64_t bh0 = (int64_t)blockIdx.x * S;
  const int n_sl = BH - bh0 < S ? (int)(BH - bh0) : S;
  const ShortPlace pl = short_place<D>(Tl, n_sl);
  const int64_t row = (bh0 + pl.sl) * Tl + pl.r;
  // Keys 0 .. n_keys - 1 are the ones the chunk's last row reaches; none:
  // a wholly future block, whose state is copied through.
  const int n_keys = kAll ? Tl : clampi(Tl + ahead, 0, Tl);
  if (n_keys == 0) {
    const float4* src = reinterpret_cast<const float4*>(acc_in + row * D + pl.d0);
    float4 x[E / 4];
#pragma unroll
    for (int e = 0; e < E / 4; ++e) x[e] = src[e];
    const float m = m_in[row], l = l_in[row];
    __syncwarp();  // the row's lanes have read m_in, l_in, which may be m_out, l_out
    if (!pl.active) return;
    float4* dst = reinterpret_cast<float4*>(acc_out + row * D + pl.d0);
#pragma unroll
    for (int e = 0; e < E / 4; ++e) dst[e] = x[e];
    if (pl.d0 == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
    return;
  }
  stage_slices<D>(k_s, v_s, k, v, bh0, n_sl, Tl, 0, n_keys);
  cp_async_commit();

  float qr[E], acc[E];
  load16(qr, q + row * D + pl.d0, scale);
  load16(acc, acc_in + row * D + pl.d0, 1.0f);
  float m = m_in[row], l = l_in[row];
  // The last key this row reaches (below 0: none), and the last any row of
  // its warp reaches: the trip count of the warp's score loop, the same in
  // every lane, so that the row sums' shuffles meet.
  const int j_row = kAll ? Tl - 1 : min(Tl - 1, pl.r + ahead);
  const int j_end = kAll ? Tl - 1 : __reduce_max_sync(0xffffffffu, j_row);
  cp_async_wait<0>();
  __syncthreads();

  const float* ks = k_s + pl.sl * stride + pl.d0;
  const float* vs = v_s + pl.sl * stride + pl.d0;
  float s[kT];
  float m_tile = kNeg;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (j <= j_end) {
      const float dot = flash::row_sum<G>(flash::dot16(qr, ks + j * D));
      s[j] = (kAll || j <= j_row) ? dot : kNeg;
      m_tile = fmaxf(m_tile, s[j]);
    }
  }
  if (j_row >= 0) {  // a row no key reaches keeps its state bit for bit
    const float m_new = fmaxf(m, m_tile);
    const float corr = exp2f((m - m_new) * kLog2e);
    const float ml = m_new * kLog2e;
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (kAll ? j < Tl : j <= j_row) {
        const float p = exp2f(fmaf(s[j], kLog2e, -ml));
        l += p;
        axpy16(acc, p, vs + j * D);
      }
    }
    m = m_new;
  }
  if (!pl.active) return;
  store16(acc_out + row * D + pl.d0, acc, 1.0f);
  if (pl.d0 == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

// One launch: blocks [0, nb) compute dk and dv, blocks [nb, 2 nb) dq, each
// of S slices.
template <int D, bool kAll>
__global__ void __launch_bounds__(kShortMaxThreads)
    ring_round_bwd_short(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int BH, int Tl, int S, int nb, int ahead,
                         float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  extern __shared__ float4 smem4[];
  const int stride = Tl * D + 4;
  float* a_s = reinterpret_cast<float*>(smem4);  // [S][Tl, D] + pad: q (dk/dv) or k (dq)
  float* b_s = a_s + S * stride;                  // do (dk/dv) or v (dq)
  float* lse_s = b_s + S * stride;                // [S][Tl], log2 units (dk/dv)
  float* dl_s = lse_s + S * Tl;                   // [S][Tl] (dk/dv)

  const bool kv = blockIdx.x < (unsigned)nb;
  const int64_t bh0 = (int64_t)(kv ? blockIdx.x : blockIdx.x - nb) * S;
  const int n_sl = BH - bh0 < S ? (int)(BH - bh0) : S;
  const ShortPlace pl = short_place<D>(Tl, n_sl);
  const int64_t row = (bh0 + pl.sl) * Tl + pl.r;
  const float c = scale * kLog2e;

  if (kv) {
    // Queries q_lo .. Tl - 1 reach key 0; this thread's key row r is
    // reached from query i_row on (Tl or past: by none), and the warp
    // walks from the first of its rows' firsts.
    const int q_lo = kAll ? 0 : clampi(-ahead, 0, Tl);
    stage_slices<D>(a_s, b_s, q, dout, bh0, n_sl, Tl, q_lo, Tl);
    cp_async_commit();
    for (int i = threadIdx.x; i < n_sl * Tl; i += blockDim.x) {
      lse_s[i] = lse[bh0 * Tl + i] * kLog2e;
      dl_s[i] = delta[bh0 * Tl + i];
    }
    float kr[E], vr[E], dk_acc[E], dv_acc[E];
    load16(kr, k + row * D + pl.d0, 1.0f);
    load16(vr, v + row * D + pl.d0, 1.0f);
#pragma unroll
    for (int e = 0; e < E; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
    const int i_row = kAll ? 0 : max(0, pl.r - ahead);
    const int i_start = kAll ? 0 : __reduce_min_sync(0xffffffffu, i_row);
    cp_async_wait<0>();
    __syncthreads();

    const float* qs = a_s + pl.sl * stride + pl.d0;
    const float* dos = b_s + pl.sl * stride + pl.d0;
    const float* ls = lse_s + pl.sl * Tl;
    const float* dls = dl_s + pl.sl * Tl;
    for (int i = i_start; i < Tl; ++i) {
      const float* qi = qs + i * D;
      const float* doi = dos + i * D;
      const float s = flash::row_sum<G>(flash::dot16(kr, qi));
      const float dp = flash::row_sum<G>(flash::dot16(vr, doi));
      const float p = (kAll || i >= i_row) ? ex2(fmaf(s, c, -ls[i])) : 0.0f;
      axpy16(dv_acc, p, doi);
      axpy16(dk_acc, p * (dp - dls[i]), qi);
    }
    if (!pl.active) return;
    store16(dk + row * D + pl.d0, dk_acc, scale);
    store16(dv + row * D + pl.d0, dv_acc, 1.0f);
    return;
  }

  // dq: this thread's q row reaches keys 0 .. j_row; the warp walks to the
  // last of its rows' lasts.
  const int n_keys = kAll ? Tl : clampi(Tl + ahead, 0, Tl);
  stage_slices<D>(a_s, b_s, k, v, bh0, n_sl, Tl, 0, n_keys);
  cp_async_commit();
  float qr[E], dor[E], acc[E];
  load16(qr, q + row * D + pl.d0, 1.0f);
  load16(dor, dout + row * D + pl.d0, 1.0f);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  const float lse2 = lse[row] * kLog2e;
  const float dl = delta[row];
  const int j_row = kAll ? Tl - 1 : min(Tl - 1, pl.r + ahead);
  const int j_end = kAll ? Tl - 1 : __reduce_max_sync(0xffffffffu, j_row);
  cp_async_wait<0>();
  __syncthreads();

  const float* ks = a_s + pl.sl * stride + pl.d0;
  const float* vs = b_s + pl.sl * stride + pl.d0;
  for (int j = 0; j <= j_end; ++j) {
    const float* kj = ks + j * D;
    const float s = flash::row_sum<G>(flash::dot16(qr, kj));
    const float dp = flash::row_sum<G>(flash::dot16(dor, vs + j * D));
    const float p = (kAll || j <= j_row) ? ex2(fmaf(s, c, -lse2)) : 0.0f;
    axpy16(acc, p * (dp - dl), kj);
  }
  if (pl.active) store16(dq + row * D + pl.d0, acc, scale);
}

// --- 2. long chunks: 3xTF32 on the tensor cores ----------------------------

constexpr int kWarps = 4;  // 16 rows each
constexpr int kTcThreads = 32 * kWarps;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 .. r0 + 63 of a [Tl, D] slice into a tile of the given row
// stride, zeros past Tl.
template <int D, int kStride>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int r0, int Tl,
                                           int tid) {
  constexpr int C4 = D / 4;
  for (int i = tid; i < kBlock * C4; i += kTcThreads) {
    const int r = i / C4, c = i - r * C4;
    const bool in = r0 + r < Tl;
    cp_async_16(dst + r * kStride + 4 * c, in ? src + (int64_t)(r0 + r) * D + 4 * c : src,
                in);
  }
}

// Fragment layouts of mma.m16n8k8 (TF32), lane = 4 g + i: A holds (row g,
// k i), (g + 8, i), (g, i + 4), (g + 8, i + 4); B holds (k i, column g),
// (k i + 4, g); C holds (row g, columns 2i, 2i + 1) and (g + 8, the same).

// 2a. The forward (flash_fwd.cu's tensor-core kernel). Padded row strides
// (floats) of the Q, K and V tiles, chosen so that each warp's fragment
// loads hit 32 distinct banks: Q and K are read as float2 at (row g,
// column 2i), V as floats at (row 2i, column g).
template <int D>
constexpr int kQStride = D + 8;
template <int D>
constexpr int kKStride = D + 8;
template <int D>
constexpr int kVStride = D + 4;

template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return sizeof(float) * kBlock * (kQStride<D> + 2 * (kKStride<D> + kVStride<D>));
}

// At D = 16 registers are capped so that five blocks fit on an SM.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 16 ? 5 : 1)
    ring_round_fwd_tc(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* m_in, const float* l_in,
                      const float* acc_in, float* m_out, float* l_out, float* acc_out, int BH,
                      int Tl, int nt, int ahead, float scale) {
  constexpr int QS = kQStride<D>, KS = kKStride<D>, VS = kVStride<D>;
  constexpr int ND = D / 8;  // n8 tiles of the output, k8 steps of Q K^T
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [64, QS]
  float* k_s = q_s + kBlock * QS;                 // [2][64, KS]
  float* v_s = k_s + 2 * kBlock * KS;             // [2][64, VS]

  const int qt = nt - 1 - (int)(blockIdx.x / BH);  // heaviest tiles first
  const int64_t bh = blockIdx.x % BH;
  const int q0 = qt * kBlock;
  const int64_t base = bh * Tl * D;
  const float* kb = k + base;
  const float* vb = v + base;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const int w_first = q0 + wrow, w_last = w_first + 15;

  // The incoming state of the warp's rows: m per row, l as lane partials
  // (lane i4 = 0 holds it), acc as the output fragments.
  float m[2], l[2];
  float acc[ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < Tl;
    m[h] = in ? m_in[bh * Tl + rows[h]] : kNeg;
    l[h] = in && i4 == 0 ? l_in[bh * Tl + rows[h]] : 0.0f;
    const float* src = acc_in + base + (int64_t)rows[h] * D + 2 * i4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float2 x = in ? *reinterpret_cast<const float2*>(src + n * 8) : make_float2(0.f, 0.f);
      acc[n][2 * h] = x.x;
      acc[n][2 * h + 1] = x.y;
    }
  }

  // K/V tiles that some row of this q tile reaches.
  const int n_kt = clampi(floor_div(min(q0 + kBlock, Tl) - 1 + ahead, kBlock) + 1, 0, nt);
  if (n_kt > 0) {
    stage_tile<D, QS>(q_s, q + base, q0, Tl, tid);
    stage_tile<D, KS>(k_s, kb, 0, Tl, tid);
    stage_tile<D, VS>(v_s, vb, 0, Tl, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      stage_tile<D, KS>(k_s + nb * kBlock * KS, kb, (kt + 1) * kBlock, Tl, tid);
      stage_tile<D, VS>(v_s + nb * kBlock * VS, vb, (kt + 1) * kBlock, Tl, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = k_s + (kt & 1) * kBlock * KS;
    const float* vs = v_s + (kt & 1) * kBlock * VS;
    const int k0 = kt * kBlock;
    // The 8-key groups some row of this warp reaches, within the chunk;
    // whether some pair of the warp's rows and those keys is not allowed.
    const int n_nt = clampi(floor_div(w_last + ahead - k0, 8) + 1, 0, min(8, (Tl - k0 + 7) / 8));
    const bool edge = k0 + kBlock - 1 > w_first + ahead || k0 + kBlock > Tl;

    // S = (scale Q) K^T for the warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt8][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      if (n_nt == 0) break;
      const float2 x = *reinterpret_cast<const float2*>(q_s + (wrow + g) * QS + kk * 8 + 2 * i4);
      const float2 y =
          *reinterpret_cast<const float2*>(q_s + (wrow + g + 8) * QS + kk * 8 + 2 * i4);
      uint32_t a_hi[4], a_lo[4];
      split_tf32(x.x * scale, a_hi[0], a_lo[0]);
      split_tf32(y.x * scale, a_hi[1], a_lo[1]);
      split_tf32(x.y * scale, a_hi[2], a_lo[2]);
      split_tf32(y.y * scale, a_hi[3], a_lo[3]);
#pragma unroll
      for (int nt8 = 0; nt8 < 8; ++nt8) {
        if (nt8 < n_nt) {
          const float2 w =
              *reinterpret_cast<const float2*>(ks + (nt8 * 8 + g) * KS + kk * 8 + 2 * i4);
          uint32_t b_hi[2], b_lo[2];
          split_tf32(w.x, b_hi[0], b_lo[0]);
          split_tf32(w.y, b_hi[1], b_lo[1]);
          mma_3xtf32(s[nt8], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }

    // Mask the pairs not allowed (tiles the edge crosses only), the online
    // softmax update, and the probabilities in place of the scores.
    if (edge) {
#pragma unroll
      for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt8 * 8 + 2 * i4 + (e & 1);
          if (!(nt8 < n_nt && key <= rows[e >> 1] + ahead && key < Tl)) s[nt8][e] = kNeg;
        }
    }
    float m_tile[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int e = 0; e < 4; ++e) m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[nt8][e]);
    float corr[2], ml[2], l_tile[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(m_tile[h]));
      corr[h] = exp2f((m[h] - m_new) * kLog2e);
      ml[h] = m_new * kLog2e;
      m[h] = m_new;
    }
#pragma unroll
    for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A masked pair is 0, also in a row that no key has reached yet.
        const float p = edge && s[nt8][e] == kNeg
                            ? 0.0f
                            : exp2f(fmaf(s[nt8][e], kLog2e, -ml[e >> 1]));
        l_tile[e >> 1] += p;
        s[nt8][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + l_tile[h];

    // P V: P's fragment for key group kk is s[kk] permuted (logical k = i
    // is key 2i, k = i + 4 key 2i + 1); V's rows are read in that order.
    // Up to D = 32 the key groups are the outer loop, each group's P split
    // once; wider heads keep the split P whole and take one n8 tile at a
    // time, so that their accumulators stay in registers.
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

  // acc unnormalised, m and l per row (the quad's partials summed; a tile
  // that no key reaches copies l through as it came).
  __syncwarp();  // every lane has read m_in and l_in, which may be m_out, l_out
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = n_kt > 0 ? quad_sum(l[h]) : l[h];
    if (rows[h] >= Tl) continue;
    float* out = acc_out + base + (int64_t)rows[h] * D + 2 * i4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(out + n * 8) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    if (i4 == 0) {
      m_out[bh * Tl + rows[h]] = m[h];
      l_out[bh * Tl + rows[h]] = lt;
    }
  }
}

// 2b. The backward (flash_bwd.cu's tensor-core kernels). Every tile sits in
// shared memory at a row stride of D + 4 floats, so that both ways a tile
// is read (16 rows by 8 columns, and 8 rows by 8 columns with the row
// order permuted) hit 32 distinct banks.
template <int D>
constexpr int kStride = D + 4;
// 8-row groups of a score tile a pass takes (its scores stay in registers);
// at D = 128 one: with flash_bwd.cu's two this kernel spills 700 bytes.
template <int D>
constexpr int kPass = D == 32 ? 8 : (D == 128 ? 1 : 4);
// Blocks an SM, which caps the registers a thread: 5 at D = 16, 3 at
// D = 32; one block at D = 64 and 128.
template <int D>
constexpr int kMinBlocks = D == 16 ? 5 : (D == 32 ? 3 : 1);

// Rows r0 .. r0 + 63 of two [Tl] rows (lse and delta of one bh), zeros past Tl.
__device__ __forceinline__ void stage_rows64(float* l_s, float* d_s, const float* l,
                                             const float* d, int r0, int Tl, int tid) {
  const int r = tid & (kBlock - 1);
  const bool in = r0 + r < Tl;
  if (tid < kBlock)
    cp_async_4(l_s + r, in ? l + r0 + r : l, in);
  else
    cp_async_4(d_s + r, in ? d + r0 + r : d, in);
}

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

// Six 64-row tiles and the dk/dv blocks' staged lse and delta.
template <int D>
constexpr size_t bwd_tc_smem_bytes() {
  return sizeof(float) * (6 * kBlock * kStride<D> + 4 * kBlock);
}

// This round's dq partial of q tile qt: K/V tiles 0 .. n_kt - 1, the last
// that some row of the tile reaches. Not inlined, like bwd_dkv_tile: each
// is allocated its registers alone, which spills less than the two inlined
// into one kernel.
template <int D>
__device__ __noinline__ void bwd_dq_tile(float* smem, const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            float* __restrict__ dq, int64_t bh, int Tl, int nt,
                                            int qt, int ahead, float scale) {
  constexpr int TS = kStride<D>, ND = D / 8, NP = kPass<D>;
  float* q_s = smem;                // [64, TS]
  float* do_s = q_s + kBlock * TS;  // [64, TS]
  float* k_s = do_s + kBlock * TS;  // [2][64, TS]
  float* v_s = k_s + 2 * kBlock * TS;  // [2][64, TS]

  const int q0 = qt * kBlock;
  const int64_t base = bh * Tl * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const int w_first = q0 + wrow, w_last = w_first + 15;
  const int n_kt = clampi(floor_div(min(q0 + kBlock, Tl) - 1 + ahead, kBlock) + 1, 0, nt);

  float acc[1][ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.0f;
  if (n_kt > 0) {
    stage_tile<D, TS>(q_s, q + base, q0, Tl, tid);
    stage_tile<D, TS>(do_s, dout + base, q0, Tl, tid);
    stage_tile<D, TS>(k_s, k + base, 0, Tl, tid);
    stage_tile<D, TS>(v_s, v + base, 0, Tl, tid);
    cp_async_commit();
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < Tl;
    lse2[h] = in ? lse[bh * Tl + rows[h]] * kLog2e : kFar;
    dl[h] = in ? delta[bh * Tl + rows[h]] : 0.0f;
  }
  const float c = scale * kLog2e;
  const float* qw = q_s + wrow * TS;
  const float* dow = do_s + wrow * TS;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      stage_tile<D, TS>(k_s + nb * kBlock * TS, k + base, (kt + 1) * kBlock, Tl, tid);
      stage_tile<D, TS>(v_s + nb * kBlock * TS, v + base, (kt + 1) * kBlock, Tl, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = k_s + (kt & 1) * kBlock * TS;
    const float* vs = v_s + (kt & 1) * kBlock * TS;
    const int k0 = kt * kBlock;
    // The 8-key groups some row of this warp reaches, within the chunk;
    // whether some pair of the warp's rows and those keys is not allowed.
    const int last = clampi(floor_div(w_last + ahead - k0, 8) + 1, 0, min(8, (Tl - k0 + 7) / 8));
    const bool edge = k0 + kBlock - 1 > w_first + ahead || k0 + kBlock > Tl;
#pragma unroll
    for (int c0 = 0; c0 < 8; c0 += NP) {
      if (c0 >= last) continue;
      float s[1][NP][4], dp[NP][4];
      two_products<D, NP>(s[0], dp, qw, dow, ks, vs, c0, 0, last, g, i4);
      // dS in place of the scores; a masked pair is 0.
#pragma unroll
      for (int nt8 = 0; nt8 < NP; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][nt8][e] = ex2(fmaf(s[0][nt8][e], c, -lse2[e >> 1]));
      if (edge) {
#pragma unroll
        for (int nt8 = 0; nt8 < NP; ++nt8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + (c0 + nt8) * 8 + 2 * i4 + (e & 1);
            if (key > rows[e >> 1] + ahead || key >= Tl) s[0][nt8][e] = 0.0f;
          }
      }
#pragma unroll
      for (int nt8 = 0; nt8 < NP; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][nt8][e] *= dp[nt8][e] - dl[e >> 1];
      const float* const bs[1] = {ks};
      add_products<D, NP, 1>(acc, s, bs, c0, 0, last, g, i4);  // dQ += dS K
    }
    __syncthreads();  // the tile is consumed before it is staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= Tl) continue;
    float* out = dq + base + (int64_t)rows[h] * D + 2 * i4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[0][n][2 * h] * scale, acc[0][n][2 * h + 1] * scale);
  }
}

// This round's dk and dv of k tile kt: Q/dO tiles from the first that
// reaches some key of the tile to the last.
template <int D>
__device__ __noinline__ void bwd_dkv_tile(float* smem, const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             float* __restrict__ dk, float* __restrict__ dv,
                                             int64_t bh, int Tl, int nt, int kt, int ahead,
                                             float scale) {
  constexpr int TS = kStride<D>, ND = D / 8, NP = kPass<D>;
  float* k_s = smem;                    // [64, TS]
  float* v_s = k_s + kBlock * TS;       // [64, TS]
  float* q_s = v_s + kBlock * TS;       // [2][64, TS]
  float* do_s = q_s + 2 * kBlock * TS;  // [2][64, TS]
  float* l_s = do_s + 2 * kBlock * TS;  // [2][64]
  float* d_s = l_s + 2 * kBlock;        // [2][64]

  const int k0 = kt * kBlock;
  const int64_t base = bh * Tl * D;
  const float* lb = lse + bh * Tl;
  const float* db = delta + bh * Tl;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, i4 = lane & 3;
  const int wrow = warp * 16;
  const int keys[2] = {k0 + wrow + g, k0 + wrow + g + 8};
  const int w_first = k0 + wrow, w_last = w_first + 15;
  // Query tile qt reaches key k0 when its last row q0 + 63 >= k0 - ahead.
  const int first_qt = clampi(floor_div(k0 - ahead, kBlock), 0, nt);

  float acc[2][ND][4];  // dV, dK
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.0f;
  if (first_qt < nt) {
    stage_tile<D, TS>(k_s, k + base, k0, Tl, tid);
    stage_tile<D, TS>(v_s, v + base, k0, Tl, tid);
    stage_tile<D, TS>(q_s, q + base, first_qt * kBlock, Tl, tid);
    stage_tile<D, TS>(do_s, dout + base, first_qt * kBlock, Tl, tid);
    stage_rows64(l_s, d_s, lb, db, first_qt * kBlock, Tl, tid);
    cp_async_commit();
  }
  const float c = scale * kLog2e;
  const float* kw = k_s + wrow * TS;
  const float* vw = v_s + wrow * TS;

  for (int qt = first_qt; qt < nt; ++qt) {
    const int b = (qt - first_qt) & 1;
    if (qt + 1 < nt) {
      const int nb = b ^ 1, r0 = (qt + 1) * kBlock;
      stage_tile<D, TS>(q_s + nb * kBlock * TS, q + base, r0, Tl, tid);
      stage_tile<D, TS>(do_s + nb * kBlock * TS, dout + base, r0, Tl, tid);
      stage_rows64(l_s + nb * kBlock, d_s + nb * kBlock, lb, db, r0, Tl, tid);
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
    // The 8-query groups that reach some key of this warp (queries past Tl
    // are computed and masked: a bound known at compile time keeps D = 128
    // within its registers); whether some pair of those queries and the
    // warp's keys is not allowed.
    const int first = clampi(floor_div(w_first - ahead - q0, 8), 0, 8);
    const bool edge = w_last > q0 + ahead || q0 + kBlock > Tl;
#pragma unroll
    for (int c0 = 0; c0 < 8; c0 += NP) {
      if (c0 + NP <= first) continue;
      float sp[2][NP][4];  // P^T, then dS^T
      two_products<D, NP>(sp[0], sp[1], kw, vw, qs, dos, c0, first, 8, g, i4);
#pragma unroll
      for (int nt8 = 0; nt8 < NP; ++nt8) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + (c0 + nt8) * 8 + 2 * i4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sp[0][nt8][e] = ex2(fmaf(sp[0][nt8][e], c, -((e & 1) ? l2.y : l2.x) * kLog2e));
      }
      if (edge) {
#pragma unroll
        for (int nt8 = 0; nt8 < NP; ++nt8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + (c0 + nt8) * 8 + 2 * i4 + (e & 1);
            if (keys[e >> 1] > qpos + ahead || qpos >= Tl) sp[0][nt8][e] = 0.0f;
          }
      }
#pragma unroll
      for (int nt8 = 0; nt8 < NP; ++nt8) {
        const float2 d2 = *reinterpret_cast<const float2*>(dls + (c0 + nt8) * 8 + 2 * i4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sp[1][nt8][e] = sp[0][nt8][e] * (sp[1][nt8][e] - ((e & 1) ? d2.y : d2.x));
      }
      const float* const bs[2] = {dos, qs};
      add_products<D, NP, 2>(acc, sp, bs, c0, first, 8, g, i4);  // dV, dK
    }
    __syncthreads();  // the tiles are consumed before they are staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= Tl) continue;
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

// One launch for the round: block b is of rank t = b / (2 BH) by weight,
// the dk/dv block of k tile t and then the dq block of q tile nt - 1 - t
// (the dk/dv block does 4/3 the products of a dq block of as many tiles).
template <int D>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<D>)
    ring_round_bwd_tc(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                      int BH, int Tl, int nt, int ahead, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = (int)(blockIdx.x / (2 * BH));
  const int64_t bh = blockIdx.x % BH;
  if (((blockIdx.x / BH) & 1) == 0)
    bwd_dkv_tile<D>(smem, q, k, v, dout, lse, delta, dk, dv, bh, Tl, nt, t, ahead, scale);
  else
    bwd_dq_tile<D>(smem, q, k, v, dout, lse, delta, dq, bh, Tl, nt, nt - 1 - t, ahead, scale);
}

// --- launches ---------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int64_t blocks, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  if (blocks > 2147483647 || smem > flash::kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Threads for n: whole warps, since every lane of a warp takes part in the
// row sums' shuffles and the warp's reductions.
int whole_warps(int n) { return (n + 31) / 32 * 32; }

template <int D, int kT, bool kAll>
int launch_fwd_short(const float* q, const float* k, const float* v, const float* m_in,
                     const float* l_in, const float* acc_in, float* m_out, float* l_out,
                     float* acc_out, int BH, int Tl, int ahead, float scale,
                     cudaStream_t stream) {
  const int per_slice = Tl * flash::kThreadsPerRow<D>;
  const int S = short_slices(BH, per_slice);
  const size_t smem = sizeof(float) * 2 * (size_t)S * (Tl * D + 4);
  return launch(ring_round_fwd_short<D, kT, kAll>, (BH + S - 1) / S,
                whole_warps(S * per_slice), smem, stream, q, k, v, m_in, l_in, acc_in, m_out,
                l_out, acc_out, BH, Tl, S, ahead, scale);
}

template <int D, int kT>
int launch_fwd_short(const float* q, const float* k, const float* v, const float* m_in,
                     const float* l_in, const float* acc_in, float* m_out, float* l_out,
                     float* acc_out, int BH, int Tl, int ahead, float scale,
                     cudaStream_t stream) {
  if (ahead >= Tl - 1)  // every pair allowed
    return launch_fwd_short<D, kT, true>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out,
                                         BH, Tl, ahead, scale, stream);
  return launch_fwd_short<D, kT, false>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out,
                                        BH, Tl, ahead, scale, stream);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const float* m_in,
               const float* l_in, const float* acc_in, float* m_out, float* l_out,
               float* acc_out, int BH, int Tl, int ahead, float scale, cudaStream_t stream) {
  if (Tl <= 16)
    return launch_fwd_short<D, 16>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl,
                                   ahead, scale, stream);
  if (Tl <= 32)
    return launch_fwd_short<D, 32>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl,
                                   ahead, scale, stream);
  if (Tl <= kShortT)
    return launch_fwd_short<D, 64>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl,
                                   ahead, scale, stream);
  const int nt = (Tl + kBlock - 1) / kBlock;
  return launch(ring_round_fwd_tc<D>, (int64_t)BH * nt, kTcThreads, fwd_tc_smem_bytes<D>(),
                stream, q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, nt, ahead,
                scale);
}

template <int D, bool kAll>
int launch_bwd_short(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq, float* dk, float* dv,
                     int BH, int Tl, int ahead, float scale, cudaStream_t stream) {
  const int per_slice = Tl * flash::kThreadsPerRow<D>;
  const int S = short_slices(BH, per_slice);
  const int nb = (BH + S - 1) / S;
  const size_t smem = sizeof(float) * (2 * (size_t)S * (Tl * D + 4) + 2 * (size_t)S * Tl);
  return launch(ring_round_bwd_short<D, kAll>, 2 * (int64_t)nb, whole_warps(S * per_slice),
                smem, stream, q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, S, nb, ahead,
                scale);
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dq, float* dk, float* dv, int BH,
               int Tl, int ahead, float scale, cudaStream_t stream) {
  if (Tl <= kShortT) {
    if (ahead >= Tl - 1)  // every pair allowed
      return launch_bwd_short<D, true>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, ahead,
                                       scale, stream);
    return launch_bwd_short<D, false>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, ahead,
                                      scale, stream);
  }
  const int nt = (Tl + kBlock - 1) / kBlock;
  return launch(ring_round_bwd_tc<D>, 2 * (int64_t)BH * nt, kTcThreads, bwd_tc_smem_bytes<D>(),
                stream, q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, nt, ahead, scale);
}

// q_off - k_off clamped to [-Tl, Tl]: the same pairs allowed.
int ahead_of(int q_off, int k_off, int Tl) {
  const long long a = (long long)q_off - (long long)k_off;
  return (int)(a < -Tl ? -Tl : (a > Tl ? Tl : a));
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// One forward ring round: m_out, l_out [BH, Tl] and acc_out [BH, Tl, D]
// from q, k, v [BH, Tl, D] and the running m_in, l_in, acc_in, all
// contiguous f32 on one device, the [BH, Tl, D] ones 16-byte aligned;
// q_off and k_off are the global positions of the local chunk's and the
// visiting block's first rows; D in {16, 32, 64, 128}. The outputs may be
// the inputs. Returns 0, or the CUDA error code.
int tpuflow_ring_round_fwd_f32(const float* q, const float* k, const float* v,
                               const float* m_in, const float* l_in,
                               const float* acc_in, float* m_out, float* l_out,
                               float* acc_out, int BH, int Tl, int D,
                               int q_off, int k_off, float scale,
                               void* stream) {
  if (BH <= 0 || Tl <= 0) return 0;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(acc_in) &&
        aligned16(acc_out)))
    return (int)cudaErrorMisalignedAddress;
  const int a = ahead_of(q_off, k_off, Tl);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_fwd<16>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, a, scale, s);
    case 32: return launch_fwd<32>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, a, scale, s);
    case 64: return launch_fwd<64>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, a, scale, s);
    case 128: return launch_fwd<128>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, a, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One backward ring round: dq, dk, dv [BH, Tl, D] from q, k, v, do
// [BH, Tl, D] and the final lse, delta [BH, Tl], with the forward's
// offsets; the [BH, Tl, D] ones 16-byte aligned. Returns 0, or the CUDA
// error code.
int tpuflow_ring_round_bwd_f32(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* delta, float* dq, float* dk,
                               float* dv, int BH, int Tl, int D, int q_off,
                               int k_off, float scale, void* stream) {
  if (BH <= 0 || Tl <= 0) return 0;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq) &&
        aligned16(dk) && aligned16(dv)))
    return (int)cudaErrorMisalignedAddress;
  const int a = ahead_of(q_off, k_off, Tl);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bwd<16>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, a, scale, s);
    case 32: return launch_bwd<32>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, a, scale, s);
    case 64: return launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, a, scale, s);
    case 128: return launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, a, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
