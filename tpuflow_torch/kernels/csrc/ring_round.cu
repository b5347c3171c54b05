// One causal context-parallel ring round on Hopper (sm_90a), float32: the
// forward update of the running softmax statistics, and the backward's
// partial gradients.
//
// Replaces the two Pallas TPU kernels at the bottom of
// tpuflow/kernels/attention.py, which parallel/ring_attention.py drives
// round by round while the K/V blocks travel the ring:
// - ring_round_fwd_f32_kernel replaces _round_fwd_kernel (launched by
//   ring_round_fwd with pl.pallas_call). For the local q chunk of one
//   batch-head, at global offset q_off, and the visiting K/V block, at
//   global offset k_off (both Tl rows), it updates the running (m, l, acc):
//       s_ij = scale * q_i . k_j   for the allowed pairs k_off + j <= q_off + i
//       m'   = max(m, max_j s_ij),  l = l e^(m - m') + sum_j e^(s_ij - m'),
//       acc  = acc e^(m - m') + sum_j e^(s_ij - m') v_j;
// - ring_round_bwd_f32_kernel replaces _round_bwd_kernel (launched by
//   ring_round_bwd). From the final lse and delta = rowsum(do * o), with
//   P_ij = exp(s_ij - lse_i) and dS_ij = P_ij (do_i . v_j - delta_i) over
//   the allowed pairs, it writes this round's partials
//       dq_i = scale sum_j dS_ij k_j,
//       dk_j = scale sum_i dS_ij q_i,   dv_j = sum_i P_ij do_i.
//
// What bounds them on an H100: a round reads its inputs once (q, k, v and
// acc, or q, k, v and do, of Tl x D floats a head, and two rows of stats)
// and writes its outputs once, and does 4 * D (forward) or 10 * D
// (backward) operations for each allowed pair: Tl(Tl+1)/2 on the diagonal
// round, Tl^2 for a block from the past, none for one from the future. At
// the ring training's Tl = 64, D = 16 the bytes bound a round; at Tl = 256
// the operations do on the diagonal and past rounds.
//
// Design (a simple kernel that is right; wgmma, TMA and bf16 are later
// work), the tiling of flash_fwd.cu and flash_bwd.cu:
// - 64-row tiles, D / 16 neighbouring threads a row, each holding 16 of
//   its dimensions in registers in f32 and summing a row's dot products
//   with warp shuffles (flash_common.cuh);
// - forward: one block per (bh, 64-row q tile). It loads the running m, l
//   and acc of its rows, loops over the visiting block's 64-row K/V tiles
//   (staged in shared memory) up to the causal edge, and writes m, l and
//   acc out. The wrapper passes fresh output buffers, as the JAX kernel
//   returns new arrays; input and output may also be the same buffers,
//   since each block reads its rows before it writes them;
// - backward: one launch a round, as on the TPU, with a grid of (bh, tile,
//   2). Blocks with z = 0 compute the dq partial of q tile i over the K/V
//   tiles up to the causal edge, scaled once at the end; blocks with z = 1
//   compute dk and dv of k tile i over the q tiles from the first one that
//   reaches it. Each block owns its output rows: no atomics, and the
//   gradients repeat run to run;
// - the causal edges use floor division: a block wholly in the future has
//   negative numerators, which C's truncating division would round up to
//   one spurious tile. Such a round runs no tile: the forward copies its
//   stats through, the backward writes zeros;
// - nothing is padded: rows past Tl load zeros, count as wholly masked and
//   store nothing, and a masked probability is set to 0 rather than
//   computed, so no exp of a masked score and no inf * 0 can arise.

#include "flash_common.cuh"

namespace {

using flash::kBlock;
using flash::kDimsPerThread;
constexpr float kNeg = -1e30f;  // the reference's finite mask value
constexpr int kScoreStride = kBlock + 1;

// a // b rounded toward minus infinity, for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int clamp_tiles(int n, int nt) {
  return n < 0 ? 0 : (n > nt ? nt : n);
}

// K/V tiles of the visiting block that reach the q tile [q0, q0 + 64) of
// the local chunk: those whose first key is at or before its last query.
__device__ __forceinline__ int k_tiles(int q0, int Tl, int q_off, int k_off) {
  const int q_last = q_off + min(q0 + kBlock, Tl) - 1;
  return clamp_tiles(floor_div(q_last - k_off, kBlock) + 1,
                     (Tl + kBlock - 1) / kBlock);
}

template <int D>
__global__ void __launch_bounds__(kBlock * flash::kThreadsPerRow<D>)
    ring_round_fwd_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v, const float* m_in,
                              const float* l_in, const float* acc_in,
                              float* m_out, float* l_out, float* acc_out,
                              int Tl, int q_off, int k_off, float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  constexpr int kThreads = kBlock * G;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // [kBlock, D]
  float* v_s = k_s + kBlock * D;  // [kBlock, D]
  float* s_s = v_s + kBlock * D;  // [kBlock, kScoreStride]

  const int tid = threadIdx.x;
  const int r = tid / G;            // this thread's row in the q tile
  const int d0 = (tid % G) * E;     // its first dimension
  const int64_t base = (int64_t)blockIdx.x * Tl * D;
  const int q0 = blockIdx.y * kBlock;
  const int qi = q0 + r;            // its row in the local chunk
  const bool row_ok = qi < Tl;
  const int qpos = q_off + qi;      // its global position
  const int64_t row = (int64_t)blockIdx.x * Tl + qi;

  float qr[E], acc[E];
  flash::load_row<D>(qr, q + base, qi, row_ok, d0);
  flash::load_row<D>(acc, acc_in + base, qi, row_ok, d0);
  float m = row_ok ? m_in[row] : kNeg;
  float l = row_ok ? l_in[row] : 0.0f;

  const int n_kb = k_tiles(q0, Tl, q_off, k_off);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlock;
    const int nk = min(kBlock, Tl - k0);
    __syncthreads();  // the previous tile is consumed
    flash::stage_rows<D>(k_s, k + base, k0, nk, tid, kThreads);
    flash::stage_rows<D>(v_s, v + base, k0, nk, tid, kThreads);
    __syncthreads();

    float m_tile = kNeg;
    for (int j = 0; j < nk; ++j) {  // the same trip count in every thread
      const float s = scale * flash::row_sum<G>(flash::dot16(qr, k_s + j * D + d0));
      const float sm = (row_ok && k_off + k0 + j <= qpos) ? s : kNeg;
      m_tile = fmaxf(m_tile, sm);
      if (d0 == 0) s_s[r * kScoreStride + j] = sm;
    }
    __syncwarp();  // the row's threads share a warp and read its scores

    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
    for (int j = 0; j < nk; ++j) {
      const bool allowed = row_ok && k_off + k0 + j <= qpos;
      const float p = allowed ? expf(s_s[r * kScoreStride + j] - m_new) : 0.0f;
      l += p;
      const float* vj = v_s + j * D + d0;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vj[e], acc[e]);
    }
    m = m_new;
  }

  if (row_ok) {
    float* out = acc_out + base + (int64_t)qi * D + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = acc[e];
    if (d0 == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBlock * flash::kThreadsPerRow<D>)
    ring_round_bwd_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, float* __restrict__ dk,
                              float* __restrict__ dv, int Tl, int q_off,
                              int k_off, float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  constexpr int kThreads = kBlock * G;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                // [kBlock, D]: k (dq) or q (dk/dv)
  float* b_s = a_s + kBlock * D;    // [kBlock, D]: v (dq) or do (dk/dv)
  float* lse_s = b_s + kBlock * D;  // [kBlock] (dk/dv)
  float* delta_s = lse_s + kBlock;  // [kBlock] (dk/dv)

  const int tid = threadIdx.x;
  const int r = tid / G;
  const int d0 = (tid % G) * E;
  const int64_t base = (int64_t)blockIdx.x * Tl * D;
  const int64_t rows = (int64_t)blockIdx.x * Tl;
  const int t0 = blockIdx.y * kBlock;  // this block's tile in the chunk
  const int nt = (Tl + kBlock - 1) / kBlock;

  if (blockIdx.z == 0) {
    // dq partial of q tile t0 over the visiting block's tiles up to the edge.
    const int qi = t0 + r;
    const bool row_ok = qi < Tl;
    const int qpos = q_off + qi;
    float qr[E], dor[E], acc[E];
    flash::load_row<D>(qr, q + base, qi, row_ok, d0);
    flash::load_row<D>(dor, dout + base, qi, row_ok, d0);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    const float lse_r = row_ok ? lse[rows + qi] : 0.0f;
    const float delta_r = row_ok ? delta[rows + qi] : 0.0f;

    const int n_kb = k_tiles(t0, Tl, q_off, k_off);
    for (int kb = 0; kb < n_kb; ++kb) {
      const int k0 = kb * kBlock;
      const int nk = min(kBlock, Tl - k0);
      __syncthreads();
      flash::stage_rows<D>(a_s, k + base, k0, nk, tid, kThreads);
      flash::stage_rows<D>(b_s, v + base, k0, nk, tid, kThreads);
      __syncthreads();
      for (int j = 0; j < nk; ++j) {  // the same trip count in every thread
        const float* kj = a_s + j * D + d0;
        const float s = scale * flash::row_sum<G>(flash::dot16(qr, kj));
        const float dp = flash::row_sum<G>(flash::dot16(dor, b_s + j * D + d0));
        const bool allowed = row_ok && k_off + k0 + j <= qpos;
        const float p = allowed ? expf(s - lse_r) : 0.0f;
        const float ds = p * (dp - delta_r);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(ds, kj[e], acc[e]);
      }
    }
    if (row_ok) {
      float* out = dq + base + (int64_t)qi * D + d0;
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = acc[e] * scale;
    }
    return;
  }

  // dk, dv of k tile t0 over the local q tiles from the first that reaches it.
  const int ki = t0 + r;
  const bool key_ok = ki < Tl;
  const int kpos = k_off + ki;
  float kr[E], vr[E], dk_acc[E], dv_acc[E];
  flash::load_row<D>(kr, k + base, ki, key_ok, d0);
  flash::load_row<D>(vr, v + base, ki, key_ok, d0);
#pragma unroll
  for (int e = 0; e < E; ++e) dk_acc[e] = dv_acc[e] = 0.0f;

  const int first_qb = clamp_tiles(floor_div(k_off + t0 - q_off, kBlock), nt);
  for (int qb = first_qb; qb < nt; ++qb) {
    const int q0 = qb * kBlock;
    const int nq = min(kBlock, Tl - q0);
    __syncthreads();
    flash::stage_rows<D>(a_s, q + base, q0, nq, tid, kThreads);
    flash::stage_rows<D>(b_s, dout + base, q0, nq, tid, kThreads);
    for (int i = tid; i < nq; i += kThreads) {
      lse_s[i] = lse[rows + q0 + i];
      delta_s[i] = delta[rows + q0 + i];
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {  // the same trip count in every thread
      const float* qi = a_s + i * D + d0;
      const float* doi = b_s + i * D + d0;
      const float s = scale * flash::row_sum<G>(flash::dot16(kr, qi));
      const float dp = flash::row_sum<G>(flash::dot16(vr, doi));
      const bool allowed = key_ok && kpos <= q_off + q0 + i;
      const float p = allowed ? expf(s - lse_s[i]) : 0.0f;
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dv_acc[e] = fmaf(p, doi[e], dv_acc[e]);
        dk_acc[e] = fmaf(ds, qi[e], dk_acc[e]);
      }
    }
  }
  if (key_ok) {
    const int64_t o = base + (int64_t)ki * D + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[o + e] = dk_acc[e] * scale;
      dv[o + e] = dv_acc[e];
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > flash::kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* m_in, const float* l_in, const float* acc_in,
               float* m_out, float* l_out, float* acc_out, int BH, int Tl,
               int q_off, int k_off, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBlock * D + kBlock * kScoreStride);
  int err = prepare(ring_round_fwd_f32_kernel<D>, smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)BH, (unsigned)((Tl + kBlock - 1) / kBlock));
  ring_round_fwd_f32_kernel<D>
      <<<grid, kBlock * flash::kThreadsPerRow<D>, smem, stream>>>(
          q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, Tl, q_off,
          k_off, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, int BH, int Tl, int q_off,
               int k_off, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBlock * D + 2 * kBlock);
  int err = prepare(ring_round_bwd_f32_kernel<D>, smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)BH, (unsigned)((Tl + kBlock - 1) / kBlock), 2);
  ring_round_bwd_f32_kernel<D>
      <<<grid, kBlock * flash::kThreadsPerRow<D>, smem, stream>>>(
          q, k, v, dout, lse, delta, dq, dk, dv, Tl, q_off, k_off, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One forward ring round: m_out, l_out [BH, Tl] and acc_out [BH, Tl, D]
// from q, k, v [BH, Tl, D] and the running m_in, l_in, acc_in, all
// contiguous f32 on one device; q_off and k_off are the global positions of
// the local chunk's and the visiting block's first rows; D in {16, 32, 64,
// 128}. The outputs may be the inputs. Returns 0, or the CUDA error code.
int tpuflow_ring_round_fwd_f32(const float* q, const float* k, const float* v,
                               const float* m_in, const float* l_in,
                               const float* acc_in, float* m_out, float* l_out,
                               float* acc_out, int BH, int Tl, int D,
                               int q_off, int k_off, float scale,
                               void* stream) {
  if (BH <= 0 || Tl <= 0) return 0;
  if ((Tl + kBlock - 1) / kBlock > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_fwd<16>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, q_off, k_off, scale, s);
    case 32: return launch_fwd<32>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, q_off, k_off, scale, s);
    case 64: return launch_fwd<64>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, q_off, k_off, scale, s);
    case 128: return launch_fwd<128>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH, Tl, q_off, k_off, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One backward ring round: dq, dk, dv [BH, Tl, D] from q, k, v, do
// [BH, Tl, D] and the final lse, delta [BH, Tl], with the forward's
// offsets. Returns 0, or the CUDA error code.
int tpuflow_ring_round_bwd_f32(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* delta, float* dq, float* dk,
                               float* dv, int BH, int Tl, int D, int q_off,
                               int k_off, float scale, void* stream) {
  if (BH <= 0 || Tl <= 0) return 0;
  if ((Tl + kBlock - 1) / kBlock > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bwd<16>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, q_off, k_off, scale, s);
    case 32: return launch_bwd<32>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, q_off, k_off, scale, s);
    case 64: return launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, q_off, k_off, scale, s);
    case 128: return launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Tl, q_off, k_off, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
