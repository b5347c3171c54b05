// Causal flash-attention forward on Hopper (sm_90a), float32.
//
// Replaces tpuflow/kernels/attention.py::_fwd_kernel, the Pallas TPU kernel
// that tpuflow/kernels/attention.py::_fwd launches with pl.pallas_call for
// flash_attention. Same function: for q, k, v [BH, T, D] (heads folded into
// the batch axis) and each row t,
//     s_j  = scale * q_t . k_j            for j <= t (causal)
//     o_t  = sum_j softmax(s)_j v_j,      lse_t = log sum_j exp(s_j)
// by the online softmax over tiles of keys: per tile, m' = max(m, max s),
// l = l * exp(m - m') + sum exp(s - m'), acc = acc * exp(m - m') +
// exp(s - m') @ V, and at the end o = acc / l, lse = m + log(l), with l = 0
// read as 1 (the reference's l_safe).
//
// What bounds it on an H100: per head it reads q, k, v once and writes o and
// lse (about 16 * T * D bytes) and does 4 * D operations for each of the
// T(T+1)/2 causal pairs. Operations over bytes is about (T + 1) / 8, against
// the card's 67 TFLOP/s f32 over 3.35 TB/s = 20: at the model's windows
// (T = 24, D = 16) bytes bound it, from T of about 160 the operations do.
//
// Design (a simple kernel that is right; wgmma, TMA and bf16 are later
// work):
// - one block per (bh, 64-row q tile); D / 16 neighbouring threads share a
//   q row, each holding 16 of its dimensions of q and of the accumulator in
//   registers in f32, with the row's m and l; a row's dot products are
//   summed over those threads with warp shuffles;
// - the loop over 64-row K/V tiles stops at the tile that holds the q
//   tile's last row (the causal skip); each K/V tile is staged in shared
//   memory once and read by all 64 rows, so a byte of k or v comes from
//   device memory (or L2) once per q tile at or below it;
// - the tile's scores go through shared memory (a [64, 65] tile, padded
//   against bank conflicts) between the max pass and the exp pass. A masked
//   score is the finite -1e30 of the reference, and its probability is set
//   to 0 instead of computed, so no inf or NaN can arise;
// - QK^T and PV are f32 FMAs on the CUDA cores;
// - the ragged last tile is masked by T: rows >= T load zeros, compute
//   with every key masked and store nothing, so no padding is needed.

#include "flash_common.cuh"

namespace {

using flash::kBlock;
using flash::kDimsPerThread;
constexpr float kNeg = -1e30f;  // the reference's finite mask value
constexpr int kScoreStride = kBlock + 1;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlock * D + kBlock * kScoreStride);
}

template <int D>
__global__ void __launch_bounds__(kBlock * flash::kThreadsPerRow<D>)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int T, float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  constexpr int kThreads = kBlock * G;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                // [kBlock, D]
  float* v_s = k_s + kBlock * D;    // [kBlock, D]
  float* s_s = v_s + kBlock * D;    // [kBlock, kScoreStride]

  const int tid = threadIdx.x;
  const int r = tid / G;            // this thread's row in the q tile
  const int d0 = (tid % G) * E;     // its first dimension
  const int64_t base = (int64_t)blockIdx.x * T * D;
  const int q0 = blockIdx.y * kBlock;
  const int qpos = q0 + r;
  const bool row_ok = qpos < T;

  float qr[E], acc[E];
  flash::load_row<D>(qr, q + base, qpos, row_ok, d0);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  float m = kNeg, l = 0.0f;

  const int q_last = min(q0 + kBlock, T) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += kBlock) {  // causal: up to the diagonal
    const int nk = min(kBlock, T - k0);
    __syncthreads();  // the previous tile is consumed
    flash::stage_rows<D>(k_s, k + base, k0, nk, tid, kThreads);
    flash::stage_rows<D>(v_s, v + base, k0, nk, tid, kThreads);
    __syncthreads();

    // Scores of the tile, masked to -1e30, and their max.
    float m_tile = kNeg;
    for (int j = 0; j < nk; ++j) {  // the same trip count in every thread
      const float s = scale * flash::row_sum<G>(flash::dot16(qr, k_s + j * D + d0));
      const float sm = (row_ok && k0 + j <= qpos) ? s : kNeg;
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
      const bool allowed = row_ok && k0 + j <= qpos;
      const float p = allowed ? expf(s_s[r * kScoreStride + j] - m_new) : 0.0f;
      l += p;
      const float* vj = v_s + j * D + d0;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vj[e], acc[e]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float l_safe = l == 0.0f ? 1.0f : l;
    float* out = o + base + (int64_t)qpos * D + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = acc[e] / l_safe;
    if (d0 == 0) lse[(int64_t)blockIdx.x * T + qpos] = m + logf(l_safe);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int BH, int T, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= flash::kMaxSharedBytes, "tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)BH, (unsigned)((T + kBlock - 1) / kBlock));
  flash_fwd_f32_kernel<D>
      <<<grid, kBlock * flash::kThreadsPerRow<D>, smem, stream>>>(
          q, k, v, o, lse, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o [BH, T, D] and lse [BH, T] from q, k, v [BH, T, D], all contiguous f32
// on one device; D in {16, 32, 64, 128}. Returns 0, or the CUDA error code.
int tpuflow_flash_fwd_f32(const float* q, const float* k, const float* v,
                          float* o, float* lse, int BH, int T, int D,
                          float scale, void* stream) {
  if (BH <= 0 || T <= 0) return 0;
  if ((T + kBlock - 1) / kBlock > 65535) return (int)cudaErrorInvalidValue;
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
