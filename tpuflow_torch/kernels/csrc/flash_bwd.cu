// Causal flash-attention backward on Hopper (sm_90a), float32: dQ, and dK
// with dV.
//
// Replaces the two Pallas TPU kernels that tpuflow/kernels/attention.py::_bwd
// launches with pl.pallas_call for the custom VJP of flash_attention:
// - flash_dq_f32_kernel replaces _dq_kernel:
//     dq_t = scale * sum_{j <= t} dS_tj k_j
// - flash_dkv_f32_kernel replaces _dkv_kernel:
//     dk_j = scale * sum_{t >= j} dS_tj q_t,   dv_j = sum_{t >= j} P_tj do_t
// with the probabilities recomputed from the forward's log-sum-exp,
//     P_tj = exp(scale * q_t . k_j - lse_t),
//     dS_tj = P_tj * (do_t . v_j - delta_t),   delta_t = do_t . o_t,
// where delta comes from the caller (the JAX package also computes it
// outside its kernels). Masked pairs (j > t) have P = 0 and are skipped, so
// no exp of a masked score and no inf * 0 can reach dS.
//
// What bounds them on an H100: each reads q, k, v, do, lse and delta once
// and writes its gradients, and does 6 * D (dQ) or 8 * D (dK/dV) operations
// for each of the T(T+1)/2 causal pairs of a head. Operations over bytes
// is about (T + 1) / 8 and (T + 1) / 7 against the card's ratio of 20 (67
// TFLOP/s f32 over 3.35 TB/s): at the model's windows (T = 24, D = 16)
// bytes bound both, from T of about 150 the operations do.
//
// Design (simple and right first; wgmma, TMA and bf16 are later work):
// - flash_dq: one block per (bh, 64-row q tile), tiled as flash_fwd.cu:
//   D / 16 threads share a q row and hold 16 dimensions each of q, do and
//   the dq accumulator in registers in f32; 64-row K/V tiles are staged in
//   shared memory, up to the diagonal; dq is scaled once at the end;
// - flash_dkv: one block per (bh, 64-row k tile); the threads of a key row
//   hold 16 dimensions each of k, v, and the dk and dv accumulators; the
//   loop runs over 64-row q tiles from the diagonal to the end, staging q,
//   do, lse and delta in shared memory;
// - each block owns its output tile, so there are no atomics and gradients
//   are the same from run to run; blocks run in any order and nothing
//   carries over between them;
// - rows past T load zeros, compute with every pair masked and store
//   nothing.

#include "flash_common.cuh"

namespace {

using flash::kBlock;
using flash::kDimsPerThread;

template <int D>
__global__ void __launch_bounds__(kBlock * flash::kThreadsPerRow<D>)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int T, float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  constexpr int kThreads = kBlock * G;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // [kBlock, D]
  float* v_s = k_s + kBlock * D;  // [kBlock, D]

  const int tid = threadIdx.x;
  const int r = tid / G;
  const int d0 = (tid % G) * E;
  const int64_t base = (int64_t)blockIdx.x * T * D;
  const int q0 = blockIdx.y * kBlock;
  const int qpos = q0 + r;
  const bool row_ok = qpos < T;

  float qr[E], dor[E], acc[E];
  flash::load_row<D>(qr, q + base, qpos, row_ok, d0);
  flash::load_row<D>(dor, dout + base, qpos, row_ok, d0);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  const int64_t row = (int64_t)blockIdx.x * T + qpos;
  const float lse_r = row_ok ? lse[row] : 0.0f;
  const float delta_r = row_ok ? delta[row] : 0.0f;

  const int q_last = min(q0 + kBlock, T) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += kBlock) {  // causal: up to the diagonal
    const int nk = min(kBlock, T - k0);
    __syncthreads();
    flash::stage_rows<D>(k_s, k + base, k0, nk, tid, kThreads);
    flash::stage_rows<D>(v_s, v + base, k0, nk, tid, kThreads);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {  // the same trip count in every thread
      const float* kj = k_s + j * D + d0;
      const float s = scale * flash::row_sum<G>(flash::dot16(qr, kj));
      const float dp = flash::row_sum<G>(flash::dot16(dor, v_s + j * D + d0));
      const bool allowed = row_ok && k0 + j <= qpos;
      const float p = allowed ? expf(s - lse_r) : 0.0f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(ds, kj[e], acc[e]);
    }
  }

  if (row_ok) {
    float* out = dq + base + (int64_t)qpos * D + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = acc[e] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kBlock * flash::kThreadsPerRow<D>)
    flash_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int T,
                         float scale) {
  constexpr int G = flash::kThreadsPerRow<D>;
  constexpr int E = kDimsPerThread;
  constexpr int kThreads = kBlock * G;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [kBlock, D]
  float* do_s = q_s + kBlock * D;     // [kBlock, D]
  float* lse_s = do_s + kBlock * D;   // [kBlock]
  float* delta_s = lse_s + kBlock;    // [kBlock]

  const int tid = threadIdx.x;
  const int r = tid / G;              // this thread's key row in the k tile
  const int d0 = (tid % G) * E;
  const int64_t base = (int64_t)blockIdx.x * T * D;
  const int k0 = blockIdx.y * kBlock;
  const int kpos = k0 + r;
  const bool key_ok = kpos < T;

  float kr[E], vr[E], dk_acc[E], dv_acc[E];
  flash::load_row<D>(kr, k + base, kpos, key_ok, d0);
  flash::load_row<D>(vr, v + base, kpos, key_ok, d0);
#pragma unroll
  for (int e = 0; e < E; ++e) dk_acc[e] = dv_acc[e] = 0.0f;

  // Causal: q tiles wholly before this k tile contribute nothing, so the
  // loop starts at the diagonal tile.
  for (int q0 = k0; q0 < T; q0 += kBlock) {
    const int nq = min(kBlock, T - q0);
    __syncthreads();
    flash::stage_rows<D>(q_s, q + base, q0, nq, tid, kThreads);
    flash::stage_rows<D>(do_s, dout + base, q0, nq, tid, kThreads);
    for (int i = tid; i < nq; i += kThreads) {
      lse_s[i] = lse[(int64_t)blockIdx.x * T + q0 + i];
      delta_s[i] = delta[(int64_t)blockIdx.x * T + q0 + i];
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {  // the same trip count in every thread
      const float* qi = q_s + i * D + d0;
      const float* doi = do_s + i * D + d0;
      const float s = scale * flash::row_sum<G>(flash::dot16(kr, qi));
      const float dp = flash::row_sum<G>(flash::dot16(vr, doi));
      const bool allowed = key_ok && kpos <= q0 + i;
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
    const int64_t o = base + (int64_t)kpos * D + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[o + e] = dk_acc[e] * scale;
      dv[o + e] = dv_acc[e];
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem, int T, dim3* grid, int BH) {
  if ((T + kBlock - 1) / kBlock > 65535) return (int)cudaErrorInvalidValue;
  if (smem > flash::kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  *grid = dim3((unsigned)BH, (unsigned)((T + kBlock - 1) / kBlock));
  return (int)err;
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, int BH, int T,
              float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kBlock * D;
  dim3 grid;
  int err = prepare(flash_dq_f32_kernel<D>, smem, T, &grid, BH);
  if (err != 0) return err;
  flash_dq_f32_kernel<D>
      <<<grid, kBlock * flash::kThreadsPerRow<D>, smem, stream>>>(
          q, k, v, dout, lse, delta, dq, T, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int BH, int T, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBlock * D + 2 * kBlock);
  dim3 grid;
  int err = prepare(flash_dkv_f32_kernel<D>, smem, T, &grid, BH);
  if (err != 0) return err;
  flash_dkv_f32_kernel<D>
      <<<grid, kBlock * flash::kThreadsPerRow<D>, smem, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dq [BH, T, D] from q, k, v, do [BH, T, D] and lse, delta [BH, T], all
// contiguous f32 on one device; D in {16, 32, 64, 128}. Returns 0, or the
// CUDA error code.
int tpuflow_flash_dq_f32(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, float* dq, int BH, int T, int D,
                         float scale, void* stream) {
  if (BH <= 0 || T <= 0) return 0;
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
