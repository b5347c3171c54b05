// Forward LSTM recurrence on Hopper (sm_90a), float32.
//
// Replaces tpuflow/kernels/lstm.py::_fwd_kernel, the Pallas TPU kernel that
// tpuflow/kernels/lstm.py::_fwd launches with pl.pallas_call for lstm_scan.
// Same function: from zero state, for t = 0..T-1
//     z   = xw_t + h @ W_h + b            (f32 accumulation)
//     i, f, g, o = split(z, 4)            (gate order i, f, g, o)
//     c   = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h   = sigmoid(o) * tanh(c)
// writing hs[t] = h and, when the caller passes a buffer, cs[t] = c.
//
// What bounds it on an H100: at the serving shape (T=24, B=4096, H=64) the
// recurrent product h @ W_h is 2*H*4H = 32768 operations per row and step,
// 3.2 GFLOP in all, against 100 MB of xw read and 25 MB of hs written. On the
// CUDA cores' f32 rate that is more time than the bytes take, so the bound is
// the operations; the work is also a chain of T dependent steps per row.
//
// Design (a simple kernel that is right; tensor cores, cp.async/TMA and
// larger tiles are later work):
// - one block per tile of kRowsPerThread * blockDim.y batch rows. Thread
//   (j, y) owns hidden unit j of kRowsPerThread rows and computes the four
//   gate pre-activations of columns j, H+j, 2H+j, 3H+j, so the gate math
//   needs no exchange between threads, and it keeps c in registers in f32;
// - W_h (H x 4H f32, 64 KB at H=64) is copied once into dynamic shared
//   memory and read from there for all T steps; each value read feeds
//   kRowsPerThread rows, and neighbouring threads read neighbouring columns;
// - h of the tile lives in shared memory, double buffered (read one buffer,
//   write the other), so one __syncthreads() per step suffices;
// - xw_t is read from global memory each step (coalesced along j), so there
//   is no ceiling on T and no padding of the batch;
// - rows past the batch edge compute on zeros and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerThread = 8;
constexpr int kThreadsPerBlock = 256;
constexpr size_t kMaxSharedBytes = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__global__ void lstm_fwd_f32_kernel(const float* __restrict__ xw,
                                    const float* __restrict__ wh,
                                    const float* __restrict__ bias,
                                    float* __restrict__ hs,
                                    float* __restrict__ cs,
                                    int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kRowsPerThread;
  const int H4 = 4 * H;
  const int tile_rows = R * blockDim.y;
  float* w_s = smem;              // [H, 4H]
  float* h_s = smem + H * H4;     // [2, tile_rows, H]

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < H * H4; i += nthreads) w_s[i] = wh[i];
  for (int i = tid; i < 2 * tile_rows * H; i += nthreads) h_s[i] = 0.0f;

  const int j = threadIdx.x;
  const int r0 = threadIdx.y * R;  // this thread's first row in the tile
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows + r0;
  const float bi = bias[j];
  const float bf = bias[H + j];
  const float bg = bias[2 * H + j];
  const float bo = bias[3 * H + j];

  float c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h_in = h_s + (t & 1) * tile_rows * H;
    float* h_out = h_s + ((t + 1) & 1) * tile_rows * H;

    // This step's input projection; used only after the product below, so
    // the loads' latency hides behind it.
    float xi[R], xf[R], xg[R], xo[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = row0 + r;
      if (row < B) {
        const float* x = xw + ((int64_t)t * B + row) * H4;
        xi[r] = x[j];
        xf[r] = x[H + j];
        xg[r] = x[2 * H + j];
        xo[r] = x[3 * H + j];
      } else {
        xi[r] = xf[r] = xg[r] = xo[r] = 0.0f;
      }
    }

    // h @ W_h for the four gate columns of unit j.
    float ai[R], af[R], ag[R], ao[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ai[r] = af[r] = ag[r] = ao[r] = 0.0f;
    for (int k = 0; k < H; k += 4) {
      float4 hv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        hv[r] = *reinterpret_cast<const float4*>(h_in + (r0 + r) * H + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* w = w_s + (k + kk) * H4;
        const float wi = w[j];
        const float wf = w[H + j];
        const float wg = w[2 * H + j];
        const float wo = w[3 * H + j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = lane_of(hv[r], kk);
          ai[r] = fmaf(hk, wi, ai[r]);
          af[r] = fmaf(hk, wf, af[r]);
          ag[r] = fmaf(hk, wg, ag[r]);
          ao[r] = fmaf(hk, wo, ao[r]);
        }
      }
    }

    // Gate math, in the reference's order: (xw + h @ W_h) + b.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float zi = (xi[r] + ai[r]) + bi;
      const float zf = (xf[r] + af[r]) + bf;
      const float zg = (xg[r] + ag[r]) + bg;
      const float zo = (xo[r] + ao[r]) + bo;
      const float cn = sigmoid_f32(zf) * c[r] + sigmoid_f32(zi) * tanhf(zg);
      const float hn = sigmoid_f32(zo) * tanhf(cn);
      c[r] = cn;
      h_out[(r0 + r) * H + j] = hn;
      const int64_t row = row0 + r;
      if (row < B) {
        const int64_t o = ((int64_t)t * B + row) * H + j;
        hs[o] = hn;
        if (cs != nullptr) cs[o] = cn;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launch shape for hidden size H: blockDim (H, y) with y = 256 / H, and
// kRowsPerThread * y rows a block. Returns 0, or the CUDA error code.
int tpuflow_lstm_fwd_f32(const float* xw, const float* wh, const float* b,
                         float* hs, float* cs, int T, int B, int H,
                         void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H <= 0 || H % 4 != 0 || H > kThreadsPerBlock)
    return (int)cudaErrorInvalidValue;
  const int ty = kThreadsPerBlock / H;
  const int tile_rows = ty * kRowsPerThread;
  const size_t smem =
      sizeof(float) * ((size_t)H * 4 * H + 2 * (size_t)tile_rows * H);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(H, ty);
  const dim3 grid((unsigned)((B + tile_rows - 1) / tile_rows));
  lstm_fwd_f32_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      xw, wh, b, hs, cs, T, B, H);
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
