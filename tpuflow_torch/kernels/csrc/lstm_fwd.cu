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
//   kRowsPerThread rows, and neighbouring threads read neighbouring columns.
//   Where W_h does not fit (H > 116: 256 KB at H = 128), a second
//   instantiation reads it from device memory through the read-only path
//   (__ldg); at H = 256 it is 1 MB, which stays in the 50 MB L2 across the
//   steps. That layout takes every H that is a multiple of 4 up to 256
//   (one thread per hidden unit, h read as float4, so a row of h must be a
//   whole number of float4);
// - every other H (not a multiple of 4, or above 256) runs a third layout,
//   lstm_fwd_f32_any_kernel: U = ceil(H / 256) units a thread, in strides
//   of the block's width ceil(H / U), h read one float at a time, and c in
//   shared memory (a thread holds U of them a row); W_h in shared memory
//   where it fits (H <= 116), else through L2. Its tiles take 3 * rows * H
//   floats: at 8 rows a thread (every H up to 2421) 96 * H bytes; where
//   that does not fit, an instantiation with 4 rows a thread (48 * H
//   bytes) takes H up to 4842. The limit is computed from those tiles and
//   the shared memory a block may use (tpuflow_lstm_fwd_max_hidden);
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

// W_h from shared memory (kSharedW) or from device memory through L2.
template <bool kSharedW>
__device__ __forceinline__ float load_w(const float* p) {
  if constexpr (kSharedW) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The float4 layout (one thread per hidden unit, h read as float4) takes H
// a multiple of 4 up to 256; every other H runs lstm_fwd_f32_any_kernel.
bool vec_path(int H) { return H % 4 == 0 && H <= kThreadsPerBlock; }

// Block shape of both layouts: U = ceil(H / 256) hidden units a thread,
// ceil(H / U) threads a block row, 256 / that many rows of threads (at
// least one). For the float4 layout that is (H, 256 / H).
dim3 block_for(int H) {
  const int units = (H + kThreadsPerBlock - 1) / kThreadsPerBlock;
  const int bx = (H + units - 1) / units;
  const int by = kThreadsPerBlock / bx;
  return dim3((unsigned)bx, (unsigned)(by > 0 ? by : 1));
}

// Rows a thread of the any-H layout: 4 where 8 would overflow shared memory.
constexpr int kFewRowsPerThread = 4;

size_t smem_bytes_for(int H, bool shared_w, int rows_per_thread) {
  const size_t tile_rows = (size_t)block_for(H).y * rows_per_thread;
  // h double buffered, and for the any-H layout c.
  const size_t tiles = (vec_path(H) ? 2 : 3) * tile_rows * H;
  return sizeof(float) * ((shared_w ? (size_t)H * 4 * H : 0) + tiles);
}

template <bool kSharedW>
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
  float* w_s = smem;                           // [H, 4H] when kSharedW
  float* h_s = smem + (kSharedW ? H * H4 : 0);  // [2, tile_rows, H]
  const float* w_src = kSharedW ? w_s : wh;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (kSharedW)
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
        const float* w = w_src + (k + kk) * H4;
        const float wi = load_w<kSharedW>(w + j);
        const float wf = load_w<kSharedW>(w + H + j);
        const float wg = load_w<kSharedW>(w + 2 * H + j);
        const float wo = load_w<kSharedW>(w + 3 * H + j);
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

// Every H the float4 layout does not take, up to max_hidden(): thread x of
// a block row owns hidden units x, x + blockDim.x, ... of R rows, reads h one float at a time and keeps c in shared memory. Same math,
// in the same order, as lstm_fwd_f32_kernel.
template <bool kSharedW, int R>
__global__ void lstm_fwd_f32_any_kernel(const float* __restrict__ xw,
                                        const float* __restrict__ wh,
                                        const float* __restrict__ bias,
                                        float* __restrict__ hs,
                                        float* __restrict__ cs,
                                        int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int tile_rows = R * blockDim.y;
  float* w_s = smem;                            // [H, 4H] when kSharedW
  float* h_s = smem + (kSharedW ? H * H4 : 0);  // [2, tile_rows, H]
  float* c_s = h_s + 2 * tile_rows * H;         // [tile_rows, H]
  const float* w_src = kSharedW ? w_s : wh;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (kSharedW)
    for (int i = tid; i < H * H4; i += nthreads) w_s[i] = wh[i];
  for (int i = tid; i < 3 * tile_rows * H; i += nthreads) h_s[i] = 0.0f;

  const int r0 = threadIdx.y * R;  // this thread's first row in the tile
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows + r0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h_in = h_s + (t & 1) * tile_rows * H;
    float* h_out = h_s + ((t + 1) & 1) * tile_rows * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      // h @ W_h for the four gate columns of unit j.
      float ai[R], af[R], ag[R], ao[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ai[r] = af[r] = ag[r] = ao[r] = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float* w = w_src + (int64_t)k * H4;
        const float wi = load_w<kSharedW>(w + j);
        const float wf = load_w<kSharedW>(w + H + j);
        const float wg = load_w<kSharedW>(w + 2 * H + j);
        const float wo = load_w<kSharedW>(w + 3 * H + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = h_in[(r0 + r) * H + k];
          ai[r] = fmaf(hk, wi, ai[r]);
          af[r] = fmaf(hk, wf, af[r]);
          ag[r] = fmaf(hk, wg, ag[r]);
          ao[r] = fmaf(hk, wo, ao[r]);
        }
      }
      const float bi = bias[j];
      const float bf = bias[H + j];
      const float bg = bias[2 * H + j];
      const float bo = bias[3 * H + j];
      // Gate math, in the reference's order: (xw + h @ W_h) + b.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t row = row0 + r;
        float xi = 0.0f, xf = 0.0f, xg = 0.0f, xo = 0.0f;
        if (row < B) {
          const float* x = xw + ((int64_t)t * B + row) * H4;
          xi = x[j];
          xf = x[H + j];
          xg = x[2 * H + j];
          xo = x[3 * H + j];
        }
        const float zi = (xi + ai[r]) + bi;
        const float zf = (xf + af[r]) + bf;
        const float zg = (xg + ag[r]) + bg;
        const float zo = (xo + ao[r]) + bo;
        float* c = c_s + (r0 + r) * H + j;
        const float cn = sigmoid_f32(zf) * *c + sigmoid_f32(zi) * tanhf(zg);
        const float hn = sigmoid_f32(zo) * tanhf(cn);
        *c = cn;
        h_out[(r0 + r) * H + j] = hn;
        if (row < B) {
          const int64_t o = ((int64_t)t * B + row) * H + j;
          hs[o] = hn;
          if (cs != nullptr) cs[o] = cn;
        }
      }
    }
    __syncthreads();
  }
}

// Rows a thread for hidden size H: kRowsPerThread where the tiles fit with
// it (always on the float4 layout, and so for every H <= 1024), else
// kFewRowsPerThread.
int rows_per_thread_for(int H) {
  return smem_bytes_for(H, false, kRowsPerThread) <= kMaxSharedBytes
             ? kRowsPerThread
             : kFewRowsPerThread;
}

size_t smem_bytes_for(int H, bool shared_w) {
  return smem_bytes_for(H, shared_w, rows_per_thread_for(H));
}

// The largest H whose tiles fit at kFewRowsPerThread rows a thread (above
// 256 the block is one row of threads, so they take 3 * 4 * H floats).
int max_hidden() {
  int h = (int)(kMaxSharedBytes / (sizeof(float) * 3 * kFewRowsPerThread));
  while (h > 0 && smem_bytes_for(h, false, kFewRowsPerThread) > kMaxSharedBytes) --h;
  return h;
}

}  // namespace

extern "C" {

// Largest hidden size the kernels take (every H from 1 up to it).
int tpuflow_lstm_fwd_max_hidden(void) { return max_hidden(); }

// Launch shape for hidden size H: block_for(H), rows_per_thread_for(H) rows
// per row of threads; the float4 layout where it applies, else the any-H
// one; W_h in shared memory where it fits, else read through L2. Returns 0,
// or the CUDA error code.
int tpuflow_lstm_fwd_f32(const float* xw, const float* wh, const float* b,
                         float* hs, float* cs, int T, int B, int H,
                         void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H <= 0 || H > max_hidden()) return (int)cudaErrorInvalidValue;
  const dim3 block = block_for(H);
  const int rows = rows_per_thread_for(H);
  const int tile_rows = (int)block.y * rows;
  const bool shared_w = smem_bytes_for(H, true) <= kMaxSharedBytes;
  const size_t smem = smem_bytes_for(H, shared_w);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  auto kernel = vec_path(H)
                    ? (shared_w ? lstm_fwd_f32_kernel<true> : lstm_fwd_f32_kernel<false>)
                : rows == kRowsPerThread
                    ? (shared_w ? lstm_fwd_f32_any_kernel<true, kRowsPerThread>
                                : lstm_fwd_f32_any_kernel<false, kRowsPerThread>)
                    : lstm_fwd_f32_any_kernel<false, kFewRowsPerThread>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + tile_rows - 1) / tile_rows));
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(xw, wh, b, hs, cs, T, B,
                                                      H);
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
