// Clipped absolute-error sums on Hopper (sm_90a), float32.
//
// Replaces tpuflow/kernels/losses.py::_sum_kernel, the Pallas TPU kernel that
// tpuflow/kernels/losses.py::_clipped_abs_sum launches with pl.pallas_call
// for mae_clip_pallas. Same function, with a row axis added:
//     sums[r] = sum_n clip(|y_true[r, n] - y_pred[r, n]|, 0, clip)
// accumulated in f32. The train loss is one row over the flattened batch
// (divided by n by the caller); the eval step's per-example loss is one row
// per example.
//
// What bounds it on an H100: 4 operations per element against 8 bytes read,
// so the bytes; at the training shapes (480 elements) the launch itself.
//
// Design: the TPU kernel carries one running sum across its sequential grid
// in an SMEM cell; Hopper blocks run in no order, so the reduction takes two
// passes, both in a fixed order (no atomics; the same sums every run):
// 1. blocks over (column chunk, row) read float4s where the row is 16-byte
//    aligned and a multiple of 4 wide (scalars otherwise), clip, and reduce
//    by warp shuffles and one shared-memory step into partials[r, chunk];
// 2. when a row has more than one chunk, one block a row sums its partials.
//    A row of one chunk is written straight into sums by pass 1.
// The ragged edge is masked in the kernel; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // float4 loads per thread per chunk
constexpr int64_t kChunk = (int64_t)kThreads * kVecPerThread * 4;
constexpr int kMaxRows = 65535;  // gridDim.y

// clip(|d|, 0, clip), NaN kept (as jnp.clip keeps it).
__device__ __forceinline__ float clipped(float d, float clip) {
  const float a = fabsf(d);
  return a > clip ? clip : a;
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // the block's sum, in thread 0
}

template <bool kVec>
__global__ void clipped_abs_partial_kernel(const float* __restrict__ yt,
                                           const float* __restrict__ yp,
                                           float* __restrict__ out,
                                           int64_t N, int chunks, float clip) {
  const int row = blockIdx.y;
  const int chunk = blockIdx.x;
  const float* a = yt + (int64_t)row * N;
  const float* b = yp + (int64_t)row * N;
  const int64_t c0 = (int64_t)chunk * kChunk;
  float acc = 0.0f;
  if (kVec) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int64_t v = c0 / 4 + (int64_t)i * kThreads + threadIdx.x;
      if (v * 4 < N) {
        const float4 x = a4[v];
        const float4 y = b4[v];
        acc += clipped(x.x - y.x, clip);
        acc += clipped(x.y - y.y, clip);
        acc += clipped(x.z - y.z, clip);
        acc += clipped(x.w - y.w, clip);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * kVecPerThread; ++i) {
      const int64_t col = c0 + (int64_t)i * kThreads + threadIdx.x;
      if (col < N) acc += clipped(a[col] - b[col], clip);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[(int64_t)row * chunks + chunk] = acc;
}

__global__ void row_sum_kernel(const float* __restrict__ partials,
                               float* __restrict__ sums, int chunks) {
  const float* p = partials + (int64_t)blockIdx.x * chunks;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) acc += p[c];
  acc = block_sum(acc);
  if (threadIdx.x == 0) sums[blockIdx.x] = acc;
}

}  // namespace

extern "C" {

// Column chunks of a row of N elements (the width of the partials).
int64_t tpuflow_mae_clip_chunks(int64_t N) { return (N + kChunk - 1) / kChunk; }

// sums[R] of clip(|yt - yp|, 0, clip) over rows of N; partials holds
// R * chunks floats and is used only when chunks > 1. Returns 0, or the
// CUDA error code.
int tpuflow_mae_clip_sums_f32(const float* yt, const float* yp,
                              float* partials, float* sums, int R, int64_t N,
                              float clip, void* stream) {
  if (R <= 0) return 0;
  if (R > kMaxRows || N <= 0) return (int)cudaErrorInvalidValue;
  const int64_t chunks = tpuflow_mae_clip_chunks(N);
  if (chunks > 2147483647) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* out = chunks == 1 ? sums : partials;
  const dim3 grid((unsigned)chunks, (unsigned)R);
  const bool vec = N % 4 == 0 && ((uintptr_t)yt % 16 == 0) &&
                   ((uintptr_t)yp % 16 == 0);
  if (vec)
    clipped_abs_partial_kernel<true><<<grid, kThreads, 0, s>>>(
        yt, yp, out, N, (int)chunks, clip);
  else
    clipped_abs_partial_kernel<false><<<grid, kThreads, 0, s>>>(
        yt, yp, out, N, (int)chunks, clip);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  row_sum_kernel<<<R, kThreads, 0, s>>>(partials, sums, (int)chunks);
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
