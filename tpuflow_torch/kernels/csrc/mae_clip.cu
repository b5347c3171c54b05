// Clipped mean absolute error and its gradient on Hopper (sm_90a), float32.
//
// 1. mae_clip (tpuflow_mae_clip_means_f32) replaces
//    tpuflow/kernels/losses.py::_sum_kernel, the Pallas TPU kernel that
//    tpuflow/kernels/losses.py::_clipped_abs_sum launches with
//    pl.pallas_call for mae_clip_pallas. Same function, with a row axis
//    added and the division by N taken in:
//        means[r] = (sum_n clip(|y_true[r, n] - y_pred[r, n]|, 0, clip)) / N
//    summed in f32 and divided with IEEE division. The train loss is one
//    row over the flattened batch; the eval step's per-example loss is one
//    row per example.
// 2. mae_clip_grad (tpuflow_mae_clip_grad_f32) replaces none of the TPU
//    kernels: it is the loss's backward, the JAX package's plain _bwd
//    (tpuflow/kernels/losses.py:99), which XLA fuses into one elementwise
//    pass. Eager PyTorch would run it as eight launches, so it is one
//    kernel here:
//        s = g / n;  dyt = s * (sign(d) * (|d| < clip));  dyp = -dyt
//    with d = y_true - y_pred, sign(d) = (d > 0) - (d < 0) as torch.sign
//    computes it (0 for NaN and +-0), and g read on the device (no host
//    sync). Bitwise the plain version's arithmetic
//    (mae_clip_grad_reference); zero where d is NaN, as JAX's gradient is.
//
// What bounds them on an H100: a few operations per element against 8 bytes
// read (and 8 written by the gradient), so the bytes; at the training
// shapes (480 elements) the launch itself. So each call is one launch:
//
// - rows of up to 1024 elements (the train loss at batch 20, the eval's 24
//   a row) take a warp each, 8 rows a block, summed by shuffles;
// - wider rows take blocks over (chunk of 4096 elements, row). A row of one
//   chunk is written by its block. For more, each block writes its partial,
//   then takes an integer ticket (__threadfence, then atomicAdd on the
//   row's counter); the block that draws the last ticket sums the row's
//   partials in index order, writes the mean and resets the counter for
//   the next call. No float atomics: the means are the same every run.
// - loads are 16 bytes wide where the rows allow it (N a multiple of 4,
//   both operands 16-byte aligned), one float otherwise;
// - NaN propagates (clip keeps it, as jnp.clip does).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // float4 loads per thread per chunk
constexpr int64_t kChunk = (int64_t)kThreads * kVecPerThread * 4;  // 4096
constexpr int64_t kNarrow = 1024;  // rows up to this take a warp each
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxRows = 65535;  // gridDim.y of the wide rows

// The tickets of the wide rows: zero when the module loads, and set back to
// zero by the last block of each row. They outlive a call, so two wide-row
// launches must not run at once on two streams of one device (each device
// has its own copy).
__device__ unsigned int g_tickets[kMaxRows];

// clip(|d|, 0, clip), NaN kept (as jnp.clip keeps it).
__device__ __forceinline__ float clipped(float d, float clip) {
  const float a = fabsf(d);
  return a > clip ? clip : a;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // in lane 0
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) v = warp_sum(lane < kThreads / 32 ? warp_sums[lane] : 0.0f);
  return v;  // the block's sum, in thread 0
}

// Rows of up to kNarrow elements: warp w of block b takes row 8b + w.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mae_clip_narrow_kernel(const float* __restrict__ yt, const float* __restrict__ yp,
                       float* __restrict__ means, int R, int N, float clip) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const float* a = yt + (int64_t)row * N;
  const float* b = yp + (int64_t)row * N;
  // Fixed trip counts with masked loads, so that a lane's loads are all in
  // flight at once.
  float acc = 0.0f;
  if (kVec) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
    for (int i = 0; i < kNarrow / 128; ++i) {
      const int v = lane + 32 * i;
      if (v < N / 4) {
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
    for (int i = 0; i < kNarrow / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < N) acc += clipped(a[c] - b[c], clip);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) means[row] = acc / (float)N;
}

// Wider rows: block (chunk, row) sums its chunk of kChunk elements.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mae_clip_wide_kernel(const float* __restrict__ yt, const float* __restrict__ yp,
                     float* __restrict__ partials, float* __restrict__ means,
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
  if (chunks == 1) {
    if (threadIdx.x == 0) means[row] = acc / (float)N;
    return;
  }

  __shared__ bool last;
  float* p = partials + (int64_t)row * chunks;
  if (threadIdx.x == 0) {
    p[chunk] = acc;
    __threadfence();  // the partial is visible before the ticket is drawn
    last = atomicAdd(&g_tickets[row], 1u) == (unsigned)(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The row's partials in index order, read past L1 (another block wrote
  // them), summed in a fixed order.
  acc = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) acc += __ldcg(p + c);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    means[row] = acc / (float)N;
    g_tickets[row] = 0u;
  }
}

// The gradient, elementwise over n: thread i takes float4 i, i + stride, ...
// (or floats where the operands are not 16-byte aligned or n % 4 != 0).
__device__ __forceinline__ float grad_of(float a, float b, float s, float clip) {
  const float d = a - b;
  const float sgn = (float)(d > 0.0f) - (float)(d < 0.0f);  // torch.sign
  return s * (sgn * (fabsf(d) < clip ? 1.0f : 0.0f));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mae_clip_grad_kernel(const float* __restrict__ yt, const float* __restrict__ yp,
                     const float* __restrict__ g, float* __restrict__ dyt,
                     float* __restrict__ dyp, int64_t n, float clip) {
  const float s = __ldg(g) / (float)n;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  if (kVec) {
    const float4* a4 = reinterpret_cast<const float4*>(yt);
    const float4* b4 = reinterpret_cast<const float4*>(yp);
    float4* t4 = reinterpret_cast<float4*>(dyt);
    float4* p4 = reinterpret_cast<float4*>(dyp);
    for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < n / 4; v += stride) {
      const float4 x = a4[v];
      const float4 y = b4[v];
      const float4 t = make_float4(grad_of(x.x, y.x, s, clip), grad_of(x.y, y.y, s, clip),
                                   grad_of(x.z, y.z, s, clip), grad_of(x.w, y.w, s, clip));
      t4[v] = t;
      p4[v] = make_float4(-t.x, -t.y, -t.z, -t.w);
    }
  } else {
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
      const float t = grad_of(yt[i], yp[i], s, clip);
      dyt[i] = t;
      dyp[i] = -t;
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// Column chunks of a row of N elements, the width of the partials: 1 for
// rows that one block (or one warp) sums.
int64_t tpuflow_mae_clip_chunks(int64_t N) {
  return N <= kNarrow ? 1 : (N + kChunk - 1) / kChunk;
}

// means[R] of clip(|yt - yp|, 0, clip) over rows of N. partials holds
// R * tpuflow_mae_clip_chunks(N) floats, and is used only where that is more
// than 1. Returns 0, or the CUDA error code.
int tpuflow_mae_clip_means_f32(const float* yt, const float* yp, float* partials,
                               float* means, int R, int64_t N, float clip,
                               void* stream) {
  if (R <= 0) return 0;
  if (R > kMaxRows || N <= 0) return (int)cudaErrorInvalidValue;
  const int64_t chunks = tpuflow_mae_clip_chunks(N);
  if (chunks > 2147483647 || (chunks > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = N % 4 == 0 && aligned16(yt) && aligned16(yp);
  if (N <= kNarrow) {
    const dim3 grid((unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock));
    if (vec)
      mae_clip_narrow_kernel<true><<<grid, kThreads, 0, s>>>(yt, yp, means, R, (int)N, clip);
    else
      mae_clip_narrow_kernel<false><<<grid, kThreads, 0, s>>>(yt, yp, means, R, (int)N, clip);
  } else {
    const dim3 grid((unsigned)chunks, (unsigned)R);
    if (vec)
      mae_clip_wide_kernel<true><<<grid, kThreads, 0, s>>>(
          yt, yp, partials, means, N, (int)chunks, clip);
    else
      mae_clip_wide_kernel<false><<<grid, kThreads, 0, s>>>(
          yt, yp, partials, means, N, (int)chunks, clip);
  }
  return (int)cudaGetLastError();
}

// dyt, dyp [n] from yt, yp [n] and the upstream gradient g (one float on
// the device). Returns 0, or the CUDA error code.
int tpuflow_mae_clip_grad_f32(const float* yt, const float* yp, const float* g,
                              float* dyt, float* dyp, int64_t n, float clip,
                              void* stream) {
  if (n <= 0) return 0;
  const bool vec = n % 4 == 0 && aligned16(yt) && aligned16(yp) && aligned16(dyt) &&
                   aligned16(dyp);
  const int64_t items = vec ? n / 4 : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // a grid-stride loop past that
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    mae_clip_grad_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        yt, yp, g, dyt, dyp, n, clip);
  else
    mae_clip_grad_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        yt, yp, g, dyt, dyp, n, clip);
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
