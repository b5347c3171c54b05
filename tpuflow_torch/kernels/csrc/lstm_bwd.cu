// Backward LSTM recurrence on Hopper (sm_90a), float32.
//
// Replaces tpuflow/kernels/lstm.py::_bwd_kernel, the Pallas TPU kernel that
// tpuflow/kernels/lstm.py::_bwd launches with pl.pallas_call for the custom
// VJP of lstm_scan. Same function: from zero carries, for t = T-1 down to 0,
// with h_{t-1} = hs[t-1] and c_{t-1} = cs[t-1] (both zero at t = 0)
//     z   = xw_t + h_{t-1} @ W_h + b         (gates recomputed, f32)
//     i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g);  c = cs[t]
//     dh  = dhs[t] + dh_carry
//     do  = dh * tanh(c)
//     dc  = dc_carry + dh * o * (1 - tanh(c)^2)
//     dz  = [dc*g * i(1-i), dc*c_{t-1} * f(1-f), dc*i * (1-g^2), do * o(1-o)]
//     dxw[t] = dz;  dW_h += h_{t-1}^T dz;  db += sum_rows dz
//     dh_carry = dz @ W_h^T;  dc_carry = dc * f
// Each block writes its own dW_h and db partial, [grid, H, 4H] and
// [grid, 4H]; the caller sums them over the block axis in a fixed order, as
// the JAX wrapper sums the per-tile partials outside its kernel. No float
// atomics: gradients are the same from run to run.
//
// What bounds it on an H100: per row and step it does three H x 4H products
// (the recomputed h @ W_h, dz @ W_h^T and h^T dz), 3 * 2 * H * 4H = 98,304
// operations at H = 64, against 7H floats of xw/hs/cs/dhs read and 4H of dxw
// written. On the CUDA cores' f32 rate that is operations, and the work is
// a chain of T dependent steps per row, as in the forward kernel.
//
// Design (simple and right first; tensor cores and tuning are later work):
// - one block per tile of kRowsPerThread * blockDim.y batch rows, with the
//   time loop inside it, from t = T-1 down to 0, as lstm_fwd.cu steps forward;
// - thread (j, y) owns hidden unit j of kRowsPerThread rows: it recomputes
//   the four gate columns j, H+j, 2H+j, 3H+j, so the gate math and the dc
//   and dh carries stay in its registers in f32;
// - dh = dz @ W_h^T needs all 4H columns of dz for a row, so dz goes through
//   shared memory between two barriers. dz and the h_{t-1} tile are double
//   buffered, so two barriers a step suffice;
// - W_h lives in shared memory with its row stride padded to 4H+1 (an odd
//   count): thread j reading row j for dz @ W_h^T then hits 32 distinct
//   banks, where the [H, 4H] stride would put a warp on one bank;
// - the dW_h tile (H x 4H f32, 64 KB at H = 64) and db live in shared
//   memory; each thread owns the entries tid, tid + nthreads, ... and adds
//   h_{t-1}^T dz of the tile to them every step, then writes them once;
// - shared memory at H = 64 and 16 rows a block: W_h 65,792 B, dW_h 65,536,
//   the dz double buffer 32,768, the h double buffer 8,192, db 1,024; 173 KB
//   of the 227 KB. That layout takes H <= 76;
// - above that a second instantiation keeps only the h and dz double
//   buffers in shared memory (40 KB at H = 256). It reads W_h from device
//   memory through the read-only path (__ldg; 1 MB at H = 256, which stays
//   in the 50 MB L2 across the steps), and keeps the block's dW_h and db
//   partial in its own slice of the global partial buffers: each thread
//   still owns the entries tid, tid + nthreads, ... and reads, adds to and
//   writes back only those, so there are no atomics and no barriers for
//   them. These two layouts take every H that is a multiple of 4 up to
//   256, one thread per hidden unit, with h_{t-1} read as float4 (a row of
//   it must be a whole number of float4);
// - every other H from 1 to 1024 (tpuflow_lstm_bwd_max_hidden) runs
//   lstm_bwd_f32_any_kernel: U = ceil(H / 256) units a thread in strides of
//   the block's width ceil(H / U), h_{t-1} and dz read one float at a time,
//   and the dh and dc carries in shared memory (a thread holds U of them a
//   row); W_h and the partial in shared memory where they fit, else in
//   device memory, as above;
// - the partials are capped: the grid is at most max(132, 256 MB / the
//   partial's bytes) blocks (tpuflow_lstm_bwd_blocks), where one tile a
//   block would take 256 x 16 MB at H = 1024, B = 4096. When the cap binds,
//   a block walks batch tiles blockIdx.x, blockIdx.x + gridDim.x, ... and
//   sums them into one partial (kWalk); otherwise each block runs one tile,
//   as before the cap. Which block sums which tiles depends on B and H
//   only, so the gradients repeat run to run;
// - rows past the batch edge carry zeros and contribute nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerThread = 4;
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

constexpr int kMaxHidden = 1024;
constexpr int kMinPartials = 132;                // one a streaming multiprocessor
constexpr size_t kPartialBytes = (size_t)256 << 20;  // what the partials may take

// The float4 layout (one thread per hidden unit, h read as float4) takes H
// a multiple of 4 up to 256; every other H runs lstm_bwd_f32_any_kernel.
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

int tile_rows_for(int H) { return kRowsPerThread * (int)block_for(H).y; }

size_t smem_bytes_for(int H, bool shared_w) {
  const size_t H4 = 4 * (size_t)H;
  const size_t rows = (size_t)tile_rows_for(H);
  const size_t tiles = 2 * rows * H     // h_{t-1}, double buffered
                       + 2 * rows * H4  // dz, double buffered
                       + (vec_path(H) ? 0 : 2 * rows * H);  // dh, dc carries
  if (!shared_w) return sizeof(float) * tiles;
  return sizeof(float) * ((size_t)H * (H4 + 1)  // W_h, padded rows
                          + tiles
                          + (size_t)H * H4      // dW_h partial
                          + H4);                // db partial
}

// Every H from 1 to kMaxHidden: the tiles alone take at most 192 KB of
// shared memory (H = 1024).
bool supported(int H) { return H > 0 && H <= kMaxHidden; }

bool shared_w_for(int H) { return smem_bytes_for(H, true) <= kMaxSharedBytes; }

template <bool kSharedW, bool kWalk>
__global__ void lstm_bwd_f32_kernel(const float* __restrict__ xw,
                                    const float* __restrict__ wh,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ hs,
                                    const float* __restrict__ cs,
                                    const float* __restrict__ dhs,
                                    float* __restrict__ dxw,
                                    float* __restrict__ dwh_part,
                                    float* __restrict__ db_part,
                                    int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kRowsPerThread;
  const int H4 = 4 * H;
  const int WS = kSharedW ? H4 + 1 : H4;  // row stride of W_h, padded in smem
  const int tile_rows = R * blockDim.y;
  float* w_s = smem;                                  // [H, 4H+1] if kSharedW
  float* h_s = w_s + (kSharedW ? H * WS : 0);         // [2, tile_rows, H]
  float* dz_s = h_s + 2 * tile_rows * H;              // [2, tile_rows, 4H]
  // The dW_h [H, 4H] and db [4H] partial: in shared memory, or this block's
  // slice of the global partial buffers.
  float* dw_s = kSharedW ? dz_s + 2 * tile_rows * H4
                         : dwh_part + (int64_t)blockIdx.x * H * H4;
  float* db_s = kSharedW ? dw_s + H * H4 : db_part + (int64_t)blockIdx.x * H4;
  const float* w_src = kSharedW ? w_s : wh;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int e = tid; e < H * H4; e += nthreads) {
    if (kSharedW) {
      const int k = e / H4;
      w_s[k * WS + (e - k * H4)] = wh[e];
    }
    dw_s[e] = 0.0f;
  }
  for (int n = tid; n < H4; n += nthreads) db_s[n] = 0.0f;

  const int j = threadIdx.x;
  const int r0 = threadIdx.y * R;  // this thread's first row in the tile
  const float bi = bias[j];
  const float bf = bias[H + j];
  const float bg = bias[2 * H + j];
  const float bo = bias[3 * H + j];

  // One batch tile, the rows from tile0 on.
  auto run_tile = [&](const int64_t tile0) {
    float dh_carry[R], dc_carry[R];  // from step t+1, f32
#pragma unroll
    for (int r = 0; r < R; ++r) dh_carry[r] = dc_carry[r] = 0.0f;

    for (int k = 0; k < T; ++k) {
      const int t = T - 1 - k;
      float* hp = h_s + (k & 1) * tile_rows * H;   // h_{t-1} of the tile
      float* dz = dz_s + (k & 1) * tile_rows * H4;  // dz of the tile

      // (1) The tile's h_{t-1}: zero at t = 0 and past the batch edge.
      for (int i = tid; i < tile_rows * H; i += nthreads) {
        const int r = i / H;
        const int64_t row = tile0 + r;
        hp[i] = (t > 0 && row < B)
                    ? hs[((int64_t)(t - 1) * B + row) * H + (i - r * H)]
                    : 0.0f;
      }
      __syncthreads();

      // (2) Recompute h_{t-1} @ W_h for the four gate columns of unit j.
      float ai[R], af[R], ag[R], ao[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ai[r] = af[r] = ag[r] = ao[r] = 0.0f;
      for (int kk = 0; kk < H; kk += 4) {
        float4 hv[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          hv[r] = *reinterpret_cast<const float4*>(hp + (r0 + r) * H + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* w = w_src + (kk + q) * WS;
          const float wi = load_w<kSharedW>(w + j);
          const float wf = load_w<kSharedW>(w + H + j);
          const float wg = load_w<kSharedW>(w + 2 * H + j);
          const float wo = load_w<kSharedW>(w + 3 * H + j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float hk = lane_of(hv[r], q);
            ai[r] = fmaf(hk, wi, ai[r]);
            af[r] = fmaf(hk, wf, af[r]);
            ag[r] = fmaf(hk, wg, ag[r]);
            ao[r] = fmaf(hk, wo, ao[r]);
          }
        }
      }

      // Gates and dz, in the reference's order; dz goes to dxw[t] and to
      // shared memory for the products below.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t row = tile0 + r0 + r;
        float dzi = 0.0f, dzf = 0.0f, dzg = 0.0f, dzo = 0.0f;
        if (row < B) {
          const int64_t o4 = ((int64_t)t * B + row) * H4;
          const int64_t o1 = ((int64_t)t * B + row) * H + j;
          const float ig = sigmoid_f32((xw[o4 + j] + ai[r]) + bi);
          const float fg = sigmoid_f32((xw[o4 + H + j] + af[r]) + bf);
          const float gg = tanhf((xw[o4 + 2 * H + j] + ag[r]) + bg);
          const float og = sigmoid_f32((xw[o4 + 3 * H + j] + ao[r]) + bo);
          const float c = cs[o1];
          const float c_prev = t > 0 ? cs[o1 - (int64_t)B * H] : 0.0f;
          const float tc = tanhf(c);
          const float dh = dhs[o1] + dh_carry[r];
          const float d_o = dh * tc;
          const float dc = dc_carry[r] + dh * og * (1.0f - tc * tc);
          dzi = dc * gg * ig * (1.0f - ig);
          dzf = dc * c_prev * fg * (1.0f - fg);
          dzg = dc * ig * (1.0f - gg * gg);
          dzo = d_o * og * (1.0f - og);
          dc_carry[r] = dc * fg;
          dxw[o4 + j] = dzi;
          dxw[o4 + H + j] = dzf;
          dxw[o4 + 2 * H + j] = dzg;
          dxw[o4 + 3 * H + j] = dzo;
        }
        float* dzr = dz + (r0 + r) * H4;
        dzr[j] = dzi;
        dzr[H + j] = dzf;
        dzr[2 * H + j] = dzg;
        dzr[3 * H + j] = dzo;
      }
      __syncthreads();

      // (3) dh for step t-1: dh[r, j] = sum_n dz[r, n] * W_h[j, n].
#pragma unroll
      for (int r = 0; r < R; ++r) dh_carry[r] = 0.0f;
      const float* wj = w_src + j * WS;
      for (int n = 0; n < H4; n += 4) {
        const float w0 = load_w<kSharedW>(wj + n);
        const float w1 = load_w<kSharedW>(wj + n + 1);
        const float w2 = load_w<kSharedW>(wj + n + 2);
        const float w3 = load_w<kSharedW>(wj + n + 3);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dz + (r0 + r) * H4 + n);
          dh_carry[r] = fmaf(d.x, w0, dh_carry[r]);
          dh_carry[r] = fmaf(d.y, w1, dh_carry[r]);
          dh_carry[r] = fmaf(d.z, w2, dh_carry[r]);
          dh_carry[r] = fmaf(d.w, w3, dh_carry[r]);
        }
      }

      // (4) dW_h += h_{t-1}^T dz and db += sum_rows dz over the tile.
      for (int e = tid; e < H * H4; e += nthreads) {
        const int kq = e / H4;
        const int n = e - kq * H4;
        float acc = dw_s[e];
        for (int r = 0; r < tile_rows; ++r)
          acc = fmaf(hp[r * H + kq], dz[r * H4 + n], acc);
        dw_s[e] = acc;
      }
      for (int n = tid; n < H4; n += nthreads) {
        float acc = db_s[n];
        for (int r = 0; r < tile_rows; ++r) acc += dz[r * H4 + n];
        db_s[n] = acc;
      }
    }
  };
  if constexpr (kWalk) {
    // The block's batch tiles: blockIdx.x, blockIdx.x + gridDim.x, ...;
    // one dW_h / db partial sums them all.
    const int n_tiles = (B + tile_rows - 1) / tile_rows;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      run_tile((int64_t)tile * tile_rows);
      __syncthreads();  // the next tile reuses the h and dz buffers
    }
  } else {
    run_tile((int64_t)blockIdx.x * tile_rows);  // a block for each tile
  }

  // Each thread wrote only its own entries: no barrier before the store.
  if (kSharedW) {
    float* dwp = dwh_part + (int64_t)blockIdx.x * H * H4;
    for (int e = tid; e < H * H4; e += nthreads) dwp[e] = dw_s[e];
    for (int n = tid; n < H4; n += nthreads)
      db_part[(int64_t)blockIdx.x * H4 + n] = db_s[n];
  }
}

// Every H the float4 layout does not take, 1 <= H <= kMaxHidden: thread x of
// a block row owns hidden units x, x + blockDim.x, ... of kRowsPerThread
// rows, reads h_{t-1} and dz one float at a time, and keeps the dh and dc
// carries in shared memory. Same math, in the same order, as
// lstm_bwd_f32_kernel, with the same two barriers a step.
template <bool kSharedW>
__global__ void lstm_bwd_f32_any_kernel(const float* __restrict__ xw,
                                        const float* __restrict__ wh,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ hs,
                                        const float* __restrict__ cs,
                                        const float* __restrict__ dhs,
                                        float* __restrict__ dxw,
                                        float* __restrict__ dwh_part,
                                        float* __restrict__ db_part,
                                        int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kRowsPerThread;
  const int H4 = 4 * H;
  const int WS = kSharedW ? H4 + 1 : H4;  // row stride of W_h, padded in smem
  const int tile_rows = R * blockDim.y;
  float* w_s = smem;                           // [H, 4H+1] if kSharedW
  float* h_s = w_s + (kSharedW ? H * WS : 0);  // [2, tile_rows, H]
  float* dz_s = h_s + 2 * tile_rows * H;       // [2, tile_rows, 4H]
  float* dh_s = dz_s + 2 * tile_rows * H4;     // [tile_rows, H] dh carry
  float* dc_s = dh_s + tile_rows * H;          // [tile_rows, H] dc carry
  float* dw_s = kSharedW ? dc_s + tile_rows * H
                         : dwh_part + (int64_t)blockIdx.x * H * H4;
  float* db_s = kSharedW ? dw_s + H * H4 : db_part + (int64_t)blockIdx.x * H4;
  const float* w_src = kSharedW ? w_s : wh;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int e = tid; e < H * H4; e += nthreads) {
    if (kSharedW) {
      const int k = e / H4;
      w_s[k * WS + (e - k * H4)] = wh[e];
    }
    dw_s[e] = 0.0f;
  }
  for (int n = tid; n < H4; n += nthreads) db_s[n] = 0.0f;

  const int r0 = threadIdx.y * R;  // this thread's first row in the tile
  const int n_tiles = (B + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t tile0 = (int64_t)tile * tile_rows;
    // The carries from step t+1, f32; each thread owns its units' entries.
    for (int j = threadIdx.x; j < H; j += blockDim.x)
#pragma unroll
      for (int r = 0; r < R; ++r)
        dh_s[(r0 + r) * H + j] = dc_s[(r0 + r) * H + j] = 0.0f;

    for (int k = 0; k < T; ++k) {
      const int t = T - 1 - k;
      float* hp = h_s + (k & 1) * tile_rows * H;    // h_{t-1} of the tile
      float* dz = dz_s + (k & 1) * tile_rows * H4;  // dz of the tile

      // (1) The tile's h_{t-1}: zero at t = 0 and past the batch edge.
      for (int i = tid; i < tile_rows * H; i += nthreads) {
        const int r = i / H;
        const int64_t row = tile0 + r;
        hp[i] = (t > 0 && row < B)
                    ? hs[((int64_t)(t - 1) * B + row) * H + (i - r * H)]
                    : 0.0f;
      }
      __syncthreads();

      // (2) For each unit j of this thread: recompute h_{t-1} @ W_h for its
      // four gate columns, then the gates and dz, which go to dxw[t] and to
      // shared memory for the products below.
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float ai[R], af[R], ag[R], ao[R];
#pragma unroll
        for (int r = 0; r < R; ++r) ai[r] = af[r] = ag[r] = ao[r] = 0.0f;
        for (int kk = 0; kk < H; ++kk) {
          const float* w = w_src + (int64_t)kk * WS;
          const float wi = load_w<kSharedW>(w + j);
          const float wf = load_w<kSharedW>(w + H + j);
          const float wg = load_w<kSharedW>(w + 2 * H + j);
          const float wo = load_w<kSharedW>(w + 3 * H + j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float hk = hp[(r0 + r) * H + kk];
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
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int64_t row = tile0 + r0 + r;
          float dzi = 0.0f, dzf = 0.0f, dzg = 0.0f, dzo = 0.0f;
          if (row < B) {
            const int64_t o4 = ((int64_t)t * B + row) * H4;
            const int64_t o1 = ((int64_t)t * B + row) * H + j;
            const float ig = sigmoid_f32((xw[o4 + j] + ai[r]) + bi);
            const float fg = sigmoid_f32((xw[o4 + H + j] + af[r]) + bf);
            const float gg = tanhf((xw[o4 + 2 * H + j] + ag[r]) + bg);
            const float og = sigmoid_f32((xw[o4 + 3 * H + j] + ao[r]) + bo);
            const float c = cs[o1];
            const float c_prev = t > 0 ? cs[o1 - (int64_t)B * H] : 0.0f;
            const float tc = tanhf(c);
            float* dc_carry = dc_s + (r0 + r) * H + j;
            const float dh = dhs[o1] + dh_s[(r0 + r) * H + j];
            const float d_o = dh * tc;
            const float dc = *dc_carry + dh * og * (1.0f - tc * tc);
            dzi = dc * gg * ig * (1.0f - ig);
            dzf = dc * c_prev * fg * (1.0f - fg);
            dzg = dc * ig * (1.0f - gg * gg);
            dzo = d_o * og * (1.0f - og);
            *dc_carry = dc * fg;
            dxw[o4 + j] = dzi;
            dxw[o4 + H + j] = dzf;
            dxw[o4 + 2 * H + j] = dzg;
            dxw[o4 + 3 * H + j] = dzo;
          }
          float* dzr = dz + (r0 + r) * H4;
          dzr[j] = dzi;
          dzr[H + j] = dzf;
          dzr[2 * H + j] = dzg;
          dzr[3 * H + j] = dzo;
        }
      }
      __syncthreads();

      // (3) dh for step t-1: dh[r, j] = sum_n dz[r, n] * W_h[j, n].
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        const float* wj = w_src + (int64_t)j * WS;
        for (int n = 0; n < H4; ++n) {
          const float w = load_w<kSharedW>(wj + n);
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(dz[(r0 + r) * H4 + n], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) dh_s[(r0 + r) * H + j] = acc[r];
      }

      // (4) dW_h += h_{t-1}^T dz and db += sum_rows dz over the tile.
      for (int e = tid; e < H * H4; e += nthreads) {
        const int kq = e / H4;
        const int n = e - kq * H4;
        float acc = dw_s[e];
        for (int r = 0; r < tile_rows; ++r)
          acc = fmaf(hp[r * H + kq], dz[r * H4 + n], acc);
        dw_s[e] = acc;
      }
      for (int n = tid; n < H4; n += nthreads) {
        float acc = db_s[n];
        for (int r = 0; r < tile_rows; ++r) acc += dz[r * H4 + n];
        db_s[n] = acc;
      }
    }
    __syncthreads();  // the next tile reuses the h and dz buffers
  }

  // Each thread wrote only its own entries: no barrier before the store.
  if (kSharedW) {
    float* dwp = dwh_part + (int64_t)blockIdx.x * H * H4;
    for (int e = tid; e < H * H4; e += nthreads) dwp[e] = dw_s[e];
    for (int n = tid; n < H4; n += nthreads)
      db_part[(int64_t)blockIdx.x * H4 + n] = db_s[n];
  }
}

}  // namespace

extern "C" {

// Largest hidden size the kernels take (every H from 1 up to it).
int tpuflow_lstm_bwd_max_hidden(void) { return kMaxHidden; }

// Blocks for batch B at hidden size H (the leading size of the partials):
// one per batch tile, at most max(kMinPartials, kPartialBytes / the bytes
// of one dW_h and db partial); 0 when the kernels do not take H.
int tpuflow_lstm_bwd_blocks(int B, int H) {
  if (B <= 0 || !supported(H)) return 0;
  const int rows = tile_rows_for(H);
  const int tiles = (B + rows - 1) / rows;
  const size_t part = sizeof(float) * (4 * (size_t)H * H + 4 * (size_t)H);
  const size_t by_bytes = kPartialBytes / part;
  const int cap = by_bytes > (size_t)kMinPartials ? (int)by_bytes : kMinPartials;
  return tiles < cap ? tiles : cap;
}

// Launch shape for hidden size H: block_for(H), kRowsPerThread rows per row
// of threads, tpuflow_lstm_bwd_blocks(B, H) blocks; the float4 layout where
// it applies, else the any-H one; W_h and the partial in shared memory where
// they fit, else in device memory. Returns 0, or the CUDA error code.
int tpuflow_lstm_bwd_f32(const float* xw, const float* wh, const float* b,
                         const float* hs, const float* cs, const float* dhs,
                         float* dxw, float* dwh_part, float* db_part, int T,
                         int B, int H, void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (!supported(H)) return (int)cudaErrorInvalidValue;
  const bool shared_w = shared_w_for(H);
  const size_t smem = smem_bytes_for(H, shared_w);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const int blocks = tpuflow_lstm_bwd_blocks(B, H);
  const int rows = tile_rows_for(H);
  // Blocks walk several tiles only when the partials are capped.
  const bool walk = blocks < (B + rows - 1) / rows;
  auto kernel = !vec_path(H)
                    ? (shared_w ? lstm_bwd_f32_any_kernel<true>
                                : lstm_bwd_f32_any_kernel<false>)
                : walk ? (shared_w ? lstm_bwd_f32_kernel<true, true>
                                   : lstm_bwd_f32_kernel<false, true>)
                       : (shared_w ? lstm_bwd_f32_kernel<true, false>
                                   : lstm_bwd_f32_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks);
  kernel<<<grid, block_for(H), smem, (cudaStream_t)stream>>>(
      xw, wh, b, hs, cs, dhs, dxw, dwh_part, db_part, T, B, H);
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
