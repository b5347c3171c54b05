// Forward LSTM recurrence on Hopper (sm_90a), float32, as one persistent
// cooperative kernel.
//
// Replaces tpuflow/kernels/lstm.py::_fwd_kernel, the Pallas TPU kernel that
// tpuflow/kernels/lstm.py::_fwd launches with pl.pallas_call for lstm_scan.
// Same function: from zero state, for t = 0..T-1
//     z   = xw_t + h_{t-1} @ W_h + b      (f32 accumulation)
//     i, f, g, o = split(z, 4)            (gate order i, f, g, o)
//     c   = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h   = sigmoid(o) * tanh(c)
// writing hs[t] = h and, when the caller passes a buffer, cs[t] = c.
//
// The TPU kernel scans the T steps of a batch tile in one grid step, with
// h @ W_h on the core's matrix unit and W_h in its VMEM. On an H100 one
// block cannot hold W_h beyond H = 116, and a block per batch tile leaves
// most of the 132 SMs idle at a small batch while each block streams all
// of W_h every step: at B = 20, H = 2048 three blocks read a 67 MB W_h
// (more than the 50 MB L2) from device memory 24 times. So each step's
// product is spread over the whole card, and the steps are separated by a
// barrier across the grid.
//
// What bounds it: every step reads W_h once across the grid (4H^2 floats)
// and does 2 * H * 4H operations a row. At B = 20 the bytes of W_h bound
// it where W_h does not stay in L2 (H = 2048: 24 x 67 MB at 3.35 TB/s is
// 0.48 ms), and otherwise the latency of 24 dependent steps, each a few
// round trips to L2 and a grid barrier. At B = 4096 the operations bound
// it on the CUDA cores' f32 rate (67 TFLOP/s): 3.3 TFLOP at H = 2048.
//
// Design:
// - a step's output is cut into tiles of 64 batch rows x 16 hidden units;
//   the tile's 64 columns of z are the i, f, g, o of those units. Thread
//   (tx, ty) of 256 holds a 4 x 4 register tile: rows 4ty .. 4ty+3, and
//   the four gates of unit tx, so the cell update needs no exchange
//   between threads (the GEMM code is lstm_common.cuh's, shared with
//   lstm_bwd.cu; the W_h slice is copied unit-major, column 4u + gate);
// - the reduction runs over k in slices of 16 through shared memory, with
//   kStages slices in flight by cp.async: h rows by cp.async.cg (16 bytes,
//   L2 only) where H is a multiple of 4, else by ld.global.cg into
//   registers one slice ahead; W_h by 4-byte cp.async. Shared memory is
//   the stages alone, so it does not grow with H. Warps whose rows all lie
//   past the batch skip the products (at B = 20, five of eight);
// - the grid is persistent: G = min(tiles, SMs x blocks an SM holds),
//   launched with cudaLaunchCooperativeKernel, which refuses a grid that
//   cannot be resident at once rather than deadlock. Block b takes tiles
//   b, b + G, ... of every step in the same order, so the thread that
//   writes c of an element at step t reads it at t+1: c needs no barrier
//   (it lives in cs, or in a [B, H] scratch when the caller keeps no cs);
// - between steps: __syncthreads, then one thread adds one to a global
//   counter (zeroed by the caller) with red.release.gpu, which fences the
//   block's writes before the add, and spins with ld.acquire.gpu until it
//   reaches G * (t + 1). h of the step before is read only through L2
//   (cp.async.cg, ld.global.cg), never through L1, whose lines are not
//   coherent across SMs;
// - what needs no h is issued before it is needed: the next tile's xw, b
//   and c and the W_h slices of its first stages, right after a tile's
//   epilogue (for the next step's first tile, between the barrier's
//   arrival and its wait). Step 0 has h = 0 and runs no product;
// - each element of hs and cs is computed by one thread, summing k in a
//   fixed order; no float atomics, so results repeat bitwise;
// - W_h is indexed in 32 bits, which sets the largest hidden size,
//   4 H^2 < 2^31: H = 23170 (tpuflow_lstm_fwd_max_hidden).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700.00 W power
// limit (device time a call, T = 24; PERF.md): LSTM-64's training shape
// (B = 20, H = 64) 0.096 ms, 4.0 us a step, where the block-per-batch-tile
// kernel it replaces took 0.157; B = 20 at H = 512 and 2048 0.41 and 1.42
// ms (before: 5.57 and 188.9); B = 4096 at H = 512 and 2048 7.5 and 111.5
// ms, 28-30 TFLOP/s (before: 17.3 and 694). At B = 4096, H = 64 it takes
// 0.21 ms against the old kernel's 0.165: there the grid barrier (2.4 us
// a step at 256 blocks) and h's round trip through L2 cost more than the
// spread gains.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace lstm;

constexpr int kUnits = kTile / 4;  // hidden units a tile: its 64 columns are their 4 gates
constexpr int kStages = 4;         // slices in flight (tunable, 3-4)
constexpr int kMaxDevices = 64;
constexpr uint64_t kBarrierTimeoutNs = 30ull * 1000 * 1000 * 1000;

struct Stage {
  ATileRow a;  // h: a[r][kk] = h_{t-1}[r0 + r, k0 + kk]
  BTile b;     // W_h: b[kk][4u + g] = W_h[k0 + kk, g * H + u0 + u]
};

// W_h's column for tile column c: gate c % 4 of unit u0 + c / 4; -1 past H.
struct UnitCols {
  int u0, H;
  __device__ __forceinline__ int operator()(int c) const {
    const int u = u0 + (c >> 2);
    return u < H ? (c & 3) * H + u : -1;
  }
};

// h_{t-1} rows r0 .. r0+63, columns k0 .. k0+15. kVec: one 16-byte
// cp.async.cg a thread into a. Else four ld.global.cg into hreg, element
// tid + 256 q of the slice (kk fastest), stored by store_h.
template <bool kVec>
__device__ __forceinline__ void load_h(ATileRow& a, float hreg[kLoads], const float* hprev,
                                       int64_t r0, int B, int H, int k0, int tid) {
  if constexpr (kVec) {
    const int r = tid >> 2, k = k0 + 4 * (tid & 3);
    const int64_t row = r0 + r;
    const bool in = row < B && k < H;
    cp_async_16_cg(&a[r][k - k0], in ? hprev + row * H + k : hprev, in);
  } else {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kGemmThreads;
      const int64_t row = r0 + (e >> 4);
      const int k = k0 + (e & (kSlice - 1));
      hreg[q] = (row < B && k < H) ? __ldcg(hprev + row * H + k) : 0.0f;
    }
  }
}

__device__ __forceinline__ void store_h(ATileRow& a, const float hreg[kLoads], int tid) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = tid + q * kGemmThreads;
    a[e >> 4][e & (kSlice - 1)] = hreg[q];
  }
}

// W_h slices of the first kStages - 1 stages for the tile of units u0..;
// left uncommitted: they join the first group that tile_gemm commits.
__device__ __forceinline__ void w_prologue(Stage* st, const float* wh, int u0, int H,
                                           int tid) {
  const int nslices = (H + kSlice - 1) / kSlice;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < nslices) load_w_slice<true>(st[s].b, wh, s * kSlice, H, UnitCols{u0, H}, tid);
}

// acc += h_{t-1}[r0.., :] @ W_h[:, tile columns], the W_h prologue already
// issued. Ends with a __syncthreads, after which the stages are free.
template <bool kVec>
__device__ __forceinline__ void tile_gemm(Stage* st, const float* wh, const float* hprev,
                                          int64_t r0, int u0, int B, int H, int tid,
                                          bool computes, float acc[4][4]) {
  const int nslices = (H + kSlice - 1) / kSlice;
  const int tx = tid & 15, ty = tid >> 4;
  float hreg[kStages - 1][kLoads];  // without kVec: the prologue's loads all in flight
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < nslices) load_h<kVec>(st[s].a, hreg[s], hprev, r0, B, H, s * kSlice, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if constexpr (!kVec) {
      if (s < nslices) store_h(st[s].a, hreg[s], tid);
    }
    cp_async_commit();
  }
  for (int sl = 0; sl < nslices; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice sl is in; stage (sl - 1) % kStages is free
    const int nxt = sl + kStages - 1;
    Stage& fill = st[nxt % kStages];
    if (nxt < nslices) {
      load_w_slice<true>(fill.b, wh, nxt * kSlice, H, UnitCols{u0, H}, tid);
      load_h<kVec>(fill.a, hreg[0], hprev, r0, B, H, nxt * kSlice, tid);
    }
    cp_async_commit();
    if (computes) mma_slice(st[sl % kStages].a, st[sl % kStages].b, tx, ty, acc);
    if constexpr (!kVec) {
      if (nxt < nslices) store_h(fill.a, hreg[0], tid);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// The barrier between steps, in two halves so that work that needs no h
// goes between them. grid_arrive: after the block's __syncthreads, one
// thread adds one to the counter with release semantics (the block's
// writes before it are visible to whoever acquires the count: a
// __threadfence and an atomicAdd in one instruction).
__device__ __forceinline__ void grid_arrive(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(counter) : "memory");
}

// grid_wait: that thread spins on an acquire load until all G blocks have
// added theirs for this step (target G * (t + 1)), then the block goes on.
// A wait past kBarrierTimeoutNs traps (the launch fails) instead of
// holding the card.
__device__ __forceinline__ void grid_wait(const int* counter, int target) {
  if (threadIdx.x == 0) {
    uint64_t start = 0;
    for (int polls = 0;; ++polls) {
      int seen;
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (seen >= target) break;
      if ((polls & 1023) == 0) {
        const uint64_t now = global_ns();
        if (start == 0) start = now;
        if (now - start > kBarrierTimeoutNs) __trap();
      }
    }
  }
  __syncthreads();
}

// What a tile's epilogue needs besides h @ W_h: xw_t, b and c of the step
// before, for thread (tx, ty)'s rows 4ty .. 4ty+3 and unit u0 + tx.
struct Operands {
  float x[4][4], c_prev[4], bias[4];
};

__device__ __forceinline__ void load_operands(Operands& op, const float* xw,
                                              const float* bias, const float* c_in,
                                              int64_t r0, int u, int t, int B, int H,
                                              int ty) {
#pragma unroll
  for (int g = 0; g < 4; ++g) op.bias[g] = u < H ? bias[g * H + u] : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = r0 + 4 * ty + i;
    const bool in = u < H && row < B;
    const float* xr = xw + ((int64_t)t * B + row) * 4 * H + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) op.x[i][g] = in ? xr[g * H] : 0.0f;
    op.c_prev[i] = (in && t > 0) ? c_in[row * H + u] : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
lstm_fwd_f32_persistent(const float* __restrict__ xw, const float* __restrict__ wh,
                        const float* __restrict__ bias, float* hs, float* cs,
                        float* c_scratch, int* counter, int T, int B, int H) {
  __shared__ __align__(16) Stage st[kStages];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int utiles = (H + kUnits - 1) / kUnits;
  const int ntiles = ((B + kTile - 1) / kTile) * utiles;
  const int G = gridDim.x;
  const int64_t BH = (int64_t)B * H;
  // c of step t-1 (read at step t > 0) and c of step t (written).
  auto c_in = [&](int t) -> const float* {
    return cs != nullptr ? cs + (t > 0 ? t - 1 : 0) * BH : c_scratch;
  };
  auto row0 = [&](int tile) { return (int64_t)(tile / utiles) * kTile; };
  auto unit0 = [&](int tile) { return (tile % utiles) * kUnits; };

  // The operands of the block's first tile; each tile then loads those of
  // the next before it waits on anything.
  Operands op;
  load_operands(op, xw, bias, c_in(0), row0(blockIdx.x), unit0(blockIdx.x) + tx, 0, B, H,
                ty);
  for (int t = 0; t < T; ++t) {
    const float* hprev = hs + (t > 0 ? t - 1 : 0) * BH;  // read only when t > 0
    float* c_out = cs != nullptr ? cs + t * BH : c_scratch;
    for (int tile = blockIdx.x; tile < ntiles; tile += G) {
      const int64_t r0 = row0(tile);
      const int u0 = unit0(tile);
      const int u = u0 + tx;

      float acc[4][4] = {};
      if (t > 0) {
        const bool computes = r0 + 8 * (tid >> 5) < B;  // the warp has a row in the batch
        tile_gemm<kVec>(st, wh, hprev, r0, u0, B, H, tid, computes, acc);
      }

      // Epilogue, in the reference's order: (xw + h @ W_h) + b.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = r0 + 4 * ty + i;
        if (u >= H || row >= B) continue;
        const float zi = (op.x[i][0] + acc[i][0]) + op.bias[0];
        const float zf = (op.x[i][1] + acc[i][1]) + op.bias[1];
        const float zg = (op.x[i][2] + acc[i][2]) + op.bias[2];
        const float zo = (op.x[i][3] + acc[i][3]) + op.bias[3];
        const float cn = sigmoid_f32(zf) * op.c_prev[i] + sigmoid_f32(zi) * tanhf(zg);
        const float hn = sigmoid_f32(zo) * tanhf(cn);
        hs[t * BH + row * H + u] = hn;
        c_out[row * H + u] = cn;
      }

      // The operands and W_h prologue of the block's next tile in this
      // step; those of the next step's first tile go inside the barrier,
      // below, after the arrival (a release there would wait on them).
      const int next = tile + G;
      if (next < ntiles) {
        load_operands(op, xw, bias, c_in(t), row0(next), unit0(next) + tx, t, B, H, ty);
        if (t > 0) w_prologue(st, wh, unit0(next), H, tid);
      }
    }
    if (t + 1 < T) {
      grid_arrive(counter);
      load_operands(op, xw, bias, c_in(t + 1), row0(blockIdx.x), unit0(blockIdx.x) + tx,
                    t + 1, B, H, ty);
      w_prologue(st, wh, unit0(blockIdx.x), H, tid);
      grid_wait(counter, G * (t + 1));
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The largest H whose W_h (4 H^2 floats) is indexed in 32 bits.
int max_hidden() {
  static const int limit = [] {
    int h = 1;
    while (4 * (int64_t)(h + 1) * (h + 1) <= INT_MAX) ++h;
    return h;
  }();
  return limit;
}

// Blocks of `kernel` that the device holds at once, per device.
int resident_blocks(const void* kernel, int slot, int* out) {
  static int cache[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && cache[dev][slot] > 0) {
    *out = cache[dev][slot];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGemmThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  if (dev < kMaxDevices) cache[dev][slot] = *out;
  return 0;
}

}  // namespace

extern "C" {

// Largest hidden size the kernel takes (every H from 1 up to it).
int tpuflow_lstm_fwd_max_hidden(void) { return max_hidden(); }

// hs [T, B, H] and, when cs is not null, cs [T, B, H] from xw [T, B, 4H],
// W_h [H, 4H] and b [4H]. c_scratch [B, H] holds c between steps when cs
// is null; counter is one int, zero on entry. Launches the persistent grid
// cooperatively on `stream`. Returns 0, or the CUDA error code (the
// launch's own when the grid cannot be resident at once).
int tpuflow_lstm_fwd_f32(const float* xw, const float* wh, const float* b, float* hs,
                         float* cs, float* c_scratch, int* counter, int T, int B, int H,
                         void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (H <= 0 || H > max_hidden() || (cs == nullptr && c_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && ((uintptr_t)hs & 15) == 0;
  const void* kernel = vec ? (const void*)lstm_fwd_f32_persistent<true>
                           : (const void*)lstm_fwd_f32_persistent<false>;
  int resident = 0;
  const int code = resident_blocks(kernel, vec ? 1 : 0, &resident);
  if (code != 0) return code;
  const int64_t tiles = ceil_div(B, kTile) * ceil_div(H, kUnits);
  const int64_t G = tiles < resident ? tiles : resident;
  if (G < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (tiles > INT_MAX || (int64_t)T * G > INT_MAX) return (int)cudaErrorInvalidValue;
  void* args[] = {&xw, &wh, &b, &hs, &cs, &c_scratch, &counter, &T, &B, &H};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)G), dim3(kGemmThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the code returned
    return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
