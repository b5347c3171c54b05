// Backward LSTM recurrence on Hopper (sm_90a), float32, as three kernels.
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
//
// The TPU kernel does all of a step in one grid step, because a TPU's grid
// runs in order on one core with the matrix unit beside it. Of the three
// H x 4H products a step, only dz @ W_h^T depends on step t+1: the gates
// depend only on the forward's residuals (xw, hs), and dW_h, db are sums
// that can be taken after the loop, since dxw is dz. So here they are three
// kernels, launched one after the other on the caller's stream:
//
// 1. lstm_bwd_gates: Z = xw + Hprev @ W_h + b for all T*B rows at once, a
//    tiled SIMT GEMM ([T*B, H] x [H, 4H]) whose epilogue applies sigmoid to
//    the i, f, o columns and tanh to g and writes the activations into the
//    dxw buffer. Hprev is hs shifted by one step: row (t, b) reads
//    hs[t-1, b], and t = 0 is masked to zero. Bound by operations (2*H*4H
//    per row) on the CUDA cores' f32 rate.
// 2. lstm_bwd_chain: the serial recurrence. One block per tile of R batch
//    rows walks t = T-1 ... 0; each step it reads the gates from dxw[t],
//    cs[t], cs[t-1] and dhs[t], forms dz in the reference's order,
//    overwrites dxw[t] with it and puts it in shared memory, and after a
//    barrier computes dh_carry = dz @ W_h^T, the only product left on the
//    chain. Its time is T steps of latency at small B and the product's
//    operations at large B. R is chosen from B as well as H, so that B = 20
//    runs on 10 blocks (2 rows each) and a large B on at least 132.
// 3. lstm_bwd_wgrad: dW_h = Hprev^T dz over all T*B rows, and db the
//    column sums of dz, from one tiled SIMT kernel whose reduction axis (the
//    rows) is cut into S fixed chunks where the H x 4H output has too few
//    64 x 64 tiles to fill the card. Each (tile, chunk) writes its own
//    partial; the caller sums the S partials in a fixed order. No float
//    atomics: the gradients are the same from run to run.
//
// Design details:
// - the two GEMMs use 64 x 64 output tiles, a reduction slice of 16 through
//   shared memory, 256 threads each holding a 4 x 4 register tile read as
//   float4 from shared memory (lstm_common.cuh, shared with lstm_fwd.cu's
//   persistent kernel); every load is masked, so any H, any B and a
//   ragged last tile need no padding. lstm_bwd_wgrad, whose blocks run long
//   reductions in a single wave, loads the next slice into registers while
//   it multiplies the current one, and sums db with every thread (thread
//   row ty takes slice row ty; the 16 sums of a column are added in order
//   at the end), so no warp of its blocks runs longer than the others;
// - in the chain, a warp computes dh for 4U hidden units at once: lanes
//   8q .. 8q+7 share units q, q+4, ... and split their 4H-term dots over the
//   float4 chunks l, l+8, ... of the row, then sum with __shfl_xor_sync. A
//   lane's dependent chain is H/2 terms (32 at H = 64); it holds all R rows
//   of its U units, so a W_h value read feeds R products and a dz value
//   read from shared memory U of them. U is 1 at R <= 2, 2 at R = 4 and 4
//   above: at U = 1 and many rows, shared-memory reads of dz bound the
//   product. A quarter-warp reads eight consecutive float4 of one W_h row:
//   no bank conflicts;
// - the chain keeps W_h in shared memory where it fits beside its tiles
//   (H <= 116 at R = 2), else reads it through L2 (__ldg, float4);
// - the chain keeps the dz tile and the dh and dc carries, R * 6H floats,
//   in shared memory while they fit at one row a block (H <= 9685, the
//   layout every H up to that keeps). Above it they live in a per-call
//   scratch in device memory that the caller allocates (its size from
//   tpuflow_lstm_bwd_chain_scratch), one region for each block: a block
//   reads and writes only its own rows, so __syncthreads orders those
//   accesses as it does shared memory's, and nothing crosses blocks. The
//   hidden sizes all three kernels take are then bounded only by indexing
//   W_h (4 H^2 floats) in 32 bits, as the forward's: H <= 23170
//   (tpuflow_lstm_bwd_max_hidden);
// - rows past the batch edge carry zeros and write nothing.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700.00 W power
// limit (PERF.md): at LSTM-64's training shape (T=24, B=20, H=64) a
// backward takes 0.061 ms of device time (gates 0.008, chain 0.040, wgrad
// 0.003), where the earlier single kernel, with all three products on its
// chain, took about 0.65; at T=24, B=4096, H=512 it takes 22.0 ms (gates
// 7.3, chain 6.8, wgrad 7.8: 26-30 of the 67 TFLOP/s f32 peak), where the
// earlier kernel, reading and writing its global dW_h partial every step,
// took 488 ms. At small B and large H the chain still bounds it: 26 of 27
// ms at B=20, H=2048, where ten blocks each re-read a 67 MB W_h every step.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace lstm;  // the GEMM tiles of lstm_bwd_gates and lstm_bwd_wgrad

constexpr size_t kMaxSharedBytes = 232448;  // what one block may use on sm_90
constexpr int kSMs = 132;                   // streaming multiprocessors, H100 SXM
constexpr size_t kPartialBytes = (size_t)256 << 20;  // what wgrad's partials may take

static_assert(kSlice == kGemmThreads / 16, "wgrad sums db over a slice's rows by ty");

// The chain.
constexpr int kChainThreads = 512;
constexpr int kLanesPerUnit = 8;  // lanes that split one dh dot product
constexpr int kMaxChainRows = 16;

// Kernel 1: dxw <- activations of xw + Hprev @ W_h + b, over M = T*B rows.
// Block (x, y) owns rows 64x .. 64x+63 and columns 64y .. 64y+63 of 4H.
__global__ void __launch_bounds__(kGemmThreads)
lstm_bwd_gates_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                      const float* __restrict__ bias, const float* __restrict__ hs,
                      float* __restrict__ gates, int T, int B, int H) {
  __shared__ __align__(16) float a_s[kSlice][kTile + kPad];  // Hprev^T slice
  __shared__ __align__(16) float b_s[kSlice][kTile + kPad];  // W_h slice
  const int64_t M = (int64_t)T * B;
  const int H4 = 4 * H;
  const int64_t m0 = (int64_t)blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < H; k0 += kSlice) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kGemmThreads;
      // Hprev[m, k]: row m - B of hs, zero for the t = 0 rows.
      const int kk = e & (kSlice - 1), r = e / kSlice;
      const int64_t m = m0 + r;
      const int k = k0 + kk;
      a_s[kk][r] = (m < M && m >= B && k < H) ? hs[(m - B) * H + k] : 0.0f;
    }
    // W_h[k, n], tile column c being column n0 + c of 4H.
    load_w_slice<false>(b_s, wh, k0, H, [=](int c) { return n0 + c < H4 ? n0 + c : -1; }, tid);
    __syncthreads();
    mma_slice(a_s, b_s, tx, ty, acc);
    __syncthreads();
  }

  // Epilogue, in the reference's order: (xw + h @ W_h) + b, then the gate's
  // activation (its quarter of the columns: i, f, g, o).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= H4) continue;
      const float z = (xw[m * H4 + n] + acc[i][j]) + bias[n];
      gates[m * H4 + n] = (n / H == 2) ? tanhf(z) : sigmoid_f32(z);
    }
  }
}

// W_h from shared memory (kSharedW) or from device memory through L2.
template <bool kSharedW>
__device__ __forceinline__ float4 load_w4(const float* p) {
  if constexpr (kSharedW) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
}

// A chain block's region of the scratch (kGlobalTiles): its R rows of 6H
// floats, rounded up to whole float4s so that every region's dz tile is
// 16-byte aligned.
__host__ __device__ inline int64_t chain_region(int R, int H) {
  return ((int64_t)R * 6 * H + 3) / 4 * 4;
}

// Kernel 2: the reverse-time chain over a tile of R batch rows. dxw holds
// the gates on entry and dz on exit. The dz tile and the carries are in
// shared memory, or with kGlobalTiles in this block's region of scratch.
template <int R, int U, bool kSharedW, bool kGlobalTiles>
__global__ void __launch_bounds__(kChainThreads)
lstm_bwd_chain_kernel(const float* __restrict__ wh, const float* __restrict__ cs,
                      const float* __restrict__ dhs, float* __restrict__ dxw,
                      float* scratch, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  float* w_s = smem;                              // [H, 4H] if kSharedW
  float* dz_s = kGlobalTiles ? scratch + blockIdx.x * chain_region(R, H)
                             : smem + (kSharedW ? H * H4 : 0);  // [R, 4H]
  float* dh_s = dz_s + R * H4;                    // [R, H] dh carry
  float* dc_s = dh_s + R * H;                     // [R, H] dc carry
  const float* w_src = kSharedW ? w_s : wh;

  const int tid = threadIdx.x;
  if (kSharedW)
    for (int e = tid; e < H * H4; e += kChainThreads) w_s[e] = wh[e];
  for (int e = tid; e < 2 * R * H; e += kChainThreads) dh_s[e] = 0.0f;
  __syncthreads();

  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int lane = tid & 31, warp = tid >> 5;
  const int part = lane & (kLanesPerUnit - 1);  // which float4 chunks
  const int unit = lane / kLanesPerUnit;        // which of the warp's 4 units
  constexpr int kUnitsPerWarp = 32 / kLanesPerUnit;
  constexpr int kWarps = kChainThreads / 32;

  for (int t = T - 1; t >= 0; --t) {
    // dz of the tile, in the reference's order, from the gates, the cell
    // states and the carries; it goes to dxw[t] and to shared memory.
    for (int e = tid; e < R * H; e += kChainThreads) {
      const int r = e / H, j = e - r * H;
      const int64_t row = row0 + r;
      float dzi = 0.0f, dzf = 0.0f, dzg = 0.0f, dzo = 0.0f;
      if (row < B) {
        const int64_t o4 = ((int64_t)t * B + row) * H4;
        const int64_t o1 = ((int64_t)t * B + row) * H + j;
        const float ig = dxw[o4 + j];
        const float fg = dxw[o4 + H + j];
        const float gg = dxw[o4 + 2 * H + j];
        const float og = dxw[o4 + 3 * H + j];
        const float c = cs[o1];
        const float c_prev = t > 0 ? cs[o1 - (int64_t)B * H] : 0.0f;
        const float tc = tanhf(c);
        const float dh = dhs[o1] + dh_s[e];
        const float d_o = dh * tc;
        const float dc = dc_s[e] + dh * og * (1.0f - tc * tc);
        dzi = dc * gg * ig * (1.0f - ig);
        dzf = dc * c_prev * fg * (1.0f - fg);
        dzg = dc * ig * (1.0f - gg * gg);
        dzo = d_o * og * (1.0f - og);
        dc_s[e] = dc * fg;
        dxw[o4 + j] = dzi;
        dxw[o4 + H + j] = dzf;
        dxw[o4 + 2 * H + j] = dzg;
        dxw[o4 + 3 * H + j] = dzo;
      }
      float* dzr = dz_s + r * H4;
      dzr[j] = dzi;
      dzr[H + j] = dzf;
      dzr[2 * H + j] = dzg;
      dzr[3 * H + j] = dzo;
    }
    __syncthreads();

    // dh for step t-1: dh[r, j] = sum_n dz[r, n] * W_h[j, n]. The loop
    // bounds are the same for the whole warp, so every lane reaches the
    // shuffles; a unit past H reads row H-1 and stores nothing.
    constexpr int kWarpUnits = kUnitsPerWarp * U;
    for (int j0 = warp * kWarpUnits; j0 < H; j0 += kWarps * kWarpUnits) {
      const float* wj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + unit + u * kUnitsPerWarp;
        wj[u] = w_src + (int64_t)(j < H ? j : H - 1) * H4;
      }
      float acc[U][R];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[u][r] = 0.0f;
#pragma unroll 4
      for (int c4 = part; c4 < H; c4 += kLanesPerUnit) {
        float4 w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) w[u] = load_w4<kSharedW>(wj[u] + 4 * c4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dz_s + r * H4 + 4 * c4);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            acc[u][r] = fmaf(d.x, w[u].x, acc[u][r]);
            acc[u][r] = fmaf(d.y, w[u].y, acc[u][r]);
            acc[u][r] = fmaf(d.z, w[u].z, acc[u][r]);
            acc[u][r] = fmaf(d.w, w[u].w, acc[u][r]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int o = kLanesPerUnit / 2; o > 0; o >>= 1)
            acc[u][r] += __shfl_xor_sync(0xffffffffu, acc[u][r], o);
        }
        const int j = j0 + unit + u * kUnitsPerWarp;
        if (part == 0 && j < H) {
#pragma unroll
          for (int r = 0; r < R; ++r) dh_s[r * H + j] = acc[u][r];
        }
      }
    }
    __syncthreads();
  }
}

// Kernel 3: dW_h and db partials. Block (x, y, s) owns columns 64x .. of
// 4H, rows 64y .. of H, and the chunk s of the M = T*B rows; the blocks of
// y = 0 also sum their chunk's dz columns into db.
__global__ void __launch_bounds__(kGemmThreads)
lstm_bwd_wgrad_kernel(const float* __restrict__ hs, const float* __restrict__ dz,
                      float* __restrict__ dwh_part, float* __restrict__ db_part,
                      int T, int B, int H, int64_t chunk) {
  __shared__ __align__(16) float a_s[kSlice][kTile + kPad];  // Hprev rows
  __shared__ __align__(16) float b_s[kSlice][kTile + kPad];  // dz rows
  const int64_t M = (int64_t)T * B;
  const int H4 = 4 * H;
  const int n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const int64_t m_begin = (int64_t)s * chunk;
  const int64_t m_end = m_begin + chunk < M ? m_begin + chunk : M;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const bool sums_db = blockIdx.y == 0;  // the same for the whole block
  float acc[4][4] = {};
  float db_acc[4] = {};  // this thread's columns, over slice row ty

  // The slice of rows from m0 into registers, one slice ahead, so that the
  // loads' latency hides behind the products of the slice before:
  // Hprev[m, k] and dz[m, n].
  float a_reg[kLoads], b_reg[kLoads];
  auto load = [&](int64_t m0) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kGemmThreads;
      const int64_t m = m0 + e / kTile;
      const int c = e & (kTile - 1);
      const bool in = m < m_end;
      a_reg[q] = (in && m >= B && k0 + c < H) ? hs[(m - B) * H + k0 + c] : 0.0f;
      b_reg[q] = (in && n0 + c < H4) ? dz[m * H4 + n0 + c] : 0.0f;
    }
  };
  if (m_begin < m_end) load(m_begin);
  for (int64_t m0 = m_begin; m0 < m_end; m0 += kSlice) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kGemmThreads;
      a_s[e / kTile][e & (kTile - 1)] = a_reg[q];
      b_s[e / kTile][e & (kTile - 1)] = b_reg[q];
    }
    __syncthreads();
    if (m0 + kSlice < m_end) load(m0 + kSlice);
    mma_slice(a_s, b_s, tx, ty, acc);
    if (sums_db) {
#pragma unroll
      for (int j = 0; j < 4; ++j) db_acc[j] += b_s[ty][4 * tx + j];
    }
    __syncthreads();
  }

  float* dwp = dwh_part + (int64_t)s * H * H4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < H4) dwp[(int64_t)k * H4 + n] = acc[i][j];
    }
  }
  if (sums_db) {
    // The 16 sums of a column (one per slice row) added in order of ty.
#pragma unroll
    for (int j = 0; j < 4; ++j) a_s[ty][4 * tx + j] = db_acc[j];
    __syncthreads();
    if (ty == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sum = 0.0f;
        for (int r = 0; r < kSlice; ++r) sum += a_s[r][4 * tx + j];
        const int n = n0 + 4 * tx + j;
        if (n < H4) db_part[(int64_t)s * H4 + n] = sum;
      }
    }
  }
}

// The chain's shared memory for R rows a block.
size_t chain_smem(int H, int R, bool shared_w) {
  const size_t H4 = 4 * (size_t)H;
  return sizeof(float) * ((shared_w ? (size_t)H * H4 : 0) + (size_t)R * (H4 + 2 * (size_t)H));
}

// Whether the chain's tiles fit in shared memory at one row a block:
// H <= 9685. Above it they go to the scratch.
bool tiles_fit(int H) { return chain_smem(H, 1, false) <= kMaxSharedBytes; }

// Rows a chain block: the largest R of 16, 8, 4, 2, 1 whose tiles fit (in
// shared memory where tiles_fit, else in the scratch, where any R does) and
// whose grid has at least min(132, ceil(B / 2)) blocks (so B = 20 runs on
// 10 blocks of 2 rows), and no larger than B needs.
int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int chain_rows(int B, int H) {
  const bool in_shared = tiles_fit(H);
  const int64_t half = ceil_div(B, 2);
  const int64_t want = half < kSMs ? half : kSMs;
  for (int R = kMaxChainRows; R >= 1; R /= 2) {
    if (in_shared && chain_smem(H, R, false) > kMaxSharedBytes) continue;
    if (R > 1 && R / 2 >= B) continue;
    if (R > 1 && ceil_div(B, R) < want) continue;
    return R;
  }
  return 1;
}

// The largest H whose W_h (4 H^2 floats) is indexed in 32 bits, as in
// lstm_fwd.cu.
int max_hidden() {
  static const int limit = [] {
    int h = 1;
    while (4 * (int64_t)(h + 1) * (h + 1) <= INT_MAX) ++h;
    return h;
  }();
  return limit;
}

bool supported(int H) { return H > 0 && H <= max_hidden(); }

template <int R>
int launch_chain(const float* wh, const float* cs, const float* dhs, float* dxw,
                 float* scratch, int T, int B, int H, cudaStream_t stream) {
  // Two units a lane where the rows are many: each dz value read from
  // shared memory then feeds two products.
  constexpr int U = R >= 8 ? 4 : (R == 4 ? 2 : 1);
  const dim3 grid((unsigned)((B + R - 1) / R));
  if (!tiles_fit(H)) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    lstm_bwd_chain_kernel<R, U, false, true>
        <<<grid, kChainThreads, 0, stream>>>(wh, cs, dhs, dxw, scratch, T, B, H);
    return (int)cudaGetLastError();
  }
  const bool shared_w = chain_smem(H, R, true) <= kMaxSharedBytes;
  const size_t smem = chain_smem(H, R, shared_w);
  auto kernel = shared_w ? lstm_bwd_chain_kernel<R, U, true, false>
                         : lstm_bwd_chain_kernel<R, U, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kChainThreads, smem, stream>>>(wh, cs, dhs, dxw, nullptr, T, B, H);
  return (int)cudaGetLastError();
}

// wgrad's row chunk for S splits: a whole number of slices.
int64_t wgrad_chunk(int T, int B, int S) {
  return ceil_div(ceil_div((int64_t)T * B, S), kSlice) * kSlice;
}

}  // namespace

extern "C" {

// Largest hidden size the kernels take (every H from 1 up to it).
int tpuflow_lstm_bwd_max_hidden(void) { return max_hidden(); }

// Splits S of wgrad's reduction over the T*B rows (the leading size of the
// partials): enough (tile, chunk) blocks for two on each SM, no chunk
// empty, and the [S, H, 4H] partials within 256 MB. Depends on the shapes
// only. 0 when T*B is 0 or H is not taken.
int tpuflow_lstm_bwd_splits(int T, int B, int H) {
  if (T <= 0 || B <= 0 || !supported(H)) return 0;
  const int64_t tiles = ceil_div(H, kTile) * ceil_div(4 * (int64_t)H, kTile);
  int64_t S = ceil_div(2 * kSMs, tiles);
  const int64_t by_bytes =
      (int64_t)(kPartialBytes / (sizeof(float) * (4 * (size_t)H * H + 4 * (size_t)H)));
  if (S > by_bytes) S = by_bytes;
  if (S < 1) S = 1;
  return (int)ceil_div((int64_t)T * B, wgrad_chunk(T, B, (int)S));
}

// Kernel 1 into gates [T, B, 4H] (the dxw buffer). Returns 0, or the CUDA
// error code.
int tpuflow_lstm_bwd_gates(const float* xw, const float* wh, const float* b,
                           const float* hs, float* gates, int T, int B, int H,
                           void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (!supported(H)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div((int64_t)T * B, kTile),
                  (unsigned)ceil_div(4 * (int64_t)H, kTile));
  lstm_bwd_gates_kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      xw, wh, b, hs, gates, T, B, H);
  return (int)cudaGetLastError();
}

// Floats of scratch the chain needs at (B, H): 0 where its tiles fit in
// shared memory (H <= 9685), else a region of R rows of 6H for each block.
int64_t tpuflow_lstm_bwd_chain_scratch(int B, int H) {
  if (B <= 0 || !supported(H) || tiles_fit(H)) return 0;
  const int R = chain_rows(B, H);
  return ceil_div(B, R) * chain_region(R, H);
}

// Kernel 2: dxw holds the gates on entry and dz on exit; scratch holds
// tpuflow_lstm_bwd_chain_scratch(B, H) floats (null when that is 0).
int tpuflow_lstm_bwd_chain(const float* wh, const float* cs, const float* dhs,
                           float* dxw, float* scratch, int T, int B, int H,
                           void* stream) {
  if (T <= 0 || B <= 0) return 0;
  const int R = supported(H) ? chain_rows(B, H) : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 16: return launch_chain<16>(wh, cs, dhs, dxw, scratch, T, B, H, st);
    case 8: return launch_chain<8>(wh, cs, dhs, dxw, scratch, T, B, H, st);
    case 4: return launch_chain<4>(wh, cs, dhs, dxw, scratch, T, B, H, st);
    case 2: return launch_chain<2>(wh, cs, dhs, dxw, scratch, T, B, H, st);
    case 1: return launch_chain<1>(wh, cs, dhs, dxw, scratch, T, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 3 into dwh_part [S, H, 4H] and db_part [S, 4H], S from
// tpuflow_lstm_bwd_splits.
int tpuflow_lstm_bwd_wgrad(const float* hs, const float* dz, float* dwh_part,
                           float* db_part, int S, int T, int B, int H,
                           void* stream) {
  if (T <= 0 || B <= 0) return 0;
  if (!supported(H) || S != tpuflow_lstm_bwd_splits(T, B, H))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(4 * (int64_t)H, kTile),
                  (unsigned)ceil_div(H, kTile), (unsigned)S);
  lstm_bwd_wgrad_kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      hs, dz, dwh_part, db_part, T, B, H, wgrad_chunk(T, B, S));
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
