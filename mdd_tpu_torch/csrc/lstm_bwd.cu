// Fused two-direction LSTM backward for Hopper (sm_90a).
//
// Replaces mdd_tpu/ops/lstm_pallas.py::_bwd_kernel (the TPU kernel behind
// the custom VJP of lstm_seq / bilstm_pallas).  Same contract as
// _lstm_seq_bwd:
//
//   x_proj (T, 2, B, 4H), w_hh (2, H, 4H), hs, cs (T, 2, B, H) in the
//   compute dtype, dhs (T, 2, B, H) float32
//     ->  dx_proj (T, 2, B, 4H) in the compute dtype, dW_hh (2, H, 4H) fp32
//
// walking t from T-1 down to 0: the gates are recomputed from h_{t-1} (read
// from hs, zero at t = 0) and w_hh, with dot operands in the compute dtype
// and float32 sums; dh and dc are carried in float32; c_t and c_{t-1} come
// from the saved cs stream (in bf16 that is the rounded c, as the Pallas
// kernel reads it); dgates are rounded to the compute dtype (dx_proj) before
// both products, dh_{t-1} = dgates @ w_hh^T and dW_hh = sum_t h_{t-1}^T @
// dgates, each summed in float32.
//
// What bounds it on an H100.  Like the forward, the T steps form a serial
// chain: dh_{t-1} needs the dgates of every gate column of step t, so the
// wall time is T times the latency of one step.  A step does three dots of
// the same size as the forward's one (gate recompute, dh, and dW's share),
// far too little at B <= 64 to fill the card.
//
// What the design does about it.  Kernel 1 (lstm_bwd_kernel) is one
// persistent cooperative launch over all T steps, with the forward's layout:
// each block owns kUnits hidden units of one direction.  It keeps two
// slices of w_hh in shared memory for the whole sequence: the 4 * kUnits
// gate COLUMNS that feed its units (to recompute their gates) and the
// kUnits ROWS of its units (to form dh_{t-1} for them; ~48 KB each in fp32
// at H = 384).  A step is: recompute the block's gates for every batch row
// (h_{t-1} comes from hs, which is complete, so no barrier is needed for
// it), form the dgates of its units from its own dh and dc carries, write
// them to dx_proj; one barrier over the direction's blocks; then read the
// direction's whole dgates row tile of step t back from L2 and form
// dh_{t-1} for its own units only.  So the next step's dh is local and a
// step needs exactly one barrier; the carries dh and dc never leave the
// block that owns them (float32 scratch rows in global memory that only
// that block touches).  Kernel 2 (lstm_dw_kernel) forms dW_hh after the
// recurrence as one hand-written tiled product over all (T-1) * B rows,
// h_{t-1}^T @ dgates_t, which runs on the whole card instead of inside the
// serial chain.  Not yet used: wgmma / TMA / clusters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

using namespace mdd;

constexpr int kThreads = 256;
constexpr int kUnits = 8;                        // hidden units per block
constexpr int kCols = 4 * kUnits;                // gate columns per block
constexpr int kRows = kThreads / kCols;          // warps per block
constexpr int kBatchTile = 16;                   // batch rows per pass
constexpr int kRowsPerThread = kBatchTile / kRows;
constexpr int kVec = 4;                          // k values per vector load
constexpr int kPadCol = 4;                       // w_col row padding, elements
constexpr int kPadRow = 16;                      // w_row row padding, elements
constexpr int kSlices = kCols / kUnits;          // K-slices per unit (dh)

static_assert(kCols == 32, "one warp lane per gate column");
static_assert(kRowsPerThread == 2, "the dot loops keep two row sums");
static_assert(kBatchTile * kUnits <= kThreads, "one gate-math item a thread");
static_assert(kSlices == 4, "the dh reduction is two shuffles");

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ whh,
                const T* __restrict__ hs, const T* __restrict__ cs,
                const float* __restrict__ dhs, T* dxp, float* dh_state,
                float* dc_state, unsigned* barrier, int n_steps, int batch,
                int hidden) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blocks_per_dir = hidden / kUnits;
  const int d = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * kUnits;
  const int four_h = 4 * hidden;
  const int wcs = hidden + kPadCol;   // w_col row stride: conflict-free
  const int wrs = four_h + kPadRow;   // w_row row stride: conflict-free

  T* w_col = reinterpret_cast<T*>(smem);                      // [kCols][wcs]
  T* w_row = w_col + static_cast<size_t>(kCols) * wcs;        // [kUnits][wrs]
  T* tile = w_row + static_cast<size_t>(kUnits) * wrs;
  // tile: h_{t-1} rows [kBatchTile][H] while gates are recomputed, then
  // dgates rows [kBatchTile][4H] while dh is formed
  float* part = reinterpret_cast<float*>(
      tile + static_cast<size_t>(kBatchTile) * four_h);
  // part: [K-slice][tile row][kCols] float32 partial dots

  // column c = gate * kUnits + unit of w_hh[d], column-major so that a
  // thread reads its column 4 k at a time; and the rows j0 .. j0 + kUnits
  const T* wd = whh + static_cast<size_t>(d) * hidden * four_h;
  for (int idx = threadIdx.x; idx < hidden * kCols; idx += kThreads) {
    const int k = idx / kCols, c = idx % kCols;
    w_col[c * wcs + k] = wd[static_cast<size_t>(k) * four_h
                            + (c / kUnits) * hidden + j0 + c % kUnits];
  }
  for (int idx = threadIdx.x; idx < kUnits * four_h; idx += kThreads) {
    const int u = idx / four_h, n = idx % four_h;
    w_row[u * wrs + n] = wd[static_cast<size_t>(j0 + u) * four_h + n];
  }
  __syncthreads();

  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int item_b = threadIdx.x / kUnits;   // gate-math item of this thread
  const int item_u = threadIdx.x % kUnits;
  const T* w_c = w_col + lane * wcs;
  const int dh_u = lane / kSlices;           // dh product: unit and K-slice
  const int dh_s = lane % kSlices;
  const T* w_r = w_row + dh_u * wrs;
  const size_t plane = static_cast<size_t>(batch) * hidden;   // one (t, d)
  unsigned target = 0;
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t step_row = (static_cast<size_t>(t) * 2 + d) * batch;
    // ---- gates of step t and the dgates of this block's units ----
    for (int b0 = 0; b0 < batch; b0 += kBatchTile) {
      const int bt = min(kBatchTile, batch - b0);
      const bool has_item = item_b < bt;
      float g[4];
      if (has_item) {
        const T* x_row = xp + (step_row + b0 + item_b) * four_h + j0 + item_u;
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = to_f(x_row[q * hidden]);
      }
      const int rows_b = min(bt, kRows);
      const int n_slices = kRows / rows_b;
      if (t > 0) {
        const T* h_prev = hs + (step_row - 2 * static_cast<size_t>(batch)
                                + b0) * hidden;
        for (int idx = threadIdx.x * kVec; idx < bt * hidden;
             idx += kThreads * kVec)
          copy4_from_l2(tile + idx, h_prev + idx);
        __syncthreads();
        const int slice = warp / rows_b;
        const int b_a = warp % rows_b;
        const int b_b = b_a + rows_b;
        if (slice < n_slices) {
          const int chunk = ((hidden + n_slices - 1) / n_slices + kVec - 1)
                            / kVec * kVec;
          const int k_lo = slice * chunk;
          const int k_hi = min(hidden, k_lo + chunk);
          float acc_a = 0.0f, acc_b = 0.0f;
          const T* h_a = tile + b_a * hidden;
          if (b_b < bt) {
            const T* h_b = tile + b_b * hidden;
            for (int k = k_lo; k < k_hi; k += kVec) {
              const float4 w = load4(w_c + k);
              acc_a = dot4(load4(h_a + k), w, acc_a);
              acc_b = dot4(load4(h_b + k), w, acc_b);
            }
            part[(slice * bt + b_b) * kCols + lane] = acc_b;
          } else {
            for (int k = k_lo; k < k_hi; k += kVec)
              acc_a = dot4(load4(h_a + k), load4(w_c + k), acc_a);
          }
          part[(slice * bt + b_a) * kCols + lane] = acc_a;
        }
        __syncthreads();
      }
      if (has_item) {
        const int b = item_b, u = item_u, j = j0 + u;
        if (t > 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float dot = 0.0f;
            for (int s = 0; s < n_slices; ++s)
              dot += part[(s * bt + b) * kCols + q * kUnits + u];
            g[q] += dot;
          }
        }
        const float i = sigmoid(g[0]);
        const float f = sigmoid(g[1]);
        const float gg = tanhf(g[2]);
        const float o = sigmoid(g[3]);
        const size_t o_idx = (step_row + b0 + b) * hidden + j;
        const size_t s_idx = (static_cast<size_t>(d) * batch + b0 + b)
                             * hidden + j;
        const float c_t = to_f(cs[o_idx]);
        const float c_prev = t > 0 ? to_f(cs[o_idx - 2 * plane]) : 0.0f;
        const float dh = dhs[o_idx] + dh_state[s_idx];
        const float tanh_c = tanhf(c_t);
        const float d_o = dh * tanh_c;
        const float dc = dh * o * (1.0f - tanh_c * tanh_c) + dc_state[s_idx];
        const float dgi = dc * gg * i * (1.0f - i);
        const float dgf = dc * c_prev * f * (1.0f - f);
        const float dgg = dc * i * (1.0f - gg * gg);
        const float dgo = d_o * o * (1.0f - o);
        T* dx_row = dxp + (step_row + b0 + b) * four_h + j;
        dx_row[0] = from_f<T>(dgi);
        dx_row[hidden] = from_f<T>(dgf);
        dx_row[2 * hidden] = from_f<T>(dgg);
        dx_row[3 * hidden] = from_f<T>(dgo);
        dc_state[s_idx] = dc * f;
      }
      __syncthreads();  // tile / part are reused by the next batch tile
    }
    if (t == 0) break;
    target += blocks_per_dir;
    direction_barrier(barrier + d, target);
    // ---- dh_{t-1} of this block's units from the direction's dgates ----
    // lane (unit, K-slice), a warp per two batch rows; the K-slices
    // interleave 4 elements at a time, so a quarter warp reads 8 distinct
    // 16-byte words of w_row and broadcasts the dgates words
    const T* dg = dxp + step_row * four_h;
    for (int b0 = 0; b0 < batch; b0 += kBatchTile) {
      const int bt = min(kBatchTile, batch - b0);
      for (int idx = threadIdx.x * kVec; idx < bt * four_h;
           idx += kThreads * kVec)
        copy4_from_l2(tile + idx, dg + static_cast<size_t>(b0) * four_h + idx);
      __syncthreads();
      const int r_a = warp * kRowsPerThread;
      const int r_b = r_a + 1;
      if (r_a < bt) {   // warp-uniform, so the shuffles see the whole warp
        const T* g_a = tile + r_a * four_h;
        const T* g_b = tile + min(r_b, bt - 1) * four_h;
        float acc_a = 0.0f, acc_b = 0.0f;
        for (int k = dh_s * kVec; k < four_h; k += kSlices * kVec) {
          const float4 w = load4(w_r + k);
          acc_a = dot4(load4(g_a + k), w, acc_a);
          acc_b = dot4(load4(g_b + k), w, acc_b);
        }
        acc_a += __shfl_xor_sync(0xffffffffu, acc_a, 1);
        acc_a += __shfl_xor_sync(0xffffffffu, acc_a, 2);
        acc_b += __shfl_xor_sync(0xffffffffu, acc_b, 1);
        acc_b += __shfl_xor_sync(0xffffffffu, acc_b, 2);
        if (dh_s == 0) {
          const size_t s_idx = (static_cast<size_t>(d) * batch + b0 + r_a)
                               * hidden + j0 + dh_u;
          dh_state[s_idx] = acc_a;
          if (r_b < bt) dh_state[s_idx + hidden] = acc_b;
        }
      }
      __syncthreads();  // the tile is refilled by the next pass / step
    }
  }
}

// dW_hh[d] = sum over t >= 1 and b of h_{t-1}[d, b]^T dgates_t[d, b]: a
// (H x M) @ (M x 4H) product over M = (T-1) * B rows, tiled 64 x 64 per
// block with a 4 x 4 float32 accumulator per thread.
constexpr int kTileK = 64;    // rows of dW (hidden index of h_{t-1})
constexpr int kTileN = 64;    // columns of dW (gate column)
constexpr int kTileM = 16;    // reduction rows staged per pass
constexpr int kDwThreads = 256;
static_assert(kTileK / 4 * kTileN / 4 == kDwThreads, "4 x 4 per thread");

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
lstm_dw_kernel(const T* __restrict__ hs, const T* __restrict__ dxp,
               float* __restrict__ dw, int n_steps, int batch, int hidden) {
  __shared__ __align__(16) float a_s[kTileM][kTileK];
  __shared__ __align__(16) float b_s[kTileM][kTileN];
  const int d = blockIdx.z;
  const int k0 = blockIdx.y * kTileK;
  const int n0 = blockIdx.x * kTileN;
  const int four_h = 4 * hidden;
  const int tx = threadIdx.x % (kTileN / 4);
  const int ty = threadIdx.x / (kTileN / 4);
  const int m_total = (n_steps - 1) * batch;
  float acc[4][4] = {};
  for (int m0 = 0; m0 < m_total; m0 += kTileM) {
    for (int e = threadIdx.x; e < kTileM * kTileK; e += kDwThreads) {
      const int mi = e / kTileK, ci = e % kTileK;
      const int m = m0 + mi;
      float a = 0.0f, bv = 0.0f;
      if (m < m_total) {
        const int t = m / batch + 1, b = m % batch;
        const size_t h_row = (static_cast<size_t>(t - 1) * 2 + d) * batch + b;
        const size_t g_row = (static_cast<size_t>(t) * 2 + d) * batch + b;
        if (k0 + ci < hidden) a = to_f(hs[h_row * hidden + k0 + ci]);
        if (n0 + ci < four_h) bv = to_f(dxp[g_row * four_h + n0 + ci]);
      }
      a_s[mi][ci] = a;
      b_s[mi][ci] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < kTileM; ++mi) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[mi][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[mi][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a4[r], b4[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + ty * 4 + r;
    if (k >= hidden) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < four_h)
        dw[(static_cast<size_t>(d) * hidden + k) * four_h + n] = acc[r][c];
    }
  }
}

template <typename T>
size_t smem_bytes(int hidden) {
  return (static_cast<size_t>(hidden + kPadCol) * kCols
          + static_cast<size_t>(4 * hidden + kPadRow) * kUnits
          + static_cast<size_t>(kBatchTile) * 4 * hidden) * sizeof(T)
       + static_cast<size_t>(kRows * kRowsPerThread) * kCols * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* xp_v, const void* whh_v, const void* hs_v,
                   const void* cs_v, const float* dhs, void* dxp_v, float* dw,
                   float* dh_state, float* dc_state, unsigned* barrier,
                   int n_steps, int batch, int hidden, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(xp_v);
  const T* whh = static_cast<const T*>(whh_v);
  const T* hs = static_cast<const T*>(hs_v);
  const T* cs = static_cast<const T*>(cs_v);
  T* dxp = static_cast<T*>(dxp_v);
  const size_t smem = smem_bytes<T>(hidden);
  void (*kernel)(const T*, const T*, const T*, const T*, const float*, T*,
                 float*, float*, unsigned*, int, int, int) =
      lstm_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&xp, &whh, &hs, &cs, &dhs, &dxp, &dh_state, &dc_state,
                  &barrier, &n_steps, &batch, &hidden};
  // cooperative: the launch fails (cudaErrorCooperativeLaunchTooLarge)
  // instead of deadlocking at the barrier when the blocks cannot all be
  // resident at once
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(2 * hidden / kUnits),
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((4 * hidden + kTileN - 1) / kTileN,
                  (hidden + kTileK - 1) / kTileK, 2);
  lstm_dw_kernel<T><<<grid, kDwThreads, 0, stream>>>(hs, dxp, dw, n_steps,
                                                      batch, hidden);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hidden units each block owns; the wrapper checks H % this == 0
int mdd_lstm_bwd_units_per_block() { return kUnits; }

// dtype: 0 = float32, 1 = bfloat16.  dh_state and dc_state are (2, B, H)
// float32 scratch that must hold zeros; barrier is 2 zeroed counters.
// Returns a cudaError_t (0 = success).
int mdd_lstm_bwd(const void* x_proj, const void* w_hh, const void* hs,
                 const void* cs, const float* dhs, void* dx_proj,
                 float* dw_hh, float* dh_state, float* dc_state,
                 unsigned* barrier, int n_steps, int batch, int hidden,
                 int dtype, void* stream) {
  if (n_steps < 1 || batch < 1 || hidden < kUnits || hidden % kUnits != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x_proj, w_hh, hs, cs, dhs, dx_proj, dw_hh,
                         dh_state, dc_state, barrier, n_steps, batch,
                         hidden, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x_proj, w_hh, hs, cs, dhs, dx_proj, dw_hh,
                                 dh_state, dc_state, barrier, n_steps, batch,
                                 hidden, s);
  return cudaErrorInvalidValue;
}

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
