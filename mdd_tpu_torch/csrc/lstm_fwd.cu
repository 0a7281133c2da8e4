// Fused two-direction LSTM recurrence, forward only, for Hopper (sm_90a).
//
// Replaces mdd_tpu/ops/lstm_pallas.py::_fwd_kernel (the TPU kernel behind
// lstm_seq / bilstm_pallas).  Same contract:
//
//   x_proj (T, 2, B, 4H), w_hh (2, H, 4H)  ->  hs, cs (T, 2, B, H)
//   gates_t = x_proj_t + h_{t-1} @ w_hh[d]   (gate order i, f, g, o)
//   c_t = f * c_{t-1} + i * g ;  h_t = o * tanh(c_t)
//
// Dot operands stay in the compute dtype (float32 or bfloat16), products are
// accumulated in float32, the gate math is float32, h is carried in the
// compute dtype and c is carried in float32 for the whole sequence (the
// Pallas kernel's h_scr / c_scr contract).  Both directions walk time
// forwards: the caller has already time-reversed direction 1's projections.
//
// What bounds it on an H100.  The T steps form a serial chain: step t needs
// every hidden unit of step t-1, so the wall time is T times the latency of
// one step, whatever the FLOP rate.  At the serving shapes (H = 384,
// B <= 16, T' <= 80) a step is only 2 * B * H * 4H FLOPs per direction, far
// too little to fill the card; a kernel that re-reads w_hh from device
// memory every step moves 2 * H * 4H * sizeof(T) bytes (4.7 MB in fp32) per
// step for that work.
//
// What the design does about it.  One persistent cooperative launch runs all
// T steps.  Each block owns kUnits hidden units of one direction, i.e. the
// 4 * kUnits gate columns of w_hh that feed them, and keeps that slice of
// w_hh in shared memory for the whole sequence (~48 KB in fp32 at H = 384),
// so w_hh is read from device memory once per call, not once per step.
// 2H / kUnits blocks (96 at H = 384) all stay resident, one per SM.  The
// cell state never leaves the block that owns it (a float32 scratch row in
// global memory that only that block touches).  After writing h_t, the
// blocks of one direction meet at a barrier in global memory; the two
// directions never wait for each other.  A step is then: load this step's
// projections (they do not depend on h, so their latency overlaps the
// rest), stage h_{t-1} of the direction from L2 into shared memory, B x 32
// dot products of length H per block (a lane per gate column, K split over
// warps when B is small, 4-wide shared-memory loads), the gate math, the
// stores, one barrier.  Not yet used: wgmma / TMA / clusters (a cluster
// could share h_{t-1} through distributed shared memory and replace the
// global barrier).

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
constexpr int kPad = 4;                          // w_s row padding, elements

static_assert(kCols == 32, "one warp lane per gate column");
static_assert(kRowsPerThread == 2, "the dot loop keeps two row sums");
static_assert(kBatchTile * kUnits <= kThreads, "one gate-math item a thread");

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ whh,
                T* hs, T* cs, float* c_state, unsigned* barrier,
                int n_steps, int batch, int hidden) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blocks_per_dir = hidden / kUnits;
  const int d = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * kUnits;
  const int four_h = 4 * hidden;
  const int ws = hidden + kPad;   // w_s row stride: conflict-free 4-wide

  T* w_s = reinterpret_cast<T*>(smem);                        // [kCols][ws]
  T* h_s = w_s + static_cast<size_t>(kCols) * ws;             // [tile][H]
  float* part = reinterpret_cast<float*>(h_s + kBatchTile * hidden);
  // part: [K-slice][tile row][kCols] float32 partial dots

  // this block's gate columns of w_hh[d], column-major so that a thread
  // reads its column 4 k at a time; column c = gate * kUnits + unit
  const T* wd = whh + static_cast<size_t>(d) * hidden * four_h;
  for (int idx = threadIdx.x; idx < hidden * kCols; idx += kThreads) {
    const int k = idx / kCols, c = idx % kCols;
    w_s[c * ws + k] = wd[static_cast<size_t>(k) * four_h
                         + (c / kUnits) * hidden + j0 + c % kUnits];
  }
  __syncthreads();

  const int lane = threadIdx.x % kCols;
  const int row = threadIdx.x / kCols;
  const int item_b = threadIdx.x / kUnits;   // gate-math item of this thread
  const int item_u = threadIdx.x % kUnits;
  const T* w_col = w_s + lane * ws;
  unsigned target = 0;
  for (int t = 0; t < n_steps; ++t) {
    const size_t step_row = (static_cast<size_t>(t) * 2 + d) * batch;
    for (int b0 = 0; b0 < batch; b0 += kBatchTile) {
      const int bt = min(kBatchTile, batch - b0);
      const bool has_item = item_b < bt;
      // this step's projections do not depend on h: load them first so
      // their latency hides behind the recurrent product
      float g[4];
      if (has_item) {
        const T* x_row = xp + (step_row + b0 + item_b) * four_h + j0 + item_u;
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = to_f(x_row[q * hidden]);
      }
      // K is split over warps when the tile has fewer rows than warps
      const int rows_b = min(bt, kRows);
      const int n_slices = kRows / rows_b;
      if (t > 0) {
        const T* h_prev = hs + (step_row - 2 * static_cast<size_t>(batch)
                                + b0) * hidden;
        for (int idx = threadIdx.x * kVec; idx < bt * hidden;
             idx += kThreads * kVec)
          copy4_from_l2(h_s + idx, h_prev + idx);
        __syncthreads();
        const int slice = row / rows_b;
        const int b_a = row % rows_b;
        const int b_b = b_a + rows_b;
        if (slice < n_slices) {
          const int chunk = ((hidden + n_slices - 1) / n_slices + kVec - 1)
                            / kVec * kVec;
          const int k_lo = slice * chunk;
          const int k_hi = min(hidden, k_lo + chunk);
          float acc_a = 0.0f, acc_b = 0.0f;
          const T* h_a = h_s + b_a * hidden;
          if (b_b < bt) {
            const T* h_b = h_s + b_b * hidden;
            for (int k = k_lo; k < k_hi; k += kVec) {
              const float4 w = load4(w_col + k);
              acc_a = dot4(load4(h_a + k), w, acc_a);
              acc_b = dot4(load4(h_b + k), w, acc_b);
            }
            part[(slice * bt + b_b) * kCols + lane] = acc_b;
          } else {
            for (int k = k_lo; k < k_hi; k += kVec)
              acc_a = dot4(load4(h_a + k), load4(w_col + k), acc_a);
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
        const size_t c_idx = (static_cast<size_t>(d) * batch + b0 + b) * hidden + j;
        const float c_prev = t > 0 ? c_state[c_idx] : 0.0f;
        const float c = sigmoid(g[1]) * c_prev + sigmoid(g[0]) * tanhf(g[2]);
        const float h = sigmoid(g[3]) * tanhf(c);
        c_state[c_idx] = c;
        const size_t o_idx = (step_row + b0 + b) * hidden + j;
        hs[o_idx] = from_f<T>(h);
        cs[o_idx] = from_f<T>(c);
      }
      __syncthreads();  // h_s / part are reused by the next tile
    }
    if (t + 1 < n_steps) {
      target += blocks_per_dir;
      direction_barrier(barrier + d, target);
    }
  }
}

template <typename T>
size_t smem_bytes(int hidden) {
  return static_cast<size_t>(hidden + kPad) * kCols * sizeof(T)
       + static_cast<size_t>(kBatchTile) * hidden * sizeof(T)
       + static_cast<size_t>(kRows * kRowsPerThread) * kCols * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* xp_v, const void* whh_v, void* hs_v,
                   void* cs_v, float* c_state, unsigned* barrier,
                   int n_steps, int batch, int hidden, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(xp_v);
  const T* whh = static_cast<const T*>(whh_v);
  T* hs = static_cast<T*>(hs_v);
  T* cs = static_cast<T*>(cs_v);
  const size_t smem = smem_bytes<T>(hidden);
  void (*kernel)(const T*, const T*, T*, T*, float*, unsigned*, int, int,
                 int) = lstm_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&xp, &whh, &hs, &cs, &c_state, &barrier,
                  &n_steps, &batch, &hidden};
  // cooperative: the launch fails (cudaErrorCooperativeLaunchTooLarge)
  // instead of deadlocking at the barrier when the blocks cannot all be
  // resident at once
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(2 * hidden / kUnits),
      dim3(kThreads), args, smem, stream);
}

}  // namespace

extern "C" {

// hidden units each block owns; the wrapper checks H % this == 0
int mdd_lstm_fwd_units_per_block() { return kUnits; }

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int mdd_lstm_fwd(const void* x_proj, const void* w_hh, void* hs, void* cs,
                 float* c_state, unsigned* barrier, int n_steps, int batch,
                 int hidden, int dtype, void* stream) {
  if (n_steps < 1 || batch < 1 || hidden < kUnits || hidden % kUnits != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x_proj, w_hh, hs, cs, c_state, barrier, n_steps,
                        batch, hidden, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x_proj, w_hh, hs, cs, c_state, barrier,
                                n_steps, batch, hidden, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
