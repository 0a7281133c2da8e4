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
// What bounds it on an H100.  Only one of the three products of a step is
// on the serial chain: dh_{t-1} needs the dgates of every gate column of
// step t, and the dgates of step t-1 need dh_{t-1}.  The wall time of the
// chain is T times the latency of one step: a (B x 4H) @ (4H x H) product
// far too small to fill the card, and an exchange between the blocks that
// share it.  The gate recompute and dW_hh read only saved streams; they are
// two large products (12 GFLOP each at B = 64, T = 80) that the float32 FMA
// pipe would bound at ~0.18 ms each.  With every dot on the FMA pipe, fed
// 16 bytes of shared memory per 8 FMAs, and all three inside the chain, the
// first version of this file spent 76% of a 54 us step in its two dots
// (clock64 stamps, H100, B = 64).
//
// What the design does about it.  Four launches:
//
// 1. lstm_product_kernel<T, false>: the gate pre-activations of every step
//    at once, z[t] = x_proj[t] + hs[t-1] @ w_hh[d] (float32 scratch), a
//    (T B x H) @ (H x 4H) product a direction on the whole card.
// 2. lstm_bwd_chain_kernel: one persistent cooperative launch over the T
//    steps that keeps only what depends on the chain.  Batch rows never
//    interact, so the blocks are split over (direction, 16-row batch tile,
//    group of 8 G hidden units), and only the blocks of one (direction,
//    batch tile) exchange anything and share a barrier.  A block owns the
//    4 x 8 G gate columns of its units and keeps THOSE COLUMNS of w_hh
//    (for every hidden unit: H x 32 G) in shared memory for the whole
//    sequence.  A step: the dgates of its units from dh, dc and
//    six coefficients a unit (7 multiply-adds, no transcendental), stored
//    to dx_proj and to shared memory; then its share of dh_{t-1} for EVERY
//    unit of the direction, (16 x 32 G) @ (32 G x H) on the tensor cores
//    straight from the dgates it has just made (nothing is gathered before
//    the product), written as one [16][H] float32 partial sum to an
//    exchange buffer in L2; arrive at the group's barrier; while the others
//    arrive, turn the inputs of step t-1 (z, cs, dhs, loaded a phase ahead)
//    into that step's coefficients (all the sigmoids and tanhs); wait; then
//    read only the partial sums for its own units (H / (8 G) producers x
//    16 x 8 G floats, 24 KB at H = 384) and add them in producer order, so
//    the result does not change from run to run.  Against gathering the
//    tile's dgates (98 KB a block and step, which the L2's bandwidth
//    bounds when 128 blocks do it at once) a step moves 48 KB a block.  dh
//    and dc stay in the registers of the thread that owns the (row, unit).
//    A block owns one 16-row batch tile; G is chosen per call so that the
//    blocks of a launch are all resident (make_plan()), and a batch too
//    large for that runs as several launches over chunks of its rows, one
//    after another in stream order, each on barrier counters of its own
//    and all on one exchange buffer sized for a chunk.  Batch rows never
//    interact in the chain, so the chunks change no sum: the result has
//    the same bits however the batch is cut.
// 3. lstm_product_kernel<T, true>: dW_hh = sum over t >= 1 and b of
//    h_{t-1}^T dgates_t, an (H x (T-1) B) @ ((T-1) B x 4H) product, split
//    over slices of the reduction so that it fills the card; the slices'
//    partial sums go to scratch and
// 4. lstm_dw_reduce_kernel adds them in a fixed order.
//
// Every product runs on the tensor cores through mma.sync m16n8k8 with
// float32 accumulators: bfloat16 operands are exact in TF32, so one pass
// gives exact products; float32 operands are split into a TF32 high part
// and the TF32 of the remainder and take three passes (lo*hi + hi*lo +
// hi*hi), which keeps float32 accuracy to ~2^-20.  The three passes run
// over all the tiles of a fragment before the next pass, so consecutive
// mma.sync never wait for one accumulator.  The product kernel is a
// 128 x 128 x 32 tile per block, 8 warps of 64 x 32, two blocks an SM,
// operands brought in by cp.async through a 3-stage ring, padded so that
// fragment reads are free of bank conflicts.  What bounds the tensor-core
// path in float32 is the split, not the tensor cores (mma.sync alone
// reaches 322 TFLOP/s in TF32 on this card; three passes plus the splits
// reach 44-48 TFLOP/s effective).  wgmma would need the split operands
// written back to shared memory; not used.  Built with
// -DMDD_LSTM_BWD_STAMPS, thread 0 of block 0 of the chain kernel sums
// clock64() differences per phase of a step (python -m
// mdd_tpu_torch.ops.lstm_stamps --kernel bwd prints them).

#include <type_traits>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

using namespace mdd;

// ------------------------------------------------------------------------
// The chain
// ------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;        // a unit group: one n-tile of the product
constexpr int kRowsTile = 16;    // batch rows of a tile: one m-tile
constexpr int kMaxGroups = 3;    // unit groups one block may own (G)
constexpr int kNBatch = 6;       // n-tiles a warp accumulates at a time
constexpr int kCounterStride = 32;   // one 128-byte line per group counter
constexpr int kChainPad = 16;    // row padding of w_s and a_s, elements

#ifdef MDD_LSTM_BWD_STAMPS
__device__ long long g_stamps[8];
#define STAMP(p)                                       \
  do {                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) {         \
      const long long now = clock64();                 \
      g_stamps[p] += now - last;                       \
      last = now;                                      \
    }                                                  \
  } while (0)
#else
#define STAMP(p)
#endif

// what of step s does not depend on the chain, for one (row, unit): as it
// is loaded (pre-activations i, f, g, o; c_s, c_{s-1}; the cotangent) ...
struct StepInputs {
  float z[4], c, c_prev, dhs;
};

template <typename T>
__device__ __forceinline__ StepInputs load_step(const float* __restrict__ z,
                                                const T* __restrict__ cs,
                                                const float* __restrict__ dhs,
                                                size_t row, size_t plane_rows,
                                                int hidden, int j,
                                                bool first) {
  StepInputs in;
  const float* z_row = z + row * 4 * hidden + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) in.z[q] = z_row[q * hidden];
  const size_t idx = row * hidden + j;
  in.c = to_f(cs[idx]);
  in.c_prev = first ? 0.0f : to_f(cs[idx - plane_rows * hidden]);
  in.dhs = dhs[idx];
  return in;
}

// ... and as the chain uses it: the cotangent and the six factors that turn
// (dh, dc) into dgates and dc'
struct Coefs {
  float dhs, p, ai, af, ag, ao, f;
};

__device__ __forceinline__ Coefs step_coefs(const StepInputs& in) {
  const float i = sigmoid(in.z[0]);
  const float f = sigmoid(in.z[1]);
  const float g = tanhf(in.z[2]);
  const float o = sigmoid(in.z[3]);
  const float tanh_c = tanhf(in.c);
  Coefs k;
  k.dhs = in.dhs;
  k.p = o * (1.0f - tanh_c * tanh_c);
  k.ai = g * i * (1.0f - i);
  k.af = in.c_prev * f * (1.0f - f);
  k.ag = i * (1.0f - g * g);
  k.ao = tanh_c * o * (1.0f - o);
  k.f = f;
  return k;
}

// float32 elements of the exchange scratch: per parity of t, direction and
// batch tile of a launch's chunk of `rows`, one [16][H] partial dh from
// each of the H / (8 G) producers
inline size_t exchange_elems(int rows, int hidden, int g) {
  const size_t chunk_tiles = (rows + kRowsTile - 1) / kRowsTile;
  return 2 * 2 * chunk_tiles * (hidden / (kUnits * g)) * kRowsTile * hidden;
}

// rows [row_lo, row_hi) of the batch are this launch's
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_chain_kernel(const float* __restrict__ z, const T* __restrict__ whh,
                      const T* __restrict__ cs, const float* __restrict__ dhs,
                      T* dxp, float* exchange, unsigned* barrier, int n_steps,
                      int batch, int hidden, int row_lo, int row_hi) {
  constexpr int kBlockUnits = kUnits * G;
  constexpr int kCols = 4 * kBlockUnits;          // this block's gate columns
  constexpr int kTileItems = kRowsTile * kBlockUnits;
  constexpr int kRounds = (kTileItems + kThreads - 1) / kThreads;
  // rows of w_s and a_s: 16 elements of padding put the 4-wide reads of 8
  // rows x 4 lanes on distinct banks, in float32 and in bfloat16
  constexpr int kStride = kCols + kChainPad;
  constexpr int kGranule = 16 / static_cast<int>(sizeof(T));   // elements
  constexpr int kUnitGranules = kBlockUnits / kGranule;  // per gate, w row
  static_assert(kBlockUnits % kGranule == 0, "16-byte copies of w_hh");

  extern __shared__ __align__(16) unsigned char smem[];
  const int four_h = 4 * hidden;
  T* w_s = reinterpret_cast<T*>(smem);   // [H][kStride]: w_hh[d, j', col]
  T* a_s = w_s + static_cast<size_t>(hidden) * kStride;
  // a_s: [16][kStride], this block's dgates of the step
  float* p_s = reinterpret_cast<float*>(a_s + kRowsTile * kStride);
  // p_s: [producer][16][8 G], the group's partial dh for this block's units

  const int unit_groups = hidden / kBlockUnits;   // producers of a group
  // tiles of this launch's chunk; tile indices below count from row_lo
  const int chunk_tiles = (row_hi - row_lo + kRowsTile - 1) / kRowsTile;
  const int group = blockIdx.x / unit_groups;          // (d, batch tile)
  const int ug = blockIdx.x % unit_groups;
  const int d = group / chunk_tiles;
  const int tile = group % chunk_tiles;
  const int b_base = row_lo + tile * kRowsTile;
  const int j0 = ug * kBlockUnits;

  // column q * 8 G + u of w_s is gate column q * H + j0 + u of w_hh[d]
  {
    const T* src = whh + static_cast<size_t>(d) * hidden * four_h + j0;
    for (int idx = threadIdx.x; idx < hidden * 4 * kUnitGranules;
         idx += kThreads) {
      const int row = idx / (4 * kUnitGranules);
      const int q = idx / kUnitGranules % 4;
      const int c = (idx % kUnitGranules) * kGranule;
      *reinterpret_cast<uint4*>(w_s + row * kStride + q * kBlockUnits + c) =
          *reinterpret_cast<const uint4*>(
              src + static_cast<size_t>(row) * four_h + q * hidden + c);
    }
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int n_tiles = hidden / kUnits;      // n-tiles of the partial dh
  const size_t plane_rows = 2 * static_cast<size_t>(batch);   // rows a step
  // one (parity, d, tile, producer) slab of the exchange is [16][H]
  const size_t slab = static_cast<size_t>(kRowsTile) * hidden;
  auto slab_of = [&](int parity, int producer) {
    return exchange
           + (((static_cast<size_t>(parity) * 2 + d) * chunk_tiles + tile)
                  * unit_groups + producer) * slab;
  };

  // item r of this thread: row b_base + item_row[r], unit j0 + item_u[r]
  int item_row[kRounds], item_u[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int item = threadIdx.x + r * kThreads;
    item_row[r] = item < kTileItems ? item / kBlockUnits : -1;
    item_u[r] = item % kBlockUnits;
  }
  auto item_live = [&](int r) {   // may be a padding row of the tile
    return item_row[r] >= 0;
  };
  auto item_valid = [&](int r) {
    return item_live(r) && b_base + item_row[r] < row_hi;
  };

  StepInputs inputs[kRounds];
  Coefs coef[kRounds];
  float dh[kRounds], dc[kRounds];
  auto load_inputs = [&](int s) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_valid(r)) {
        const size_t row =
            (static_cast<size_t>(s) * 2 + d) * batch + b_base + item_row[r];
        inputs[r] = load_step(z, cs, dhs, row, plane_rows, hidden,
                              j0 + item_u[r], s == 0);
      }
  };
  auto make_coefs = [&]() {
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_valid(r)) coef[r] = step_coefs(inputs[r]);
  };
#pragma unroll
  for (int r = 0; r < kRounds; ++r) dh[r] = dc[r] = 0.0f;
  load_inputs(n_steps - 1);
  make_coefs();
  __syncthreads();   // w_s is complete

  GroupBarrier bar(barrier + group * kCounterStride, unit_groups);
#ifdef MDD_LSTM_BWD_STAMPS
  long long last = clock64();
#endif
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t step_row = (static_cast<size_t>(t) * 2 + d) * batch + b_base;
    // ---- dgates of step t for this block's (row, unit) items: to dx_proj
    // and, as the A operand of the product, to a_s (zeros in padding rows)
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_live(r)) {
        T dg[4] = {from_f<T>(0.0f), from_f<T>(0.0f), from_f<T>(0.0f),
                   from_f<T>(0.0f)};
        if (item_valid(r)) {
          const Coefs& c = coef[r];
          const float dh_total = c.dhs + dh[r];
          const float dc_t = fmaf(dh_total, c.p, dc[r]);
          dg[0] = from_f<T>(dc_t * c.ai);
          dg[1] = from_f<T>(dc_t * c.af);
          dg[2] = from_f<T>(dc_t * c.ag);
          dg[3] = from_f<T>(dh_total * c.ao);
          dc[r] = dc_t * c.f;
          T* dx_row =
              dxp + (step_row + item_row[r]) * four_h + j0 + item_u[r];
#pragma unroll
          for (int q = 0; q < 4; ++q) dx_row[q * hidden] = dg[q];
        }
        T* a_row = a_s + item_row[r] * kStride + item_u[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) a_row[q * kBlockUnits] = dg[q];
      }
    if (t == 0) break;
    __syncthreads();
    // the inputs of step t - 1, loaded a phase ahead of their use
    load_inputs(t - 1);
    STAMP(0);
    // ---- this block's share of dh_{t-1}, for every unit of the direction:
    // its dgates columns times their columns of w_hh, (16 x 32 G) @
    // (32 G x H) on the tensor cores; warps take the n-tiles in turn
    {
      float* out = slab_of(t & 1, ug);
      for (int n0 = warp; n0 < n_tiles; n0 += kWarps * kNBatch) {
        float acc[kNBatch][4];
#pragma unroll
        for (int i = 0; i < kNBatch; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
        // n-tiles past the last repeat it: computed, never stored
        const T* b_rows[kNBatch];
#pragma unroll
        for (int i = 0; i < kNBatch; ++i)
          b_rows[i] = w_s + (min(n0 + i * kWarps, n_tiles - 1) * kUnits + gid)
                                * kStride + 4 * tig;
        // Two k-steps at a time over 16 columns, of which this lane reads
        // 4 consecutive ones with one load per row: the sum over k does not
        // care which column sits in which slot of a fragment, as long as
        // both operands agree.
#pragma unroll 2
        for (int k0 = 0; k0 < kCols; k0 += 16) {
          const float4 a_r0 = load4(a_s + gid * kStride + k0 + 4 * tig);
          const float4 a_r8 = load4(a_s + (gid + 8) * kStride + k0 + 4 * tig);
          float4 b_v[kNBatch];
#pragma unroll
          for (int i = 0; i < kNBatch; ++i) b_v[i] = load4(b_rows[i] + k0);
          Frag<T, 4> a;
          Frag<T, 2> b[kNBatch];
          a.set(0, a_r0.x);
          a.set(1, a_r8.x);
          a.set(2, a_r0.y);
          a.set(3, a_r8.y);
#pragma unroll
          for (int i = 0; i < kNBatch; ++i) {
            b[i].set(0, b_v[i].x);
            b[i].set(1, b_v[i].y);
          }
          mma_frags(acc, a, b);
          a.set(0, a_r0.z);
          a.set(1, a_r8.z);
          a.set(2, a_r0.w);
          a.set(3, a_r8.w);
#pragma unroll
          for (int i = 0; i < kNBatch; ++i) {
            b[i].set(0, b_v[i].z);
            b[i].set(1, b_v[i].w);
          }
          mma_frags(acc, a, b);
        }
#pragma unroll
        for (int i = 0; i < kNBatch; ++i) {
          const int n = n0 + i * kWarps;
          if (n < n_tiles) {
            float* o = out + gid * hidden + n * kUnits + 2 * tig;
            *reinterpret_cast<float2*>(o) = make_float2(acc[i][0], acc[i][1]);
            *reinterpret_cast<float2*>(o + 8 * hidden) =
                make_float2(acc[i][2], acc[i][3]);
          }
        }
      }
    }
    STAMP(1);
    bar.arrive();
    make_coefs();          // needs nothing of the other blocks
    STAMP(2);
    bar.wait();
    STAMP(3);
    // ---- dh_{t-1} of this block's units: the producers' partial sums for
    // them, brought into shared memory and added in producer order
    {
      constexpr int kRowVecs = kBlockUnits / 4;          // float4 a row
      const int n_vecs = unit_groups * kRowsTile * kRowVecs;
      for (int e = threadIdx.x; e < n_vecs; e += kThreads) {
        const int producer = e / (kRowsTile * kRowVecs);
        const int row = e / kRowVecs % kRowsTile;
        const int v = e % kRowVecs;
        cp_async16(p_s + e * 4,
                   slab_of(t & 1, producer) + row * hidden + j0 + v * 4,
                   true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int item = threadIdx.x + r * kThreads;
        if (item < kTileItems) {
          float sum = 0.0f;
          for (int p = 0; p < unit_groups; ++p)
            sum += p_s[p * kTileItems + item];
          dh[r] = sum;
        }
      }
    }
    STAMP(4);
    // (the barriers of the next step separate these reads of p_s and the
    // product's reads of a_s from their next writes)
  }
}

template <typename T>
size_t chain_smem_bytes(int hidden, int g) {
  const size_t stride = 4 * kUnits * g + kChainPad;
  return (hidden + static_cast<size_t>(kRowsTile)) * stride * sizeof(T)
         + static_cast<size_t>(kRowsTile) * hidden * sizeof(float);
}

// ------------------------------------------------------------------------
// The two products off the chain
// ------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kPadBytes = 16;   // unit of the row padding of its tiles

template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return kPadBytes / static_cast<int>(sizeof(T));
}

constexpr int kPStages = 3;
constexpr int kPThreads = 256;
constexpr int kWarpM = 64, kWarpN = 32;          // 2 x 4 warps
constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
static_assert((kBM / kWarpM) * (kBN / kWarpN) * 32 == kPThreads, "8 warps");

// C (M x N) = A (M x K) @ B (K x N), both directions (blockIdx.z).
//
// kDw = false, the gate pre-activations: M = T B rows (t, b), K = H,
//   N = 4H; A[m][k] = hs[t-1, d, b, k] (zero at t = 0), B = w_hh[d],
//   C = z[t, d, b, :] = x_proj[t, d, b, :] + A @ B.  `a` = hs, `b` = w_hh,
//   `add` = x_proj, `out` = z.
// kDw = true, dW_hh: M = H, N = 4H, K = (T-1) B rows (t >= 1, b);
//   A[i][k] = hs[t-1, d, b, i], B[k][n] = dgates[t, d, b, n]; slice
//   blockIdx.z / 2 of `k_slices` equal runs of K-tiles writes its partial
//   sum to out[slice, d].  `a` = hs, `b` = dx_proj, `out` = the partials.
template <typename T, bool kDw>
__global__ void __launch_bounds__(kPThreads, 2)   // 2 blocks an SM: 128 regs
lstm_product_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ add, float* __restrict__ out,
                    int n_steps, int batch, int hidden, int k_slices) {
  constexpr int kPad = pad_elems<T>();
  constexpr int kGranule = 16 / static_cast<int>(sizeof(T));
  // A is staged as it lies in memory: [m][k] for z, [k][m] for dW
  constexpr int kARows = kDw ? kBK : kBM;
  constexpr int kACols = kDw ? kBM : kBK;
  constexpr int kAStride = kACols + (kDw ? 2 * kPad : kPad);
  constexpr int kBStride = kBN + 2 * kPad;
  constexpr int kAElems = kARows * kAStride;
  constexpr int kStageElems = kAElems + kBK * kBStride;
  constexpr int kARowGranules = kACols / kGranule;
  constexpr int kBRowGranules = kBN / kGranule;
  constexpr int kACopies = kARows * kARowGranules / kPThreads;
  constexpr int kBCopies = kBK * kBRowGranules / kPThreads;
  static_assert(kARows * kARowGranules % kPThreads == 0, "whole copies");
  static_assert(kBK * kBRowGranules % kPThreads == 0, "whole copies");

  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);

  const int four_h = 4 * hidden;
  const int d = blockIdx.z % 2;
  const int slice = blockIdx.z / 2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int m_total = kDw ? hidden : n_steps * batch;
  const int k_total = kDw ? (n_steps - 1) * batch : hidden;
  const int k_tiles = (k_total + kBK - 1) / kBK;
  const int slice_tiles = (k_tiles + k_slices - 1) / k_slices;
  const int kt_lo = kDw ? slice * slice_tiles : 0;
  const int kt_hi = kDw ? min(k_tiles, kt_lo + slice_tiles) : k_tiles;

  // row (t, b) of a (T, 2, B, .) stream for direction d
  auto stream_row = [&](int t, int bb) {
    return (static_cast<size_t>(t) * 2 + d) * batch + bb;
  };

  auto load_tile = [&](int stage, int kt) {
    T* a_s = stages + static_cast<size_t>(stage) * kStageElems;
    T* b_s = a_s + kAElems;
    const int k0 = kt * kBK;
    if constexpr (kDw) {
      // rows of both tiles are reduction rows (t >= 1, b)
#pragma unroll
      for (int c = 0; c < kACopies; ++c) {
        const int idx = threadIdx.x + c * kPThreads;
        const int row = idx / kARowGranules;
        const int col = (idx % kARowGranules) * kGranule;
        const int k = k0 + row;
        const bool valid = k < k_total && m0 + col < hidden;
        const size_t src = valid ? stream_row(k / batch, k % batch) * hidden
                                       + m0 + col
                                 : 0;
        cp_async16(a_s + row * kAStride + col, a + src, valid);
      }
#pragma unroll
      for (int c = 0; c < kBCopies; ++c) {
        const int idx = threadIdx.x + c * kPThreads;
        const int row = idx / kBRowGranules;
        const int col = (idx % kBRowGranules) * kGranule;
        const int k = k0 + row;
        const bool valid = k < k_total && n0 + col < four_h;
        const size_t src = valid ? stream_row(k / batch + 1, k % batch) * four_h
                                       + n0 + col
                                 : 0;
        cp_async16(b_s + row * kBStride + col, b + src, valid);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kACopies; ++c) {
        const int idx = threadIdx.x + c * kPThreads;
        const int row = idx / kARowGranules;
        const int col = (idx % kARowGranules) * kGranule;
        const int m = m0 + row;
        const int t = m / batch;
        const bool valid = m < m_total && t > 0 && k0 + col < hidden;
        const size_t src = valid ? stream_row(t - 1, m % batch) * hidden
                                       + k0 + col
                                 : 0;
        cp_async16(a_s + row * kAStride + col, a + src, valid);
      }
#pragma unroll
      for (int c = 0; c < kBCopies; ++c) {
        const int idx = threadIdx.x + c * kPThreads;
        const int row = idx / kBRowGranules;
        const int col = (idx % kBRowGranules) * kGranule;
        const bool valid = k0 + row < hidden && n0 + col < four_h;
        const size_t src = valid ? (static_cast<size_t>(d) * hidden + k0 + row)
                                           * four_h + n0 + col
                                 : 0;
        cp_async16(b_s + row * kBStride + col, b + src, valid);
      }
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wm = (warp / (kBN / kWarpN)) * kWarpM;
  const int wn = (warp % (kBN / kWarpN)) * kWarpN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (kt_lo + s < kt_hi) load_tile(s, kt_lo + s);
    cp_async_commit();
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo;
    cp_async_wait<kPStages - 2>();
    __syncthreads();   // tile `it` has landed; tile it-1 is read by all
    if (kt + kPStages - 1 < kt_hi)
      load_tile((it + kPStages - 1) % kPStages, kt + kPStages - 1);
    cp_async_commit();
    const T* a_s = stages + static_cast<size_t>(it % kPStages) * kStageElems;
    const T* b_s = a_s + kAElems;
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 8) {
      Frag<T, 2> bf[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = wn + j * 8 + gid;
        bf[j].set(0, to_f(b_s[(k0 + tig) * kBStride + n]));
        bf[j].set(1, to_f(b_s[(k0 + tig + 4) * kBStride + n]));
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int m = wm + i * 16 + gid;
        Frag<T, 4> af;
        if constexpr (kDw) {
          af.set(0, to_f(a_s[(k0 + tig) * kAStride + m]));
          af.set(1, to_f(a_s[(k0 + tig) * kAStride + m + 8]));
          af.set(2, to_f(a_s[(k0 + tig + 4) * kAStride + m]));
          af.set(3, to_f(a_s[(k0 + tig + 4) * kAStride + m + 8]));
        } else {
          af.set(0, to_f(a_s[m * kAStride + k0 + tig]));
          af.set(1, to_f(a_s[(m + 8) * kAStride + k0 + tig]));
          af.set(2, to_f(a_s[m * kAStride + k0 + tig + 4]));
          af.set(3, to_f(a_s[(m + 8) * kAStride + k0 + tig + 4]));
        }
        mma_frags(acc[i], af, bf);
      }
    }
  }
  cp_async_wait<0>();

  // a lane holds rows m, m + 8 and columns n, n + 1 of each 16 x 8 tile
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + gid + half * 8;
      if (m >= m_total) continue;
      size_t out_row;
      if constexpr (kDw)
        out_row = (static_cast<size_t>(slice) * 2 + d) * hidden + m;
      else
        out_row = stream_row(m / batch, m % batch);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + wn + j * 8 + 2 * tig;
        if (n >= four_h) continue;
        float2 v = make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        if constexpr (!kDw) {
          const T* x = add + out_row * four_h + n;
          v.x += to_f(x[0]);
          v.y += to_f(x[1]);
        }
        *reinterpret_cast<float2*>(out + out_row * four_h + n) = v;
      }
    }
}

template <typename T, bool kDw>
constexpr size_t product_smem_bytes() {
  constexpr int pad = pad_elems<T>();
  constexpr int a = kDw ? kBK * (kBM + 2 * pad) : kBM * (kBK + pad);
  return static_cast<size_t>(kPStages) * (a + kBK * (kBN + 2 * pad))
         * sizeof(T);
}

// dW_hh = the slices' partial sums, added in slice order
__global__ void __launch_bounds__(256)
lstm_dw_reduce_kernel(const float4* __restrict__ partial,
                      float4* __restrict__ dw, int n_vec, int k_slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  float4 sum = partial[i];
  for (int s = 1; s < k_slices; ++s) {
    const float4 v = partial[static_cast<size_t>(s) * n_vec + i];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  dw[i] = sum;
}

// ------------------------------------------------------------------------
// Host side
// ------------------------------------------------------------------------

// how one call is laid out on the card
struct Plan {
  int groups;      // G: unit groups of 8 a chain block owns
  int blocks;      // chain blocks of a launch, all resident at once
  int smem;        // dynamic shared memory of a chain block, bytes
  int k_slices;    // slices of dW_hh's reduction
  int chunk_rows;  // batch rows of one chain launch
  int launches;    // chain launches of the call, one after another
};

template <int N>
using Int = std::integral_constant<int, N>;

// fn(G as an integral constant) for the chain kernel that runs g unit
// groups a block
template <typename Fn>
cudaError_t for_chain(int g, Fn fn) {
  static_assert(kMaxGroups == 3, "one case per G");
  if (g == 1) return fn(Int<1>());
  if (g == 2) return fn(Int<2>());
  return fn(Int<3>());
}

// What the card holds of each chain instance at this H: its shared memory
// a block and the blocks resident at once (0 where a block does not fit).
// Asked of the runtime once a (device, H) and thread, so that a plan is
// arithmetic after the first call; this also raises each instance's
// dynamic shared memory limit to the card's, which every launch then uses.
struct Capacity {
  int device, hidden, sms;
  int smem[kMaxGroups], blocks[kMaxGroups];
};

template <typename T>
cudaError_t capacity(int device, int hidden, Capacity* out) {
  thread_local std::vector<Capacity> memo;
  for (const Capacity& c : memo)
    if (c.device == device && c.hidden == hidden) {
      *out = c;
      return cudaSuccess;
    }
  Capacity cap = {device, hidden, 0, {}, {}};
  int optin = 0;
  cudaDeviceGetAttribute(&cap.sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  for (int g = 1; g <= kMaxGroups; ++g) {
    const cudaError_t err = for_chain(g, [&](auto G) {
      auto kernel = lstm_bwd_chain_kernel<T, decltype(G)::value>;
      const size_t smem = chain_smem_bytes<T>(hidden, g);
      cap.smem[g - 1] = static_cast<int>(smem);
      cap.blocks[g - 1] = 0;
      if (smem > static_cast<size_t>(optin)) return cudaSuccess;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (e != cudaSuccess) return e;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
      cap.blocks[g - 1] = per_sm * cap.sms;
      return e;
    });
    if (err != cudaSuccess) return err;
  }
  memo.push_back(cap);
  *out = cap;
  return cudaSuccess;
}

// Among the G whose blocks of one batch tile are all resident: the fewest
// chain launches (each is a whole serial chain of T' - 1 steps), then the
// least work an SM and step: a block's product grows with G, and two
// blocks on one SM take turns.  Only the last launch may be ragged.
// cudaErrorInvalidConfiguration when there is none (H too large for a
// block's shared memory).
template <typename T>
cudaError_t make_plan(int n_steps, int batch, int hidden, Plan* plan) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  Capacity cap;
  err = capacity<T>(device, hidden, &cap);
  if (err != cudaSuccess) return err;
  const int batch_tiles = (batch + kRowsTile - 1) / kRowsTile;
  Plan best = {};
  int best_cost = 0;
  for (int g = 1; g <= kMaxGroups; ++g) {
    if (hidden % (kUnits * g) != 0) continue;
    const int unit_groups = hidden / (kUnits * g);
    const int chunk_tiles =
        min(batch_tiles, cap.blocks[g - 1] / (2 * unit_groups));
    if (chunk_tiles == 0) continue;
    const int launches = (batch_tiles + chunk_tiles - 1) / chunk_tiles;
    const int blocks = 2 * chunk_tiles * unit_groups;
    const int cost = (2 + g) * ((blocks + cap.sms - 1) / cap.sms);
    if (best.groups == 0 || launches < best.launches
        || (launches == best.launches && cost < best_cost)) {
      best = {g, blocks, cap.smem[g - 1], 1,
              min(batch, chunk_tiles * kRowsTile), launches};
      best_cost = cost;
    }
  }
  if (best.groups == 0) return cudaErrorInvalidConfiguration;
  // enough slices of dW's reduction for ~4 blocks an SM, 2 K-tiles or more
  // each
  const int out_tiles = 2 * ((hidden + kBM - 1) / kBM)
                        * ((4 * hidden + kBN - 1) / kBN);
  const int k_tiles = ((n_steps - 1) * batch + kBK - 1) / kBK;
  best.k_slices = max(1, min(min(16, k_tiles / 2),
                             (4 * cap.sms + out_tiles - 1) / out_tiles));
  *plan = best;
  return cudaSuccess;
}

constexpr int kPartZ = 1, kPartChain = 2, kPartDw = 4;

template <typename T, int G>
cudaError_t launch_chain(const Plan& plan, const float* z, const T* whh,
                         const T* cs, const float* dhs, T* dxp,
                         float* exchange, unsigned* barrier, int n_steps,
                         int batch, int hidden, cudaStream_t stream) {
  const int unit_groups = hidden / (kUnits * G);
  const int chunk_tiles = plan.chunk_rows / kRowsTile;
  for (int i = 0; i < plan.launches; ++i) {
    int row_lo = i * plan.chunk_rows;
    int row_hi = min(batch, row_lo + plan.chunk_rows);
    const int tiles_i = (row_hi - row_lo + kRowsTile - 1) / kRowsTile;
    const int blocks = 2 * tiles_i * unit_groups;
    // each launch's groups count on counters of their own; the exchange is
    // reused, since the launches run one after another on the stream
    unsigned* counters = barrier + static_cast<size_t>(i) * 2 * chunk_tiles
                                       * kCounterStride;
    void* args[] = {&z, &whh, &cs, &dhs, &dxp, &exchange, &counters,
                    &n_steps, &batch, &hidden, &row_lo, &row_hi};
    // cooperative: the launch fails (cudaErrorCooperativeLaunchTooLarge)
    // instead of deadlocking at a barrier when the blocks cannot all be
    // resident at once
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(lstm_bwd_chain_kernel<T, G>), dim3(blocks),
        dim3(kThreads), args, plan.smem, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* xp_v, const void* whh_v, const void* hs_v,
                   const void* cs_v, const float* dhs, void* dxp_v, float* dw,
                   float* z, float* dw_partial, float* exchange,
                   unsigned* barrier, int n_steps, int batch, int hidden,
                   int parts, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(xp_v);
  const T* whh = static_cast<const T*>(whh_v);
  const T* hs = static_cast<const T*>(hs_v);
  const T* cs = static_cast<const T*>(cs_v);
  T* dxp = static_cast<T*>(dxp_v);
  Plan plan;
  cudaError_t err = make_plan<T>(n_steps, batch, hidden, &plan);
  if (err != cudaSuccess) return err;
  const int four_h = 4 * hidden;
  const int n_tiles = (four_h + kBN - 1) / kBN;
  if (parts & kPartZ) {
    constexpr size_t smem = product_smem_bytes<T, false>();
    err = cudaFuncSetAttribute(lstm_product_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(n_tiles, (n_steps * batch + kBM - 1) / kBM, 2);
    lstm_product_kernel<T, false><<<grid, kPThreads, smem, stream>>>(
        hs, whh, xp, z, n_steps, batch, hidden, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kPartChain) {
    err = for_chain(plan.groups, [&](auto G) {
      return launch_chain<T, decltype(G)::value>(plan, z, whh, cs, dhs, dxp,
                                                 exchange, barrier, n_steps,
                                                 batch, hidden, stream);
    });
    if (err != cudaSuccess) return err;
  }
  if (parts & kPartDw) {
    constexpr size_t smem = product_smem_bytes<T, true>();
    err = cudaFuncSetAttribute(lstm_product_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(n_tiles, (hidden + kBM - 1) / kBM, 2 * plan.k_slices);
    lstm_product_kernel<T, true><<<grid, kPThreads, smem, stream>>>(
        hs, dxp, nullptr, dw_partial, n_steps, batch, hidden, plan.k_slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n_vec = 2 * hidden * four_h / 4;
    lstm_dw_reduce_kernel<<<(n_vec + 255) / 256, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(dw_partial),
        reinterpret_cast<float4*>(dw), n_vec, plan.k_slices);
    err = cudaGetLastError();
  }
  return err;
}

bool shapes_ok(int n_steps, int batch, int hidden) {
  return n_steps >= 1 && batch >= 1 && hidden >= kUnits
         && hidden % kUnits == 0;
}

}  // namespace

extern "C" {

// the unit group: the wrapper checks H % this == 0
int mdd_lstm_bwd_units_per_block() { return kUnits; }

// How a call of these shapes is laid out: out[0 .. 7) = unit groups a
// chain block owns, chain blocks of a launch, their shared memory in
// bytes, slices of dW_hh's reduction, float32 elements of the chain's
// exchange (the wrapper sizes the scratch by these two), batch rows of a
// chain launch and chain launches.
// cudaErrorInvalidConfiguration (9) when H is too large for a block.
int mdd_lstm_bwd_plan(int n_steps, int batch, int hidden, int dtype,
                      int* out) {
  if (!shapes_ok(n_steps, batch, hidden) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t err =
      dtype == 0 ? make_plan<float>(n_steps, batch, hidden, &plan)
                 : make_plan<__nv_bfloat16>(n_steps, batch, hidden, &plan);
  if (err != cudaSuccess) return err;
  out[0] = plan.groups;
  out[1] = plan.blocks;
  out[2] = plan.smem;
  out[3] = plan.k_slices;
  out[4] = static_cast<int>(exchange_elems(plan.chunk_rows, hidden,
                                           plan.groups));
  out[5] = plan.chunk_rows;
  out[6] = plan.launches;
  return cudaSuccess;
}

// dtype: 0 = float32, 1 = bfloat16.  Scratch, none of it initialised
// unless said: z (T, 2, B, 4H) float32; dw_partial (k_slices, 2, H, 4H)
// float32 and exchange, float32, sized by mdd_lstm_bwd_plan; barrier,
// ZEROED, 32 counters for each of the 2 * ceil(B / 16) groups there can be
// (the chain's launches take disjoint runs of them).  parts: 1 = the
// pre-activation product, 2 = the chain, 4 = dW_hh (product and reduce);
// 7 is the backward, the single parts exist to be timed (each needs what
// the earlier ones left in z and dx_proj).  Returns a cudaError_t
// (0 = success).
int mdd_lstm_bwd(const void* x_proj, const void* w_hh, const void* hs,
                 const void* cs, const float* dhs, void* dx_proj,
                 float* dw_hh, float* z, float* dw_partial, float* exchange,
                 unsigned* barrier, int n_steps, int batch, int hidden,
                 int dtype, int parts, void* stream) {
  if (!shapes_ok(n_steps, batch, hidden)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x_proj, w_hh, hs, cs, dhs, dx_proj, dw_hh, z,
                         dw_partial, exchange, barrier, n_steps, batch,
                         hidden, parts, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x_proj, w_hh, hs, cs, dhs, dx_proj, dw_hh,
                                 z, dw_partial, exchange, barrier, n_steps,
                                 batch, hidden, parts, s);
  return cudaErrorInvalidValue;
}

#ifdef MDD_LSTM_BWD_STAMPS
const char* mdd_lstm_bwd_stamp_names() {
  return "dgates,partial dh product,arrive + next coefficients,"
         "barrier wait,read + add partial dh";
}

// copies the cycle sums of block 0 into out[0 .. n) and zeroes them
int mdd_lstm_bwd_read_stamps(long long* out, int n) {
  long long host[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(host));
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n && i < 8; ++i) out[i] = host[i];
  const long long zero[8] = {};
  return cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
}
#endif

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
