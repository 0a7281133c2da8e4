// The bfloat16 text BiLSTM under the scan contract, forward and backward,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it computes mdd_tpu/ops/lstm.py's `bilstm`,
// the lax.scan that runs mdd_tpu's canonical-phone BiLSTM
// (models/ctc_model.py's TextEncoder) and that mdd_tpu compiles whole, and
// JAX's autodiff of it.  Layout as lstm_fwd.cu / lstm_bwd.cu: x_proj
// (T, 2, B, 4H), w_hh (2, H, 4H), hs (T, 2, B, H), all bfloat16; both
// directions walk time forwards (the caller has reversed direction 1).
//
//   forward: gates_t = x_proj_t + h_{t-1} @ w_hh[d] (float32 sums of exact
//     products); c_t = sig(f) c_{t-1} + sig(i) tanh(g) from the ROUNDED
//     c_{t-1}; h_t = sig(o) tanh(c_t) of the unrounded c_t; h and c carried
//     rounded to bfloat16.  cs keeps the unrounded float32 c_t.
//   backward: JAX's transpose of that scan (lstm_cuda.lstm_scan_bwd_reference
//     lists its five rounding points): dh and dc carried as bfloat16 values,
//     float32 dgates in both products, dh_{t-1} = rnd(dgates @ w_hh^T),
//     dW_hh = the bfloat16 sum from t = T-1 down of rnd(h_{t-1}^T dgates_t).
//
// What bounds it on an H100.  The forward's T steps and the backward's T-1
// form serial chains: step t needs every hidden unit of step t-1.  At the
// text BiLSTM's cell (T = 48, B = 512, H = 384) a step is a (2 x 512 x 384)
// @ (384 x 1536) product, 1.2 GFLOP: enough for the whole card for ~2 us.
// The off-chain products (the backward's gate recompute and dW_hh) are
// plain matrix products of 58 GFLOP, of which dW_hh takes float32 dgates:
// an exact float32 x bfloat16 product needs three bfloat16 passes.
//
// What the design does about it (the kernels before it, the kScan
// instances of lstm_fwd.cu / lstm_bwd.cu, ran a block per 16-row batch
// tile, so a batch of 512 ran as 8 forward and 7 backward cooperative
// launches, each a whole serial chain; their float32-dgates products ran
// as three TF32 passes of mma.sync m16n8k8, half the bfloat16 rate; dW_hh
// walked every step in one block a 64 x 64 tile):
//
// 1. scan_fwd_kernel: one persistent cooperative launch over the T steps;
//    blocks over (direction, row group of R 16-row tiles, group of 8 G
//    hidden units), only the blocks of one (direction, row group) share a
//    barrier.  A block keeps the 4 x 8 G gate columns of w_hh of its units
//    (H x 32 G bfloat16, 80 KB at G = 3) in shared memory for the whole
//    sequence, so w_hh is read from device memory once a launch and from
//    shared memory once a step for all of the block's rows.  R is chosen
//    per call (make_plan) so that a batch runs in as few launches as the
//    card holds: 48 x 512 is R = 8, G = 3, 128 blocks, one launch.  A step:
//    wait at the barrier; each warp copies its rows of h_{t-1} (an m-tile,
//    its share of K) from L2 into shared memory by cp.async in three commit
//    groups and multiplies each group as it lands on the tensor cores,
//    mma.sync m16n8k16 with bfloat16 operands (exact products, float32
//    sums), the K columns of a 32-column chunk permuted alike in both
//    operands so that a lane reads 16 bytes of h and of w_hh a chunk.  With
//    R = 8 a warp owns a whole m-tile and every lane holds all four gates
//    of its 12 (row, unit) items in its accumulators, so the gate math runs
//    in registers; with R < 8, 8 / R warps share an m-tile by K and add
//    their partial sums through shared memory in warp order.  Then h_t to
//    hs, arrive, the next projections into shared memory by cp.async and
//    c_t out.
// 2. The backward, four kernels (parts):
//    a. scan_z_kernel: the gate pre-activations of every step, z[t] =
//       x_proj[t] + hs[t-1] @ w_hh[d] (float32), a (T B x H) @ (H x 4H)
//       product a direction: 128 x 128 x 32 tiles, mma.sync m16n8k16 on
//       ldmatrix fragments, a 3-stage cp.async ring.
//    b. scan_chain_kernel: the chain, one cooperative launch a chunk of
//       rows (R <= 4 tiles a block, G unit groups; 48 x 512 is R = 4, G =
//       3, two launches of 256 rows).  A step: the dgates of the block's
//       (row, unit) items from the carried dh, dc and the step's
//       coefficients, in the transpose's order (scan_step()), to dx_proj
//       and to the float32 dgates stream, and split EXACTLY into three
//       bfloat16 parts (split3()) in shared memory; its share of dh_{t-1}
//       for every unit, (16 R x 32 G) @ (32 G x H), three passes of
//       mma.sync m16n8k16 against the w_hh columns the block keeps in
//       shared memory (the bfloat16 rate, where the kScan instances ran
//       three TF32 passes of half the rate), written as float32 partial
//       sums to an exchange in L2; arrive; the next step's coefficients;
//       wait; the partial sums of its own units brought in by cp.async
//       and added in producer order (the same bits every run).
//    c. scan_dw_kernel: the T-1 step products rnd(h_{t-1}^T @ dgates_t) in
//       parallel over (step, direction, 128 x 128 tile), the float32
//       dgates split exactly into three bfloat16 parts as they are staged
//       (three passes, exact products, float32 sums), each rounded to
//       bfloat16 into a (T-1, 2, H, 4H) scratch; and
//    d. scan_dw_carry_kernel: one ordered elementwise pass, acc = rnd(acc +
//       P_t) from t = T-1 down: the transpose's order, bit for bit what the
//       serial carry gives.  Where a tile has little work over all its steps
//       ((T-1) x ceil(B / 32) <= kDwSerialTiles K-tiles), one block walks
//       the steps of its tile and carries in registers instead (no
//       scratch, no fourth launch): the whole backward's device time at
//       7 x 1 is 0.058 ms against 0.070 by the scratch, 7 x 64 0.082
//       against 0.094, 12 x 64 0.135 / 0.140, 17 x 64 0.180 / 0.191, 33 x
//       1 0.233 / 0.270 (CUDA-graph replays in turns).
//
// Measured (H100 80GB HBM3 at 700 W, T = 48, H = 384, D = 512; CUDA events
// against the kScan instances in one call; python -m
// mdd_tpu_torch.ops.lstm_stamps --kernel scan-fwd|scan-bwd for the
// stamps): B = 512 forward 0.54 ms (1.44), backward 2.96-3.04 (4.75):
// pre-activations 0.39 (0.53), recurrence 2.00-2.09 (2.74), dW_hh 0.59
// (1.42); B = 64 forward 0.20 (0.26), backward 0.51-0.55 (0.61).  What
// holds them back, from the stamps: the forward's step reads h_{t-1} 16
// times a row (once a unit group) from L2, ~12 MB a step at B = 512, and
// runs its gate math with two warps an SM sub-partition; the recurrence at
// B = 512 spends its step waiting on memory: without the exchange's stores
// (a timing variant) it takes 1.18 ms instead of 2.70, without its MMAs
// 1.93.  Tried and dropped: the exchange in distributed shared memory of
// a 16-block cluster a row group (the card holds 7 such clusters at once,
// so 48 x 512 took 3 waves: 2.40 ms against 2.25; 0.405 against 0.28 at
// 48 x 64); a warp's m-tiles' accumulators all live at once (2.70 ms,
// registers spilled, the stores drained all at the arrive); the next
// coefficients made before the arrive (2.25 against 2.13); the partial
// sums read by per-item L2 loads (20,000 cycles a step at B = 1, 48
// producers, against 2,300 by cp.async); c_{t-1} rounded only when the
// coefficients are made (B = 512 3% faster, B = 64 15% slower); the
// pre-activations' epilogue staged through shared memory (0.437 against
// 0.397 ms); dW_hh carried in registers by 64-row tiles at 48 x 64 (0.228
// against 0.175 ms by the scratch); a block's rows run as two halves with
// a barrier (named bar.sync) and an exchange each, so that they drift
// apart (forward 0.538-0.555 ms against 0.541-0.544, recurrence
// 2.06-2.09 against 2.06-2.07: no gain for the code).
//
// The exact split.  A float32 x = hi + mid + lo with hi = x cut to
// bfloat16's 8 significant bits, mid the remainder (exact in float32, at
// most 16 significant bits) cut likewise, lo what is left (at most 8
// significant bits): each part a bfloat16 value, exact above bfloat16's
// subnormal range (|x| >= 2^-110); a zero part takes x's sign.  A float32
// times a bfloat16 is then three exact products, so three passes give the
// float32 product up to the order of the float32 sums.
// (ops/lstm_cuda.bf16_split3 is the same function in PyTorch.)
//
// Built with -DMDD_LSTM_SCAN_STAMPS, thread 0 of block 0 of the forward
// and of the chain sums clock64() differences per phase of a step
// (python -m mdd_tpu_torch.ops.lstm_stamps --kernel scan-fwd|scan-bwd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <vector>

#include "lstm_common.cuh"

namespace {

using namespace mdd;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;          // a unit group: one n-tile a gate
constexpr int kRowsTile = 16;      // batch rows of an m-tile
constexpr int kMaxGroups = 3;      // unit groups a block may own (G)
constexpr int kChunk = 32;         // K columns a lane reads 16 bytes of
constexpr int kCounterStride = 32; // one 128-byte line per group counter
constexpr int kFwdTileSets = 4;    // forward: R in {1, 2, 4, 8}
constexpr int kChainTileSets = 3;  // chain: R in {1, 2, 4}
constexpr int kDwSerialTiles = 32; // dW in one block a tile up to this work
constexpr int kCopyGroups = 3;     // forward: commit groups of a step's h

#ifdef MDD_LSTM_SCAN_STAMPS
__device__ long long g_fwd_stamps[8];
__device__ long long g_bwd_stamps[8];
#define STAMP(arr, p)                                  \
  do {                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) {         \
      const long long now = clock64();                 \
      arr[p] += now - last;                            \
      last = now;                                      \
    }                                                  \
  } while (0)
#else
#define STAMP(arr, p)
#endif

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride (bfloat16 elements) of a tile whose rows are read 16 bytes a
// lane, 4 lanes a row: a multiple of 32 elements that is an odd multiple
// of 64 bytes, so that the two rows a quarter-warp reads fall on distinct
// banks.
__host__ __device__ constexpr int lane_stride(int cols) {
  return round_up(cols, 32) % 64 ? round_up(cols, 32) : round_up(cols, 32) + 32;
}

__host__ __device__ constexpr int tiles_of(int set) { return 1 << set; }

// ---- tensor cores: bfloat16 operands, float32 accumulators ----

// c (16 x 8) += a (16 x 16, row-major) @ b (16 x 8, column-major), one warp.
// With g = lane / 4 and q = lane % 4 a lane holds a[0..3] = A[g][2q..2q+1],
// A[g + 8][2q..], A[g][2q + 8..2q + 9], A[g + 8][2q + 8..]; b[0..1] =
// B[2q..2q+1][g], B[2q + 8..2q + 9][g]; c as mma_tf32's (the lower index
// in the lower half of a register).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8 x 8 bfloat16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8.  kTrans: each lane gets the transposed
// fragment (column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// returns when this thread's copy group g of kGroups (committed in order,
// none after) has landed
template <int kGroups>
__device__ __forceinline__ void cp_async_wait_for(int g) {
  static_assert(kGroups == 3, "one case a pending count");
  if (g == 0)
    cp_async_wait<2>();
  else if (g == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

__device__ __forceinline__ float bits_to_f(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint4 lds128(const uint16_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// x = hi + mid + lo exactly, each the bit pattern of a bfloat16 value as a
// float32 (low 16 bits zero); see the notes at the top
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  constexpr uint32_t kHigh = 0xffff0000u;
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = bits & 0x80000000u;
  hi = bits & kHigh;
  const uint32_t r = __float_as_uint(x - __uint_as_float(hi)) | sign;
  mid = r & kHigh;
  lo = __float_as_uint(__uint_as_float(r) - __uint_as_float(mid)) | sign;
}

// the bfloat16 halves of two such patterns in one register (a low)
__device__ __forceinline__ uint32_t pack_hi16(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// ------------------------------------------------------------------------
// 1. The forward
// ------------------------------------------------------------------------

// mdd_tpu's scan step for one (row, unit): gates g (i, f, g, o) in float32,
// c_prev the rounded carry; not contracted into FMAs.  -> h_t (float32,
// rounded by its store), c_t unrounded in c_out, the rounded carry in c.
__device__ __forceinline__ float scan_cell(const float (&g)[4], float& c,
                                           float& c_out) {
  const float c_new = __fadd_rn(__fmul_rn(sigmoid(g[1]), c),
                                __fmul_rn(sigmoid(g[0]), tanhf(g[2])));
  c = round_to<bf16>(c_new);
  c_out = c_new;
  return sigmoid(g[3]) * tanhf(c_new);
}

template <int G, int R>
struct FwdShape {
  static constexpr int kBU = kUnits * G;      // the block's hidden units
  static constexpr int kCols = 4 * kBU;       // its gate columns
  static constexpr int kNT = 4 * G;           // n-tiles of its product
  static constexpr int kKW = kWarps / R;      // warps sharing an m-tile
  static constexpr int kRows = kRowsTile * R;
  static constexpr int kPS = kCols + 8;       // row stride of the partials
  static constexpr int kItems = kRows * kBU;
  static constexpr int kRounds = (kItems + kThreads - 1) / kThreads;
  // row stride of x_s: 8 elements of padding put a warp's 4-byte reads of
  // 8 rows x 4 lanes on distinct banks
  static constexpr int kXS = kCols + 8;
  // w_s [kCols][ws], h_s [kRows][ws] and x_s [kRows][kXS] bfloat16, then
  // with kKW > 1 the partial sums [kKW][kRows][kPS] float32
  static size_t smem_bytes(int hidden) {
    const size_t ws = lane_stride(hidden);
    return (kCols + kRows) * ws * 2 + static_cast<size_t>(kRows) * kXS * 2
           + (kKW > 1 ? static_cast<size_t>(kKW) * kRows * kPS * 4 : 0);
  }
};

// rows [row_lo, row_hi) of the batch are this launch's
template <int G, int R>
__global__ void __launch_bounds__(kThreads, 1)
scan_fwd_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ whh,
                bf16* hs, float* __restrict__ cs, unsigned* barrier,
                int n_steps, int batch, int hidden, int row_lo, int row_hi) {
  using S = FwdShape<G, R>;
  constexpr int kBU = S::kBU, kCols = S::kCols, kNT = S::kNT, kKW = S::kKW;
  constexpr int kRows = S::kRows, kPS = S::kPS, kItems = S::kItems;
  constexpr int kRounds = S::kRounds, kXS = S::kXS;

  extern __shared__ __align__(16) unsigned char smem[];
  const int four_h = 4 * hidden;
  const int hp = round_up(hidden, kChunk);
  const int ws = lane_stride(hidden);
  uint16_t* w_s = reinterpret_cast<uint16_t*>(smem);   // [kCols][ws]
  uint16_t* h_s = w_s + static_cast<size_t>(kCols) * ws;   // [kRows][ws]
  // x_s [kRows][kXS]: the step's projections of the block's gate columns
  uint16_t* x_s = h_s + static_cast<size_t>(kRows) * ws;
  float* part = reinterpret_cast<float*>(x_s + kRows * kXS);

  const int unit_groups = hidden / kBU;
  const int chunk_groups = (row_hi - row_lo + kRows - 1) / kRows;
  const int group = blockIdx.x / unit_groups;        // (d, row group)
  const int ug = blockIdx.x % unit_groups;
  const int d = group / chunk_groups;
  const int row0 = row_lo + (group % chunk_groups) * kRows;
  const int j0 = ug * kBU;

  // w_s[c][k] = w_hh[d][k][q H + j0 + u] for column c = q kBU + u; k runs
  // fastest over the threads, so that the stores fall on distinct banks
  {
    const bf16* src = whh + static_cast<size_t>(d) * hidden * four_h + j0;
    constexpr int kQuads = kBU / 4;
    const int n = 4 * kQuads * hp;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int k = idx % hp;
      const int c = idx / hp * 4;          // q kBU + 4 * quad
      const int q = c / kBU, u = c % kBU;
      uint2 v = make_uint2(0u, 0u);
      if (k < hidden)
        v = *reinterpret_cast<const uint2*>(
            src + static_cast<size_t>(k) * four_h + q * hidden + u);
      w_s[c * ws + k] = static_cast<uint16_t>(v.x);
      w_s[(c + 1) * ws + k] = static_cast<uint16_t>(v.x >> 16);
      w_s[(c + 2) * ws + k] = static_cast<uint16_t>(v.y);
      w_s[(c + 3) * ws + k] = static_cast<uint16_t>(v.y >> 16);
    }
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int mt = warp % R;                 // this warp's m-tile
  const int kgrp = warp / R;               // and its share of K
  const int n_ch = hp / kChunk;
  const int ch_lo = kgrp * n_ch / kKW;
  const int ch_hi = (kgrp + 1) * n_ch / kKW;
  const int m_row = mt * kRowsTile;        // first row of the m-tile
  const size_t plane_rows = 2 * static_cast<size_t>(batch);   // rows a step

  // ---- the state: with kKW == 1 a lane's items are its accumulators'
  // (rows gid, gid + 8; units 8 j + 2 tig + e of each unit group j); else
  // thread-strided (row, unit) items as in lstm_fwd.cu
  constexpr int kLaneItems = 2 * G * 2;
  constexpr int kN = kKW == 1 ? kLaneItems : kRounds;
  float c_reg[kN], c_out[kN];
  auto item_at = [&](int r, int& row, int& u) {
    if constexpr (kKW == 1) {
      row = m_row + gid + (r / (2 * G)) * 8;
      u = (r / 2 % G) * kUnits + 2 * tig + r % 2;
    } else {
      const int item = threadIdx.x + r * kThreads;
      row = item / kBU;
      u = item % kBU;
    }
  };
  auto item_valid = [&](int r) {
    int row, u;
    item_at(r, row, u);
    return (kKW == 1 || threadIdx.x + r * kThreads < kItems)
           && row0 + row < row_hi;
  };
  // with kKW == 1 items 2 i and 2 i + 1 are neighbouring units of one
  // row: their stores go in pairs
  constexpr int kStep = kKW == 1 ? 2 : 1;
  // step s's projections of the block's rows and gate columns into x_s by
  // cp.async (zeros in padding rows), one commit group
  auto copy_x = [&](int s) {
    const size_t rows = (static_cast<size_t>(s) * 2 + d) * batch + row0;
    constexpr int kGran = kBU / 8;     // 16-byte granules a gate and row
    for (int e = threadIdx.x; e < kRows * 4 * kGran; e += kThreads) {
      const int row = e / (4 * kGran), q = e / kGran % 4;
      const int c = e % kGran * 8;
      const bool valid = row0 + row < row_hi;
      cp_async16(x_s + row * kXS + q * kBU + c,
                 xp + (valid ? (rows + row) * four_h + q * hidden + j0 + c
                             : 0),
                 valid);
    }
    cp_async_commit();
  };
  auto x_at = [&](int row, int q, int u) {
    return bits_to_f(x_s[row * kXS + q * kBU + u]);
  };
  auto store_c = [&](int s) {
    const size_t rows = (static_cast<size_t>(s) * 2 + d) * batch + row0;
#pragma unroll
    for (int r = 0; r < kN; r += kStep)
      if (item_valid(r)) {
        int row, u;
        item_at(r, row, u);
        float* c = cs + (rows + row) * hidden + j0 + u;
        if constexpr (kStep == 2)
          __stcs(reinterpret_cast<float2*>(c),
                 make_float2(c_out[r], c_out[r + 1]));
        else
          __stcs(c, c_out[r]);
      }
  };
#pragma unroll
  for (int r = 0; r < kN; ++r) c_reg[r] = 0.0f;
  copy_x(0);
  cp_async_wait<0>();
  __syncthreads();   // the w_hh slice and step 0's projections are complete

  GroupBarrier bar(barrier + group * kCounterStride, unit_groups);
#ifdef MDD_LSTM_SCAN_STAMPS
  long long last = clock64();
#endif
  for (int t = 0; t < n_steps; ++t) {
    const size_t step_row = (static_cast<size_t>(t) * 2 + d) * batch + row0;
    if (t > 0) bar.wait();
    STAMP(g_fwd_stamps, 0);
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    if (t > 0) {
      // ---- this warp's rows of h_{t-1} (its m-tile, its K chunks) from
      // L2 into h_s in kCopyGroups commit groups, and its share of h_{t-1}
      // @ the w_hh columns, each group's chunks as soon as they land
      const size_t prev = step_row - plane_rows;
      auto group_lo = [&](int g) {
        return ch_lo + (ch_hi - ch_lo) * g / kCopyGroups;
      };
#pragma unroll
      for (int g = 0; g < kCopyGroups; ++g) {
        const int c_lo = group_lo(g), width = (group_lo(g + 1) - c_lo) * 4;
        for (int e = lane; e < kRowsTile * width; e += 32) {
          const int row = e / width;
          const int col = (c_lo * 4 + e % width) * 8;
          const bool valid = row0 + m_row + row < row_hi && col < hidden;
          cp_async16(h_s + (m_row + row) * ws + col,
                     hs + (valid ? (prev + m_row + row) * hidden + col : 0),
                     valid);
        }
        cp_async_commit();
      }
      STAMP(g_fwd_stamps, 5);
      const uint16_t* a_row = h_s + (m_row + gid) * ws + 8 * tig;
      const uint16_t* b_row = w_s + gid * ws + 8 * tig;
#pragma unroll
      for (int g = 0; g < kCopyGroups; ++g) {
        cp_async_wait_for<kCopyGroups>(g);
        __syncwarp();
        for (int ch = group_lo(g); ch < group_lo(g + 1); ++ch) {
          const uint4 a0 = lds128(a_row + ch * kChunk);
          const uint4 a8 = lds128(a_row + 8 * ws + ch * kChunk);
          // lane tig's 8 columns of the chunk are the k slots (2 tig, 2
          // tig + 1, 2 tig + 8, 2 tig + 9) of two k16 steps; w_s is read
          // alike.  Each k16 step runs over all n-tiles before the next,
          // so that consecutive mma.sync never wait for one accumulator.
          uint4 b[kNT];
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            b[j] = lds128(b_row + j * kUnits * ws + ch * kChunk);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_bf16(acc[j], a0.x, a8.x, a0.y, a8.y, b[j].x, b[j].y);
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_bf16(acc[j], a0.z, a8.z, a0.w, a8.w, b[j].z, b[j].w);
        }
      }
      if constexpr (kKW > 1) {
        float* p = part + (kgrp * kRows + m_row + gid) * kPS + 2 * tig;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          *reinterpret_cast<float2*>(p + j * kUnits) =
              make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(p + 8 * kPS + j * kUnits) =
              make_float2(acc[j][2], acc[j][3]);
        }
        __syncthreads();
      }
      STAMP(g_fwd_stamps, 1);
    }
    // ---- the gates of this thread's items, c in registers, h_t out
    if constexpr (kKW == 1) {
      // x_s is the copies of every thread: each waited for its own (its
      // h copies' last wait covers the older group of x)
      if (t > 0) __syncthreads();
      // n-tile q G + j holds gate q of units 8 j ..; a lane's accumulator
      // e of it is (row gid + 8 (e / 2), unit 8 j + 2 tig + e % 2)
#pragma unroll
      for (int r = 0; r < kN; r += 2) {
        const int half = r / (2 * G), j = r / 2 % G;
        int row, u;
        item_at(r, row, u);
        float2 x[4];   // the pair's projections, one 4-byte read a gate
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              x_s + row * kXS + q * kBU + u));
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            g[q] = (e ? x[q].y : x[q].x) + acc[q * G + j][2 * half + e];
          h[e] = scan_cell(g, c_reg[r + e], c_out[r + e]);
        }
        if (item_valid(r)) {
          *reinterpret_cast<__nv_bfloat162*>(
              hs + (step_row + row) * hidden + j0 + u) =
              __floats2bfloat162_rn(h[0], h[1]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kN; ++r)
        if (item_valid(r)) {
          int row, u;
          item_at(r, row, u);
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            g[q] = x_at(row, q, u);
            if (t > 0) {
              const float* s = part + row * kPS + q * kBU + u;
              float dot = 0.0f;
#pragma unroll
              for (int v = 0; v < kKW; ++v) dot += s[v * kRows * kPS];
              g[q] += dot;
            }
          }
          const float h = scan_cell(g, c_reg[r], c_out[r]);
          hs[(step_row + row) * hidden + j0 + u] = from_f<bf16>(h);
        }
    }
    STAMP(g_fwd_stamps, 2);
    if (t + 1 == n_steps) break;
    bar.arrive();   // its block sync also guards `part`, h_s and x_s
    STAMP(g_fwd_stamps, 3);
    copy_x(t + 1);
    store_c(t);
    STAMP(g_fwd_stamps, 4);
  }
  store_c(n_steps - 1);
}

// ------------------------------------------------------------------------
// 2b. The backward's chain
// ------------------------------------------------------------------------

// what of step s does not depend on the chain, for one (row, unit): the
// pre-activations i, f, g, o; the unrounded c_s; c_{s-1} rounded as the
// forward carried it; the cotangent
struct StepInputs {
  float z[4], c, c_prev, dhs;
};

__device__ __forceinline__ StepInputs load_step(const float* __restrict__ z,
                                                const float* __restrict__ cs,
                                                const float* __restrict__ dhs,
                                                size_t row, size_t plane_rows,
                                                int hidden, int j,
                                                bool first) {
  StepInputs in;
  const float* z_row = z + row * 4 * hidden + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) in.z[q] = __ldcs(z_row + q * hidden);
  const size_t idx = row * hidden + j;
  in.c = __ldcs(cs + idx);
  in.c_prev = first ? 0.0f
                    : round_to<bf16>(cs[idx - plane_rows * hidden]);
  in.dhs = __ldcs(dhs + idx);
  return in;
}

// the activations of JAX's transpose of mdd_tpu's scan step, each as the
// forward made it (the factors built from them, 1 - g, 1 - tanh c and the
// sigmoids' derivatives, are made where they are used: fewer registers
// carried across the step's product)
struct ScanCoefs {
  float dhs, i, f, g, o, tanh_c, c_prev;
};

__device__ __forceinline__ ScanCoefs scan_coefs(const StepInputs& in) {
  ScanCoefs k;
  k.dhs = in.dhs;
  k.i = sigmoid(in.z[0]);
  k.f = sigmoid(in.z[1]);
  k.g = tanhf(in.z[2]);
  k.o = sigmoid(in.z[3]);
  k.tanh_c = tanhf(in.c);
  k.c_prev = in.c_prev;
  return k;
}

// One step of the chain for one (row, unit), in the order and with the
// roundings of JAX's transpose (lstm_scan_bwd_reference): dh and the
// carried dc arrive as bfloat16 values; -> the float32 dgates, the next dc
// (rounded).  Written with __fmul_rn / __fadd_rn so that nvcc contracts
// nothing into an FMA.
__device__ __forceinline__ float scan_step(const ScanCoefs& k, float dh_in,
                                           float dc_in, float (&dg)[4]) {
  const float di = __fmul_rn(k.i, 1.0f - k.i);
  const float df = __fmul_rn(k.f, 1.0f - k.f);
  const float d_o = __fmul_rn(k.o, 1.0f - k.o);
  const float dh = round_to<bf16>(__fadd_rn(k.dhs, dh_in));
  const float ef = __fmul_rn(__fmul_rn(k.o, dh), 1.0f - k.tanh_c);
  const float dc = __fadd_rn(__fadd_rn(dc_in, ef), __fmul_rn(ef, k.tanh_c));
  const float em = __fmul_rn(__fmul_rn(k.i, dc), 1.0f - k.g);
  dg[0] = __fmul_rn(__fmul_rn(dc, k.g), di);
  dg[1] = __fmul_rn(__fmul_rn(dc, k.c_prev), df);
  dg[2] = __fadd_rn(em, __fmul_rn(em, k.g));
  dg[3] = __fmul_rn(__fmul_rn(dh, k.tanh_c), d_o);
  return round_to<bf16>(__fmul_rn(k.f, dc));
}

template <int G, int R>
struct ChainShape {
  static constexpr int kBU = kUnits * G;
  static constexpr int kCols = 4 * kBU;
  static constexpr int kRows = kRowsTile * R;
  static constexpr int kStride = lane_stride(kCols);   // of w_s and a_s
  static constexpr int kItems = kRows * kBU;
  static constexpr int kRounds = (kItems + kThreads - 1) / kThreads;
  static constexpr int kNB = 6;     // n-tiles a warp accumulates at a time
  // w_s [H][kStride], a_s [3][kRows][kStride] bfloat16, then p_s
  // [H / kBU producers][kRows][kBU] float32
  static size_t smem_bytes(int hidden) {
    return (static_cast<size_t>(hidden) + 3 * kRows) * kStride * 2
           + static_cast<size_t>(hidden) * kRows * 4;
  }
};

// float32 elements of the chain's exchange: per parity of t, direction and
// row group of a launch's chunk of `rows`, one [16 R][H] partial dh from
// each of the H / (8 G) producers
inline size_t exchange_elems(int rows, int hidden, int g, int r) {
  const size_t groups = (rows + kRowsTile * r - 1) / (kRowsTile * r);
  return 2 * 2 * groups * (hidden / (kUnits * g)) * kRowsTile * r
         * static_cast<size_t>(hidden);
}

// rows [row_lo, row_hi) of the batch are this launch's; the chain also
// writes the float32 dgates to dg (scan_dw_kernel reads them)
template <int G, int R>
__global__ void __launch_bounds__(kThreads, 1)
scan_chain_kernel(const float* __restrict__ z, const bf16* __restrict__ whh,
                  const float* __restrict__ cs, const float* __restrict__ dhs,
                  bf16* __restrict__ dxp, float* __restrict__ dg_out,
                  float* exchange, unsigned* barrier, int n_steps, int batch,
                  int hidden, int row_lo, int row_hi) {
  using S = ChainShape<G, R>;
  constexpr int kBU = S::kBU, kRows = S::kRows;
  constexpr int kStride = S::kStride, kItems = S::kItems;
  constexpr int kRounds = S::kRounds, kNB = S::kNB;
  constexpr int kPlane = kRows * kStride;

  extern __shared__ __align__(16) unsigned char smem[];
  const int four_h = 4 * hidden;
  uint16_t* w_s = reinterpret_cast<uint16_t*>(smem);    // [H][kStride]
  uint16_t* a_s = w_s + static_cast<size_t>(hidden) * kStride;
  // a_s: [3][kRows][kStride], the step's dgates as (lo, mid, hi) parts
  float* p_s = reinterpret_cast<float*>(a_s + 3 * kPlane);
  // p_s: [producer][kRows][kBU], the group's partial dh for this block's
  // units

  const int unit_groups = hidden / kBU;   // producers of a group
  const int chunk_groups = (row_hi - row_lo + kRows - 1) / kRows;
  const int group = blockIdx.x / unit_groups;          // (d, row group)
  const int ug = blockIdx.x % unit_groups;
  const int d = group / chunk_groups;
  const int rg = group % chunk_groups;
  const int row0 = row_lo + rg * kRows;
  const int j0 = ug * kBU;

  // column q kBU + u of w_s is gate column q H + j0 + u of w_hh[d]
  {
    const bf16* src = whh + static_cast<size_t>(d) * hidden * four_h + j0;
    constexpr int kGran = kBU / 8;     // 16-byte granules a gate and row
    for (int idx = threadIdx.x; idx < hidden * 4 * kGran; idx += kThreads) {
      const int row = idx / (4 * kGran);
      const int q = idx / kGran % 4;
      const int c = idx % kGran * 8;
      *reinterpret_cast<uint4*>(w_s + row * kStride + q * kBU + c) =
          *reinterpret_cast<const uint4*>(
              src + static_cast<size_t>(row) * four_h + q * hidden + c);
    }
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int n_tiles = hidden / kUnits;      // n-tiles of the partial dh
  const size_t plane_rows = 2 * static_cast<size_t>(batch);
  // one (parity, d, row group, producer) slab of the exchange is
  // [kRows][H]
  const size_t slab = static_cast<size_t>(kRows) * hidden;
  auto slab_of = [&](int parity, int producer) {
    return exchange
           + (((static_cast<size_t>(parity) * 2 + d) * chunk_groups + rg)
                  * unit_groups + producer) * slab;
  };

  // item r of this thread: row item_row(r) of the block, unit item_u(r)
  auto item_live = [&](int r) { return threadIdx.x + r * kThreads < kItems; };
  auto item_row = [&](int r) { return (threadIdx.x + r * kThreads) / kBU; };
  auto item_u = [&](int r) { return (threadIdx.x + r * kThreads) % kBU; };
  auto item_valid = [&](int r) {
    return item_live(r) && row0 + item_row(r) < row_hi;
  };

  StepInputs inputs[kRounds];
  ScanCoefs coef[kRounds];
  float dh[kRounds], dc[kRounds];
  auto load_inputs = [&](int s) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_valid(r)) {
        const size_t row =
            (static_cast<size_t>(s) * 2 + d) * batch + row0 + item_row(r);
        inputs[r] = load_step(z, cs, dhs, row, plane_rows, hidden,
                              j0 + item_u(r), s == 0);
      }
  };
  auto make_coefs = [&]() {
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_valid(r)) coef[r] = scan_coefs(inputs[r]);
  };
#pragma unroll
  for (int r = 0; r < kRounds; ++r) dh[r] = dc[r] = 0.0f;
  load_inputs(n_steps - 1);
  make_coefs();
  __syncthreads();   // w_s is complete

  GroupBarrier bar(barrier + group * kCounterStride, unit_groups);
#ifdef MDD_LSTM_SCAN_STAMPS
  long long last = clock64();
#endif
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t step_row = (static_cast<size_t>(t) * 2 + d) * batch + row0;
    // ---- dgates of step t: to dx_proj, to the float32 stream and, split
    // in three, to a_s (zeros in padding rows)
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_live(r)) {
        float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (item_valid(r)) {
          const size_t at =
              (step_row + item_row(r)) * four_h + j0 + item_u(r);
          dc[r] = scan_step(coef[r], dh[r], dc[r], dg);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            __stcs(dg_out + at + q * hidden, dg[q]);
            __stcs(reinterpret_cast<unsigned short*>(dxp) + at + q * hidden,
                   bf16_bits(dg[q]));
          }
        }
        uint16_t* a = a_s + item_row(r) * kStride + item_u(r);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t hi, mid, lo;
          split3(dg[q], hi, mid, lo);
          a[q * kBU] = static_cast<uint16_t>(lo >> 16);
          a[kPlane + q * kBU] = static_cast<uint16_t>(mid >> 16);
          a[2 * kPlane + q * kBU] = static_cast<uint16_t>(hi >> 16);
        }
      }
    STAMP(g_bwd_stamps, 0);
    if (t == 0) break;
    __syncthreads();   // a_s is complete
    STAMP(g_bwd_stamps, 5);
    // the inputs of step t - 1, loaded a phase ahead of their use
    load_inputs(t - 1);
    STAMP(g_bwd_stamps, 6);
    // ---- this block's share of dh_{t-1} for every unit: its dgates
    // columns times their columns of w_hh, (16 R x 32 G) @ (32 G x H),
    // three passes (lo, mid, hi); a warp takes kNB n-tiles, keeps their
    // w_hh fragments in registers and walks the m-tiles, each m-tile's
    // partial sums stored (and draining to L2) while the next is computed
    for (int n0 = warp * kNB; n0 < n_tiles; n0 += kWarps * kNB) {
      uint4 bw[kNB][G];
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        // n-tiles past the last repeat it: computed, never stored
        const uint16_t* b_row =
            w_s + (min(n0 + i, n_tiles - 1) * kUnits + gid) * kStride
            + 8 * tig;
#pragma unroll
        for (int c = 0; c < G; ++c) bw[i][c] = lds128(b_row + c * kChunk);
      }
      float* out = slab_of(t & 1, ug);
#pragma unroll 1
      for (int mt = 0; mt < R; ++mt) {
        float acc[kNB][4];
#pragma unroll
        for (int i = 0; i < kNB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
        const uint16_t* a_row =
            a_s + (mt * kRowsTile + gid) * kStride + 8 * tig;
#pragma unroll
        for (int c = 0; c < G; ++c) {
          uint4 a0[3], a8[3];
#pragma unroll
          for (int p = 0; p < 3; ++p) {      // lo, mid, hi
            a0[p] = lds128(a_row + p * kPlane + c * kChunk);
            a8[p] = lds128(a_row + p * kPlane + 8 * kStride + c * kChunk);
          }
          // each pass over all kNB n-tiles before the next, so that
          // consecutive mma.sync never wait for one accumulator
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int i = 0; i < kNB; ++i)
              mma_bf16(acc[i], a0[p].x, a8[p].x, a0[p].y, a8[p].y,
                       bw[i][c].x, bw[i][c].y);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int i = 0; i < kNB; ++i)
              mma_bf16(acc[i], a0[p].z, a8[p].z, a0[p].w, a8[p].w,
                       bw[i][c].z, bw[i][c].w);
        }
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          const int n = n0 + i;
          if (n >= n_tiles) continue;
          float* o = out + (mt * kRowsTile + gid) * hidden + n * kUnits
                     + 2 * tig;
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(o + 8 * hidden) =
              make_float2(acc[i][2], acc[i][3]);
        }
      }
    }
    STAMP(g_bwd_stamps, 1);
    bar.arrive();
    make_coefs();          // needs nothing of the other blocks
    STAMP(g_bwd_stamps, 2);
    bar.wait();
    STAMP(g_bwd_stamps, 3);
    // ---- dh_{t-1} of this block's items: the producers' partial sums for
    // them, brought into shared memory by cp.async (all in flight at
    // once) and added in producer order
    {
      constexpr int kRowVecs = kBU / 4;          // float4 a row
      const int n_vecs = unit_groups * kRows * kRowVecs;
      for (int e = threadIdx.x; e < n_vecs; e += kThreads) {
        const int producer = e / (kRows * kRowVecs);
        const int row = e / kRowVecs % kRows;
        const int v = e % kRowVecs;
        cp_async16(p_s + e * 4,
                   slab_of(t & 1, producer) + row * hidden + j0 + v * 4,
                   true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        if (item_live(r)) {
          const int item = threadIdx.x + r * kThreads;
          float sum = 0.0f;
          for (int p = 0; p < unit_groups; ++p) sum += p_s[p * kItems + item];
          dh[r] = round_to<bf16>(sum);
        }
    }
    STAMP(g_bwd_stamps, 4);
    // (the barriers of the next step separate the product's reads of a_s
    // from its next writes; the exchange alternates by parity)
  }
}

// ------------------------------------------------------------------------
// 2a. The gate pre-activations, off the chain
// ------------------------------------------------------------------------

constexpr int kPM = 128, kPN = 128, kPK = 32, kPStages = 3;
// row strides (elements) that are odd multiples of 16 bytes, so that the 8
// rows an ldmatrix reads fall on distinct banks
constexpr int kPAStride = kPK + 8;    // A [m][k]: 80-byte rows
constexpr int kPBStride = kPN + 8;    // B [k][n]: 272-byte rows
constexpr int kPStage = kPM * kPAStride + kPK * kPBStride;   // elements

// z[t, d, b, :] = x_proj[t, d, b, :] + hs[t-1, d, b, :] @ w_hh[d] (zero
// h at t = 0): M = T B rows (t, b), K = H, N = 4H, direction blockIdx.z.
// 8 warps of 64 x 32 (2 x 4).
__global__ void __launch_bounds__(kThreads, 2)
scan_z_kernel(const bf16* __restrict__ hs, const bf16* __restrict__ whh,
              const bf16* __restrict__ xp, float* __restrict__ z,
              int n_steps, int batch, int hidden) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem);
  const int four_h = 4 * hidden;
  const int d = blockIdx.z;
  const int m0 = blockIdx.y * kPM;
  const int n0 = blockIdx.x * kPN;
  const int m_total = n_steps * batch;
  const int k_tiles = (hidden + kPK - 1) / kPK;
  auto stream_row = [&](int t, int b) {
    return (static_cast<size_t>(t) * 2 + d) * batch + b;
  };

  auto load_tile = [&](int stage, int kt) {
    uint16_t* a_s = stages + stage * kPStage;
    uint16_t* b_s = a_s + kPM * kPAStride;
    const int k0 = kt * kPK;
#pragma unroll
    for (int c = 0; c < kPM * kPK / 8 / kThreads; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int row = idx / (kPK / 8), col = idx % (kPK / 8) * 8;
      const int m = m0 + row;
      const int t = m / batch;
      const bool valid = m < m_total && t > 0 && k0 + col < hidden;
      cp_async16(a_s + row * kPAStride + col,
                 hs + (valid ? stream_row(t - 1, m % batch) * hidden + k0 + col
                             : 0),
                 valid);
    }
#pragma unroll
    for (int c = 0; c < kPK * kPN / 8 / kThreads; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int row = idx / (kPN / 8), col = idx % (kPN / 8) * 8;
      const bool valid = k0 + row < hidden && n0 + col < four_h;
      cp_async16(b_s + row * kPBStride + col,
                 whh + (valid ? (static_cast<size_t>(d) * hidden + k0 + row)
                                        * four_h + n0 + col
                              : 0),
                 valid);
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8
  const int lr = lane % 8, lm = lane / 8;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();
    if (kt + kPStages - 1 < k_tiles)
      load_tile((kt + kPStages - 1) % kPStages, kt + kPStages - 1);
    cp_async_commit();
    const uint16_t* a_s = stages + (kt % kPStages) * kPStage;
    const uint16_t* b_s = a_s + kPM * kPAStride;
#pragma unroll
    for (int ks = 0; ks < kPK; ks += 16) {
      // B: matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) of an n-tile pair
      uint32_t bf[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix4<true>(r, b_s + (ks + (lm % 2) * 8 + lr) * kPBStride + wn
                               + p * 16 + (lm / 2) * 8);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A: matrices (m 0-7 | 8-15) x (k 0-7 | 8-15)
        uint32_t a[4];
        ldmatrix4<false>(a, a_s + (wm + i * 16 + (lm % 2) * 8 + lr)
                                    * kPAStride + ks + (lm / 2) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[0], a[1], a[2], a[3], bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + gid + half * 8;
      if (m >= m_total) continue;
      const size_t row = stream_row(m / batch, m % batch);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * tig;
        if (n >= four_h) continue;
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xp + row * four_h + n));
        *reinterpret_cast<float2*>(z + row * four_h + n) =
            make_float2(acc[i][j][2 * half] + x.x,
                        acc[i][j][2 * half + 1] + x.y);
      }
    }
}

// ------------------------------------------------------------------------
// 2c / 2d. dW_hh
// ------------------------------------------------------------------------

constexpr int kDM = 128, kDN = 128, kDK = 32;
constexpr int kDStride = kDN + 8;            // [k][m] and [k][n] rows
constexpr int kDAElems = kDK * kDStride;     // a stage: A, then 3 B planes
constexpr int kDStage = 4 * kDAElems;

// P_t = rnd(h_{t-1}^T @ dgates_t) for the steps of one chunk (blockIdx.z /
// 2; t from n_steps - 1 - chunk * steps_per_chunk down, t >= 1) of one
// 128 x 128 tile of direction blockIdx.z % 2: M = H (rows i), N = 4H, K =
// B; 8 warps of 64 x 32.  kCarry: one chunk holds every step, the block
// carries acc = rnd(acc + P_t) in registers and writes dW_hh; else it
// writes each P_t to out[t - 1] (the scratch).  A (hs, bfloat16) comes by
// cp.async, B (the float32 dgates) through registers, split in three on
// the way into shared memory; two stages.
template <bool kCarry>
__global__ void __launch_bounds__(kThreads, kCarry ? 1 : 2)
scan_dw_kernel(const bf16* __restrict__ hs, const float* __restrict__ dg,
               bf16* __restrict__ out, int n_steps, int batch, int hidden,
               int steps_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t (*stages)[kDStage] = reinterpret_cast<uint16_t (*)[kDStage]>(smem);
  const int four_h = 4 * hidden;
  const int d = blockIdx.z % 2;
  const int chunk = blockIdx.z / 2;
  const int m0 = blockIdx.y * kDM;
  const int n0 = blockIdx.x * kDN;
  const int t_hi = n_steps - 1 - chunk * steps_per_chunk;
  const int t_lo = max(1, t_hi - steps_per_chunk + 1);
  const int k_tiles = (batch + kDK - 1) / kDK;
  const int n_iters = (t_hi - t_lo + 1) * k_tiles;

  // K-tile `it`: step t_hi - it / k_tiles, batch rows from (it % k_tiles)
  // * 32
  constexpr int kBVecs = kDK * kDN / 4 / kThreads;   // float4 a thread
  float4 b_reg[kBVecs];
  auto load_a = [&](int stage, int it) {
    const int t = t_hi - it / k_tiles;
    const int b0 = it % k_tiles * kDK;
    uint16_t* a_s = stages[stage];
#pragma unroll
    for (int c = 0; c < kDK * kDM / 8 / kThreads; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int row = idx / (kDM / 8), col = idx % (kDM / 8) * 8;
      const bool valid = b0 + row < batch && m0 + col < hidden;
      cp_async16(a_s + row * kDStride + col,
                 hs + (valid ? ((static_cast<size_t>(t - 1) * 2 + d) * batch
                                + b0 + row) * hidden + m0 + col
                             : 0),
                 valid);
    }
  };
  auto load_b = [&](int it) {
    const int t = t_hi - it / k_tiles;
    const int b0 = it % k_tiles * kDK;
#pragma unroll
    for (int c = 0; c < kBVecs; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int row = idx / (kDN / 4), col = idx % (kDN / 4) * 4;
      b_reg[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b0 + row < batch && n0 + col < four_h)
        b_reg[c] = *reinterpret_cast<const float4*>(
            dg + ((static_cast<size_t>(t) * 2 + d) * batch + b0 + row)
                     * four_h + n0 + col);
    }
  };
  auto store_b = [&](int stage) {
    uint16_t* b_s = stages[stage] + kDAElems;   // planes lo, mid, hi
#pragma unroll
    for (int c = 0; c < kBVecs; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int row = idx / (kDN / 4), col = idx % (kDN / 4) * 4;
      uint32_t hi[4], mid[4], lo[4];
      split3(b_reg[c].x, hi[0], mid[0], lo[0]);
      split3(b_reg[c].y, hi[1], mid[1], lo[1]);
      split3(b_reg[c].z, hi[2], mid[2], lo[2]);
      split3(b_reg[c].w, hi[3], mid[3], lo[3]);
      uint16_t* p = b_s + row * kDStride + col;
      *reinterpret_cast<uint2*>(p) =
          make_uint2(pack_hi16(lo[0], lo[1]), pack_hi16(lo[2], lo[3]));
      *reinterpret_cast<uint2*>(p + kDAElems) =
          make_uint2(pack_hi16(mid[0], mid[1]), pack_hi16(mid[2], mid[3]));
      *reinterpret_cast<uint2*>(p + 2 * kDAElems) =
          make_uint2(pack_hi16(hi[0], hi[1]), pack_hi16(hi[2], hi[3]));
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wm = (warp / 4) * (kDM / 2);   // 64
  const int wn = (warp % 4) * 32;
  const int lr = lane % 8, lm = lane / 8;
  constexpr int kMT = kDM / 32;   // m-tiles of a warp

  float acc[kMT][4][4];
  uint32_t carry[kMT][4][2];   // kCarry: the bfloat16 carry, two a register
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      carry[i][j][0] = carry[i][j][1] = 0u;
    }

  if (n_iters > 0) {
    load_a(0, 0);
    cp_async_commit();
    load_b(0);
    store_b(0);
  }
  for (int it = 0; it < n_iters; ++it) {
    const int stage = it % 2;
    const bool more = it + 1 < n_iters;
    cp_async_wait<0>();
    __syncthreads();   // tile `it` is in shared memory; tile it-1 read by all
    if (more) {        // the next tile's loads under this product
      load_a(stage ^ 1, it + 1);
      cp_async_commit();
      load_b(it + 1);
    }
    const uint16_t* a_s = stages[stage];
    const uint16_t* b_s = a_s + kDAElems;
#pragma unroll
    for (int ks = 0; ks < kDK; ks += 16) {
      // A = h^T: stored [k][m], so the transposed matrices (k 0-7 | 8-15)
      // x (m 0-7 | 8-15) give the row-major fragments
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t r[4];
        ldmatrix4<true>(r, a_s + (ks + (lm / 2) * 8 + lr) * kDStride + wm
                               + i * 16 + (lm % 2) * 8);
        a[i][0] = r[0];
        a[i][1] = r[1];
        a[i][2] = r[2];
        a[i][3] = r[3];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {      // lo, mid, hi
        uint32_t bf[4][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t r[4];
          ldmatrix4<true>(r, b_s + p * kDAElems
                                 + (ks + (lm % 2) * 8 + lr) * kDStride + wn
                                 + q * 16 + (lm / 2) * 8);
          bf[2 * q][0] = r[0];
          bf[2 * q][1] = r[1];
          bf[2 * q + 1][0] = r[2];
          bf[2 * q + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], bf[j][0],
                     bf[j][1]);
      }
    }
    if (it % k_tiles == k_tiles - 1) {   // the step's product is complete
      const int t = t_hi - it / k_tiles;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wm + i * 16 + gid + half * 8;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + wn + j * 8 + 2 * tig;
            const __nv_bfloat162 prod = __floats2bfloat162_rn(
                acc[i][j][2 * half], acc[i][j][2 * half + 1]);
            if constexpr (kCarry) {
              const float2 c = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      &carry[i][j][half]));
              const float2 p = __bfloat1622float2(prod);
              const __nv_bfloat162 sum =
                  __floats2bfloat162_rn(c.x + p.x, c.y + p.y);
              carry[i][j][half] = *reinterpret_cast<const uint32_t*>(&sum);
            } else if (m < hidden && n < four_h) {
              *reinterpret_cast<__nv_bfloat162*>(
                  out + ((static_cast<size_t>(t - 1) * 2 + d) * hidden + m)
                            * four_h + n) = prod;
            }
            acc[i][j][2 * half] = acc[i][j][2 * half + 1] = 0.0f;
          }
        }
    }
    if (more) store_b(stage ^ 1);   // read first after the next barrier
  }
  if constexpr (kCarry) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + gid + half * 8;
        if (m >= hidden) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn + j * 8 + 2 * tig;
          if (n < four_h)
            *reinterpret_cast<uint32_t*>(
                out + (static_cast<size_t>(d) * hidden + m) * four_h + n) =
                carry[i][j][half];
        }
      }
  }
}

// dW_hh = the ordered bfloat16 sum of the scratch's P_t, t = T-1 down to
// 1: acc = rnd(acc + P_t); 8 elements a thread.  Zero at T = 1.
__global__ void __launch_bounds__(256)
scan_dw_carry_kernel(const uint4* __restrict__ scratch, uint4* __restrict__ dw,
                     int n_steps, int n_vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  float acc[8] = {};
  for (int t = n_steps - 1; t >= 1; --t) {
    const uint4 v = scratch[static_cast<size_t>(t - 1) * n_vec + i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * e] = round_to<bf16>(acc[2 * e] + __uint_as_float(w[e] << 16));
      acc[2 * e + 1] =
          round_to<bf16>(acc[2 * e + 1] + __uint_as_float(w[e] & 0xffff0000u));
    }
  }
  uint4 o;
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    ow[e] = pack_hi16(__float_as_uint(acc[2 * e]),
                      __float_as_uint(acc[2 * e + 1]));
  dw[i] = o;
}

// ------------------------------------------------------------------------
// Host side
// ------------------------------------------------------------------------

template <int N>
using Int = std::integral_constant<int, N>;

// fn(G, R as integral constants) for g unit groups and tile set `set` (R =
// 2^set)
template <typename Fn>
cudaError_t for_fwd(int g, int set, Fn fn) {
  static_assert(kMaxGroups == 3 && kFwdTileSets == 4, "one case each");
  auto by_g = [&](auto G) -> cudaError_t {
    switch (set) {
      case 0: return fn(G, Int<1>());
      case 1: return fn(G, Int<2>());
      case 2: return fn(G, Int<4>());
      default: return fn(G, Int<8>());
    }
  };
  if (g == 1) return by_g(Int<1>());
  if (g == 2) return by_g(Int<2>());
  return by_g(Int<3>());
}

template <typename Fn>
cudaError_t for_chain(int g, int set, Fn fn) {
  static_assert(kMaxGroups == 3 && kChainTileSets == 3, "one case each");
  auto by_g = [&](auto G) -> cudaError_t {
    switch (set) {
      case 0: return fn(G, Int<1>());
      case 1: return fn(G, Int<2>());
      default: return fn(G, Int<4>());
    }
  };
  if (g == 1) return by_g(Int<1>());
  if (g == 2) return by_g(Int<2>());
  return by_g(Int<3>());
}

// What the card holds of each instance of a recurrence at this H: its
// shared memory a block and the blocks resident at once (0 where a block
// does not fit).  Asked of the runtime once a (device, H, kind) and
// thread; this also raises each instance's dynamic shared memory limit to
// the card's.
struct Capacity {
  int device, hidden, chain, sms;
  int smem[kMaxGroups][kFwdTileSets], blocks[kMaxGroups][kFwdTileSets];
};

cudaError_t capacity(int device, int hidden, bool chain, Capacity* out) {
  thread_local std::vector<Capacity> memo;
  for (const Capacity& c : memo)
    if (c.device == device && c.hidden == hidden && c.chain == chain) {
      *out = c;
      return cudaSuccess;
    }
  Capacity cap = {device, hidden, chain, 0, {}, {}};
  int optin = 0;
  cudaDeviceGetAttribute(&cap.sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const int sets = chain ? kChainTileSets : kFwdTileSets;
  for (int g = 1; g <= kMaxGroups; ++g)
    for (int set = 0; set < sets; ++set) {
      auto probe = [&](const void* kernel, size_t smem) -> cudaError_t {
        cap.smem[g - 1][set] = static_cast<int>(smem);
        cap.blocks[g - 1][set] = 0;
        if (smem > static_cast<size_t>(optin)) return cudaSuccess;
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
        if (e != cudaSuccess) return e;
        int per_sm = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
        cap.blocks[g - 1][set] = per_sm * cap.sms;
        return e;
      };
      const cudaError_t err =
          chain ? for_chain(g, set, [&](auto G, auto R) {
                    constexpr int kG = decltype(G)::value;
                    constexpr int kR = decltype(R)::value;
                    return probe(reinterpret_cast<const void*>(
                                     scan_chain_kernel<kG, kR>),
                                 ChainShape<kG, kR>::smem_bytes(hidden));
                  })
                : for_fwd(g, set, [&](auto G, auto R) {
                    constexpr int kG = decltype(G)::value;
                    constexpr int kR = decltype(R)::value;
                    return probe(
                        reinterpret_cast<const void*>(scan_fwd_kernel<kG, kR>),
                        FwdShape<kG, kR>::smem_bytes(hidden));
                  });
      if (err != cudaSuccess) return err;
    }
  memo.push_back(cap);
  *out = cap;
  return cudaSuccess;
}

// how a recurrence is laid out on the card
struct Plan {
  int groups;      // G: unit groups of 8 a block owns
  int tiles;       // R: 16-row tiles a block owns
  int blocks;      // blocks of one launch, all resident at once
  int smem;        // dynamic shared memory of a block, bytes
  int chunk_rows;  // batch rows of one launch
  int launches;    // launches of the call, one after another
};

// Among the (G, R) whose blocks of one row group are all resident: the
// fewest launches (each is a whole serial chain of steps), then the least
// product an SM and step (R G a block, times the blocks an SM takes in
// turn), then the fewest blocks an SM, then the least G.
// cudaErrorInvalidConfiguration when there is none.  On an H100 at H = 384
// the forward takes R = 8, G = 3 at B = 512 (128 blocks, one launch), R =
// 1, G = 3 at B = 64 and R = 1, G = 1 at B = 1 (as lstm_fwd.cu's plan).
// The chain's R stops at 4 (its state a thread grows with R; see the
// notes at the top): 48 x 512 runs as two launches of R = 4, G = 3.
cudaError_t make_plan(int batch, int hidden, bool chain, Plan* plan) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  Capacity cap;
  err = capacity(device, hidden, chain, &cap);
  if (err != cudaSuccess) return err;
  const int batch_tiles = (batch + kRowsTile - 1) / kRowsTile;
  const int sets = chain ? kChainTileSets : kFwdTileSets;
  Plan best = {};
  long long best_work = 0;
  int best_per_sm = 0;
  for (int g = 1; g <= kMaxGroups; ++g) {
    if (hidden % (kUnits * g) != 0) continue;
    const int unit_groups = hidden / (kUnits * g);
    for (int set = 0; set < sets; ++set) {
      const int r = tiles_of(set);
      if (set > 0 && tiles_of(set - 1) >= batch_tiles) break;
      const int row_groups = (batch_tiles + r - 1) / r;
      const int per_launch =
          min(row_groups, cap.blocks[g - 1][set] / (2 * unit_groups));
      if (per_launch == 0) continue;
      const int launches = (row_groups + per_launch - 1) / per_launch;
      const int blocks = 2 * per_launch * unit_groups;
      const int per_sm = (blocks + cap.sms - 1) / cap.sms;
      const long long work = static_cast<long long>(r) * g * per_sm;
      if (best.groups == 0 || launches < best.launches
          || (launches == best.launches
              && (work < best_work
                  || (work == best_work && per_sm < best_per_sm)))) {
        best = {g, r, blocks, cap.smem[g - 1][set],
                min(batch, per_launch * r * kRowsTile), launches};
        best_work = work;
        best_per_sm = per_sm;
      }
    }
  }
  if (best.groups == 0) return cudaErrorInvalidConfiguration;
  *plan = best;
  return cudaSuccess;
}

int set_of(int tiles) {
  int set = 0;
  while (tiles_of(set) < tiles) ++set;
  return set;
}

cudaError_t launch_fwd(const void* xp_v, const void* whh_v, void* hs_v,
                       void* cs_v, unsigned* barrier, int n_steps, int batch,
                       int hidden, cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(xp_v);
  const bf16* whh = static_cast<const bf16*>(whh_v);
  bf16* hs = static_cast<bf16*>(hs_v);
  float* cs = static_cast<float*>(cs_v);
  Plan plan;
  cudaError_t err = make_plan(batch, hidden, false, &plan);
  if (err != cudaSuccess) return err;
  return for_fwd(plan.groups, set_of(plan.tiles), [&](auto G, auto R) {
    constexpr int kG = decltype(G)::value;
    constexpr int kR = decltype(R)::value;
    auto kernel = scan_fwd_kernel<kG, kR>;
    const int unit_groups = hidden / (kUnits * kG);
    const int group_rows = kR * kRowsTile;
    for (int i = 0; i < plan.launches; ++i) {
      int row_lo = i * plan.chunk_rows;
      int row_hi = min(batch, row_lo + plan.chunk_rows);
      const int groups = (row_hi - row_lo + group_rows - 1) / group_rows;
      // each launch's groups count on counters of their own
      unsigned* counters = barrier + static_cast<size_t>(i) * 2
                           * (plan.chunk_rows / group_rows) * kCounterStride;
      void* args[] = {&xp, &whh, &hs, &cs, &counters, &n_steps, &batch,
                      &hidden, &row_lo, &row_hi};
      // cooperative: the launch fails instead of deadlocking at a barrier
      // when the blocks cannot all be resident at once
      const cudaError_t e = cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(kernel), dim3(2 * groups * unit_groups),
          dim3(kThreads), args, plan.smem, stream);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
}

// dW_hh's layout: steps a block walks, and whether one block a tile
// carries in registers (no scratch)
struct DwPlan {
  int steps_per_chunk, chunks, carry;
};

DwPlan dw_plan(int n_steps, int batch) {
  const int k_tiles = (batch + kDK - 1) / kDK;
  const int steps = n_steps - 1;
  if (steps < 1) return {0, 0, 1};
  if (steps * k_tiles <= kDwSerialTiles) return {steps, 1, 1};
  const int spc = max(1, 8 / k_tiles);
  return {spc, (steps + spc - 1) / spc, 0};
}


size_t dw_scratch_elems(int n_steps, int batch, int hidden) {
  const DwPlan p = dw_plan(n_steps, batch);
  return p.carry ? 0
                 : static_cast<size_t>(n_steps - 1) * 2 * hidden * 4 * hidden;
}

constexpr int kPartZ = 1, kPartChain = 2, kPartDw = 4;

cudaError_t launch_bwd(const void* xp_v, const void* whh_v, const void* hs_v,
                       const float* cs, const float* dhs, void* dxp_v,
                       void* dw_v, float* z, float* dg, float* exchange,
                       void* scratch_v, unsigned* barrier, int n_steps,
                       int batch, int hidden, int parts,
                       cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(xp_v);
  const bf16* whh = static_cast<const bf16*>(whh_v);
  const bf16* hs = static_cast<const bf16*>(hs_v);
  bf16* dxp = static_cast<bf16*>(dxp_v);
  bf16* dw = static_cast<bf16*>(dw_v);
  bf16* scratch = static_cast<bf16*>(scratch_v);
  const int four_h = 4 * hidden;
  cudaError_t err = cudaSuccess;
  if (parts & kPartZ) {
    constexpr size_t smem = static_cast<size_t>(kPStages) * kPStage * 2;
    err = cudaFuncSetAttribute(scan_z_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((four_h + kPN - 1) / kPN, (n_steps * batch + kPM - 1) / kPM,
                    2);
    scan_z_kernel<<<grid, kThreads, smem, stream>>>(hs, whh, xp, z, n_steps,
                                                    batch, hidden);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kPartChain) {
    Plan plan;
    err = make_plan(batch, hidden, true, &plan);
    if (err != cudaSuccess) return err;
    err = for_chain(plan.groups, set_of(plan.tiles), [&](auto G, auto R) {
      constexpr int kG = decltype(G)::value;
      constexpr int kR = decltype(R)::value;
      const int unit_groups = hidden / (kUnits * kG);
      const int group_rows = kR * kRowsTile;
      for (int i = 0; i < plan.launches; ++i) {
        int row_lo = i * plan.chunk_rows;
        int row_hi = min(batch, row_lo + plan.chunk_rows);
        const int groups = (row_hi - row_lo + group_rows - 1) / group_rows;
        // counters of its own; the exchange is reused, since the launches
        // run one after another on the stream
        unsigned* counters = barrier + static_cast<size_t>(i) * 2
                             * (plan.chunk_rows / group_rows) * kCounterStride;
        void* args[] = {&z, &whh, &cs, &dhs, &dxp, &dg, &exchange, &counters,
                        &n_steps, &batch, &hidden, &row_lo, &row_hi};
        const cudaError_t e = cudaLaunchCooperativeKernel(
            reinterpret_cast<void*>(scan_chain_kernel<kG, kR>),
            dim3(2 * groups * unit_groups), dim3(kThreads), args, plan.smem,
            stream);
        if (e != cudaSuccess) return e;
      }
      return cudaSuccess;
    });
    if (err != cudaSuccess) return err;
  }
  if (!(parts & kPartDw)) return err;
  const DwPlan p = dw_plan(n_steps, batch);
  const int n_vec = 2 * hidden * four_h / 8;
  if (p.chunks == 0) {       // T = 1: no h_{t-1}, dW_hh = 0
    scan_dw_carry_kernel<<<(n_vec + 255) / 256, 256, 0, stream>>>(
        nullptr, reinterpret_cast<uint4*>(dw), 1, n_vec);
    return cudaGetLastError();
  }
  const dim3 grid((four_h + kDN - 1) / kDN, (hidden + kDM - 1) / kDM,
                  2 * p.chunks);
  constexpr size_t smem = 2 * kDStage * 2;
  auto dw_kernel = p.carry ? scan_dw_kernel<true> : scan_dw_kernel<false>;
  err = cudaFuncSetAttribute(dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (p.carry) {
    scan_dw_kernel<true><<<grid, kThreads, smem, stream>>>(
        hs, dg, dw, n_steps, batch, hidden, p.steps_per_chunk);
    return cudaGetLastError();
  }
  scan_dw_kernel<false><<<grid, kThreads, smem, stream>>>(
      hs, dg, scratch, n_steps, batch, hidden, p.steps_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_dw_carry_kernel<<<(n_vec + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const uint4*>(scratch), reinterpret_cast<uint4*>(dw),
      n_steps, n_vec);
  return cudaGetLastError();
}

bool shapes_ok(int n_steps, int batch, int hidden, int dtype) {
  return n_steps >= 1 && batch >= 1 && hidden >= kUnits
         && hidden % kUnits == 0 && dtype == 1;
}

void write_plan(const Plan& plan, int* out) {
  out[0] = plan.groups;
  out[1] = plan.tiles;
  out[2] = plan.blocks;
  out[3] = plan.smem;
  out[4] = plan.chunk_rows;
  out[5] = plan.launches;
}

}  // namespace

extern "C" {

// the unit group: the wrapper checks H % this == 0
int mdd_lstm_scan_fwd_units_per_block() { return kUnits; }
int mdd_lstm_scan_bwd_units_per_block() { return kUnits; }

// How the forward lays a batch out: out[0 .. 6) = unit groups a block owns,
// 16-row tiles a block owns, blocks of a launch, their shared memory in
// bytes, batch rows of a launch, launches.  dtype must be 1 (bfloat16).
// cudaErrorInvalidConfiguration (9) when H is too large for a block.
int mdd_lstm_scan_fwd_plan(int batch, int hidden, int dtype, int* out) {
  if (!shapes_ok(1, batch, hidden, dtype)) return cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t err = make_plan(batch, hidden, false, &plan);
  if (err == cudaSuccess) write_plan(plan, out);
  return err;
}

// x_proj, w_hh, hs bfloat16; cs float32 (the unrounded c_t).  barrier:
// ZEROED, 32 counters for each of the 2 * ceil(B / 16) groups there can be.
// Returns a cudaError_t (0 = success).
int mdd_lstm_scan_fwd(const void* x_proj, const void* w_hh, void* hs,
                      void* cs, unsigned* barrier, int n_steps, int batch,
                      int hidden, int dtype, void* stream) {
  if (!shapes_ok(n_steps, batch, hidden, dtype)) return cudaErrorInvalidValue;
  const cudaError_t err =
      launch_fwd(x_proj, w_hh, hs, cs, barrier, n_steps, batch, hidden,
                 static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How the backward lays a call out: out[0 .. 6) as the forward's plan for
// the chain, out[6] the float32 elements of the chain's exchange in L2,
// out[7] the steps a dW_hh block walks, out[8] 1 where one block a tile
// carries dW_hh in registers, out[9] the bfloat16 elements of dW_hh's step
// scratch (0 then).  The wrapper sizes the scratch by out[6] and out[9].
int mdd_lstm_scan_bwd_plan(int n_steps, int batch, int hidden, int dtype,
                           int* out) {
  if (!shapes_ok(n_steps, batch, hidden, dtype)) return cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t err = make_plan(batch, hidden, true, &plan);
  if (err != cudaSuccess) return err;
  write_plan(plan, out);
  out[6] = static_cast<int>(exchange_elems(plan.chunk_rows, hidden,
                                           plan.groups, plan.tiles));
  const DwPlan p = dw_plan(n_steps, batch);
  out[7] = p.steps_per_chunk;
  out[8] = p.carry;
  const size_t scratch = dw_scratch_elems(n_steps, batch, hidden);
  if (scratch > 0x7fffffffu) return cudaErrorInvalidValue;
  out[9] = static_cast<int>(scratch);
  return cudaSuccess;
}

// x_proj, w_hh, hs bfloat16; cs float32 (the forward's c_t); dhs float32
// (the bfloat16 cotangent widened); out: dx_proj and dw_hh bfloat16.
// Scratch, none of it initialised: z and dg (T, 2, B, 4H) float32,
// exchange float32 and dw_scratch bfloat16 sized by
// mdd_lstm_scan_bwd_plan; barrier ZEROED as the forward's.  parts: 1 = the
// pre-activation product, 2 = the chain, 4 = dW_hh (product and carry); 7
// is the backward, the single parts exist to be timed (each needs what the
// earlier ones left in z and dg).  Returns a cudaError_t.
int mdd_lstm_scan_bwd(const void* x_proj, const void* w_hh, const void* hs,
                      const float* cs, const float* dhs, void* dx_proj,
                      void* dw_hh, float* z, float* dg, float* exchange,
                      void* dw_scratch, unsigned* barrier, int n_steps,
                      int batch, int hidden, int dtype, int parts,
                      void* stream) {
  if (!shapes_ok(n_steps, batch, hidden, dtype)) return cudaErrorInvalidValue;
  return launch_bwd(x_proj, w_hh, hs, cs, dhs, dx_proj, dw_hh, z, dg,
                    exchange, dw_scratch, barrier, n_steps, batch, hidden,
                    parts, static_cast<cudaStream_t>(stream));
}

#ifdef MDD_LSTM_SCAN_STAMPS
const char* mdd_lstm_scan_fwd_stamp_names() {
  return "barrier wait,h product (after the copies' issue),"
         "gate math + h stores,arrive,next x_proj copy + c stores,"
         "h copies issued";
}

const char* mdd_lstm_scan_bwd_stamp_names() {
  return "dgates + split,partial dh product,arrive + next coefficients,"
         "barrier wait,read + add partial dh,block sync after dgates,"
         "next step's loads issued";
}

// copy the cycle sums of block 0 into out[0 .. n) and zero them
int mdd_lstm_scan_fwd_read_stamps(long long* out, int n) {
  long long host[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_fwd_stamps, sizeof(host));
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n && i < 8; ++i) out[i] = host[i];
  const long long zero[8] = {};
  return cudaMemcpyToSymbol(g_fwd_stamps, zero, sizeof(zero));
}

int mdd_lstm_scan_bwd_read_stamps(long long* out, int n) {
  long long host[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_bwd_stamps, sizeof(host));
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n && i < 8; ++i) out[i] = host[i];
  const long long zero[8] = {};
  return cudaMemcpyToSymbol(g_bwd_stamps, zero, sizeof(zero));
}
#endif

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
