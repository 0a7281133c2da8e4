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
// summed in float32, the gate math is float32, h is carried in the compute
// dtype and c in float32 for the whole sequence (the Pallas kernel's h_scr /
// c_scr contract).  Both directions walk time forwards: the caller has
// already time-reversed direction 1's projections.
//
// The scan contract (mdd_tpu/ops/lstm.py's bilstm, c rounded to bfloat16
// every step) has kernels of its own in csrc/lstm_scan.cu.
//
// What bounds it on an H100.  The T steps form a serial chain: step t needs
// every hidden unit of step t-1, so the wall time is T times the latency of
// one step, whatever the FLOP rate.  A step is a (B x H) @ (H x 4H) product
// a direction, far too small to fill the card (2 * B * H * 4H FLOPs: 75
// MFLOP at B = 16, H = 384), plus an exchange of h_t between the blocks
// that share its rows, and the gate math.
//
// What the design does about it.  One persistent cooperative launch runs the
// T steps.  Batch rows never interact, so the blocks are split over
// (direction, 16-row batch tile, group of 8 G hidden units), and only the
// blocks of one (direction, tile) share a barrier.  A block owns the
// 4 x 8 G gate columns of its units and keeps those columns of w_hh
// (H x 32 G) in shared memory for the whole sequence, so w_hh is read from
// device memory once a launch; in float32 at G = 1 the slice is split into
// its TF32 high and low parts once, at load.  A step: wait at the tile's
// barrier; each of the 8 warps loads ITS K-slice of h_{t-1} (the 16 rows of
// the tile, H / 8 columns) straight from L2 into registers, all loads in
// flight at once, and multiplies it with its K-slice of the w_hh columns on
// the tensor cores (mma.sync m16n8k8: 3xTF32 with the mask split in
// float32, one exact pass in bfloat16), so no warp waits for a gather of
// the whole tile and nothing is staged in shared memory (each value of h is
// used by one warp only); the 8 partial sums go to shared memory and the
// thread that owns a (row, unit) adds them in warp order (the same bits
// every run), adds the projections it loaded while the block waited, and
// runs the gate math with c in its registers; it stores h_t (1.5 KB a block
// at G = 3: the whole exchange), the block arrives at the barrier (a
// release add; the waiters poll with acquire loads), and then stores c_t
// and loads step t+1's projections, which need nothing of the other blocks.
// G is chosen per call so that the blocks of at least one tile are all
// resident (make_plan()): 96 blocks of 8 units at B <= 16, 128 of 24 units
// at B = 64 (H = 384, float32); a larger batch runs as several launches of
// whole tiles, one after another (B = 256: 4 launches of 64 rows).
// Built with -DMDD_LSTM_FWD_STAMPS, thread 0 of block 0 sums clock64()
// differences per phase of a step (python -m mdd_tpu_torch.ops.lstm_stamps
// --kernel fwd prints them).
//
// Measured (H100 80GB HBM3 at 700 W, float32, H = 384, T' = 80;
// ops/lstm_stamps.py, variants with --source).  The kernel this replaced
// (one block a direction's 8 units walking every batch tile of a step in
// turn, dots on the FMA pipe out of shared memory, a barrier over all
// blocks of a direction) ran 0.268 / 0.531 / 1.855 ms at B = 1 / 16 / 64,
// its dot 52-59% of a step; this one 0.235 / 0.258 / 0.492 ms.  Tried and
// dropped, at B = 1 / 16 (/ 64): one cluster of 16 blocks of 24 units a
// (direction, tile) exchanging h_t through distributed shared memory and
// barrier.cluster, 0.386 / 0.486 ms (bfloat16 0.276 / 0.354 against
// 0.200 / 0.215): the product of 24 units a block costs more than the
// exchange it saves; 16 or 24 units a block at B <= 16, 0.293 / 0.317 and
// 0.364 / 0.449 ms; 8 or 16 units a block at B = 64 (4 or 2 tiles a block),
// 0.979 and 0.644 ms; the barrier with full fences, 0.264 / 0.281 / 0.542
// ms; w_hh loaded one element at a time, 0.244 / 0.267 / 0.545 ms; two
// accumulator chains a warp at 8 units, no change; each warp's K-slice
// brought into shared memory by cp.async, one group a 16-column chunk
// with the product starting on the first, 0.249 / 0.253 / 0.482 ms
// against 0.232 / 0.247 / 0.495 (the register loads already overlap: each
// mma.sync waits only for its own chunk).  Blocks that own up to 4 tiles
// each, beside the launches, ran B = 256 / 512 in 1.60 / 3.17 ms against
// 1.96 / 3.88 ms as 4 / 8 launches of one-tile blocks; dropped so that one
// mechanism takes every batch (no path of the port runs B > 64 on the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <vector>

#include "lstm_common.cuh"

namespace {

using namespace mdd;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;          // a unit group: one n-tile a gate
constexpr int kRowsTile = 16;      // batch rows of a tile: one m-tile
constexpr int kMaxGroups = 3;      // unit groups one block may own (G)
constexpr int kMaxKG = 3;          // 16-column K groups a warp loads at once
constexpr int kCounterStride = 32; // one 128-byte line per group counter
constexpr int kPadBytes = 16;      // row padding of the w_hh slice
constexpr int kPartPad = 8;        // row padding of the partial sums, floats

#ifdef MDD_LSTM_FWD_STAMPS
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

// The w_hh slice of a block in shared memory: row c = q * 8 G + u holds
// gate column q * H + j0 + u of w_hh[d] for k = 0 .. Hp (zeros past H), so
// that a lane reads 4 consecutive k of one column with one load.  Rows are
// padded by 16 bytes: the 4-wide reads of 8 rows x 4 lanes fall on
// distinct banks.  kSplit: float32 kept as its TF32 high and low parts.
template <typename T, bool kSplit>
struct WSlice;

template <typename T>
struct WSlice<T, false> {
  static constexpr int kPad = kPadBytes / static_cast<int>(sizeof(T));
  T* w;
  int stride;
  __device__ WSlice(unsigned char* smem, int hp, int)
      : w(reinterpret_cast<T*>(smem)), stride(hp + kPad) {}
  __host__ __device__ static size_t bytes(int hp, int cols) {
    return static_cast<size_t>(hp + kPad) * cols * sizeof(T);
  }
  __device__ void put(int c, int k, float v) {
    w[c * stride + k] = from_f<T>(v);
  }
  // b0 / b1: the fragments of the two k-steps of a 16-column group for
  // n-tiles j0 .. j0 + N, from this lane's 4 columns at k (= k0 + 4 tig)
  template <int N>
  __device__ __forceinline__ void frags(int j0, int gid, int k,
                                        Frag<T, 2> (&b0)[N],
                                        Frag<T, 2> (&b1)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 v = load4(w + ((j0 + i) * kUnits + gid) * stride + k);
      b0[i].set(0, v.x);
      b0[i].set(1, v.y);
      b1[i].set(0, v.z);
      b1[i].set(1, v.w);
    }
  }
};

template <>
struct WSlice<float, true> {
  static constexpr int kPad = kPadBytes / 4;
  uint32_t* hi;
  uint32_t* lo;
  int stride;
  __device__ WSlice(unsigned char* smem, int hp, int cols)
      : hi(reinterpret_cast<uint32_t*>(smem)),
        lo(hi + static_cast<size_t>(hp + kPad) * cols), stride(hp + kPad) {}
  __host__ __device__ static size_t bytes(int hp, int cols) {
    return 2 * static_cast<size_t>(hp + kPad) * cols * 4;
  }
  __device__ void put(int c, int k, float v) {
    tf32_split(v, hi[c * stride + k], lo[c * stride + k]);
  }
  template <int N>
  __device__ __forceinline__ void frags(int j0, int gid, int k,
                                        Frag<float, 2> (&b0)[N],
                                        Frag<float, 2> (&b1)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int at = ((j0 + i) * kUnits + gid) * stride + k;
      const uint4 h = *reinterpret_cast<const uint4*>(hi + at);
      const uint4 l = *reinterpret_cast<const uint4*>(lo + at);
      b0[i].hi[0] = h.x;
      b0[i].hi[1] = h.y;
      b0[i].lo[0] = l.x;
      b0[i].lo[1] = l.y;
      b1[i].hi[0] = h.z;
      b1[i].hi[1] = h.w;
      b1[i].lo[0] = l.z;
      b1[i].lo[1] = l.w;
    }
  }
};

__host__ __device__ inline int round16(int hidden) {
  return (hidden + 15) / 16 * 16;
}

template <typename T, int G, bool kSplit>
size_t smem_bytes(int hidden) {
  constexpr int kCols = 4 * kUnits * G;
  return WSlice<T, kSplit>::bytes(round16(hidden), kCols)
         + static_cast<size_t>(kWarps) * kRowsTile * (kCols + kPartPad)
               * sizeof(float);
}

// rows [row_lo, row_hi) of the batch are this launch's
template <typename T, int G, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ whh, T* hs,
                T* __restrict__ cs, unsigned* barrier,
                int n_steps, int batch, int hidden, int row_lo, int row_hi) {
  constexpr int kBlockUnits = kUnits * G;
  constexpr int kCols = 4 * kBlockUnits;       // this block's gate columns
  constexpr int kNT = 4 * G;                   // n-tiles of the product
  constexpr int kNB = G == 3 ? 6 : kNT;        // n-tiles a batch of B frags
  constexpr int kPS = kCols + kPartPad;        // row stride of the partials
  constexpr int kTileItems = kRowsTile * kBlockUnits;
  constexpr int kRounds = (kTileItems + kThreads - 1) / kThreads;
  static_assert(kNT % kNB == 0, "whole batches of n-tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  const int four_h = 4 * hidden;
  const int hp = round16(hidden);
  WSlice<T, kSplit> w(smem, hp, kCols);
  float* part = reinterpret_cast<float*>(
      smem + WSlice<T, kSplit>::bytes(hp, kCols));
  // part: [warp][16][kPS], each warp's partial gate sums of the tile

  const int unit_groups = hidden / kBlockUnits;
  const int chunk_tiles = (row_hi - row_lo + kRowsTile - 1) / kRowsTile;
  const int group = blockIdx.x / unit_groups;          // (d, batch tile)
  const int ug = blockIdx.x % unit_groups;
  const int d = group / chunk_tiles;
  const int row0 = row_lo + (group % chunk_tiles) * kRowsTile;
  const int j0 = ug * kBlockUnits;

  {
    // 4 consecutive units of one gate at a time, several loads in flight
    const T* src = whh + static_cast<size_t>(d) * hidden * four_h + j0;
    constexpr int kQuads = kBlockUnits / 4;
    const int n = hidden * 4 * kQuads;
#pragma unroll 8
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int k = idx / (4 * kQuads);
      const int q = idx / kQuads % 4;
      const int u = idx % kQuads * 4;
      const float4 v = load4(src + static_cast<size_t>(k) * four_h
                             + q * hidden + u);
      const int c = q * kBlockUnits + u;
      w.put(c, k, v.x);
      w.put(c + 1, k, v.y);
      w.put(c + 2, k, v.z);
      w.put(c + 3, k, v.w);
    }
    for (int idx = threadIdx.x; idx < (hp - hidden) * kCols; idx += kThreads)
      w.put(idx % kCols, hidden + idx / kCols, 0.0f);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  // this warp's 16-column groups of K
  const int n_kg = hp / 16;
  const int kg_lo = warp * n_kg / kWarps;
  const int kg_hi = (warp + 1) * n_kg / kWarps;
  const size_t plane_rows = 2 * static_cast<size_t>(batch);   // rows a step

  // item r of this thread: row row0 + item_row[r], unit j0 + item_u[r]
  int item_row[kRounds], item_u[kRounds];
  bool item_valid[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int item = threadIdx.x + r * kThreads;
    item_row[r] = item / kBlockUnits;
    item_u[r] = item % kBlockUnits;
    item_valid[r] = item < kTileItems && row0 + item_row[r] < row_hi;
  }

  // c_reg: the carried c; c_out: c_t as the cs stream keeps it
  float c_reg[kRounds], c_out[kRounds], xg[kRounds][4];
  auto load_x = [&](int s) {
    const size_t rows = (static_cast<size_t>(s) * 2 + d) * batch + row0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_valid[r]) {
        const T* x = xp + (rows + item_row[r]) * four_h + j0 + item_u[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[r][q] = to_f(x[q * hidden]);
      }
  };
  auto store_c = [&](int s) {
    const size_t rows = (static_cast<size_t>(s) * 2 + d) * batch + row0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_valid[r])
        cs[(rows + item_row[r]) * hidden + j0 + item_u[r]] =
            from_f<T>(c_out[r]);
  };
#pragma unroll
  for (int r = 0; r < kRounds; ++r) c_reg[r] = 0.0f;
  load_x(0);
  __syncthreads();   // the w_hh slice is complete

  GroupBarrier bar(barrier + group * kCounterStride, unit_groups);
#ifdef MDD_LSTM_FWD_STAMPS
  long long last = clock64();
#endif
  for (int t = 0; t < n_steps; ++t) {
    const size_t step_row = (static_cast<size_t>(t) * 2 + d) * batch;
    if (t > 0) bar.wait();
    STAMP(0);
    if (t > 0) {
      // ---- this warp's K-slice of h_{t-1} @ the w_hh columns, 16 x 32 G
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      const bool v0 = row0 + gid < row_hi;
      const bool v8 = row0 + gid + 8 < row_hi;
      const T* h0 = hs + (step_row - plane_rows + row0 + gid) * hidden
                    + 4 * tig;
      const T* h8 = h0 + 8 * static_cast<size_t>(hidden);
      for (int base = kg_lo; base < kg_hi; base += kMaxKG) {
        // every load of the slice in flight before the first product
        float4 a0[kMaxKG], a8[kMaxKG];
#pragma unroll
        for (int i = 0; i < kMaxKG; ++i) {
          const int kk = (base + i) * 16;
          const bool in = base + i < kg_hi && kk + 4 * tig < hidden;
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          a0[i] = in && v0 ? load4_l2(h0 + kk) : zero;
          a8[i] = in && v8 ? load4_l2(h8 + kk) : zero;
        }
#pragma unroll
        for (int i = 0; i < kMaxKG; ++i) {
          if (base + i >= kg_hi) break;
          // two k-steps over 16 columns, of which this lane holds 4
          // consecutive ones a row: the sum over k does not care which
          // column sits in which slot of a fragment, as long as both
          // operands agree
          Frag<T, 4> a_first, a_second;
          a_first.set(0, a0[i].x);
          a_first.set(1, a8[i].x);
          a_first.set(2, a0[i].y);
          a_first.set(3, a8[i].y);
          a_second.set(0, a0[i].z);
          a_second.set(1, a8[i].z);
          a_second.set(2, a0[i].w);
          a_second.set(3, a8[i].w);
          const int kk = (base + i) * 16 + 4 * tig;
#pragma unroll
          for (int jb = 0; jb < kNT; jb += kNB) {
            Frag<T, 2> b0[kNB], b1[kNB];
            w.template frags<kNB>(jb, gid, kk, b0, b1);
            auto& acc_b = *reinterpret_cast<float(*)[kNB][4]>(acc[jb]);
            mma_frags(acc_b, a_first, b0);
            mma_frags(acc_b, a_second, b1);
          }
        }
      }
      float* p = part + (warp * kRowsTile + gid) * kPS + 2 * tig;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<float2*>(p + j * kUnits) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(p + 8 * kPS + j * kUnits) =
            make_float2(acc[j][2], acc[j][3]);
      }
      __syncthreads();
      STAMP(1);
    }
    // ---- the gates of this thread's (row, unit) items: the warps' partial
    // sums in warp order, the projections, c in registers
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (item_valid[r]) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          g[q] = xg[r][q];
          if (t > 0) {
            const float* s =
                part + item_row[r] * kPS + q * kBlockUnits + item_u[r];
            float dot = 0.0f;
#pragma unroll
            for (int v = 0; v < kWarps; ++v) dot += s[v * kRowsTile * kPS];
            g[q] += dot;
          }
        }
        const float c = sigmoid(g[1]) * c_reg[r] + sigmoid(g[0]) * tanhf(g[2]);
        c_reg[r] = c;
        c_out[r] = c;
        hs[(step_row + row0 + item_row[r]) * hidden + j0 + item_u[r]] =
            from_f<T>(sigmoid(g[3]) * tanhf(c));
      }
    STAMP(2);
    if (t + 1 == n_steps) break;
    bar.arrive();   // its block sync also guards `part` for the next step
    STAMP(3);
    // ---- what needs nothing of the other blocks: c_t and step t+1's
    // projections
    store_c(t);
    load_x(t + 1);
    STAMP(4);
  }
  store_c(n_steps - 1);
}

// ------------------------------------------------------------------------
// Host side
// ------------------------------------------------------------------------

// how one call is laid out on the card
struct Plan {
  int groups;      // G: unit groups of 8 a block owns
  int split;       // float32 w_hh slice split into TF32 parts at load
  int blocks;      // blocks of one launch, all resident at once
  int smem;        // dynamic shared memory of a block, bytes
  int chunk_rows;  // batch rows of one launch
  int launches;    // launches of the call, one after another
};

template <int N>
using Int = std::integral_constant<int, N>;
template <bool B>
using Bool = std::integral_constant<bool, B>;

// fn(G, kSplit as integral constants) for the instance that runs g unit
// groups a block.  float32 at G = 1 keeps its w_hh slice split into TF32
// parts; at G > 1 the two halves do not fit beside each other.
template <typename T, typename Fn>
cudaError_t for_instance(int g, Fn fn) {
  static_assert(kMaxGroups == 3, "one case per G");
  if (g == 1) return fn(Int<1>(), Bool<std::is_same<T, float>::value>());
  if (g == 2) return fn(Int<2>(), Bool<false>());
  return fn(Int<3>(), Bool<false>());
}

// What the card holds of each instance at this H: its shared memory a
// block and the blocks resident at once (0 where a block does not fit).
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
    const cudaError_t err = for_instance<T>(g, [&](auto G, auto kSplit) {
      auto kernel = lstm_fwd_kernel<T, decltype(G)::value,
                                    decltype(kSplit)::value>;
      const size_t smem =
          smem_bytes<T, decltype(G)::value, decltype(kSplit)::value>(hidden);
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
// launches (each is a whole serial chain of T' steps), then the fewest
// blocks an SM (two on one SM take turns), then the least G (a block's
// product grows with it).  On an H100 at H = 384, float32, T' = 80 that is
// G = 1 at B <= 16 (0.235 ms at B = 1, where G = 2 / 3 take 0.293 / 0.364),
// G = 2 at B = 24 and G = 3 at B = 64 (one launch each).
// cudaErrorInvalidConfiguration when there is none (H too large for a
// block's shared memory).
template <typename T>
cudaError_t make_plan(int batch, int hidden, Plan* plan) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  Capacity cap;
  err = capacity<T>(device, hidden, &cap);
  if (err != cudaSuccess) return err;
  const int batch_tiles = (batch + kRowsTile - 1) / kRowsTile;
  Plan best = {};
  int best_per_sm = 0;
  for (int g = 1; g <= kMaxGroups; ++g) {
    if (hidden % (kUnits * g) != 0) continue;
    const int unit_groups = hidden / (kUnits * g);
    const int chunk_tiles =
        min(batch_tiles, cap.blocks[g - 1] / (2 * unit_groups));
    if (chunk_tiles == 0) continue;
    const int launches = (batch_tiles + chunk_tiles - 1) / chunk_tiles;
    const int blocks = 2 * chunk_tiles * unit_groups;
    const int per_sm = (blocks + cap.sms - 1) / cap.sms;
    if (best.groups == 0 || launches < best.launches
        || (launches == best.launches && per_sm < best_per_sm)) {
      best = {g, g == 1 && std::is_same<T, float>::value, blocks,
              cap.smem[g - 1], chunk_tiles * kRowsTile, launches};
      best_per_sm = per_sm;
    }
  }
  if (best.groups == 0) return cudaErrorInvalidConfiguration;
  *plan = best;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* xp_v, const void* whh_v, void* hs_v,
                   void* cs_v, unsigned* barrier, int n_steps, int batch,
                   int hidden, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(xp_v);
  const T* whh = static_cast<const T*>(whh_v);
  T* hs = static_cast<T*>(hs_v);
  T* cs = static_cast<T*>(cs_v);
  Plan plan;
  cudaError_t err = make_plan<T>(batch, hidden, &plan);
  if (err != cudaSuccess) return err;
  return for_instance<T>(plan.groups, [&](auto G, auto kSplit) {
    auto kernel = lstm_fwd_kernel<T, decltype(G)::value,
                                  decltype(kSplit)::value>;
    const int unit_groups = hidden / (kUnits * decltype(G)::value);
    for (int i = 0; i < plan.launches; ++i) {
      int row_lo = i * plan.chunk_rows;
      int row_hi = min(batch, row_lo + plan.chunk_rows);
      const int chunk_tiles = (row_hi - row_lo + kRowsTile - 1) / kRowsTile;
      const int blocks = 2 * chunk_tiles * unit_groups;
      // each launch's groups count on counters of their own
      unsigned* counters = barrier + static_cast<size_t>(i) * 2
                           * (plan.chunk_rows / kRowsTile) * kCounterStride;
      void* args[] = {&xp, &whh, &hs, &cs, &counters, &n_steps, &batch,
                      &hidden, &row_lo, &row_hi};
      // cooperative: the launch fails (cudaErrorCooperativeLaunchTooLarge)
      // instead of deadlocking at a barrier when the blocks cannot all be
      // resident at once
      const cudaError_t e = cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads), args,
          plan.smem, stream);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
}

bool shapes_ok(int n_steps, int batch, int hidden) {
  return n_steps >= 1 && batch >= 1 && hidden >= kUnits
         && hidden % kUnits == 0;
}

void write_plan(const Plan& plan, int* out) {
  out[0] = plan.groups;
  out[1] = plan.split;
  out[2] = plan.blocks;
  out[3] = plan.smem;
  out[4] = plan.chunk_rows;
  out[5] = plan.launches;
}

}  // namespace

extern "C" {

// the unit group: the wrapper checks H % this == 0
int mdd_lstm_fwd_units_per_block() { return kUnits; }

// How a call of these shapes is laid out: out[0 .. 6) = unit groups a block
// owns, 1 if float32 w_hh is split at load, blocks of a launch, their
// shared memory in bytes, batch rows of a launch, launches.
// cudaErrorInvalidConfiguration (9) when H is too large for a block.
int mdd_lstm_fwd_plan(int batch, int hidden, int dtype, int* out) {
  if (!shapes_ok(1, batch, hidden) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t err =
      dtype == 0 ? make_plan<float>(batch, hidden, &plan)
                 : make_plan<__nv_bfloat16>(batch, hidden, &plan);
  if (err == cudaSuccess) write_plan(plan, out);
  return err;
}

// dtype: 0 = float32, 1 = bfloat16.  barrier: ZEROED, 32 counters for each
// of the 2 * ceil(B / 16) groups there can be.  Returns a cudaError_t
// (0 = success).
int mdd_lstm_fwd(const void* x_proj, const void* w_hh, void* hs, void* cs,
                 unsigned* barrier, int n_steps, int batch, int hidden,
                 int dtype, void* stream) {
  if (!shapes_ok(n_steps, batch, hidden)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x_proj, w_hh, hs, cs, barrier, n_steps, batch,
                        hidden, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x_proj, w_hh, hs, cs, barrier, n_steps,
                                batch, hidden, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef MDD_LSTM_FWD_STAMPS
const char* mdd_lstm_fwd_stamp_names() {
  return "barrier wait,h gather + product,gate math + h stores,arrive,"
         "c stores + next x_proj";
}

// copies the cycle sums of block 0 into out[0 .. n) and zeroes them
int mdd_lstm_fwd_read_stamps(long long* out, int n) {
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
