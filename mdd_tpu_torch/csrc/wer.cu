// The train step's greedy WER counts in one launch, for Hopper (sm_90a).
//
// Replaces mdd_tpu/ops/wer.py:32 `batched_edit_distance` and the collapse
// of `greedy_wer_counts` around it.  Neither is a Pallas kernel: mdd_tpu
// compiles them into its jitted train step, the edit distance as one
// lax.scan over the predicted positions with an associative_scan cummin
// inside.  The port's plain version (ops/wer.py) runs that scan as a
// Python loop of ~12 launches a padded column.  Same function:
//
//   keep[t]   = t < frames & ids[t] != blank & ids[t] != ids[t-1]
//   pred      = ids[keep], compacted                      (the CTC collapse)
//   dist      = Levenshtein(pred, targets[:target_sizes])
//   errors    = sum of dist over the valid rows
//   tokens    = sum of target_sizes over the valid rows
//
// with target_sizes clamped to [0, L] where the distance is read, as
// mdd_tpu's gather clamps.  Integers only, so the kernel equals the plain
// version exactly.
//
// Design.  One warp a row (4 rows a block), no block barrier anywhere.
//   - The collapse walks the row's own frames (< frames, not the padded
//     width) 32 at a time: a lane loads one id, its left neighbour comes
//     by a shuffle (the chunk's first lane takes the previous chunk's
//     last), a ballot gives the kept lanes, and each kept token is handed
//     to the whole warp by a shuffle in frame order.  No compacted copy
//     is stored.
//   - The DP row of L + 1 cells lives in registers, P consecutive cells a
//     lane (32 P >= L + 1; P = 1, 2, 4, ..., 32).  A token's update is
//     cand[j] = min(row[j] + 1, row[j-1] + (target[j-1] != x)), whose left
//     neighbour crosses lanes by one shuffle, then the insertion chain
//     new[j] = min(cand[j], new[j-1] + 1) = min_{k<=j}(cand[k] - k) + j,
//     a prefix-min: P - 1 mins in the lane, 5 shuffle steps across lanes.
//   - Lane 0 writes the row's distance and adds the two counts with 64-bit
//     integer atomics, exact in any order.
//
// What bounds it on an H100: neither bytes nor operations.  At the train
// cell (B=64, T' <= 110, L <= 40) it reads ~80 KB and does ~10^6 integer
// operations, well under a microsecond either way; the time is the chain
// of dependent DP steps a row (one a kept token, ~50 at T'=110), each a
// few shuffles deep, and the launch.  One warp a row keeps every step
// inside a warp (no __syncthreads) and the row in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
greedy_wer_kernel(const long long* __restrict__ ids, long long ids_sb,
                  long long ids_st, const long long* __restrict__ frames,
                  const long long* __restrict__ targets, long long tg_sb,
                  long long tg_st, const long long* __restrict__ target_sizes,
                  const bool* __restrict__ valid, int B, int T, int L,
                  long long blank, long long* __restrict__ dist,
                  unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together

  // cells j = lane * P + p: row[j] and the target a cell compares with
  int cell[P];
  long long tgt[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane * P + p;
    cell[p] = j;
    tgt[p] = (j >= 1 && j <= L) ? targets[row * tg_sb + (j - 1) * tg_st] : 0;
  }

  long long n = frames[row];
  n = n < 0 ? 0 : (n > T ? T : n);
  const long long* id_row = ids + row * ids_sb;
  long long prev_last = -1;  // the id of the frame before the chunk
  for (long long t0 = 0; t0 < n; t0 += 32) {
    const long long t = t0 + lane;
    const long long id = t < n ? id_row[t * ids_st] : blank;
    long long prev = __shfl_up_sync(kFull, id, 1);
    if (lane == 0) prev = prev_last;
    unsigned kept = __ballot_sync(kFull, t < n && id != blank && id != prev);
    prev_last = __shfl_sync(kFull, id, 31);
    while (kept) {
      const int src = __ffs(kept) - 1;
      kept &= kept - 1;
      const long long x = __shfl_sync(kFull, id, src);
      // cand[j] - j, then its prefix-min in the lane
      const int left = __shfl_up_sync(kFull, cell[P - 1], 1);
      int v[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = lane * P + p;
        const int diag = (p == 0 ? left : cell[p - 1]) + (tgt[p] != x);
        v[p] = (j == 0 ? cell[p] + 1 : min(cell[p] + 1, diag)) - j;
      }
#pragma unroll
      for (int p = 1; p < P; ++p) v[p] = min(v[p - 1], v[p]);
      // the prefix-min over the lanes before this one
      int scan = v[P - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, scan, d);
        if (lane >= d) scan = min(scan, o);
      }
      int before = __shfl_up_sync(kFull, scan, 1);
      if (lane == 0) before = 0x3fffffff;
#pragma unroll
      for (int p = 0; p < P; ++p) cell[p] = min(before, v[p]) + lane * P + p;
    }
  }

  const long long ts = target_sizes[row];
  const int at = static_cast<int>(ts < 0 ? 0 : (ts > L ? L : ts));
  int mine = 0;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (at == lane * P + p) mine = cell[p];
  const int d = __shfl_sync(kFull, mine, at / P);
  if (lane == 0) {
    dist[row] = d;
    if (valid[row]) {
      atomicAdd(counts, static_cast<unsigned long long>(d));
      atomicAdd(counts + 1, static_cast<unsigned long long>(ts));
    }
  }
}

template <int P>
cudaError_t launch(const long long* ids, long long ids_sb, long long ids_st,
                   const long long* frames, const long long* targets,
                   long long tg_sb, long long tg_st,
                   const long long* target_sizes, const bool* valid, int B,
                   int T, int L, long long blank, long long* dist,
                   unsigned long long* counts, cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  greedy_wer_kernel<P><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      ids, ids_sb, ids_st, frames, targets, tg_sb, tg_st, target_sizes, valid,
      B, T, L, blank, dist, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ids: (B, T) int64 with element strides (ids_sb, ids_st); frames,
// target_sizes: (B,) int64; targets: (B, L) int64 with strides (tg_sb,
// tg_st); valid: (B,) bool.  dist: (B,) int64 out; counts: 2 int64 that
// the caller zeroed, += (errors, tokens).  1 <= B, 0 <= T, 0 <= L <= 1023.
// Returns a cudaError_t (0 = success).
int mdd_greedy_wer(const long long* ids, long long ids_sb, long long ids_st,
                   const long long* frames, const long long* targets,
                   long long tg_sb, long long tg_st,
                   const long long* target_sizes, const bool* valid, int B,
                   int T, int L, long long blank, long long* dist,
                   long long* counts, void* stream) {
  if (B < 1 || T < 0 || L < 0 || L > 1023) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* c = reinterpret_cast<unsigned long long*>(counts);
  const int cells = L + 1;
#define MDD_WER_LAUNCH(P)                                                   \
  return launch<P>(ids, ids_sb, ids_st, frames, targets, tg_sb, tg_st,      \
                   target_sizes, valid, B, T, L, blank, dist, c, s)
  if (cells <= 32) MDD_WER_LAUNCH(1);
  if (cells <= 64) MDD_WER_LAUNCH(2);
  if (cells <= 128) MDD_WER_LAUNCH(4);
  if (cells <= 256) MDD_WER_LAUNCH(8);
  if (cells <= 512) MDD_WER_LAUNCH(16);
  MDD_WER_LAUNCH(32);
#undef MDD_WER_LAUNCH
}

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
