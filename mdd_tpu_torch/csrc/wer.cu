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
// with target_sizes clamped to [0, L] where the distance is read.  Integers
// only, so the kernel equals the plain version exactly.
//
// Design.  One warp a row, no block barrier anywhere.
//   - The edit distance runs bit-parallel (Myers 1999, in Hyyro's form for
//     the global distance; ops/wer_cuda.edit_distance_bits is its plain
//     Python model).  After j kept tokens the distance column over the
//     target rows i = 0 .. L is kept as its vertical steps D[i] - D[i-1]:
//     VP (+1) and VN (-1), row i in bit i - 1.  Column 0 is D[i] = i: VP
//     all ones, VN zero.  A kept token with match mask Eq (bit i - 1 set
//     where target i - 1 is the token) costs ~15 word operations:
//       Xv = Eq | VN;   Xh = (((Eq & VP) + VP) ^ VP) | Eq
//       Ph = VN | ~(Xh | VP);   Mh = VP & Xh
//       Ph = Ph << 1 | 1;   Mh = Mh << 1       (row 0 gains one a token)
//       VP = Mh | ~(Xv | Ph);   VN = Ph & Xv
//     The add's carry does the insertion chain that a prefix-min over the
//     row did.  The distance at row `at` is pred_len + popc(VP & low(at))
//     - popc(VN & low(at)).  Rows past `at` never reach it: carries and
//     shifts only move up.
//   - L <= 64: one 64-bit word, which every lane of the warp carries alike,
//     so the token chain has no cross-lane step.  64 < L <= 1023: a word
//     a lane (W = ceil(L / 64) <= 16 lanes); the add's carry crosses the
//     words as a warp carry-lookahead (carry into word k = bit k of
//     (G + (G | P)) ^ (P & ~G), G and P the ballots of the words' carry-out
//     and all-ones sums) and the shifts' top bits by one shuffle.
//   - The match masks are taken off the chain.  Each warp builds, once a
//     row, a table in shared memory of the mask of every id in [0, 128)
//     (shared atomics over the targets); an id outside it scans the
//     targets itself.  The collapse walks the row's own frames in segments
//     of four chunks of 32 frames: a lane loads an id of each chunk (the
//     four loads in flight at once, the next segment's while this one's
//     chain runs), its left neighbour comes by a shuffle, a ballot gives
//     the kept lanes, and each kept lane copies its token's mask into the
//     warp's stage at its rank among the segment's kept tokens.  The chain
//     then reads the stage in order, unrolled by four (the reads ahead of
//     the steps).
//   - One launch a call: the last warp to finish (a ticket counter in the
//     library's device memory, which that warp resets) sums the valid rows'
//     distances and target sizes and writes the counts; the caller zeroes
//     nothing.  So launches of this kernel on one device must not overlap:
//     the port makes them from the train step's stream, one at a time.
//
// What bounds it on an H100: neither bytes nor operations.  At the train
// cell (B=64, T' <= 110, L <= 40) it reads ~80 KB and does ~10^5 integer
// operations, well under a microsecond either way; the time is a row's
// loads, its chain of dependent token steps (one a kept token, ~50 at
// T'=110), the ticket's two round trips and the launch.  The kernel it
// replaced kept the DP row of L + 1 cells in registers and spent 384
// cycles a kept token, 221 of them in eight dependent shuffles (the
// broadcast, the left neighbour, five prefix-min steps, the cell before),
// and took a caller-zeroed counts buffer (a fill launch): 0.0140 ms at
// B=64, T'=110, L=40 by CUDA-graph replays.  This one: 144 cycles a
// kept token, 53 of them the chain, 0.0065 ms in turns with it (python -m
// mdd_tpu_torch.ops.frame_stamps --kernel wer; H100 80GB HBM3, 700.00 W),
// within 0.0011 ms of its chain floor (-DMDD_WER_SKELETON).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kWordWarps = 4;     // rows a block while L <= 64
constexpr int kWordsWarps = 1;    // rows a block past it (W tables a warp)
constexpr int kTable = 128;       // ids [0, kTable) have a table entry
constexpr int kSegChunks = 4;     // chunks of 32 frames a segment
constexpr int kStage = 32 * kSegChunks;   // a segment's kept tokens, at most
constexpr int kMaxTarget = 1023;
constexpr unsigned kFull = 0xffffffffu;

__device__ unsigned int g_ticket;   // rows finished in the current launch

// Built with -DMDD_WER_STAMPS, thread MDD_STAMP_THREAD (0 unless given)
// of block 0 (a lane of row 0's warp) sums clock64() differences per
// phase in registers and adds them to g_stamps when it leaves (python -m
// mdd_tpu_torch.ops.frame_stamps --kernel wer reads them).
#ifdef MDD_WER_STAMPS
__device__ long long g_stamps[8];
#ifndef MDD_STAMP_THREAD
#define MDD_STAMP_THREAD 0
#endif
#define STAMP_START                                       \
  const bool stamping =                                   \
      blockIdx.x == 0 && threadIdx.x == MDD_STAMP_THREAD; \
  long long stamp_sum[8] = {};                            \
  long long stamp_last = clock64()
#define STAMP(p)                                          \
  do {                                                    \
    const long long now = clock64();                      \
    stamp_sum[p] += now - stamp_last;                     \
    stamp_last = now;                                     \
  } while (0)
#define STAMP_END                                                 \
  do {                                                            \
    if (stamping)                                                 \
      for (int p = 0; p < 8; ++p) g_stamps[p] += stamp_sum[p];    \
  } while (0)
#else
#define STAMP_START
#define STAMP(p)
#define STAMP_END
#endif

// one kept token on one 64-bit word (every lane alike)
__device__ __forceinline__ void word_step(u64& vp, u64& vn, u64 eq) {
#ifdef MDD_WER_SKELETON
  vp ^= eq;
#else
  const u64 xv = eq | vn;
  const u64 xh = (((eq & vp) + vp) ^ vp) | eq;
  u64 ph = vn | ~(xh | vp);
  u64 mh = vp & xh;
  ph = (ph << 1) | 1ull;
  mh <<= 1;
  vp = mh | ~(xv | ph);
  vn = ph & xv;
#endif
}

// one kept token on W words, word `lane` in this lane (lanes >= W carry
// words that no lower word reads)
__device__ __forceinline__ void words_step(u64& vp, u64& vn, u64 eq, int lane,
                                           unsigned live) {
#ifdef MDD_WER_SKELETON
  const unsigned gen = __ballot_sync(kFull, (eq & 1) != 0) & live;
  vp ^= eq ^ __shfl_up_sync(kFull, gen, 1);
#else
  const u64 x = eq & vp;
  u64 add = x + vp;
  const unsigned gen = __ballot_sync(kFull, add < x) & live;
  const unsigned prop = __ballot_sync(kFull, add == ~0ull) & live;
  const unsigned carry = (gen + (gen | prop)) ^ (prop & ~gen);
  add += (carry >> lane) & 1u;
  const u64 xv = eq | vn;
  const u64 xh = (add ^ vp) | eq;
  u64 ph = vn | ~(xh | vp);
  u64 mh = vp & xh;
  const unsigned top = static_cast<unsigned>(ph >> 63) |
                       (static_cast<unsigned>(mh >> 63) << 1);
  const unsigned below = __shfl_up_sync(kFull, top, 1);
  ph = (ph << 1) | (lane == 0 ? 1ull : static_cast<u64>(below & 1u));
  mh = (mh << 1) | (lane == 0 ? 0ull : static_cast<u64>(below >> 1));
  vp = mh | ~(xv | ph);
  vn = ph & xv;
#endif
}

template <bool kWords>
__global__ void __launch_bounds__((kWords ? kWordsWarps : kWordWarps) * 32)
greedy_wer_kernel(const long long* __restrict__ ids, long long ids_sb,
                  long long ids_st, const long long* __restrict__ frames,
                  const long long* __restrict__ targets, long long tg_sb,
                  long long tg_st, const long long* __restrict__ target_sizes,
                  const bool* __restrict__ valid, int B, int T, int L,
                  long long blank, long long* __restrict__ dist,
                  long long* __restrict__ counts) {
  // a warp's table (kTable ids x W words) and stage (kStage tokens x W
  // words)
  extern __shared__ u64 smem[];
  constexpr int kWarps = kWords ? kWordsWarps : kWordWarps;
  const int W = kWords ? (L + 63) / 64 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;  // the whole warp leaves together
  u64* const table = smem + warp * (kTable + kStage) * W;
  u64* const stage = table + kTable * W;
  const long long* const tg = targets + row * tg_sb;
  const long long* const id_row = ids + row * ids_sb;
  // every load that does not wait for another goes out first: the first
  // segment's ids (in bounds up to T), the frames and the target size
  long long id_next[kSegChunks];
#pragma unroll
  for (int c = 0; c < kSegChunks; ++c) {
    const int t = 32 * c + lane;
    id_next[c] = t < T ? id_row[t * ids_st] : blank;
  }
  long long n = frames[row];
  const long long ts = target_sizes[row];
  n = n < 0 ? 0 : (n > T ? T : n);

  STAMP_START;
  for (int i = lane; i < kTable * W; i += 32) table[i] = 0;
  __syncwarp();
  for (int j = lane; j < L; j += 32) {
    const long long y = tg[j * tg_st];
    if (y >= 0 && y < kTable)
      atomicOr(&table[y * W + (j >> 6)], 1ull << (j & 63));
  }
  __syncwarp();
  STAMP(3);

  const unsigned live = W >= 32 ? kFull : (1u << W) - 1u;
  u64 vp = ~0ull, vn = 0;
  long long pred_len = 0;
  long long prev_last = -1;  // the id of the frame before the chunk
  for (long long seg = 0; seg < n; seg += kStage) {
    long long id_seg[kSegChunks];
#pragma unroll
    for (int c = 0; c < kSegChunks; ++c) id_seg[c] = id_next[c];
    int count = 0;
#pragma unroll
    for (int c = 0; c < kSegChunks; ++c) {
      const long long t0 = seg + 32 * c;
      if (t0 >= n) break;  // uniform over the warp
      const long long t = t0 + lane;
      const long long id = id_seg[c];
      long long prev = __shfl_up_sync(kFull, id, 1);
      if (lane == 0) prev = prev_last;
      const bool keep = t < n && id != blank && id != prev;
      const unsigned kept = __ballot_sync(kFull, keep);
      prev_last = __shfl_sync(kFull, id, 31);
      if (keep) {
        u64* const out =
            stage + (count + __popc(kept & ((1u << lane) - 1u))) * W;
        if (id >= 0 && id < kTable) {
          for (int w = 0; w < W; ++w) out[w] = table[id * W + w];
        } else {  // no table entry: scan the targets
          for (int w = 0; w < W; ++w) out[w] = 0;
          for (int j = 0; j < L; ++j)
            if (tg[j * tg_st] == id) out[j >> 6] |= 1ull << (j & 63);
        }
      }
      count += __popc(kept);
    }
    __syncwarp();
    pred_len += count;
    // the next segment's ids, in flight while this segment's chain runs
    if (seg + kStage < n) {
#pragma unroll
      for (int c = 0; c < kSegChunks; ++c) {
        const long long t = seg + kStage + 32 * c + lane;
        id_next[c] = t < T ? id_row[t * ids_st] : blank;
      }
    }
    STAMP(0);
    if (kWords) {
#pragma unroll 2
      for (int k = 0; k < count; ++k)
        words_step(vp, vn, lane < W ? stage[k * W + lane] : 0ull, lane, live);
    } else {
#pragma unroll 4
      for (int k = 0; k < count; ++k) word_step(vp, vn, stage[k]);
    }
    STAMP(1);
    __syncwarp();  // the stage is read before the next segment writes it
  }

  const int at = static_cast<int>(ts < 0 ? 0 : (ts > L ? L : ts));
  int part;
  if (kWords) {
    const int k = at - 64 * lane;
    const u64 low = k <= 0 ? 0ull : (k >= 64 ? ~0ull : (1ull << k) - 1ull);
    part = lane < W ? __popcll(vp & low) - __popcll(vn & low) : 0;
    part = __reduce_add_sync(kFull, part);
  } else {
    const u64 low = at >= 64 ? ~0ull : (1ull << at) - 1ull;
    part = __popcll(vp & low) - __popcll(vn & low);
  }
  // the last warp to finish writes the counts
  unsigned last = 0;
  if (lane == 0) {
    dist[row] = pred_len + part;
    __threadfence();
    last = atomicAdd(&g_ticket, 1u) == static_cast<unsigned>(B - 1);
  }
  if (__shfl_sync(kFull, last, 0)) {
    __threadfence();
    long long errors = 0, tokens = 0;
    for (int r = lane; r < B; r += 32) {
      if (valid[r]) {
        errors += __ldcg(dist + r);
        tokens += target_sizes[r];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      errors += __shfl_xor_sync(kFull, errors, o);
      tokens += __shfl_xor_sync(kFull, tokens, o);
    }
    if (lane == 0) {
      counts[0] = errors;
      counts[1] = tokens;
      g_ticket = 0;
    }
  }
  STAMP(2);
  STAMP_END;
}

template <bool kWords>
cudaError_t launch(const long long* ids, long long ids_sb, long long ids_st,
                   const long long* frames, const long long* targets,
                   long long tg_sb, long long tg_st,
                   const long long* target_sizes, const bool* valid, int B,
                   int T, int L, long long blank, long long* dist,
                   long long* counts, cudaStream_t stream) {
  const int warps = kWords ? kWordsWarps : kWordWarps;
  const int words = kWords ? (L + 63) / 64 : 1;
  const int blocks = (B + warps - 1) / warps;
  const size_t smem = static_cast<size_t>(warps) * (kTable + kStage) *
                      words * sizeof(u64);
  greedy_wer_kernel<kWords><<<blocks, warps * 32, smem, stream>>>(
      ids, ids_sb, ids_st, frames, targets, tg_sb, tg_st, target_sizes, valid,
      B, T, L, blank, dist, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ids: (B, T) int64 with element strides (ids_sb, ids_st); frames,
// target_sizes: (B,) int64; targets: (B, L) int64 with strides (tg_sb,
// tg_st); valid: (B,) bool.  dist: (B,) int64 out; counts: 2 int64 out,
// (errors, tokens), written by the kernel.  1 <= B, 0 <= T, 0 <= L <= 1023.
// Returns a cudaError_t (0 = success).
int mdd_greedy_wer(const long long* ids, long long ids_sb, long long ids_st,
                   const long long* frames, const long long* targets,
                   long long tg_sb, long long tg_st,
                   const long long* target_sizes, const bool* valid, int B,
                   int T, int L, long long blank, long long* dist,
                   long long* counts, void* stream) {
  if (B < 1 || T < 0 || L < 0 || L > kMaxTarget) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 64)
    return launch<false>(ids, ids_sb, ids_st, frames, targets, tg_sb, tg_st,
                         target_sizes, valid, B, T, L, blank, dist, counts, s);
  return launch<true>(ids, ids_sb, ids_st, frames, targets, tg_sb, tg_st,
                      target_sizes, valid, B, T, L, blank, dist, counts, s);
}

#ifdef MDD_WER_STAMPS
const char* mdd_wer_stamp_names() {
  return "collapse and match masks,token chain,distance and counts,"
         "match table (once a row)";
}

// copies the cycle sums of block 0's stamping thread into out[0 .. n) and
// zeroes them
int mdd_wer_read_stamps(long long* out, int n) {
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
