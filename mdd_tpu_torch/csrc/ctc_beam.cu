// The batched CTC prefix beam search in one launch, for Hopper (sm_90a).
//
// Replaces mdd_tpu/decode/beam_jit.py:60 `_beam_search_batch`.  That is no
// Pallas kernel: mdd_tpu compiles it into one device program, a lax.scan
// over the frames vmapped over the batch.  The port's plain version
// (decode/beam_jit.beam_search_batch) runs the scan as a Python loop of
// ~83 launches a frame.  Same function, frame for frame:
//
//   skip      (1 - exp(lp[t, blank])) < threshold, or t >= length: hold
//   stay      p_b' = logaddexp(p_b, p_nb) + lp[blank]
//             p_nb' = len > 0 ? p_nb + lp[last] : NEG_INF
//   extend    (k, c): (base + lp[c]) + lm[last_k, c], base = p_b when c
//             repeats last_k and p_{t-1}(blank) < 0.9, else p_total;
//             NEG_INF for the blank column
//   merge     an extension whose rolling hashes equal a stay's adds to
//             that stay's p_nb (masked log-sum-exp) and becomes NEG_INF
//   select    the K best of the K + K*C candidates, ordered as a stable
//             descending sort (the lowest index first among equal values,
//             NaN first)
//   finish    (logaddexp(p_b, p_nb) + eos) / max(len, 1), the first
//             maximum, its prefix with zeros after it
//
// in the plain version's float order (ATen's logaddexp, m + log1p(exp(-|a -
// b|)); no fast math), so the sequences and scores equal its own bit for
// bit where both run on the card.  The hashes wrap as uint32 (the plain
// version's int32 products, without C++'s signed overflow).
//
// What bounds it on an H100: neither bytes (the log-probs are read once,
// ~1.2 MB at B=64, T'=110, C=43) nor operations (~10^8 at that shape) but
// the chain of dependent frames a row, and within a frame the SM's issue
// rate: ~15 warps compute, sort and merge candidates between barriers.
// The kernel this one replaced took 7.67-7.75 us a frame at B=64, T'=110,
// K=10, C=43, 14,192 SM cycles, of which its stamps (-DMDD_CTC_BEAM_STAMPS,
// python -m mdd_tpu_torch.ops.frame_stamps --kernel beam) gave 53% to
// ranking the warps' survivors (each of 140 threads against all 140) and
// 30% to the candidate values; this one takes ~2.25 us a frame.  Its
// floor, the same launch with the same frame loop, barriers and shared-
// memory round trips and none of the arithmetic (-DMDD_CTC_BEAM_SKELETON),
// is ~0.68 us a frame (NVIDIA H100 80GB HBM3, 700.00 W, SM clock 1980
// MHz).
//
// Design: one block a row, its frame loop inside the block.
//   - A thread owns a candidate slot (two where 32 + K * C > 1024): the
//     first warp holds the K stays (the rest of it fillers), so that no
//     warp runs both paths, and slot 32 + e the extension e = (k, c) =
//     divmod(e, C).  Each computes its value from the beam state in
//     shared memory.  Each beam carries ptot = logaddexp(p_b, p_nb),
//     computed once when it is made, which the stays and extensions of
//     the next frame read instead of each taking the log-sum-exp again;
//     an extension's ptot (logaddexp(NEG_INF, v)) is v itself for every
//     finite v >= NEG_INF but 0, and is taken whole otherwise.
//   - The merge needs no (K*C, K) matrix.  Live beams are distinct
//     prefixes, so an extension matches a stay only where parent + [c] is
//     that stay: the stay's thread solves c = h1(stay) - h1(k) * M1 - 1
//     for each parent k (h1 read 16 bytes at a time), checks h2 for the
//     few that give a class, and folds the matches in (dead stays too, as
//     the plain version merges them); an extension's
//     thread compares its h1 with the K stays' (16-byte loads) and both
//     hashes only where one matched, to mask itself.  Dead beams
//     (NEG_INF) may share hashes, so a stay may see more than one match:
//     it takes ATen's logsumexp (max, then log of the sum of exp(v - max)
//     plus the max); every term but one live match is then exactly 1 or 0,
//     so the sum is exact in any order, and a single finite, non-zero
//     match is the match itself (log(exp(0)) + m = m).
//   - The selection is a sort network.  Each candidate gets one 64-bit
//     key, its value's bits mapped to an order-preserving uint32 (NaN
//     above everything, -0 as +0) over the complement of its index, so
//     that one integer compare is the stable sort's order.  Each warp
//     sorts its 32 keys by a bitonic network of shuffles (15
//     compare-exchange stages; two tiles merge in the warp), then a merge
//     tree over the warps: at each level warp w + step hands its top 16 to
//     warp w through shared memory and a barrier, and warp w merges the
//     two sorted lists by a bitonic merge (5 stages).  A global top-K
//     member is among its warp's top 16, so warp 0's lanes end holding the
//     K best in order; lane r writes new beam r and its back-pointer, and
//     a barrier closes the frame: ceil(log2(warps)) + 1 barriers a kept
//     frame (5 at K=10, C=43).
//   - The beam state (last, len, two hashes, p_b, p_nb, ptot),
//     double-buffered, the LM matrix ((V+1)^2 floats, 7.7 KB at 43
//     classes) and two chunks of 16 frames of log-probs live in shared
//     memory: the next chunk is copied with cp.async while the current one
//     runs.  Skipped frames cost a compare, uniform over the block.
//   - No prefix is copied: each kept frame writes K back-pointers
//     (parent, label + 1 or 0) to global scratch, and one thread walks the
//     best beam's back from the last kept frame, from chunks staged in
//     shared memory, writing its labels from the end.
//
// Tried and dropped: two barriers a frame, each survivor counting the keys
// above its own in every warp's list by binary searches (3.73 us a frame:
// 16 searches of 5 dependent 8-byte loads a survivor took 2,457 of a
// frame's 6,433 cycles); __launch_bounds__(1024) (ptxas held the kernel to
// 32 registers and spilled; without it 36-37, no spill, 0.2511 against
// 0.2630 ms).  Not tried: fewer threads a row.  At B=512 the 480-thread
// block fits 3 to an SM by its registers, so 116 of 512 rows run in a
// second wave (5.27 us a frame against 2.25 at B=64).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxC = 64;
constexpr int kMaxV1 = 65;        // the LM matrix's side, V + 1
constexpr int kChunk = 16;        // frames of log-probs staged at once
constexpr int kList = 16;         // a warp's best keys, passed up the tree
constexpr int kBackChunk = 2048;  // back-pointers staged at once
constexpr float kNegInf = -1e30f;
constexpr uint32_t kMul1 = 1000003u;
constexpr uint32_t kMul2 = 2654435769u;
constexpr unsigned kFull = 0xffffffffu;

using Key = unsigned long long;

// Built with -DMDD_CTC_BEAM_STAMPS, thread MDD_STAMP_THREAD (0 unless
// given) of block 0 sums clock64() differences per phase in registers and
// adds them to g_stamps when it leaves (python -m
// mdd_tpu_torch.ops.frame_stamps reads them).
#ifdef MDD_CTC_BEAM_STAMPS
__device__ long long g_stamps[8];
#ifndef MDD_STAMP_THREAD
#define MDD_STAMP_THREAD 0
#endif
#define STAMP_START                                     \
  const bool stamping =                                 \
      blockIdx.x == 0 && threadIdx.x == MDD_STAMP_THREAD; \
  long long stamp_sum[8] = {};                          \
  long long stamp_last = clock64()
#define STAMP(p)                                        \
  do {                                                  \
    const long long now = clock64();                    \
    stamp_sum[p] += now - stamp_last;                   \
    stamp_last = now;                                   \
  } while (0)
#define STAMP_END                                       \
  do {                                                  \
    if (stamping)                                       \
      for (int p = 0; p < 8; ++p) g_stamps[p] += stamp_sum[p]; \
  } while (0)
#else
#define STAMP_START
#define STAMP(p)
#define STAMP_END
#endif

// ATen's logaddexp in float32; both at NEG_INF give NEG_INF exactly (-1e30
// + log 2 rounds to -1e30), without the exp and the log
__device__ __forceinline__ float log_add(float a, float b) {
  if (a == kNegInf && b == kNegInf) return kNegInf;
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// log_add(NEG_INF, v): v itself where v is finite, >= NEG_INF and not 0
// (the gap is >= 7e22, so exp gives 0, log1p 0, and v + 0 is v)
__device__ __forceinline__ float log_add_neg_inf(float v) {
  return (isfinite(v) && v >= kNegInf && v != 0.0f) ? v
                                                      : log_add(kNegInf, v);
}

// a ranks ahead of b in a stable descending sort (NaN first, as torch.sort
// and torch.argmax order it)
__device__ __forceinline__ bool ahead(float va, int ia, float vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

// a candidate's sort key: key(a) > key(b) iff ahead(a, b).  The value's
// bits map to an order-preserving uint32 (NaN above +inf, -0 as +0), the
// index's complement breaks ties; no key is 0.
__device__ __forceinline__ Key sort_key(float v, int idx) {
  uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = isnan(v) ? 0xffffffffu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  return (static_cast<Key>(u) << 32) |
         (0xffffffffu - static_cast<uint32_t>(idx));
}

__device__ __forceinline__ int key_index(Key key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

// one compare-exchange with lane ^ j: the larger key where take_max, else
// the smaller (the keys of a block are distinct)
__device__ __forceinline__ Key exchange(Key key, int j, bool take_max) {
  const Key other = __shfl_xor_sync(kFull, key, j);
  return (other > key) == take_max ? other : key;
}

// the warp's 32 keys in descending order over its lanes (bitonic): runs of
// k lanes alternate in direction, the last (k = 32) descends
__device__ __forceinline__ Key warp_sort(Key key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
      key = exchange(key, j, ((lane & j) == 0) == ((lane & k) == 0));
  }
  return key;
}

// a bitonic warp of keys (lanes 0-15 descending, 16-31 ascending) in
// descending order over its lanes: the top 16 of two sorted lists
__device__ __forceinline__ Key warp_merge(Key key, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) key = exchange(key, j, (lane & j) == 0);
  return key;
}

// count floats from global to shared memory, 4 bytes a copy, in flight
// until cp_async_wait
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src,
                                                int count, int tid,
                                                int nthreads) {
  for (int i = tid; i < count; i += nthreads) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a beam: its prefix's last label, length and two hashes, p_b, p_nb and
// ptot = log_add(p_b, p_nb), computed once when the beam is made
struct __align__(16) Beams {
  int last[kMaxK];
  int len[kMaxK];
  uint32_t h1[kMaxK];
  uint32_t h2[kMaxK];
  float pb[kMaxK];
  float pnb[kMaxK];
  float ptot[kMaxK];
};

// the unmasked value of extension (k, c)
__device__ __forceinline__ float extension(const Beams& s, int k, int c,
                                          const float* lpt, const float* lm,
                                          int V1, int blank, bool prevdom) {
  if (c == blank) return kNegInf;
  const int lk = s.last[k];
  const float base = (lk == c && !prevdom) ? s.pb[k] : s.ptot[k];
  return (base + lpt[c]) + lm[lk * V1 + c];
}

// stay i's value, its p_b and p_nb (the matching extensions merged in)
__device__ __forceinline__ float stay(const Beams& s, int i, int K, int C,
                                      const float* lpt, const float* lm,
                                      int V1, int blank, bool prevdom,
                                      float* spb_out, float* spnb_out) {
  const float p_nb = s.pnb[i];
  const float spb = s.ptot[i] + lpt[blank];
  const int li = s.last[i];
  float spnb = s.len[i] > 0 ? p_nb + lpt[li < C - 1 ? li : C - 1] : kNegInf;
  // the extensions (k, c) with parent + [c] == this stay: the parents
  // whose h1 gives a class, then h2 checked for those
  const uint32_t h1 = s.h1[i], h2 = s.h2[i];
  const uint4* beam_h1 = reinterpret_cast<const uint4*>(s.h1);
  unsigned mask = 0;
#pragma unroll
  for (int q = 0; q < kMaxK / 4; ++q) {
    const uint4 w = beam_h1[q];
    mask |= (h1 - w.x * kMul1 - 1u < static_cast<uint32_t>(C)) << (4 * q);
    mask |= (h1 - w.y * kMul1 - 1u < static_cast<uint32_t>(C)) << (4 * q + 1);
    mask |= (h1 - w.z * kMul1 - 1u < static_cast<uint32_t>(C)) << (4 * q + 2);
    mask |= (h1 - w.w * kMul1 - 1u < static_cast<uint32_t>(C)) << (4 * q + 3);
  }
  mask &= (1u << K) - 1;
  for (unsigned r = mask; r; r &= r - 1) {
    const int k = __ffs(r) - 1;
    if (h2 != s.h2[k] * kMul2 + (h1 - s.h1[k] * kMul1 - 1u) + 1u)
      mask &= ~(1u << k);
  }
  if (mask) {
    float m = 0.0f, first = 0.0f;
    for (unsigned r = mask; r; r &= r - 1) {
      const int k = __ffs(r) - 1;
      const float v = extension(s, k, static_cast<int>(h1 - s.h1[k] * kMul1 -
                                                       1u),
                                lpt, lm, V1, blank, prevdom);
      if (r == mask) first = m = v;
      else m = fmaxf(m, v);
    }
    // ATen's logsumexp: a max of +-inf is taken as 0; the terms summed in
    // k order from 0.  A single finite, non-zero term is exact: log(exp(0))
    // + m = m.
    float gain = first;
    if ((mask & (mask - 1)) || !isfinite(first) || first == 0.0f) {
      const float mm = isinf(m) ? 0.0f : m;
      float sum = expf(first - mm);
      if (mask & (mask - 1)) {
        sum = 0.0f;
        for (unsigned r = mask; r; r &= r - 1) {
          const int k = __ffs(r) - 1;
          sum += expf(extension(s, k, static_cast<int>(h1 - s.h1[k] * kMul1 -
                                                       1u),
                                lpt, lm, V1, blank, prevdom) - mm);
        }
      }
      gain = logf(sum) + mm;
    }
    spnb = log_add(spnb, gain);
  }
  *spb_out = spb;
  *spnb_out = spnb;
  return log_add(spb, spnb);
}

template <int TILES>
__global__ void ctc_beam_kernel(const float* __restrict__ log_probs,
                                const long long* __restrict__ lengths,
                                const float* __restrict__ lm_matrix,
                                long long* __restrict__ out_prefix,
                                long long* __restrict__ out_len,
                                float* __restrict__ out_score,
                                uint16_t* __restrict__ back_all, int T,
                                int C, int V1, int K, int blank,
                                float skip_thr, float log09) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Beams st[2];
  __shared__ float stay_pb[kMaxK], stay_pnb[kMaxK], stay_val[kMaxK];
  __shared__ uint16_t back_s[kBackChunk];
  __shared__ int best_s, best_len_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  const int N = K * (C + 1);
  const long long row = blockIdx.x;
  Key* list = reinterpret_cast<Key*>(dyn);              // warps * kList
  float* lm = reinterpret_cast<float*>(list + warps * kList);  // V1 * V1
  float* lp_s = lm + V1 * V1;                  // 2 chunks of kChunk * C
  float* ext_val = lp_s + 2 * kChunk * C;      // K * C, the extensions'
  float* ext_ptot = ext_val + K * C;           // K * C, their ptot

  long long n = lengths[row];
  n = n < 0 ? 0 : (n > T ? T : n);
  const float* lp_row = log_probs + row * T * C;
  uint16_t* back = back_all + row * T * K;
  // the first chunk in flight while the LM and the state are set
  cp_async_floats(lp_s, lp_row, static_cast<int>(n < kChunk ? n : kChunk) * C,
                  tid, nthreads);
  for (int i = tid; i < V1 * V1; i += nthreads) lm[i] = lm_matrix[i];
  if (tid < K) {
    // beam 0 the empty prefix, the others dead with distinct hashes
    const uint32_t h = tid == 0 ? 1u : static_cast<uint32_t>(-1 - tid);
    st[0].last[tid] = V1 - 1;
    st[0].len[tid] = 0;
    st[0].h1[tid] = h;
    st[0].h2[tid] = h;
    st[0].pb[tid] = tid == 0 ? 0.0f : kNegInf;
    st[0].pnb[tid] = kNegInf;
    st[0].ptot[tid] = log_add(st[0].pb[tid], kNegInf);
  }
  // this thread's candidates: slot z = u * nthreads + tid; the first warp
  // holds the stays (z < K; the rest of it fillers), so that no warp runs
  // both paths; slot z >= 32 is extension e = z - 32 = (k, c) = divmod(e,
  // C).  A candidate's index in the sort is i < K for stay i, K + e for
  // extension e and N + z for a filler.
  int cand_k[TILES], cand_c[TILES];
#pragma unroll
  for (int u = 0; u < TILES; ++u) {
    const int e = u * nthreads + tid - 32;
    cand_k[u] = e >= 0 ? e / C : 0;
    cand_c[u] = e >= 0 ? e % C : 0;
  }

  int cur = 0, active = 0, buf = 0;
  float prev_lpb = kNegInf;
  STAMP_START;

  for (long long t0 = 0; t0 < n; t0 += kChunk, buf ^= 1) {
    const int frames = static_cast<int>(n - t0 < kChunk ? n - t0 : kChunk);
    cp_async_wait();
    // this chunk has landed; the other buffer is read and the state
    // written: stage the next chunk there
    __syncthreads();
    if (t0 + kChunk < n) {
      const long long rest = n - t0 - kChunk;
      cp_async_floats(lp_s + (buf ^ 1) * kChunk * C,
                      lp_row + (t0 + kChunk) * C,
                      static_cast<int>(rest < kChunk ? rest : kChunk) * C,
                      tid, nthreads);
    }
    STAMP(5);
    const float* lp_chunk = lp_s + buf * kChunk * C;
    for (int f = 0; f < frames; ++f) {
      const float* lpt = lp_chunk + f * C;
      const float lpb = lpt[blank];
      const bool prevdom = prev_lpb >= log09;
      prev_lpb = lpb;
      if ((1.0f - expf(lpb)) < skip_thr) {  // uniform: the state holds
        STAMP(5);
        continue;
      }
      const Beams& s = st[cur];
      Beams& nx = st[cur ^ 1];

      // ---- every candidate's value and key ----
      Key key[TILES];
#pragma unroll
      for (int u = 0; u < TILES; ++u) {
        const int z = u * nthreads + tid, e = z - 32;
        float v = -INFINITY;  // a filler ranks after every candidate
        int i = N + z;
        if (z < K) {
          i = z;
#ifdef MDD_CTC_BEAM_SKELETON
          v = s.pb[i];
          stay_pb[i] = stay_pnb[i] = stay_val[i] = v;
#else
          float spb, spnb;
          v = stay(s, i, K, C, lpt, lm, V1, blank, prevdom, &spb, &spnb);
          stay_pb[i] = spb;
          stay_pnb[i] = spnb;
          stay_val[i] = v;
#endif
        } else if (e >= 0 && e < K * C) {
          i = K + e;
#ifdef MDD_CTC_BEAM_SKELETON
          v = s.pnb[cand_k[u]];
          ext_val[e] = ext_ptot[e] = v;
#else
          const int k = cand_k[u], c = cand_c[u];
          v = extension(s, k, c, lpt, lm, V1, blank, prevdom);
          // merged into a stay with both its hashes: a first pass over
          // h1 in 16-byte loads (the slots past K may hold anything), then
          // the exact test where one matched
          const uint32_t h1 = s.h1[k] * kMul1 + static_cast<uint32_t>(c) + 1u;
          const uint4* beam_h1 = reinterpret_cast<const uint4*>(s.h1);
          bool any = false;
#pragma unroll
          for (int q = 0; q < kMaxK / 4; ++q) {
            const uint4 w = beam_h1[q];
            any |= (w.x == h1) | (w.y == h1) | (w.z == h1) | (w.w == h1);
          }
          if (any) {
            const uint32_t h2 =
                s.h2[k] * kMul2 + static_cast<uint32_t>(c) + 1u;
            for (int j = 0; j < K; ++j)
              if (h1 == s.h1[j] && h2 == s.h2[j]) v = kNegInf;
          }
          ext_val[e] = v;
          ext_ptot[e] = log_add_neg_inf(v);  // the new beam's, if chosen
#endif
        }
        key[u] = sort_key(v, i);
      }
      STAMP(0);

      // ---- the K best: each warp sorts its keys, a merge tree over the
      // warps leaves them in order in warp 0 ----
#ifdef MDD_CTC_BEAM_SKELETON
      Key best = key[0];
#else
      Key best = warp_sort(key[0], lane);
#pragma unroll
      for (int u = 1; u < TILES; ++u) {
        // the second tile's top 16, ascending, in lanes 16-31
        const Key other =
            __shfl_sync(kFull, warp_sort(key[u], lane), 31 - lane);
        if (lane >= 16) best = other;
        best = warp_merge(best, lane);
      }
#endif
      STAMP(1);
      for (int step = 1; step < warps; step <<= 1) {
        // warp w + step hands its top 16 to warp w (w a multiple of 2 step)
        const int role = warp & (2 * step - 1);
        if (role == step && lane < kList) list[warp * kList + lane] = best;
        __syncthreads();
        if (role == 0 && warp + step < warps) {
          if (lane >= 16) best = list[(warp + step) * kList + 31 - lane];
#ifndef MDD_CTC_BEAM_SKELETON
          best = warp_merge(best, lane);
#endif
        }
      }
      STAMP(2);

      // ---- lane r of warp 0 holds the r-th best: new beam r ----
      if (warp == 0 && lane < K) {
        const int rank = lane, ix = key_index(best);
        uint16_t code;
        if (ix < K) {
          nx.last[rank] = s.last[ix];
          nx.len[rank] = s.len[ix];
          nx.h1[rank] = s.h1[ix];
          nx.h2[rank] = s.h2[ix];
          nx.pb[rank] = stay_pb[ix];
          nx.pnb[rank] = stay_pnb[ix];
          nx.ptot[rank] = stay_val[ix];
          code = static_cast<uint16_t>(ix);
        } else {
          const int e = ix - K, k = e / C, c = e % C;
          nx.last[rank] = c;
          nx.len[rank] = s.len[k] + 1;
          nx.h1[rank] = s.h1[k] * kMul1 + static_cast<uint32_t>(c) + 1u;
          nx.h2[rank] = s.h2[k] * kMul2 + static_cast<uint32_t>(c) + 1u;
          nx.pb[rank] = kNegInf;
          nx.pnb[rank] = ext_val[e];
          nx.ptot[rank] = ext_ptot[e];
          code = static_cast<uint16_t>(k | ((c + 1) << 8));
        }
        back[active * K + rank] = code;
      }
      ++active;
      cur ^= 1;
      STAMP(3);
      __syncthreads();
      STAMP(4);
    }
  }

  // ---- the EOS term, length normalisation, the first maximum ----
  cp_async_wait();
  __syncthreads();  // the state and the LM, where no frame was kept
  if (tid == 0) {
    const Beams& s = st[cur];
    int best = 0;
    float best_v = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float eos = s.len[k] > 0 ? lm[s.last[k] * V1 + V1 - 1] : 0.0f;
      const float norm = (s.ptot[k] + eos) /
                         static_cast<float>(s.len[k] > 1 ? s.len[k] : 1);
      if (k == 0 || ahead(norm, k, best_v, best)) {
        best = k;
        best_v = norm;
      }
    }
    best_s = best;
    best_len_s = s.len[best];
    out_len[row] = s.len[best];
    out_score[row] = best_v;
  }
  __syncthreads();
  const int best_len = best_len_s;
  long long* out = out_prefix + row * T;
  for (int p = best_len + tid; p < T; p += nthreads) out[p] = 0;
  // walk the back-pointers from the last kept frame, a staged chunk at a
  // time (the loop bounds are the same in every thread)
  int beam = best_s, pos = best_len;
  const int per = kBackChunk / K;
  for (int hi = active; hi > 0; hi -= per) {
    const int lo = hi - per > 0 ? hi - per : 0;
    __syncthreads();
    for (int i = tid; i < (hi - lo) * K; i += nthreads)
      back_s[i] = back[lo * K + i];
    __syncthreads();
    if (tid == 0) {
      for (int a = hi - 1; a >= lo; --a) {
        const uint16_t code = back_s[(a - lo) * K + beam];
        if (code >> 8) out[--pos] = (code >> 8) - 1;
        beam = code & 0xff;
      }
    }
  }
  STAMP_END;
}

}  // namespace

extern "C" {

// log_probs: (B, T, C) float32; lengths: (B,) int64; lm_matrix: (V1, V1)
// float32, V1 = V + 1 (row V the <s> history, column V the </s> term);
// out_prefix: (B, T) int64, out_len: (B,) int64 and out_score: (B,) float32
// (the best beam's normalised score) out; back: B * T * K
// uint16 of scratch.  All contiguous.  1 <= K <= 16, 1 <= C <= 64,
// C <= V1 <= 65, 0 <= blank < C.  Returns a cudaError_t (0 = success).
int mdd_ctc_beam(const float* log_probs, const long long* lengths,
                 const float* lm_matrix, long long* out_prefix,
                 long long* out_len, float* out_score, uint16_t* back, int B,
                 int T, int C,
                 int V1, int K, int blank, float skip_thr, float log09,
                 void* stream) {
  if (B < 1 || T < 0 || K < 1 || K > kMaxK || C < 1 || C > kMaxC || V1 < C ||
      V1 > kMaxV1 || blank < 0 || blank >= C)
    return cudaErrorInvalidValue;
  // a warp of stays, then the K * C extensions
  const int slots = 32 + K * C;
  const int tiles = (slots + 1023) / 1024;  // 1 or 2 within the limits
  const int threads = ((slots + tiles - 1) / tiles + 31) / 32 * 32;
  const size_t smem = sizeof(Key) * (threads / 32) * kList +
                      sizeof(float) * (V1 * V1 + 2 * kChunk * C + 2 * K * C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles == 1)
    ctc_beam_kernel<1><<<B, threads, smem, s>>>(
        log_probs, lengths, lm_matrix, out_prefix, out_len, out_score, back, T,
        C, V1, K, blank, skip_thr, log09);
  else
    ctc_beam_kernel<2><<<B, threads, smem, s>>>(
        log_probs, lengths, lm_matrix, out_prefix, out_len, out_score, back, T,
        C, V1, K, blank, skip_thr, log09);
  return cudaGetLastError();
}

#ifdef MDD_CTC_BEAM_STAMPS
const char* mdd_ctc_beam_stamp_names() {
  return "candidate values,warp sort,merge tree (its barriers),state write,"
         "frame barrier,chunk staging + skipped frames";
}

// copies the cycle sums of block 0 into out[0 .. n) and zeroes them
int mdd_ctc_beam_read_stamps(long long* out, int n) {
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
