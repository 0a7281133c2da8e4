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
//             descending sort (the lowest index first among equal values)
//   finish    (logaddexp(p_b, p_nb) + eos) / max(len, 1), the first
//             maximum, its prefix with zeros after it
//
// in the plain version's float order (ATen's logaddexp, m + log1p(exp(-|a -
// b|)); no fast math), so the sequences equal its sequences bit for bit
// where both run on the card.  The hashes wrap as uint32 (the plain
// version's int32 products, without C++'s signed overflow).
//
// Design: one block a row, its frame loop inside the block.
//   - A thread owns a candidate (two where K * (C + 1) > 1024): index i < K
//     is the stay of beam i, i >= K the extension (k, c) = divmod(i - K, C).
//     Each computes its value from the beam state in shared memory, with
//     no barrier until the selection.
//   - The merge needs no (K*C, K) matrix.  Live beams are distinct
//     prefixes, so an extension matches a stay only where parent + [c] is
//     that stay: the stay's thread solves c = h1(stay) - h1(k) * M1 - 1
//     for each parent k (K tries, not K * C), checks h2, and folds the
//     match in; an extension's thread compares its hashes with the K
//     stays to mask itself.  Dead beams (NEG_INF) may share hashes, so a
//     stay may see more than one match: it takes ATen's logsumexp (max,
//     then log of the sum of exp(v - max) plus the max); every term but
//     one live match is then exactly 1 or 0, so the sum is exact in any
//     order, and with a single match the result is the match itself.
//   - The K best: each warp ranks its 32 candidates by shuffles (31
//     compares a lane) and keeps its K best in shared memory; a second
//     pass ranks the warps' survivors against each other.  A global
//     top-K member is among its warp's K best, so the ranks among the
//     survivors are the global ranks for the K best.  Three barriers a
//     frame in all.
//   - The beam state (last, len, two hashes, p_b, p_nb), double-buffered,
//     the LM matrix ((V+1)^2 floats, 7.7 KB at 43 classes) and a chunk of
//     16 frames of log-probs live in shared memory.  Skipped frames cost a
//     compare, uniform over the block.
//   - No prefix is copied: each kept frame writes K back-pointers
//     (parent, label + 1 or 0) to global scratch, and one thread walks the
//     best beam's back from the last kept frame, from chunks staged in
//     shared memory, writing its labels from the end.
//
// What bounds it on an H100: neither bytes (the log-probs are read once,
// ~1.2 MB at B=64, T'=110, C=43) nor operations (~10^8 at that shape); the
// time is the chain of dependent frames a row, each three block barriers
// and a few hundred dependent instructions deep.  One block a row puts up
// to 132 rows in flight at once and keeps each frame inside an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxC = 64;
constexpr int kMaxV1 = 65;        // the LM matrix's side, V + 1
constexpr int kChunk = 16;        // frames of log-probs staged at once
constexpr int kBackChunk = 2048;  // back-pointers staged at once
constexpr float kNegInf = -1e30f;
constexpr uint32_t kMul1 = 1000003u;
constexpr uint32_t kMul2 = 2654435769u;
constexpr unsigned kFull = 0xffffffffu;

// ATen's logaddexp in float32
__device__ __forceinline__ float log_add(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// a ranks ahead of b in a stable descending sort (NaN first, as torch.sort
// and torch.argmax order it)
__device__ __forceinline__ bool ahead(float va, int ia, float vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

struct Beams {
  int last[kMaxK];
  int len[kMaxK];
  uint32_t h1[kMaxK];
  uint32_t h2[kMaxK];
  float pb[kMaxK];
  float pnb[kMaxK];
};

// the unmasked value of extension (k, c)
__device__ __forceinline__ float extension(const Beams& s, int k, int c,
                                          const float* lpt, const float* lm,
                                          int V1, int blank, bool prevdom) {
  if (c == blank) return kNegInf;
  const int lk = s.last[k];
  const float base =
      (lk == c && !prevdom) ? s.pb[k] : log_add(s.pb[k], s.pnb[k]);
  return (base + lpt[c]) + lm[lk * V1 + c];
}

template <int TILES>
__global__ void ctc_beam_kernel(const float* __restrict__ log_probs,
                                const long long* __restrict__ lengths,
                                const float* __restrict__ lm_matrix,
                                long long* __restrict__ out_prefix,
                                long long* __restrict__ out_len,
                                float* __restrict__ out_score,
                                uint16_t* __restrict__ back_all, int T, int C,
                                int V1, int K, int blank, float skip_thr,
                                float log09) {
  extern __shared__ float dyn[];
  __shared__ Beams st[2];
  __shared__ float stay_pb[kMaxK], stay_pnb[kMaxK], sel_val[kMaxK];
  __shared__ int sel_idx[kMaxK];
  __shared__ uint16_t back_s[kBackChunk];
  __shared__ int best_s, best_len_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  const int N = K * (C + 1);
  const int S = TILES * warps * K;
  const long long row = blockIdx.x;
  float* lm = dyn;                           // V1 * V1
  float* lp_s = lm + V1 * V1;                // kChunk * C
  float* surv_val = lp_s + kChunk * C;       // S
  int* surv_idx = reinterpret_cast<int*>(surv_val + S);  // S

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
  }
  // this thread's candidates: the stay index, or the extension's (k, c)
  int cand_k[TILES], cand_c[TILES];
#pragma unroll
  for (int u = 0; u < TILES; ++u) {
    const int e = u * nthreads + tid - K;
    cand_k[u] = e >= 0 ? e / C : 0;
    cand_c[u] = e >= 0 ? e % C : 0;
  }

  long long n = lengths[row];
  n = n < 0 ? 0 : (n > T ? T : n);
  const float* lp_row = log_probs + row * T * C;
  uint16_t* back = back_all + row * T * K;
  int cur = 0, active = 0;
  float prev_lpb = kNegInf;

  for (long long t0 = 0; t0 < n; t0 += kChunk) {
    const int frames = static_cast<int>(n - t0 < kChunk ? n - t0 : kChunk);
    __syncthreads();  // the last chunk is read (and the state written)
    for (int i = tid; i < frames * C; i += nthreads)
      lp_s[i] = lp_row[t0 * C + i];
    __syncthreads();
    for (int f = 0; f < frames; ++f) {
      const float* lpt = lp_s + f * C;
      const float lpb = lpt[blank];
      const bool prevdom = prev_lpb >= log09;
      prev_lpb = lpb;
      if ((1.0f - expf(lpb)) < skip_thr) continue;  // uniform: the state holds
      const Beams& s = st[cur];
      Beams& nx = st[cur ^ 1];

      // ---- every candidate's value ----
      float val[TILES];
#pragma unroll
      for (int u = 0; u < TILES; ++u) {
        const int i = u * nthreads + tid;
        if (i >= N) {
          val[u] = -INFINITY;  // a filler that ranks after every candidate
        } else if (i < K) {
          const float p_b = s.pb[i], p_nb = s.pnb[i];
          const float spb = log_add(p_b, p_nb) + lpt[blank];
          const int li = s.last[i];
          float spnb = s.len[i] > 0 ? p_nb + lpt[li < C - 1 ? li : C - 1]
                                    : kNegInf;
          // the extensions (k, c) with parent + [c] == this stay
          float m = 0.0f;
          int matches = 0;
          for (int k = 0; k < K; ++k) {
            const uint32_t c = s.h1[i] - s.h1[k] * kMul1 - 1u;
            if (c < static_cast<uint32_t>(C) &&
                s.h2[i] == s.h2[k] * kMul2 + c + 1u) {
              const float v = extension(s, k, static_cast<int>(c), lpt, lm,
                                        V1, blank, prevdom);
              m = matches++ ? fmaxf(m, v) : v;
            }
          }
          if (matches) {
            // ATen's logsumexp: a max of +-inf is taken as 0
            const float mm = isinf(m) ? 0.0f : m;
            float sum = 0.0f;
            for (int k = 0; k < K; ++k) {
              const uint32_t c = s.h1[i] - s.h1[k] * kMul1 - 1u;
              if (c < static_cast<uint32_t>(C) &&
                  s.h2[i] == s.h2[k] * kMul2 + c + 1u)
                sum += expf(extension(s, k, static_cast<int>(c), lpt, lm, V1,
                                      blank, prevdom) - mm);
            }
            spnb = log_add(spnb, logf(sum) + mm);
          }
          stay_pb[i] = spb;
          stay_pnb[i] = spnb;
          val[u] = log_add(spb, spnb);
        } else {
          const int k = cand_k[u], c = cand_c[u];
          float v = extension(s, k, c, lpt, lm, V1, blank, prevdom);
          const uint32_t h1 = s.h1[k] * kMul1 + static_cast<uint32_t>(c) + 1u;
          const uint32_t h2 = s.h2[k] * kMul2 + static_cast<uint32_t>(c) + 1u;
          for (int j = 0; j < K; ++j)
            if (h1 == s.h1[j] && h2 == s.h2[j]) v = kNegInf;
          val[u] = v;
        }
      }

      // ---- each warp's K best (fillers carry their own index >= N) ----
#pragma unroll
      for (int u = 0; u < TILES; ++u) {
        const int idx = u * nthreads + tid;
        int rank = 0;
        for (int d = 1; d < 32; ++d) {
          const int src = (lane + d) & 31;
          const float ov = __shfl_sync(kFull, val[u], src);
          const int oi = __shfl_sync(kFull, idx, src);
          rank += ahead(ov, oi, val[u], idx);
        }
        if (rank < K) {
          const int slot = (u * warps + warp) * K + rank;
          surv_val[slot] = val[u];
          surv_idx[slot] = idx;
        }
      }
      __syncthreads();

      // ---- the K best of the survivors, in order ----
      for (int q = tid; q < S; q += nthreads) {
        const float v = surv_val[q];
        const int ix = surv_idx[q];
        int rank = 0;
        for (int o = 0; o < S; ++o)
          rank += ahead(surv_val[o], surv_idx[o], v, ix);
        if (rank < K) {
          sel_idx[rank] = ix;
          sel_val[rank] = v;
        }
      }
      __syncthreads();

      // ---- the new beams, and their back-pointers ----
      if (tid < K) {
        const int ix = sel_idx[tid];
        uint16_t code;
        if (ix < K) {
          nx.last[tid] = s.last[ix];
          nx.len[tid] = s.len[ix];
          nx.h1[tid] = s.h1[ix];
          nx.h2[tid] = s.h2[ix];
          nx.pb[tid] = stay_pb[ix];
          nx.pnb[tid] = stay_pnb[ix];
          code = static_cast<uint16_t>(ix);
        } else {
          const int e = ix - K, k = e / C, c = e % C;
          nx.last[tid] = c;
          nx.len[tid] = s.len[k] + 1;
          nx.h1[tid] = s.h1[k] * kMul1 + static_cast<uint32_t>(c) + 1u;
          nx.h2[tid] = s.h2[k] * kMul2 + static_cast<uint32_t>(c) + 1u;
          nx.pb[tid] = kNegInf;
          nx.pnb[tid] = sel_val[tid];
          code = static_cast<uint16_t>(k | ((c + 1) << 8));
        }
        back[active * K + tid] = code;
      }
      ++active;
      cur ^= 1;
      __syncthreads();
    }
  }

  // ---- the EOS term, length normalisation, the first maximum ----
  __syncthreads();  // the state and the LM, where no frame was kept
  if (tid == 0) {
    const Beams& s = st[cur];
    int best = 0;
    float best_v = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float eos = s.len[k] > 0 ? lm[s.last[k] * V1 + V1 - 1] : 0.0f;
      const float norm = (log_add(s.pb[k], s.pnb[k]) + eos) /
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
  const int N = K * (C + 1);
  const int tiles = (N + 1023) / 1024;  // 1 or 2 within the limits
  const int threads = ((N + tiles - 1) / tiles + 31) / 32 * 32;
  const int S = tiles * (threads / 32) * K;
  const size_t smem = sizeof(float) * (V1 * V1 + kChunk * C + S) +
                      sizeof(int) * S;
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

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
