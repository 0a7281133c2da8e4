// The CTC loss's two recursions and its gradient, for Hopper (sm_90a).
//
// Replaces mdd_tpu/ops/ctc_loss.py's `_alpha_scan` (:69) and `_beta_scan`
// (:113) with `_ctc_bwd` (:196), the custom VJP of `ctc_loss`.  Neither is
// a Pallas kernel: mdd_tpu compiles each into its jitted train step as one
// lax.scan over the frames.  The same function, over the extended
// (blank-interleaved) labels ext = [blank, y1, blank, y2, ..., blank] of
// S = 2L + 1 slots:
//
//   alpha_0(s)  = lp_0(ext[s]) for s = 0, and s = 1 if the row has labels
//   alpha_t(s)  = lse3(alpha(s), alpha(s-1), alpha(s-2) if skip(s))
//                 + lp_t(ext[s])                      for 1 <= t < len
//   nll         = -log(alpha(2l) + alpha(2l-1))        (the last alpha)
//   beta_{len-1}(s) = lp(ext[s]) at s = 2l and 2l-1, the floor elsewhere
//   beta_t(s)   = lse3(beta(s), beta(s+1), beta(s+2) if skip(s+2)) + lp
//   dlp_t(c)    = -g * sum_{s: ext[s]=c} exp(min(alpha + beta - lp + nll,
//                 20)),  0 where alpha or beta is at the floor, at
//                 t >= len and on infeasible rows (nll >= 5e29)
//
// with mdd_tpu's floor arithmetic kept exactly: LOG_EPS = -1e30 and an
// lse3 that returns the floor when its max is <= -5e29; frame 0's emission
// is counted at every input length, 0 included, as mdd_tpu's alpha0 is.
// Lengths are clamped to [0, T] and [0, L]; an id outside [0, C) emits 0
// (mdd_tpu's one-hot row of zeros).  Accurate expf / logf, no fast math.
//
// Design.  One block an utterance, a thread a slot, its frame loop inside.
//   - ctc_alpha: alpha double-buffered in shared memory, one barrier a
//     frame, the loop run only to the row's own input length; each frame's
//     alphas written to (T, B, S) for the backward, nll by thread 0.  The
//     next frame's emission is loaded before the current frame's sum.
//   - ctc_beta_grad: t from len-1 down to 0, beta and the posterior weights
//     double-buffered in shared memory, one barrier a frame; after it one
//     thread a class sums its class's slots in slot order (deterministic, no
//     float atomics) and writes dlog_probs[t, b, :].  Every entry of the
//     output is written, the zero frames and rows too.
//
// What bounds it on an H100: neither bytes nor operations.  At the train
// cell (B=64, T' <= 110, L <= 40) each kernel moves ~2-5 MB and does ~10^7
// float operations, a microsecond or two either way; the time is the chain
// of dependent frames a row (one barrier, an lse3 and a shared-memory
// round trip each) and the launch.  One block a row keeps the whole chain
// on one SM with no grid-wide barrier; 64 rows fill half the SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogEps = -1e30f;
constexpr float kFloorCut = kLogEps / 2;   // -5e29
constexpr int kMaxSlots = 1023;
constexpr int kMaxClasses = 1024;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float out = m + logf((expf(a - m) + expf(b - m)) + expf(c - m));
  return m <= kFloorCut ? kLogEps : out;
}

__device__ __forceinline__ float emission(const float* lp_t, long long id,
                                          int C) {
  return (id >= 0 && id < C) ? lp_t[id] : 0.f;
}

__device__ __forceinline__ long long clamp_len(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ long long ext_at(const long long* labels,
                                            long long lab_sb, long long lab_sl,
                                            int b, int s, long long blank) {
  return (s & 1) ? labels[b * lab_sb + (s >> 1) * lab_sl] : blank;
}

__global__ void ctc_alpha_kernel(
    const float* __restrict__ lp, long long lp_st, long long lp_sb,
    const long long* __restrict__ input_lengths,
    const long long* __restrict__ labels, long long lab_sb, long long lab_sl,
    const long long* __restrict__ label_lengths, int T, int B, int C, int L,
    long long blank, float* __restrict__ alphas, float* __restrict__ nll) {
  extern __shared__ float buf[];        // 2 S floats: alpha, double-buffered
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool in_s = s < S;
  float* const buf0 = buf;
  float* const buf1 = buf + S;
  const long long len = clamp_len(input_lengths[b], T);
  const long long ll = clamp_len(label_lengths[b], L);

  long long ext = blank;
  bool can_skip = false;
  if (in_s) {
    ext = ext_at(labels, lab_sb, lab_sl, b, s, blank);
    const long long ext_m2 = s >= 2 ? ext_at(labels, lab_sb, lab_sl, b, s - 2,
                                             blank)
                                    : blank;
    can_skip = ext != blank && ext != ext_m2 && s >= 2;
  }
  const bool valid = s < 2 * ll + 1;
  const float* lp_b = lp + b * lp_sb;
  float* out = alphas + static_cast<size_t>(b) * S;
  const size_t out_st = static_cast<size_t>(B) * S;

  if (in_s) {
    float a = kLogEps;
    if (s == 0 || (s == 1 && ll > 0)) a = emission(lp_b, ext, C);
    buf0[s] = a;
    out[s] = a;
  }
  float e_next = (in_s && len > 1) ? emission(lp_b + lp_st, ext, C) : 0.f;
  __syncthreads();
  for (long long t = 1; t < len; ++t) {
    const float* cur = (t & 1) ? buf0 : buf1;   // frame t - 1
    float* nxt = (t & 1) ? buf1 : buf0;
    const float e = e_next;
    if (in_s && t + 1 < len) e_next = emission(lp_b + (t + 1) * lp_st, ext, C);
    if (in_s) {
      const float x0 = cur[s];
      const float x1 = s >= 1 ? cur[s - 1] : kLogEps;
      const float x2 = can_skip ? cur[s - 2] : kLogEps;
      const float v = valid ? lse3(x0, x1, x2) + e : kLogEps;
      nxt[s] = v;
      out[t * out_st + s] = v;
    }
    __syncthreads();
  }
  if (s == 0) {
    const float* fin = (len >= 2 && ((len - 1) & 1)) ? buf1 : buf0;
    const int end = static_cast<int>(2 * ll);
    const float last = fin[end];
    const float second = end >= 1 ? fin[end - 1] : kLogEps;
    const float m = fmaxf(last, second);
    float l = m + logf(expf(last - m) + expf(second - m));
    if (m <= kFloorCut) l = kLogEps;
    nll[b] = -l;
  }
}

__global__ void ctc_beta_grad_kernel(
    const float* __restrict__ lp, long long lp_st, long long lp_sb,
    const long long* __restrict__ input_lengths,
    const long long* __restrict__ labels, long long lab_sb, long long lab_sl,
    const long long* __restrict__ label_lengths, int T, int B, int C, int L,
    long long blank, const float* __restrict__ alphas,
    const float* __restrict__ nll, const float* __restrict__ g,
    float* __restrict__ grad, long long gr_st, long long gr_sb) {
  // beta and the posterior weights, each double-buffered (4 S floats),
  // then the extended labels (S int64, 8-byte aligned after 16 S bytes)
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  float* const beta0 = smem;
  float* const beta1 = smem + S;
  float* const w0 = smem + 2 * S;
  float* const w1 = smem + 3 * S;
  long long* const ext_sm = reinterpret_cast<long long*>(smem + 4 * S);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long len = clamp_len(input_lengths[b], T);
  const long long ll = clamp_len(label_lengths[b], L);
  const float nl = nll[b];
  const float gb = g[b];
  float* const grad_b = grad + b * gr_sb;

  // the frames with no gradient: t >= len, or all of them on a row no
  // alignment fits
  const bool feasible = nl < -kLogEps / 2;
  for (long long t = feasible ? len : 0; t < T; ++t)
    for (int c = tid; c < C; c += blockDim.x) grad_b[t * gr_st + c] = 0.f;
  if (!feasible || len == 0) return;    // the whole block

  const bool in_s = tid < S;
  if (in_s) ext_sm[tid] = ext_at(labels, lab_sb, lab_sl, b, tid, blank);
  __syncthreads();
  const long long ext = in_s ? ext_sm[tid] : blank;
  // a transition s -> s + 2 is allowed iff a skip into s + 2 is
  const bool skip_p2 = in_s && tid + 2 < S && ext_sm[tid + 2] != blank &&
                       ext_sm[tid + 2] != ext;
  const bool valid = tid < 2 * ll + 1;
  const long long end = 2 * ll;
  const bool terminal = tid == end || (tid == end - 1 && end >= 1);
  const float* lp_b = lp + b * lp_sb;
  const float* al = alphas + static_cast<size_t>(b) * S;
  const size_t al_st = static_cast<size_t>(B) * S;

  for (long long t = len - 1; t >= 0; --t) {
    float* bn = (t & 1) ? beta1 : beta0;
    const float* bo = (t & 1) ? beta0 : beta1;  // frame t + 1
    float* wn = (t & 1) ? w1 : w0;
    if (in_s) {
      const float e = emission(lp_b + t * lp_st, ext, C);
      float v;
      if (t == len - 1) {
        v = terminal ? e : kLogEps;
      } else {
        const float x0 = bo[tid];
        const float x1 = tid + 1 < S ? bo[tid + 1] : kLogEps;
        const float x2 = skip_p2 ? bo[tid + 2] : kLogEps;
        v = lse3(x0, x1, x2) + e;
      }
      if (!valid) v = kLogEps;
      bn[tid] = v;
      const float a = al[t * al_st + tid];
      float w = 0.f;
      if (!(a <= kFloorCut || v <= kFloorCut)) {
        const float gamma = (a + v) - e;
        w = expf(fminf(gamma + nl, 20.f));
      }
      wn[tid] = w;
    }
    __syncthreads();
    for (int c = tid; c < C; c += blockDim.x) {
      float sum = 0.f;
      for (int s = 0; s < S; ++s)
        if (ext_sm[s] == c) sum += wn[s];
      grad_b[t * gr_st + c] = -sum * gb;
    }
  }
}

int threads_for(int n) { return (n + 31) / 32 * 32; }

bool shapes_ok(int T, int B, int C, int L, long long blank) {
  return T >= 1 && B >= 1 && C >= 1 && C <= kMaxClasses && L >= 0 &&
         2 * L + 1 <= kMaxSlots && blank >= 0 && blank < C;
}

}  // namespace

extern "C" {

// lp: (T, B, C) float32 log-probs with element strides (lp_st, lp_sb, 1);
// input_lengths, label_lengths: (B,) int64; labels: (B, L) int64 with
// strides (lab_sb, lab_sl).  alphas: (T, B, S) float32 out, S = 2L + 1,
// written for t < max(len, 1) of each row; nll: (B,) float32 out.
// 1 <= T, B; 1 <= C <= 1024; S <= 1023; 0 <= blank < C.  Returns a
// cudaError_t (0 = success).
int mdd_ctc_alpha(const float* lp, long long lp_st, long long lp_sb,
                  const long long* input_lengths, const long long* labels,
                  long long lab_sb, long long lab_sl,
                  const long long* label_lengths, int T, int B, int C, int L,
                  long long blank, float* alphas, float* nll, void* stream) {
  if (!shapes_ok(T, B, C, L, blank)) return cudaErrorInvalidValue;
  const int S = 2 * L + 1;
  ctc_alpha_kernel<<<B, threads_for(S), 2 * S * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      lp, lp_st, lp_sb, input_lengths, labels, lab_sb, lab_sl, label_lengths,
      T, B, C, L, blank, alphas, nll);
  return cudaGetLastError();
}

// The arguments of mdd_ctc_alpha, its alphas and nll, g: (B,) float32, the
// cotangent of nll; grad: (T, B, C) float32 out with element strides
// (gr_st, gr_sb, 1), every entry written.
int mdd_ctc_beta_grad(const float* lp, long long lp_st, long long lp_sb,
                      const long long* input_lengths, const long long* labels,
                      long long lab_sb, long long lab_sl,
                      const long long* label_lengths, int T, int B, int C,
                      int L, long long blank, const float* alphas,
                      const float* nll, const float* g, float* grad,
                      long long gr_st, long long gr_sb, void* stream) {
  if (!shapes_ok(T, B, C, L, blank)) return cudaErrorInvalidValue;
  const int S = 2 * L + 1;
  const int threads = threads_for(S > C ? S : C);
  const size_t smem = 4 * S * sizeof(float) + S * sizeof(long long);
  ctc_beta_grad_kernel<<<B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      lp, lp_st, lp_sb, input_lengths, labels, lab_sb, lab_sl, label_lengths,
      T, B, C, L, blank, alphas, nll, g, grad, gr_st, gr_sb);
  return cudaGetLastError();
}

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
