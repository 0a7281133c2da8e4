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
//   - ctc_beta_grad: first, once a row, the slots of each class in slot
//     order (a slot's place among its class's, an integer count a class,
//     a warp scan).  Then the chain, t from len-1 down to 0: beta
//     double-buffered in shared memory, one barrier a frame, as in
//     ctc_alpha; each frame's posterior weights w_t(s) go to a (T, B, S)
//     float32 scratch that the wrapper allocates (the saved alphas are not
//     reused: autograd may read them again under retain_graph), and the
//     emissions and alphas are loaded two frames ahead into a ring of
//     registers.  Then the class sums, frames in parallel: a warp a frame,
//     its S weights staged in shared memory by cp.async a frame ahead,
//     a lane a class, each class's slots added in slot order, so the sums
//     are those of the kernel that summed on its chain, bit for bit, and
//     need no float atomics.  Every entry of the output is written, the
//     zero frames and rows too.
//
// What bounds it on an H100: neither bytes nor operations.  At the train
// cell (B=64, T' <= 110, L <= 40) each kernel moves ~2-5 MB and does ~10^7
// float operations, a microsecond or two either way; the time is the chain
// of dependent frames a row and the launch.  One block a row keeps the
// whole chain on one SM with no grid-wide barrier; 64 rows fill half the
// SMs.  ctc_beta_grad's chain once waited each frame for one thread a
// class to sum its class over all S slots: 79% of a frame's 5,014 SM
// cycles by its stamps (-DMDD_CTC_LOSS_STAMPS, python -m
// mdd_tpu_torch.ops.frame_stamps --kernel beta_grad), 0.2026 ms at B=64,
// T'=110, L=40 (NVIDIA H100 80GB HBM3, 700.00 W, SM clock 1980 MHz).
// Without the sums on it the chain's frame is ~600 cycles, most of it the
// beta step's logsumexp and weight; its floor, the same loop with its
// barrier and shared-memory round trip and no arithmetic
// (-DMDD_CTC_LOSS_SKELETON), ~0.08 us a frame.
//
// Tried and dropped for ctc_beta_grad: a thread a (frame, class) pair
// reading the weights from the scratch (the blank class's 41 dependent
// loads set the pace; staging by warp is 10-15% faster); loads four
// frames ahead (48 registers: two blocks of 512 threads an SM, so B=512
// ran in two waves, 0.093 against 0.060 ms); __launch_bounds__(1024)
// (ptxas then held it to 32 registers and spilled).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogEps = -1e30f;
constexpr float kFloorCut = kLogEps / 2;   // -5e29
constexpr int kMaxSlots = 1023;
constexpr int kMaxClasses = 1024;
constexpr int kGradThreads = 512;   // ctc_beta_grad's least block: its
                                    // class sums run a warp a frame
constexpr int kSumBatch = 8;        // a class's weights loaded at once
constexpr int kAhead = 2;           // frames ctc_beta_grad loads ahead
constexpr size_t kSmemBytes = 48 * 1024;  // without an opt-in

// Built with -DMDD_CTC_LOSS_STAMPS, thread MDD_STAMP_THREAD (0 unless
// given) of ctc_beta_grad's block 0 sums clock64() differences per phase
// in registers and adds them to g_stamps when it leaves (python -m
// mdd_tpu_torch.ops.frame_stamps reads them).
#ifdef MDD_CTC_LOSS_STAMPS
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

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float out = m + logf((expf(a - m) + expf(b - m)) + expf(c - m));
  return m <= kFloorCut ? kLogEps : out;
}

__device__ __forceinline__ float emission(const float* lp_t, long long id,
                                          int C) {
  return (id >= 0 && id < C) ? lp_t[id] : 0.f;
}

// count floats from global to shared memory, a lane's share of a warp's
// 4-byte copies in flight until cp_async_wait
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src,
                                                int count, int lane) {
  for (int i = lane; i < count; i += 32) {
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
    float* weights, float* __restrict__ grad, long long gr_st,
    long long gr_sb, int grad_warps) {
  // the extended labels (S int64), beta double-buffered (2 S floats), the
  // start of each class's slots (C + 1 ints) and the slots in class, then
  // slot order (S ints), then two frames of weights for each of the
  // grad_warps warps of the class sums
  extern __shared__ long long smem_ll[];
  const int S = 2 * L + 1;
  long long* const ext_sm = smem_ll;
  float* const beta0 = reinterpret_cast<float*>(smem_ll + S);
  float* const beta1 = beta0 + S;
  int* const cls_start = reinterpret_cast<int*>(beta1 + S);
  int* const cls_slots = cls_start + C + 1;
  float* const w_stage = reinterpret_cast<float*>(cls_slots + S);
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
  const int t_zero = feasible ? static_cast<int>(len) : 0;
  for (int p = tid; p < (T - t_zero) * C; p += blockDim.x)
    grad_b[(t_zero + p / C) * gr_st + p % C] = 0.f;
  if (!feasible || len == 0) return;    // the whole block

  STAMP_START;
  // ---- the slots of each class in slot order, once a row: a slot's place
  // among its class's slots, a count a class and their scan ----
  const bool in_s = tid < S;
  for (int c = tid; c <= C; c += blockDim.x) cls_start[c] = 0;
  if (in_s) ext_sm[tid] = ext_at(labels, lab_sb, lab_sl, b, tid, blank);
  __syncthreads();
  const long long ext = in_s ? ext_sm[tid] : blank;
#ifndef MDD_CTC_LOSS_SKELETON
  int cls = -1, place = 0;
  if (in_s && ext >= 0 && ext < C) {
    cls = static_cast<int>(ext);
    for (int s = 0; s < tid; ++s) place += ext_sm[s] == ext;
    atomicAdd(&cls_start[cls + 1], 1);
  }
  __syncthreads();
  if (tid < 32) {                       // cls_start[c + 1] += cls_start[c]
    int carry = 0;
    for (int base = 0; base < C; base += 32) {
      const int c = base + tid;
      int v = c < C ? cls_start[c + 1] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, v, d);
        if (tid >= d) v += o;
      }
      if (c < C) cls_start[c + 1] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  if (cls >= 0) cls_slots[cls_start[cls] + place] = tid;
#endif
  STAMP(3);

  // ---- the chain: beta and the posterior weights, one barrier a frame ----
  // a transition s -> s + 2 is allowed iff a skip into s + 2 is
  const bool skip_p2 = in_s && tid + 2 < S && ext_sm[tid + 2] != blank &&
                       ext_sm[tid + 2] != ext;
  const bool valid = tid < 2 * ll + 1;
  const long long end = 2 * ll;
  const bool terminal = tid == end || (tid == end - 1 && end >= 1);
  const float* lp_b = lp + b * lp_sb;
  const float* al = alphas + static_cast<size_t>(b) * S;
  const size_t row_st = static_cast<size_t>(B) * S;  // a frame of (T, B, S)
  float* const w_b = weights + static_cast<size_t>(b) * S;
  // each frame's emission and alpha are loaded kAhead frames ahead, into
  // a ring of registers (the loop unrolled by kAhead)
  float e_ring[kAhead], a_ring[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    e_ring[u] = a_ring[u] = 0.f;
    if (in_s && len - 1 - u >= 0) {
      e_ring[u] = emission(lp_b + (len - 1 - u) * lp_st, ext, C);
      a_ring[u] = al[(len - 1 - u) * row_st + tid];
    }
  }
  for (long long t0 = len - 1; t0 >= 0; t0 -= kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long t = t0 - u;
      if (t < 0) break;                   // uniform over the block
      float* bn = (t & 1) ? beta1 : beta0;
      const float* bo = (t & 1) ? beta0 : beta1;  // frame t + 1
      if (in_s) {
        const float e = e_ring[u], a = a_ring[u];
        if (t - kAhead >= 0) {
          e_ring[u] = emission(lp_b + (t - kAhead) * lp_st, ext, C);
          a_ring[u] = al[(t - kAhead) * row_st + tid];
        }
#ifdef MDD_CTC_LOSS_SKELETON
        bn[tid] = t == len - 1 ? 0.f : bo[tid + 1 < S ? tid + 1 : tid];
#else
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
        float w = 0.f;
        if (!(a <= kFloorCut || v <= kFloorCut)) {
          const float gamma = (a + v) - e;
          w = expf(fminf(gamma + nl, 20.f));
        }
        w_b[t * row_st + tid] = w;
#endif
      }
      STAMP(0);
      __syncthreads();
      STAMP(1);
    }
  }
#ifdef MDD_CTC_LOSS_SKELETON
  return;
#endif

  // ---- the class sums, frames in parallel: a warp a frame, its weights
  // staged in shared memory by cp.async a frame ahead, a lane a class,
  // each class's slots added in slot order ----
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < grad_warps) {
    float* const stage = w_stage + 2 * warp * S;   // two frames
    if (warp < len) cp_async_floats(stage, w_b + warp * row_st, S, lane);
    for (int t = warp, buf = 0; t < len; t += grad_warps, buf ^= 1) {
      const float* wt = stage + buf * S;
      cp_async_wait();
      __syncwarp();                 // frame t is staged and the other read
      if (t + grad_warps < len)
        cp_async_floats(stage + (buf ^ 1) * S,
                        w_b + (t + grad_warps) * row_st, S, lane);
      for (int c = lane; c < C; c += 32) {
        const int end = cls_start[c + 1];
        float sum = 0.f;
        int q = cls_start[c];
        for (; q + kSumBatch <= end; q += kSumBatch) {
          float w[kSumBatch];       // the loads first, then the adds
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) w[u] = wt[cls_slots[q + u]];
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) sum += w[u];
        }
        for (; q < end; ++q) sum += wt[cls_slots[q]];
        grad_b[t * gr_st + c] = -sum * gb;
      }
      __syncwarp();
    }
  }
  STAMP(2);
  STAMP_END;
}

int threads_for(int n) { return (n + 31) / 32 * 32; }

// (T * C fits an int: ctc_beta_grad counts a row's (frame, class) pairs
// in 32 bits)
bool shapes_ok(int T, int B, int C, int L, long long blank) {
  return T >= 1 && B >= 1 && C >= 1 && C <= kMaxClasses && L >= 0 &&
         2 * L + 1 <= kMaxSlots && blank >= 0 && blank < C &&
         static_cast<long long>(T) * C <= 0x7fffffffLL;
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
// cotangent of nll; weights: (T, B, S) float32 of scratch (the posterior
// weights, written and read for t < len of each row); grad: (T, B, C)
// float32 out with element strides (gr_st, gr_sb, 1), every entry written.
int mdd_ctc_beta_grad(const float* lp, long long lp_st, long long lp_sb,
                      const long long* input_lengths, const long long* labels,
                      long long lab_sb, long long lab_sl,
                      const long long* label_lengths, int T, int B, int C,
                      int L, long long blank, const float* alphas,
                      const float* nll, const float* g, float* weights,
                      float* grad, long long gr_st, long long gr_sb,
                      void* stream) {
  if (!shapes_ok(T, B, C, L, blank)) return cudaErrorInvalidValue;
  const int S = 2 * L + 1;
  const int threads = threads_for(S > kGradThreads ? S : kGradThreads);
  // as many warps stage weights for the class sums as 48 KB of shared
  // memory holds (all 16 at S = 81; 3 at S = 1023)
  const size_t base = S * sizeof(long long) + 2 * S * sizeof(float) +
                      (C + 1 + S) * sizeof(int);
  int grad_warps =
      static_cast<int>((kSmemBytes - base) / (2 * S * sizeof(float)));
  grad_warps = grad_warps < threads / 32 ? grad_warps : threads / 32;
  grad_warps = grad_warps > 1 ? grad_warps : 1;
  const size_t smem = base + 2 * grad_warps * S * sizeof(float);
  ctc_beta_grad_kernel<<<B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      lp, lp_st, lp_sb, input_lengths, labels, lab_sb, lab_sl, label_lengths,
      T, B, C, L, blank, alphas, nll, g, weights, grad, gr_st, gr_sb,
      grad_warps);
  return cudaGetLastError();
}

#ifdef MDD_CTC_LOSS_STAMPS
const char* mdd_ctc_loss_stamp_names() {
  return "beta step,barrier,class sums (after the chain),slot lists";
}

// copies the cycle sums of ctc_beta_grad's block 0 into out[0 .. n) and
// zeroes them
int mdd_ctc_loss_read_stamps(long long* out, int n) {
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
