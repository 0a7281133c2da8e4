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
// Design.
//   - ctc_alpha: one warp a row (four rows a block), P = ceil(S / 32)
//     consecutive slots a lane in registers (a template on P; the lanes
//     past slot S - 1 leave), no shared memory and no barrier.  Slots
//     s - 1 and s - 2 of a lane's first two slots come from the lane
//     below by two shuffles of its last two; the P logsumexps of a frame
//     are written stage by stage side by side so that their chains
//     interleave, and the loop-invariant flags (skip, valid slot, an
//     emitting id) are bit masks for bitwise selects, not predicates:
//     with P = 3 they left the logf calls' scratch predicates one
//     register, which serialised the three logs.  Each slot's emissions
//     sit in a ring of registers kAlphaAhead frames ahead: frame t + K's
//     are loaded, right after frame t's step, into the registers frame t's
//     left (a load issued before their last use needs a copy at the loop's
//     end that waits for it).  Each frame's alphas go to (T, B, S) for the
//     backward, the loop run only to the row's own input length; the last
//     lane's slots past S - 1 store to S - 1 before the slot that owns it,
//     so no store needs a predicate.  nll comes from the lane that holds
//     slot 2l.
//     Each slot's arithmetic is that of the kernel it replaced (a block a
//     row, a thread a slot, alpha double-buffered in shared memory, one
//     barrier a frame, the emission one frame ahead; measured in
//     PERF.md), so nll and the alphas are its bits.
//   - ctc_beta_grad: first, once a row, the slots of each class in slot
//     order (a slot's place among its class's, an integer count a class,
//     a warp scan).  Then the chain, t from len-1 down to 0: beta
//     double-buffered in shared memory, one barrier a frame (a block
//     a row); each frame's posterior weights w_t(s) go to a (T, B, S)
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
// of dependent frames a row and the launch.  ctc_beta_grad keeps a row's
// chain in one block, on one SM, with no grid-wide barrier; 64 rows fill
// half the SMs.  Its chain once waited each frame for one thread a class
// to sum its class over all S slots: 79% of a frame's 5,014 SM cycles by
// its stamps (-DMDD_CTC_LOSS_STAMPS, python -m
// mdd_tpu_torch.ops.frame_stamps --kernel beta_grad), 0.2026 ms at B=64,
// T'=110, L=40 (NVIDIA H100 80GB HBM3, 700.00 W, SM clock 1980 MHz).
// Without the sums on it the chain's frame is ~600 cycles, most of it the
// beta step's logsumexp and weight; its floor, the same loop with its
// barrier and shared-memory round trip and no arithmetic
// (-DMDD_CTC_LOSS_SKELETON), ~0.08 us a frame.  ctc_alpha's frame is one
// lse3's dependent chain (accurate expf, then logf, then the adds and
// selects) and the emission load: the block-a-row kernel took 0.02617 ms
// at B=64, T'=110, L=40, 496 cycles a frame by the same stamps (python -m
// mdd_tpu_torch.ops.frame_stamps --kernel alpha: its step and store 64%,
// the wait for the emission loaded a frame ahead 30%, the barrier 5%);
// this one 0.0259 ms in turns with it (0.0261), 0.0195 against 0.0227 at
// B=512, T'=80: the barrier is gone, the chain is not.  Its emissions K
// frames ahead gave 0.0550, 0.0370, 0.0279, 0.0259, 0.0266 and 0.0258 ms
// at B=64 for K = 1, 2, 3, 4, 6 and 8 (H100 80GB HBM3, 700.00 W).
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
constexpr int kAlphaWarps = 4;      // ctc_alpha's rows a block
constexpr int kAlphaAhead = 4;      // frames ctc_alpha loads ahead
constexpr size_t kSmemBytes = 48 * 1024;  // without an opt-in

// Built with -DMDD_CTC_LOSS_STAMPS, thread MDD_STAMP_THREAD (0 unless
// given) of block 0 of each kernel sums clock64() differences per phase
// in registers and adds them to its kernel's counters when it leaves:
// g_stamps for ctc_beta_grad, g_alpha_stamps for ctc_alpha (python -m
// mdd_tpu_torch.ops.frame_stamps --kernel beta_grad|alpha reads them).
#ifdef MDD_CTC_LOSS_STAMPS
__device__ long long g_stamps[8];
__device__ long long g_alpha_stamps[8];
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
#define STAMP_END(counters)                             \
  do {                                                  \
    if (stamping)                                       \
      for (int p = 0; p < 8; ++p) counters[p] += stamp_sum[p]; \
  } while (0)
#else
#define STAMP_START
#define STAMP(p)
#define STAMP_END(counters)
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

// mask ? a : b, for a mask of all ones or all zeros: a bitwise select,
// which takes no predicate register (the loop keeps its predicates for the
// logf calls, whose scratch predicates then do not serialise them)
__device__ __forceinline__ float pick(unsigned mask, float a, float b) {
  return __int_as_float((__float_as_int(a) & mask) |
                        (__float_as_int(b) & ~mask));
}

__device__ __forceinline__ unsigned mask_of(bool x) { return x ? ~0u : 0u; }

// P slots a lane (s = lane * P + p), the lanes past slot S - 1 gone; the
// frames' emissions K ahead (fewer registers for the larger P)
template <int P>
__global__ void __launch_bounds__(kAlphaWarps * 32)
ctc_alpha_kernel(
    const float* __restrict__ lp, long long lp_st, long long lp_sb,
    const long long* __restrict__ input_lengths,
    const long long* __restrict__ labels, long long lab_sb, long long lab_sl,
    const long long* __restrict__ label_lengths, int T, int B, int C, int L,
    long long blank, float* __restrict__ alphas, float* __restrict__ nll) {
  constexpr int K = P <= 4 ? kAlphaAhead : 1;
  const int S = 2 * L + 1;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kAlphaWarps + (threadIdx.x >> 5);
  const int s0 = lane * P;
  if (b >= B || s0 >= S) return;   // whole warps, and the idle lanes
  const int held = (S + P - 1) / P;        // the lanes that hold slots
  const unsigned lanes = held >= 32 ? 0xffffffffu : (1u << held) - 1u;
  const long long len = clamp_len(input_lengths[b], T);
  const long long ll = clamp_len(label_lengths[b], L);
  const float* lp_b = lp + b * lp_sb;
  float* out = alphas + static_cast<size_t>(b) * S;
  const size_t out_st = static_cast<size_t>(B) * S;

  // per slot: its class (0 for an id that emits 0, with emit_m clear),
  // masks for the skip, the valid slots and the emission; where frames
  // store it (a slot past S - 1 of the last lane stores to S - 1 first,
  // and the slot that owns it overwrites that later in program order)
  int cls[P], dst[P];
  unsigned skip_m[P], valid_m[P], emit_m[P];
  float a[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int s = s0 + p;
    const bool in_s = s < S;
    const long long ext = in_s ? ext_at(labels, lab_sb, lab_sl, b, s, blank)
                               : blank;
    const long long ext_m2 =
        (in_s && s >= 2) ? ext_at(labels, lab_sb, lab_sl, b, s - 2, blank)
                         : blank;
    skip_m[p] = mask_of(in_s && ext != blank && ext != ext_m2 && s >= 2);
    valid_m[p] = mask_of(s < 2 * ll + 1);
    emit_m[p] = mask_of(in_s && ext >= 0 && ext < C);
    cls[p] = emit_m[p] ? static_cast<int>(ext) : 0;
    dst[p] = in_s ? s : S - 1;
    a[p] = kLogEps;
    if (s == 0 || (s == 1 && ll > 0))
      a[p] = pick(emit_m[p], lp_b[cls[p]], 0.f);
  }
#pragma unroll
  for (int p = P - 1; p >= 0; --p) out[dst[p]] = a[p];
  const unsigned below_m = mask_of(lane >= 1);   // slot s0 - 1 exists
  float ring[K][P];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const float* lp_t = lp_b + (1 + u < T ? 1 + u : T - 1) * lp_st;
#pragma unroll
    for (int p = 0; p < P; ++p) ring[u][p] = lp_t[cls[p]];
  }
  STAMP_START;
  for (long long t0 = 1; t0 < len; t0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const long long t = t0 + u;
      if (t >= len) break;             // uniform over the warp
      // slots s0 - 1 and s0 - 2: the lane below's last two (two lanes
      // below at P = 1)
      const float up1 = __shfl_up_sync(lanes, a[P - 1], 1);
      const float up2 = P >= 2
                            ? __shfl_up_sync(lanes, a[P >= 2 ? P - 2 : 0], 1)
                            : __shfl_up_sync(lanes, a[0], 2);
      STAMP(1);
      // the P slots' lse3 side by side, stage by stage (each slot's float
      // steps are lse3's), so that their chains interleave
      float x0[P], x1[P], x2[P], m[P], v[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        x0[p] = a[p];
        x1[p] = p >= 1 ? a[p >= 1 ? p - 1 : 0] : pick(below_m, up1, kLogEps);
        x2[p] = pick(skip_m[p], p >= 2 ? a[p >= 2 ? p - 2 : 0]
                                : p == 1 ? up1 : up2, kLogEps);
        m[p] = fmaxf(fmaxf(x0[p], x1[p]), x2[p]);
      }
#ifdef MDD_CTC_LOSS_SKELETON
#pragma unroll
      for (int p = 0; p < P; ++p) v[p] = x1[p];
#else
      float ea[P], eb[P], ec[P];
#pragma unroll
      for (int p = 0; p < P; ++p) ea[p] = expf(x0[p] - m[p]);
#pragma unroll
      for (int p = 0; p < P; ++p) eb[p] = expf(x1[p] - m[p]);
#pragma unroll
      for (int p = 0; p < P; ++p) ec[p] = expf(x2[p] - m[p]);
#pragma unroll
      for (int p = 0; p < P; ++p) v[p] = logf((ea[p] + eb[p]) + ec[p]);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float out_v = m[p] + v[p];
        const float l = m[p] <= kFloorCut ? kLogEps : out_v;
        v[p] = pick(valid_m[p], l + pick(emit_m[p], ring[u][p], 0.f),
                    kLogEps);
      }
#endif
      STAMP(2);
#pragma unroll
      for (int p = P - 1; p >= 0; --p) {
        a[p] = v[p];
        out[t * out_st + dst[p]] = v[p];
      }
      STAMP(3);
      // frame t + K's emissions into the registers frame t's just left
      // (a load before their last use would need a copy at the loop's
      // end, which waits for it); past the row's frames a frame in bounds
      // is read and not used
      const float* lp_t = lp_b + (t + K < T ? t + K : T - 1) * lp_st;
#pragma unroll
      for (int p = 0; p < P; ++p) ring[u][p] = lp_t[cls[p]];
      STAMP(0);
    }
  }
  // nll from the lanes that hold slots 2l and 2l - 1
  const int end = static_cast<int>(2 * ll);
  float last = kLogEps, second = kLogEps;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (s0 + p == end) last = a[p];
    if (s0 + p == end - 1) second = a[p];
  }
  last = __shfl_sync(lanes, last, end / P);
  second = end >= 1 ? __shfl_sync(lanes, second, (end - 1) / P) : kLogEps;
  if (lane == 0) {
    const float m = fmaxf(last, second);
    float l = m + logf(expf(last - m) + expf(second - m));
    if (m <= kFloorCut) l = kLogEps;
    nll[b] = -l;
  }
  STAMP(4);
  STAMP_END(g_alpha_stamps);
}

template <int P>
cudaError_t launch_alpha(const float* lp, long long lp_st, long long lp_sb,
                         const long long* input_lengths,
                         const long long* labels, long long lab_sb,
                         long long lab_sl, const long long* label_lengths,
                         int T, int B, int C, int L, long long blank,
                         float* alphas, float* nll, cudaStream_t stream) {
  const int blocks = (B + kAlphaWarps - 1) / kAlphaWarps;
  ctc_alpha_kernel<P><<<blocks, kAlphaWarps * 32, 0, stream>>>(
      lp, lp_st, lp_sb, input_lengths, labels, lab_sb, lab_sl, label_lengths,
      T, B, C, L, blank, alphas, nll);
  return cudaGetLastError();
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
  STAMP_END(g_stamps);
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
  const int per_lane = (2 * L + 1 + 31) / 32;   // ceil(S / 32) <= 32
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MDD_ALPHA_LAUNCH(P)                                                \
  if (per_lane <= P)                                                      \
  return launch_alpha<P>(lp, lp_st, lp_sb, input_lengths, labels, lab_sb, \
                         lab_sl, label_lengths, T, B, C, L, blank, alphas, \
                         nll, s)
  MDD_ALPHA_LAUNCH(1);
  MDD_ALPHA_LAUNCH(2);
  MDD_ALPHA_LAUNCH(3);
  MDD_ALPHA_LAUNCH(4);
  MDD_ALPHA_LAUNCH(6);
  MDD_ALPHA_LAUNCH(8);
  MDD_ALPHA_LAUNCH(12);
  MDD_ALPHA_LAUNCH(16);
  MDD_ALPHA_LAUNCH(24);
  MDD_ALPHA_LAUNCH(32);
#undef MDD_ALPHA_LAUNCH
  return cudaErrorInvalidValue;
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

// copies the cycle sums of a kernel's block 0 into out[0 .. n) and
// zeroes them
static int read_stamps(const void* counters, long long* out, int n) {
  long long host[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, counters, sizeof(host));
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n && i < 8; ++i) out[i] = host[i];
  const long long zero[8] = {};
  return cudaMemcpyToSymbol(counters, zero, sizeof(zero));
}

int mdd_ctc_loss_read_stamps(long long* out, int n) {
  return read_stamps(g_stamps, out, n);
}

const char* mdd_ctc_alpha_stamp_names() {
  return "emission loads (issue),shuffles from the lane below,alpha step,"
         "alpha stores,nll";
}

int mdd_ctc_alpha_read_stamps(long long* out, int n) {
  return read_stamps(g_alpha_stamps, out, n);
}
#endif

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
