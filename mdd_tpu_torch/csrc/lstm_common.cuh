// Helpers shared by the package's kernels: dtype conversions and 4-wide
// loads and stores (lstm_fwd.cu, lstm_bwd.cu, dropout.cu); the L2 read of
// data other blocks wrote and the per-direction grid barrier (the LSTM
// recurrences); and what the backward's tensor-core kernels share: the
// TF32 split, the warp-level TF32 product, 16-byte asynchronous copies
// into shared memory, and a barrier over a group of blocks whose arrival
// and wait are separate calls.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mdd {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 raw) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four consecutive elements (16- or 8-byte aligned) as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return bf16x4_to_float4(*reinterpret_cast<const uint2*>(p));
}

// four floats to four consecutive elements (16- or 8-byte aligned)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Data written by other blocks during the launch: read it from L2, never
// from a (non-coherent) L1 line; four elements at a time.
__device__ __forceinline__ void copy4_from_l2(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) =
      __ldcg(reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ void copy4_from_l2(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) =
      __ldcg(reinterpret_cast<const uint2*>(src));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Barrier over the blocks of one direction (the pattern of cooperative
// groups' grid sync: the block's threads meet, one thread publishes with a
// device-scope fence and an atomic, then waits).  `target` grows by the
// number of blocks of the direction at every step, so the counter never
// needs a reset inside the launch.  A wait that lasts seconds means the
// blocks are not all resident: trap, so that the fault reaches the caller
// instead of a hang.
__device__ __forceinline__ void direction_barrier(unsigned* counter,
                                                  unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    long long spins = 0;
    while (*reinterpret_cast<volatile unsigned*>(counter) < target) {
      if (++spins > (1ll << 31)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Barrier over a group of `size` blocks that share one zeroed counter, in
// two halves: every thread of the block calls arrive() once its writes of
// the step are made, may then do work that needs nothing of the other
// blocks, and calls wait() before it reads what they wrote.  The target
// grows by `size` at every use, so the counter needs no reset inside the
// launch; the fences and the trap are those of direction_barrier.
struct GroupBarrier {
  unsigned* counter;
  unsigned size;
  unsigned target;

  __device__ GroupBarrier(unsigned* counter_, unsigned size_)
      : counter(counter_), size(size_), target(0) {}

  __device__ __forceinline__ void arrive() {
    target += size;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(counter, 1u);
    }
  }

  __device__ __forceinline__ void wait() {
    if (threadIdx.x == 0) {
      long long spins = 0;
      while (*reinterpret_cast<volatile unsigned*>(counter) < target) {
        if (++spins > (1ll << 31)) __trap();
      }
      __threadfence();
    }
    __syncthreads();
  }
};

// ---- tensor cores (mma.sync, TF32 operands, float32 accumulators) ----

// x = hi + lo up to 2^-20 |x|, both valid TF32 (10 mantissa bits, the low
// 13 bits of the word zero): hi is x cut to TF32, lo the remainder (exact
// in float32) cut to TF32.  A float32 product a * b is then a_lo * b_hi +
// a_hi * b_lo + a_hi * b_hi to about float32 accuracy ("3xTF32"; the
// a_lo * b_lo term is below 2^-20).  Cutting instead of rounding
// (cvt.rna.tf32.f32) costs one bit and keeps the split on the full-rate
// integer and float pipes: with cvt.rna.tf32.f32 in it the split, not
// the tensor cores, bounded both kernels of lstm_bwd.cu (H100: 33 -> 48
// TFLOP/s effective in the product kernel).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  constexpr uint32_t kTf32Mask = 0xffffe000u;
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

// c (16 x 8) += a (16 x 8, row-major) @ b (8 x 8, column-major), one warp.
// With g = lane / 4 and q = lane % 4 a lane holds a[0..3] = A[g][q],
// A[g + 8][q], A[g][q + 4], A[g + 8][q + 4]; b[0..1] = B[q][g], B[q + 4][g];
// c[0..3] = C[g][2q], C[g][2q + 1], C[g + 8][2q], C[g + 8][2q + 1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// N operand registers of a fragment as the tensor cores take them, set from
// values of type T widened to float.  float32 operands are split (hi, lo)
// for the three-pass product; bfloat16 operands are exact in TF32 (8
// mantissa bits of 10), so one pass gives exact products and float32 sums,
// as the kernels' contract asks.
template <typename T, int N>
struct Frag;

template <int N>
struct Frag<float, N> {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    tf32_split(x, hi[i], lo[i]);
  }
};

template <int N>
struct Frag<__nv_bfloat16, N> {
  uint32_t hi[N];
  // x: a bfloat16 value as to_f() or load4() widened it
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = __float_as_uint(x);
  }
};

// c[j] += a @ b[j] for N tiles that share a, in the operands' own precision
// (small terms first).  Each pass runs over all N tiles before the next, so
// that consecutive mma.sync never wait for each other's accumulator.
template <int N>
__device__ __forceinline__ void mma_frags(float (&c)[N][4],
                                          const Frag<float, 4>& a,
                                          const Frag<float, 2> (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.hi, b[j].hi);
}
template <int N>
__device__ __forceinline__ void mma_frags(
    float (&c)[N][4], const Frag<__nv_bfloat16, 4>& a,
    const Frag<__nv_bfloat16, 2> (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.hi, b[j].hi);
}

// ---- asynchronous 16-byte copies, global (through L2 only) -> shared ----

// Copies 16 bytes when `valid`, else fills them with zeros (src is not
// read then, but must still be an address inside an allocation).  Both
// pointers 16-byte aligned.  The .cg path never allocates in L1, so it also
// reads what other blocks wrote during the launch.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// closes the copies started so far into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// returns when at most `kPending` of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

}  // namespace mdd
