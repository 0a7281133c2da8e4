// Helpers shared by the package's kernels: dtype conversions and 4-wide
// loads and stores (lstm_fwd.cu, lstm_bwd.cu, dropout.cu); the L2 read of
// data other blocks wrote and the per-direction grid barrier (the LSTM
// recurrences).
#pragma once

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

}  // namespace mdd
