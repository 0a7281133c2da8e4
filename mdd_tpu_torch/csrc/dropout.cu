// Dropout whose mask is made inside the kernel from a seed, for Hopper
// (sm_90a).
//
// Replaces mdd_tpu/ops/dropout_pallas.py::_kernel (the TPU kernel behind
// fused_dropout).  Same function:
//
//   keep      = 1 - rate
//   threshold = min(round(keep * 2^32), 2^32 - 1)          (the wrapper's)
//   out[i]    = bits(seed, i) < threshold ? x[i] * (1 / keep) : 0
//
// over the flat index i of a contiguous tensor, the product in float32 and
// rounded to x's type (float32 or bfloat16).  The backward pass is the same
// kernel on dy with the same seed, so the seed is the only residual: no mask
// and no random bits ever reach device memory.
//
// The TPU kernel seeds the core's own generator per block; here the bits
// come from Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC'11), a counter-based generator written out below: the
// four elements 4g .. 4g+3 take the four words of
//
//   philox4x32_10(counter = (lo32(g), hi32(g), 0, 0),
//                 key     = (lo32(seed), hi32(seed)))
//
// so an element's bit depends on the seed and its flat index only, whatever
// the launch geometry, and ops/dropout_cuda.py::fused_dropout_reference
// repeats it bit for bit in tensor arithmetic.  The mask pattern differs
// from the TPU's; the distribution does not.
//
// What bounds it on an H100: bytes.  x is read once and out written once
// (8 bytes an element in float32); Philox is 10 rounds of two 32x32->64
// multiplies and a few xors per 4 elements, about 30 integer operations an
// element, far below the card's rate at 3.35 TB/s.  What the design does
// about it: one thread per 4 consecutive elements, so one Philox call feeds
// one 16-byte load and one 16-byte store in float32 (8-byte in bfloat16),
// neighbouring threads on neighbouring addresses; the seed is a 1-element
// int64 tensor read in the kernel, so the host never waits for the draw.
// A tensor whose storage is not aligned for the wide access, and the last
// partial group, take the same thread mapping with scalar accesses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace mdd;

constexpr int kThreads = 256;
constexpr uint32_t kMul0 = 0xD2511F53u;
constexpr uint32_t kMul1 = 0xCD9E8D57u;
constexpr uint32_t kBump0 = 0x9E3779B9u;   // golden ratio
constexpr uint32_t kBump1 = 0xBB67AE85u;   // sqrt(3) - 1

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kMul0, c.x), lo0 = kMul0 * c.x;
    const uint32_t hi1 = __umulhi(kMul1, c.z), lo1 = kMul1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kBump0;
    k.y += kBump1;
  }
  return c;
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
               const long long* __restrict__ seed, long long n,
               uint32_t threshold, float inv_keep) {
  const unsigned long long group =
      static_cast<unsigned long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = static_cast<long long>(group * 4ull);
  if (i >= n) return;
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(group),
                 static_cast<uint32_t>(group >> 32), 0u, 0u),
      make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)));
  const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
  if (kWide && i + 4 <= n) {
    const float4 v = load4(x + i);
    store4(out + i,
           make_float4(bits[0] < threshold ? v.x * inv_keep : 0.0f,
                       bits[1] < threshold ? v.y * inv_keep : 0.0f,
                       bits[2] < threshold ? v.z * inv_keep : 0.0f,
                       bits[3] < threshold ? v.w * inv_keep : 0.0f));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j < n) {
        out[i + j] = from_f<T>(
            bits[j] < threshold ? to_f(x[i + j]) * inv_keep : 0.0f);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const long long* seed,
                   long long n, uint32_t threshold, float inv_keep,
                   cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 4 elements of T per access: 16 bytes in float32, 8 in bfloat16
  const uintptr_t mask = 4 * sizeof(T) - 1;
  const bool wide = ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out)) & mask) == 0;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  if (wide) {
    dropout_kernel<T, true><<<grid, block, 0, stream>>>(
        xp, op, seed, n, threshold, inv_keep);
  } else {
    dropout_kernel<T, false><<<grid, block, 0, stream>>>(
        xp, op, seed, n, threshold, inv_keep);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: n contiguous elements (dtype: 0 = float32, 1 = bfloat16); seed: one
// int64 on the device.  Returns a cudaError_t (0 = success).
int mdd_fused_dropout(const void* x, void* out, const long long* seed,
                      long long n, unsigned threshold, float inv_keep,
                      int dtype, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(x, out, seed, n, threshold, inv_keep, s)
             : launch<__nv_bfloat16>(x, out, seed, n, threshold, inv_keep, s);
}

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
