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
// (8 bytes an element in float32, 4 in bfloat16).  Philox is 10 rounds of
// two 32x32 -> 64-bit multiplies and two 3-input xors per 4 elements (the
// round keys are the same for every element), ~12 integer operations an
// element with the compare and select: at the 64 a clock and SM of the
// integer pipes, 30% of the bytes' time in float32 and 60% in bfloat16.
//
// What the design does about it.  The first version gave each thread one
// group of 4 elements, read the seed, ran Philox, and only then loaded x:
// a thread had at most one 16-byte load in flight.  On an H100 (700 W) it
// reached 90% of the bytes' bound at the conv0 and BiLSTM sites in
// float32, but 75-81% in bfloat16, where Philox is a larger share (a
// scaled copy on the same geometry reached 93%).  Here:
//   - a block owns a contiguous run of 256 x k 16-byte accesses, and thread
//     t takes accesses t, t + 256, ...: every warp load is one coalesced
//     512-byte run, and a block's loads stay inside one stretch of memory
//     (spreading a thread's accesses a whole wave apart, one resident wave
//     walking the tensor, lost 7% at the 55 M-element site);
//   - every access is 16 bytes: 4 float32 elements and one Philox call, or
//     8 bfloat16 elements and two;
//   - a thread issues its k loads, and the read of the seed, before the
//     first Philox round, so the rounds run while the loads are in flight;
//     k = 2 in float32 and 4 in bfloat16 (8 Philox calls) timed best;
//   - loads take the read-only path (__ldg): streaming loads (__ldcs) were
//     as fast in bfloat16 and 1.5% slower at the largest float32 site.
// float32 went to 86-96% of the bound at the three sites of a train step,
// bfloat16 to 79-87% (ops/dropout_time.py; PERF.md has the numbers of
// every variant).  A tensor whose storage is not 16-byte aligned takes one
// group of 4 a thread with scalar accesses, and the last partial access
// of an aligned one too.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

using namespace mdd;

constexpr int kThreads = 256;
constexpr int kRounds = 10;
constexpr uint32_t kMul0 = 0xD2511F53u;
constexpr uint32_t kMul1 = 0xCD9E8D57u;
constexpr uint32_t kBump0 = 0x9E3779B9u;   // golden ratio
constexpr uint32_t kBump1 = 0xBB67AE85u;   // sqrt(3) - 1

// the key of every round, from the seed's two halves
struct RoundKeys {
  uint2 k[kRounds];
  __device__ __forceinline__ explicit RoundKeys(unsigned long long seed) {
    uint2 key = make_uint2(static_cast<uint32_t>(seed),
                           static_cast<uint32_t>(seed >> 32));
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      k[r] = key;
      key.x += kBump0;
      key.y += kBump1;
    }
  }
};

// the four words of group g
__device__ __forceinline__ uint4 philox4x32_10(unsigned long long g,
                                               const RoundKeys& keys) {
  uint4 c = make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                       0u, 0u);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t hi0 = __umulhi(kMul0, c.x), lo0 = kMul0 * c.x;
    const uint32_t hi1 = __umulhi(kMul1, c.z), lo1 = kMul1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ keys.k[r].x, lo1, hi0 ^ c.w ^ keys.k[r].y, lo0);
  }
  return c;
}

struct Mask {
  uint32_t threshold;
  float inv_keep;
  __device__ __forceinline__ float operator()(uint32_t bits, float v) const {
    return bits < threshold ? v * inv_keep : 0.0f;
  }
};

// elements of one 16-byte access
template <typename T>
__host__ __device__ constexpr int access_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// 16-byte accesses a thread has in flight: 2 in float32 (2 Philox calls),
// 4 in bfloat16 (8 Philox calls)
template <typename T>
__host__ __device__ constexpr int accesses_per_thread() {
  return sizeof(T) == 4 ? 2 : 4;
}

// one 16-byte access a (4 float32 elements: group a)
__device__ __forceinline__ uint4 apply(uint4 raw, unsigned long long a,
                                       const RoundKeys& keys, Mask m,
                                       float) {
  const uint4 r = philox4x32_10(a, keys);
  return make_uint4(
      __float_as_uint(m(r.x, __uint_as_float(raw.x))),
      __float_as_uint(m(r.y, __uint_as_float(raw.y))),
      __float_as_uint(m(r.z, __uint_as_float(raw.z))),
      __float_as_uint(m(r.w, __uint_as_float(raw.w))));
}

// two bfloat16 elements with two words
__device__ __forceinline__ uint32_t apply2(uint32_t raw, uint32_t b0,
                                           uint32_t b1, Mask m) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  const __nv_bfloat162 o = __floats2bfloat162_rn(m(b0, v.x), m(b1, v.y));
  return *reinterpret_cast<const uint32_t*>(&o);
}

// one 16-byte access a (8 bfloat16 elements: groups 2a and 2a + 1)
__device__ __forceinline__ uint4 apply(uint4 raw, unsigned long long a,
                                       const RoundKeys& keys, Mask m,
                                       __nv_bfloat16) {
  const uint4 r0 = philox4x32_10(2 * a, keys);
  const uint4 r1 = philox4x32_10(2 * a + 1, keys);
  return make_uint4(apply2(raw.x, r0.x, r0.y, m), apply2(raw.y, r0.z, r0.w, m),
                    apply2(raw.z, r1.x, r1.y, m), apply2(raw.w, r1.z, r1.w, m));
}

// elements 4g .. min(4g + 4, n) - 1, one at a time
template <typename T>
__device__ __forceinline__ void scalar_group(const T* __restrict__ x,
                                             T* __restrict__ out,
                                             unsigned long long g, long long n,
                                             const RoundKeys& keys, Mask m) {
  const uint4 r = philox4x32_10(g, keys);
  const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
  const long long i = static_cast<long long>(g) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < n) out[i + j] = from_f<T>(m(bits[j], to_f(x[i + j])));
}

// A block owns kThreads x accesses_per_thread<T>() consecutive 16-byte
// accesses (wide) or kThreads groups of 4 (narrow: storage that is not
// 16-byte aligned).  Thread t of a wide block takes accesses t, t +
// kThreads, ... of the block's run, so every load of the block's warps is
// one coalesced run of 512 bytes.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
               const long long* __restrict__ seed, long long n, Mask m) {
  // the seed's read is in flight with the loads of x
  const unsigned long long s = static_cast<unsigned long long>(__ldg(seed));
  if constexpr (kWide) {
    constexpr int kElems = access_elems<T>();
    constexpr int kPer = accesses_per_thread<T>();
    const long long n_acc = n / kElems;        // whole 16-byte accesses
    const long long a0 =
        static_cast<long long>(blockIdx.x) * kThreads * kPer + threadIdx.x;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    uint4 raw[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (a0 + u * kThreads < n_acc) raw[u] = __ldg(xv + a0 + u * kThreads);
    const RoundKeys keys(s);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long a = a0 + u * kThreads;
      if (a < n_acc) ov[a] = apply(raw[u], a, keys, m, T());
    }
    // the last partial access (one or two groups), by the last block
    const long long g0 = n_acc * kElems / 4;
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x < (n + 3) / 4 - g0)
      scalar_group(x, out, g0 + threadIdx.x, n, keys, m);
  } else {
    const long long g =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (g < (n + 3) / 4) scalar_group(x, out, g, n, RoundKeys(s), m);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const long long* seed,
                   long long n, Mask m, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const bool wide = ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long per_block =
      wide ? static_cast<long long>(kThreads) * accesses_per_thread<T>()
                 * access_elems<T>()
           : kThreads * 4LL;
  const long long blocks = std::max(1LL, (n + per_block - 1) / per_block);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (wide)
    dropout_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, op, seed, n, m);
  else
    dropout_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, op, seed, n,
                                                            m);
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
  const Mask m = {threshold, inv_keep};
  return dtype == 0 ? launch<float>(x, out, seed, n, m, s)
                    : launch<__nv_bfloat16>(x, out, seed, n, m, s);
}

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
