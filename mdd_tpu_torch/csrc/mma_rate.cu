// What the warp-level tensor-core op (mma.sync) and the FMA pipe
// sustain on the card, with nothing else in the loop: the yardstick for the
// products inside lstm_bwd.cu (ops/mma_rate.py prints the table).  Every
// warp repeats one mma.sync over `kAccs` independent accumulators, so
// kAccs = 1 shows the rate of a fully dependent chain.  No kernel of the
// model's path; it computes nothing of use.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Mode { kTf32K8 = 0, kBf16K16 = 1, kTf32K4 = 2, kFma = 3 };

template <int kAccs, int kMode>
__global__ void __launch_bounds__(kThreads)
rate_kernel(float* out, int iters) {
  float c[kAccs][4];
#pragma unroll
  for (int i = 0; i < kAccs; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kAccs; ++i) {
      if (kMode == kTf32K8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else if (kMode == kBf16K16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else if (kMode == kTf32K4)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(b[0]));
      else
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[i][e] = fmaf(c[i][e], __uint_as_float(a[e]),
                         __uint_as_float(b[e & 1]));
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kAccs; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int kAccs, int kMode>
cudaError_t run(float* out, int blocks, int iters, float* ms,
                cudaStream_t stream) {
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  rate_kernel<kAccs, kMode><<<blocks, kThreads, 0, stream>>>(out, 16);
  cudaEventRecord(start, stream);
  rate_kernel<kAccs, kMode><<<blocks, kThreads, 0, stream>>>(out, iters);
  cudaEventRecord(stop, stream);
  cudaError_t err = cudaEventSynchronize(stop);
  if (err == cudaSuccess) err = cudaEventElapsedTime(ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs `iters` rounds of kAccs mma.sync (or FMAs) a warp in `blocks`
// blocks of 8 warps and writes the second launch's milliseconds to ms[0].
// mode: 0 = m16n8k8 TF32, 1 = m16n8k16 bf16, 2 = m16n8k4 TF32, 3 = 4 float32
// FMAs a thread.  accs: 1 or 8.  out: blocks * 256 floats of scratch.
// Returns a cudaError_t (0 = success).
int mdd_mma_rate(float* out, float* ms, int mode, int accs, int blocks,
                 int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (accs != 1 && accs != 8) return cudaErrorInvalidValue;
  switch (mode * 2 + (accs == 8)) {
    case 0: return run<1, kTf32K8>(out, blocks, iters, ms, s);
    case 1: return run<8, kTf32K8>(out, blocks, iters, ms, s);
    case 2: return run<1, kBf16K16>(out, blocks, iters, ms, s);
    case 3: return run<8, kBf16K16>(out, blocks, iters, ms, s);
    case 4: return run<1, kTf32K4>(out, blocks, iters, ms, s);
    case 5: return run<8, kTf32K4>(out, blocks, iters, ms, s);
    case 6: return run<1, kFma>(out, blocks, iters, ms, s);
    case 7: return run<8, kFma>(out, blocks, iters, ms, s);
  }
  return cudaErrorInvalidValue;
}

const char* mdd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
