// Throughput of one warp-level tensor-core instruction on the card: every
// warp of a full grid runs CHAINS independent accumulators through ITERS
// back-to-back mma.sync instructions, and the host times the launch with
// CUDA events. The operands are fixed registers: what is measured is the
// rate at which the SMs retire the instruction, the ceiling of any kernel
// built on it (flash_attention_fwd.cu and flash_attention_bwd.cu run their
// products as mma.sync.m16n8k8 tf32). Built and run by
// tools/torch_mma_peak.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int CHAINS>
__global__ void tf32_loop(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u,
                         threadIdx.x + 3u};
  const uint32_t b[2] = {blockIdx.x, blockIdx.x + 1u};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
__global__ void bf16_loop(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u,
                         threadIdx.x + 3u};
  const uint32_t b[2] = {blockIdx.x, blockIdx.x + 1u};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <class K>
float time_ms(K kernel, int blocks, int threads, float* out, int iters) {
  kernel<<<blocks, threads>>>(out, iters);   // warm-up
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  kernel<<<blocks, threads>>>(out, iters);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, end);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  return ms;
}

}  // namespace

// TFLOP/s of `kind` (0: mma.sync m16n8k8 tf32, 2048 FLOPs a warp
// instruction; 1: m16n8k16 bf16, 4096) with `chains` (4 or 8) accumulators
// a warp, `blocks` x `threads` threads, `iters` rounds; negative on a CUDA
// error.
extern "C" double mma_peak_tflops(int kind, int chains, int blocks,
                                  int threads, int iters) {
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * threads) != cudaSuccess)
    return -1.0;
  float ms = 0.f;
  if (kind == 0)
    ms = chains == 8 ? time_ms(tf32_loop<8>, blocks, threads, out, iters)
                     : time_ms(tf32_loop<4>, blocks, threads, out, iters);
  else
    ms = chains == 8 ? time_ms(bf16_loop<8>, blocks, threads, out, iters)
                     : time_ms(bf16_loop<4>, blocks, threads, out, iters);
  const cudaError_t err = cudaGetLastError();
  cudaFree(out);
  if (err != cudaSuccess || ms <= 0.f) return -2.0;
  const double flops_per_mma = kind == 0 ? 2048.0 : 4096.0;
  const double mmas = (double)blocks * (threads / 32) * chains * iters;
  return mmas * flops_per_mma / (ms * 1e-3) / 1e12;
}
