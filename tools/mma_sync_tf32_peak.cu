// The rate of mma.sync.aligned.m16n8k8 with TF32 operands and float32
// accumulation on the first CUDA card: every warp runs independent chains
// of the instruction on register operands only (no loads, no splits), the
// ceiling for K3's float32 backward and K4's 3xTF32 products, which need
// three of them for every float32 product.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//        -o build/mma_sync_tf32_peak tools/mma_sync_tf32_peak.cu
//   build/mma_sync_tf32_peak
//
// Prints one JSON object a line: chains a warp, warps a block, blocks an
// SM, TFLOP/s (2 * 16 * 8 * 8 a instruction, CUDA events around one launch
// after a warm-up launch).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

template <int CHAINS>
__global__ void tf32_chains(float* out, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1234.5f) out[threadIdx.x] = s;  // keeps the chains alive
}

template <int CHAINS>
int run(int warps, int blocks_per_sm) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) !=
      cudaSuccess)
    return 1;
  float* out = nullptr;
  if (cudaMalloc(&out, 4096) != cudaSuccess) return 1;
  const int iters = 4096, blocks = sms * blocks_per_sm;
  tf32_chains<CHAINS><<<blocks, 32 * warps>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  tf32_chains<CHAINS><<<blocks, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops =
      2.0 * 16 * 8 * 8 * (double)CHAINS * iters * warps * blocks;
  printf("{\"chains\": %d, \"warps_per_block\": %d, \"blocks_per_sm\": %d, "
         "\"tflops\": %.1f}\n",
         CHAINS, warps, blocks_per_sm, flops / ms / 1e9);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}

int main() {
  int err = 0;
  err |= run<4>(4, 1);
  err |= run<8>(4, 1);
  err |= run<8>(4, 2);
  err |= run<8>(8, 2);
  err |= run<16>(8, 2);
  return err;
}
