// Stride-1 2-D convolution for NVIDIA Hopper (sm_90a), NHWC x HWIO -> NHWC.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -Xptxas -v
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers).  Unlike dse_sweep.cu this source is built WITH FMA
// contraction: the kernels are held to their plain version by a tolerance,
// not bit for bit (the sum over kh*kw*Cin terms is taken in another order
// anyway).  Every entry point takes raw device pointers and the caller's
// CUDA stream, launches on that stream, does not synchronise, allocates
// nothing (the split-K workspace comes from the caller), and returns a CUDA
// error code: cudaErrorInvalidValue for a launch plan it refuses, else
// cudaGetLastError().
//
// ---------------------------------------------------------------------------
// K2   replaces the TPU kernel repro/kernels/conv2d.py::_conv_kernel
//
//   y[b, oh, ow, n] = sum_{i, j, c} x[b, oh + i - pad_t, ow + j - pad_l, c]
//                                  * w[i, j, c, n]
//   over the zero-padded input: a read outside [0, H) x [0, W) is 0, so the
//   top/left padding is (pad_t, pad_l) and the bottom/right padding is
//   whatever H_out / W_out imply.  Inputs are read as T (float or bf16),
//   products are accumulated in float32 and the output is rounded to T once
//   -- what _conv_kernel does with its float32 accumulator.
//     in : x [B, H, W, Cin], w [KH, KW, Cin, Cout] (T, contiguous)
//     out: y [B, H_out, W_out, Cout] (T)
//
//   The TPU kernel adds kh*kw shifted-window MXU matmuls per (batch, row
//   tile).  Here the same sum is an implicit GEMM with
//     M = B*H_out*W_out (output pixels), N = Cout, K = KH*KW*Cin,
//   walked tap by tap (i, j) and, inside a tap, in chunks of BK channels
//   (one "step").  HWIO weights are already the [K, N] matrix with N
//   contiguous and are read in place; the A operand is never materialised.
//
//   Bound on an H100: operations.  ResNet-50's stride-1 convolutions do
//   2*M*N*K flops on about (M*Cin + K*N + M*N) elements, 10^2..10^3 flops per
//   byte, above the card's ridge point for both dtypes.
//
//   The launch plan -- variant, tile, split, grid -- is made in Python
//   (repro_torch/kernels/conv2d.py, plan()).  These entry points check that
//   a plan fits the shape and obey it; they choose nothing.
//
//   Split-K.  Where the tile grid cannot fill the card, the plan cuts the K
//   walk into `split` slices of whole steps: slice z covers steps
//   [z*steps/split, (z+1)*steps/split).  Each block of slice z writes its
//   float32 partial tile to ws[z, M, N]; k2_conv2d_splitk_sum_kernel then
//   adds the slices in slice order and rounds once.  No atomics: the result
//   does not depend on scheduling, two runs give the same bits.
//
//   Variants (every kernel's name starts with k2_conv2d_, the profiler's
//   symbol for K2):
//
//   k2_conv2d_bf16_tc_kernel<BN, GATHER>   bf16, Cin % 8 == 0, Cout % 8 == 0,
//     16-byte aligned x and w: every ResNet-50 shape.  Tensor cores:
//     wgmma.mma_async m64nBNk16 bf16 x bf16 -> f32, both operands from shared
//     memory through descriptors, 128-byte swizzle.  Block = 3 warpgroups:
//     warpgroup 0 loads, warpgroups 1 and 2 each multiply 64 rows of the
//     128 x BN tile (BN = 64 or 128, by the plan).  BK = 64 channels = one
//     128-byte swizzle row.  A ring of up to 5 shared-memory stages (the
//     plan's count) with a full and an empty mbarrier each keeps loads in
//     flight while the tensor cores work.
//       B (weights): TMA, a 3-D tensor map over w viewed [taps, Cin, Cout],
//       boxes of 64 channels x 64 outputs; the tile stays N-major, and wgmma
//       reads it as a transposed B (imm-trans-b = 1).  Channels past Cin and
//       outputs past Cout are TMA's zero fill.
//       A, 1x1 with no padding (GATHER = false): TMA, a 2-D tensor map over
//       x viewed [B*H*W, Cin]; rows past M are TMA's zero fill.
//       A, any other kernel (GATHER = true): 16-byte cp.async gathers by the
//       128 threads of warpgroup 0, zero-filled (src-size 0) for a pixel in
//       the padding or past M, written in the 128-byte swizzled layout that
//       TMA would write, completing on the stage's mbarrier through
//       cp.async.mbarrier.arrive.noinc.  Chosen over TMA's im2col mode: the
//       M tile runs across image rows and images, which im2col boxes do not
//       describe, and the padding is one compare per 16 bytes.
//     Epilogue: accumulator fragments straight to bf16x2 (or float2 partial
//     sums) in global memory, masked past M.
//
//   k2_conv2d_f32_kernel<BN, VEC>   float32, any shape.  The reference
//     convolves float32 in IEEE float32, so this stays on the CUDA cores
//     (67 TFLOP/s; TF32 would break the tolerance).  A 128 x BN tile per
//     256-thread block, an 8 x (BN/16) register tile per thread, BK = 16
//     channels per step; both operands double-buffered in shared memory by
//     cp.async of VEC floats (16 bytes where Cin % 4 == 0, Cout % 4 == 0 and
//     x, w are 16-byte aligned, else 4 bytes), so one barrier per step.  A is
//     kept pixel-major; the inner loop reads 4 channels of 8 pixels and 4
//     rows of B as float4s and does 32*(BN/16) FMAs per 8 + BN/32 reads.
//
//   k2_conv2d_simt_kernel   bf16 shapes the tensor-core kernel does not take
//     (Cin or Cout not a multiple of 8, or a misaligned view): the first
//     CUDA-core version, a 128 x 64 tile, register-staged loads, no split.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

using bf16 = __nv_bfloat16;

struct ConvShape {
  int B, H, W, Cin, Cout, KH, KW, pad_t, pad_l, Ho, Wo;
  int M;       // B * Ho * Wo (the wrapper checks it fits an int)
  int chunks;  // channel chunks per tap, ceil(Cin / BK)
  int steps;   // KH * KW * chunks
  int split;   // K slices = gridDim.z
  int stages;  // tensor-core kernel: shared-memory stages in the ring
};

ConvShape make_shape(int B, int H, int W, int Cin, int Cout, int KH, int KW,
                     int pad_t, int pad_l, int Ho, int Wo, int bk, int split,
                     int stages = 0) {
  ConvShape a{B, H, W, Cin, Cout, KH, KW, pad_t, pad_l, Ho, Wo};
  a.M = B * Ho * Wo;
  a.chunks = (Cin + bk - 1) / bk;
  a.steps = KH * KW * a.chunks;
  a.split = split;
  a.stages = stages;
  return a;
}

// the steps of K slice z: the plan's Plan.slice_bounds
__device__ __forceinline__ void slice_bounds(const ConvShape& a, int z,
                                             int& s0, int& s1) {
  s0 = (int)((int64_t)z * a.steps / a.split);
  s1 = (int)((int64_t)(z + 1) * a.steps / a.split);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// D[64 x N] += A[64 x 16] (K-major, descriptor da) * B[16 x N] (N-major,
// descriptor db, imm-trans-b = 1), bf16 x bf16 -> f32
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  wgmma_m64n64k16(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  wgmma_m64n128k16(d, da, db);
}

// --- k2_conv2d_bf16_tc_kernel ------------------------------------------------

constexpr int kTcBM = 128;
constexpr int kTcBK = 64;  // channels per step: one 128-byte swizzle row
constexpr int kTcMaxStages = 5;
constexpr int kTcThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kTcABytes = kTcBM * kTcBK * 2;  // 16 KiB per stage
constexpr int kBoxBytes = 64 * 64 * 2;        // one 64 x 64 bf16 TMA box

// stages of A and B, full and empty barriers, 1 KiB to align the base
constexpr int tc_smem_bytes(int bn, int stages) {
  return stages * (kTcABytes + kTcBK * bn * 2) + 2 * stages * 8 + 1024;
}

// 128 x 64: at most 80 registers, so that two blocks fit on an SM; 128 x 128
// needs 90 (its wgmma alone holds 64 accumulators a thread): one block
template <int BN, bool GATHER>
__global__ void __launch_bounds__(kTcThreads, BN == 64 ? 2 : 1)
k2_conv2d_bf16_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const bf16* __restrict__ x, bf16* __restrict__ y,
                         float* __restrict__ ws, ConvShape a) {
  constexpr int kBBytes = kTcBK * BN * 2;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem;
  const int stages = a.stages;
  uint8_t* sB = smem + stages * kTcABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + stages * kBBytes);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      // GATHER: 128 cp.async arrivals + thread 0's expect_tx for B
      mbar_init(&full[st], GATHER ? 129 : 1);
      mbar_init(&empty[st], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * BN;
  int s0, s1;
  slice_bounds(a, blockIdx.z, s0, s1);
  const int wg = tid / 128;

  if (wg == 0) {
    // ---- producer ----
    if (GATHER) {
      // thread t copies 16-byte chunk (t % 8) of rows t/8 + 16 r, r < 8;
      // the (b, oh, ow) of its rows is decoded once; b = -1 past M
      const int c = tid & 7;
      int rb[8], roh[8], row_[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = m0 + (tid >> 3) + 16 * r;
        if (m < a.M) {
          row_[r] = m % a.Wo;
          const int t = m / a.Wo;
          roh[r] = t % a.Ho;
          rb[r] = t / a.Ho;
        } else {
          rb[r] = -1;
          roh[r] = 0;
          row_[r] = 0;
        }
      }
      for (int s = s0, it = 0; s < s1; ++s, ++it) {
        const int st = it % stages;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        const int tap = s / a.chunks;
        const int c0 = (s - tap * a.chunks) * kTcBK;
        const int i = tap / a.KW;
        const int j = tap - i * a.KW;
        if (tid == 0) {
          mbar_arrive_expect_tx(&full[st], kBBytes);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load_3d(sB + st * kBBytes + h * kBoxBytes, &tm_w, &full[st],
                        n0 + 64 * h, c0, tap);
        }
        const int cc = c0 + c * 8;
        const uint32_t base = smem_u32(sA + st * kTcABytes);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int row = (tid >> 3) + 16 * r;
          const int ih = roh[r] + i - a.pad_t;
          const int iw = row_[r] + j - a.pad_l;
          const bool ok = rb[r] >= 0 && cc < a.Cin &&
                          (unsigned)ih < (unsigned)a.H &&
                          (unsigned)iw < (unsigned)a.W;
          const bf16* src =
              ok ? x + (((int64_t)rb[r] * a.H + ih) * a.W + iw) * a.Cin + cc
                 : x;
          // 128-byte swizzle: chunk c of row `row` sits at c ^ (row % 8)
          cp_async16(base + row * 128 + ((c ^ (row & 7)) << 4), src, ok);
        }
        mbar_arrive_cp_async(&full[st]);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (tid == 0) {
      for (int s = s0, it = 0; s < s1; ++s, ++it) {
        const int st = it % stages;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        const int c0 = s * kTcBK;  // 1x1: one tap, step = channel chunk
        mbar_arrive_expect_tx(&full[st], kTcABytes + kBBytes);
        tma_load_2d(sA + st * kTcABytes, &tm_x, &full[st], c0, m0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_load_3d(sB + st * kBBytes + h * kBoxBytes, &tm_w, &full[st],
                      n0 + 64 * h, c0, 0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw multiplies rows [64 cw, 64 cw + 64) ----
  const int cw = wg - 1;
  float acc[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) acc[q] = 0.0f;
  for (int s = s0, it = 0; s < s1; ++s, ++it) {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    // cp.async wrote A through the generic proxy; wgmma reads through the
    // async proxy
    if (GATHER) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t a_addr = smem_u32(sA + st * kTcABytes + cw * 64 * 128);
    const uint32_t b_addr = smem_u32(sB + st * kBBytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, the
      //    16-channel slice kk at +32 kk bytes inside the swizzled row
      // B: N-major, rows of 64 outputs; 8-channel groups 1024 bytes apart
      //    (SBO), 64-output boxes kBoxBytes apart (LBO); slice kk = 16 rows
      wgmma_tile<BN>(acc, smem_desc(a_addr + kk * 32, 16, 1024),
                     smem_desc(b_addr + kk * 2048, kBoxBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    mbar_arrive(&empty[st]);
  }

  // accumulator fragment: thread t of the warpgroup holds rows
  // 16 (t / 32) + (t % 32) / 4 and +8, columns 8 q + 2 (t % 4) + {0, 1}
  // in acc[4 q + {0, 1}] and acc[4 q + {2, 3}]
  const int t = tid & 127;
  const int r0 = m0 + cw * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int n = n0 + q * 8 + (t & 3) * 2;
    if (n >= a.Cout) continue;  // Cout % 8 == 0: n + 1 < Cout too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= a.M) continue;
      const float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      if (a.split > 1) {
        *reinterpret_cast<float2*>(
            ws + ((int64_t)blockIdx.z * a.M + m) * a.Cout + n) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(y + (int64_t)m * a.Cout + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// --- k2_conv2d_f32_kernel ----------------------------------------------------

constexpr int kF32BM = 128;
constexpr int kF32BK = 16;
constexpr int kF32Threads = 256;  // 16 x 16 threads
constexpr int kF32Apad = 4;       // A rows of 20 floats: 16-byte aligned

template <int BN, int VEC>
__global__ void __launch_bounds__(kF32Threads)
k2_conv2d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, float* __restrict__ ws,
                     ConvShape a) {
  constexpr int TN = BN / 16;                          // 8 or 4 outputs
  constexpr int RA = kF32BM * kF32BK / VEC / kF32Threads;  // A copies
  constexpr int RB = kF32BK * BN / VEC / kF32Threads;      // B copies
  constexpr int AC = kF32BK / VEC;  // copies per A row
  constexpr int BC = BN / VEC;      // copies per B row
  static_assert(kF32Threads % AC == 0 && kF32Threads % BC == 0, "tiling");
  __shared__ __align__(16) float As[2][kF32BM][kF32BK + kF32Apad];
  __shared__ __align__(16) float Bs[2][kF32BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * BN;
  int s0, s1;
  slice_bounds(a, blockIdx.z, s0, s1);

  // the pixels of this thread's A copies, decoded once; b = -1 past M
  const int a_k = (tid % AC) * VEC;
  int a_b[RA], a_oh[RA], a_ow[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int m = m0 + (tid + r * kF32Threads) / AC;
    if (m < a.M) {
      a_ow[r] = m % a.Wo;
      const int t = m / a.Wo;
      a_oh[r] = t % a.Ho;
      a_b[r] = t / a.Ho;
    } else {
      a_b[r] = -1;
      a_oh[r] = 0;
      a_ow[r] = 0;
    }
  }
  const int b_n = (tid % BC) * VEC;

  auto load = [&](int buf, int s) {
    const int tap = s / a.chunks;
    const int c0 = (s - tap * a.chunks) * kF32BK;
    const int i = tap / a.KW;
    const int j = tap - i * a.KW;
    const int c = c0 + a_k;
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int row = (tid + r * kF32Threads) / AC;
      const int ih = a_oh[r] + i - a.pad_t;
      const int iw = a_ow[r] + j - a.pad_l;
      const bool ok = a_b[r] >= 0 && c < a.Cin &&
                      (unsigned)ih < (unsigned)a.H &&
                      (unsigned)iw < (unsigned)a.W;
      const float* src =
          ok ? x + (((int64_t)a_b[r] * a.H + ih) * a.W + iw) * a.Cin + c : x;
      const uint32_t dst = smem_u32(&As[buf][row][a_k]);
      if (VEC == 4) cp_async16(dst, src, ok);
      else cp_async4(dst, src, ok);
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int k = (tid + r * kF32Threads) / BC;
      const int cc = c0 + k;
      const bool ok = cc < a.Cin && n < a.Cout;
      const float* src = ok ? w + ((int64_t)tap * a.Cin + cc) * a.Cout + n : w;
      const uint32_t dst = smem_u32(&Bs[buf][k][b_n]);
      if (VEC == 4) cp_async16(dst, src, ok);
      else cp_async4(dst, src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // thread (tx, ty): pixels 4 ty + {0..3} and 64 + 4 ty + {0..3}, outputs
  // 4 tx + {0..3} (and 64 + 4 tx + {0..3} where BN = 128): a quarter warp
  // reads 128 consecutive bytes of B, all of a warp's A reads are 2 rows
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][TN];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[p][q] = 0.0f;

  if (s0 < s1) load(0, s0);
  for (int s = s0, it = 0; s < s1; ++s, ++it) {
    const int buf = it & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // one barrier: step s has landed for every thread, and every thread is
    // done reading buffer buf ^ 1 (step s - 1)
    __syncthreads();
    if (s + 1 < s1) load(buf ^ 1, s + 1);  // in flight during the products
#pragma unroll
    for (int k4 = 0; k4 < kF32BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int row = (p < 4 ? 4 * ty + p : 64 + 4 * ty + p - 4);
        av[p] = *reinterpret_cast<const float4*>(&As[buf][row][k4]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 t4 = *reinterpret_cast<const float4*>(
              &Bs[buf][k4 + kk][64 * g + 4 * tx]);
          bv[4 * g] = t4.x;
          bv[4 * g + 1] = t4.y;
          bv[4 * g + 2] = t4.z;
          bv[4 * g + 3] = t4.w;
        }
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float v = kk == 0 ? av[p].x
                        : kk == 1 ? av[p].y
                        : kk == 2 ? av[p].z
                                  : av[p].w;
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[p][q] += v * bv[q];
        }
      }
    }
  }

  float* out = a.split > 1 ? ws + (int64_t)blockIdx.z * a.M * a.Cout : y;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int m = m0 + (p < 4 ? 4 * ty + p : 64 + 4 * ty + p - 4);
    if (m >= a.M) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int n = n0 + 64 * g + 4 * tx;
      float* dst = out + (int64_t)m * a.Cout + n;
      if (VEC == 4) {  // Cout % 4 == 0: all four or none
        if (n < a.Cout)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[p][4 * g], acc[p][4 * g + 1],
                          acc[p][4 * g + 2], acc[p][4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < a.Cout) dst[e] = acc[p][4 * g + e];
      }
    }
  }
}

// --- k2_conv2d_splitk_sum_kernel ---------------------------------------------

__device__ __forceinline__ void store4(float* y, float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}
__device__ __forceinline__ void store4(bf16* y, float4 v) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(y);
  p[0] = __floats2bfloat162_rn(v.x, v.y);
  p[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void store1(float* y, float v) { *y = v; }
__device__ __forceinline__ void store1(bf16* y, float v) {
  *y = __float2bfloat16(v);  // round to nearest even, as Tensor.to()
}

// y[e] = ((ws[0, e] + ws[1, e]) + ws[2, e]) + ... over the `split` slices,
// in slice order, rounded to T once; VEC consecutive elements per thread
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
k2_conv2d_splitk_sum_kernel(const float* __restrict__ ws, T* __restrict__ y,
                            int64_t n, int split) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e >= n) return;
  if (VEC == 4) {
    float4 s = *reinterpret_cast<const float4*>(ws + e);
    for (int z = 1; z < split; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(ws + z * n + e);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    store4(y + e, s);
  } else {
    float s = ws[e];
    for (int z = 1; z < split; ++z) s += ws[z * n + e];
    store1(y + e, s);
  }
}

// --- k2_conv2d_simt_kernel (bf16 shapes outside the tensor-core kernel) -----

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per K chunk
constexpr int kTM = 8;    // pixels per thread
constexpr int kTN = 4;    // channels per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kApad = 4;  // keeps A rows 16-byte aligned for float4 reads

static_assert(kThreads % kBK == 0, "A loads: threads must tile BK");
static_assert(kThreads % kBN == 0, "B loads: threads must tile BN");
static_assert((kBM * kBK) % kThreads == 0, "A loads must divide evenly");
static_assert((kBK * kBN) % kThreads == 0, "B loads must divide evenly");
static_assert(kTM % 4 == 0 && kTN % 4 == 0, "float4 reads of the tiles");

constexpr int kRA = kBM * kBK / kThreads;  // A elements each thread loads: 8
constexpr int kRB = kBK * kBN / kThreads;  // B elements each thread loads: 4
constexpr int kAStep = kThreads / kBK;     // pixel stride between them: 16
constexpr int kBStep = kThreads / kBN;     // channel stride between them: 4

__global__ void __launch_bounds__(kThreads)
k2_conv2d_simt_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ y, ConvShape a) {
  __shared__ __align__(16) float As[kBK][kBM + kApad];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int M = a.M;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // The pixels whose A elements this thread loads: fixed for the whole K
  // walk, so their (b, oh, ow) is decoded once.  b = -1 marks a pixel past M.
  const int a_k = tid % kBK;
  const int a_m = tid / kBK;
  int a_b[kRA], a_oh[kRA], a_ow[kRA];
#pragma unroll
  for (int r = 0; r < kRA; ++r) {
    const int m = m0 + a_m + r * kAStep;
    if (m < M) {
      a_ow[r] = m % a.Wo;
      const int t = m / a.Wo;
      a_oh[r] = t % a.Ho;
      a_b[r] = t / a.Ho;
    } else {
      a_b[r] = -1;
      a_oh[r] = 0;
      a_ow[r] = 0;
    }
  }
  const int b_n = tid % kBN;
  const int b_k = tid / kBN;

  float ra[kRA], rb[kRB];
  // fetch K step `s` (tap s / chunks, channel chunk s % chunks) into
  // registers; out-of-range elements (padding, ragged edges) are 0
  auto fetch = [&](int s) {
    const int tap = s / a.chunks;
    const int c0 = (s - tap * a.chunks) * kBK;
    const int i = tap / a.KW;
    const int j = tap - i * a.KW;
    const int c = c0 + a_k;
#pragma unroll
    for (int r = 0; r < kRA; ++r) {
      float v = 0.0f;
      const int ih = a_oh[r] + i - a.pad_t;
      const int iw = a_ow[r] + j - a.pad_l;
      if (a_b[r] >= 0 && c < a.Cin && (unsigned)ih < (unsigned)a.H &&
          (unsigned)iw < (unsigned)a.W) {
        v = __bfloat162float(
            x[(((int64_t)a_b[r] * a.H + ih) * a.W + iw) * a.Cin + c]);
      }
      ra[r] = v;
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const int cc = c0 + b_k + r * kBStep;
      rb[r] = (cc < a.Cin && n < a.Cout)
                  ? __bfloat162float(
                        w[((int64_t)tap * a.Cin + cc) * a.Cout + n])
                  : 0.0f;
    }
  };

  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int p = 0; p < kTM; ++p)
#pragma unroll
    for (int q = 0; q < kTN; ++q) acc[p][q] = 0.0f;

  fetch(0);
  for (int s = 0; s < a.steps; ++s) {
#pragma unroll
    for (int r = 0; r < kRA; ++r) As[a_k][a_m + r * kAStep] = ra[r];
#pragma unroll
    for (int r = 0; r < kRB; ++r) Bs[b_k + r * kBStep][b_n] = rb[r];
    __syncthreads();
    if (s + 1 < a.steps) fetch(s + 1);  // in flight during the products
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int q = 0; q < kTM; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&As[k][ty * kTM + q]);
        av[q] = t.x; av[q + 1] = t.y; av[q + 2] = t.z; av[q + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < kTN; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN + q]);
        bv[q] = t.x; bv[q + 1] = t.y; bv[q + 2] = t.z; bv[q + 3] = t.w;
      }
#pragma unroll
      for (int p = 0; p < kTM; ++p)
#pragma unroll
        for (int q = 0; q < kTN; ++q) acc[p][q] += av[p] * bv[q];
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kTM; ++p) {
    const int m = m0 + ty * kTM + p;
    if (m >= M) break;
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      const int n = n0 + tx * kTN + q;
      if (n < a.Cout) y[(int64_t)m * a.Cout + n] = __float2bfloat16(acc[p][q]);
    }
  }
}

// --- host side ---------------------------------------------------------------

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the split-K workspace and grid checks every variant shares
bool plan_fits(const ConvShape& a, int bm, int bn, int gx, int gy,
               const void* ws) {
  return a.split >= 1 && a.split <= a.steps && (a.split == 1 || ws) &&
         gx == ceil_div(a.M, bm) && gy == ceil_div(a.Cout, bn);
}

template <typename T>
cudaError_t launch_sum(const float* ws, T* y, const ConvShape& a, int vec,
                       cudaStream_t stream) {
  const int64_t n = (int64_t)a.M * a.Cout;
  const unsigned blocks = (unsigned)ceil_div(ceil_div(n, vec), 256);
  if (vec == 4)
    k2_conv2d_splitk_sum_kernel<T, 4><<<blocks, 256, 0, stream>>>(
        ws, y, n, a.split);
  else
    k2_conv2d_splitk_sum_kernel<T, 1><<<blocks, 256, 0, stream>>>(
        ws, y, n, a.split);
  return cudaGetLastError();
}

template <int BN, bool GATHER>
int launch_tc(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
              const bf16* x, bf16* y, float* ws, const ConvShape& a, dim3 grid,
              int device, cudaStream_t stream) {
  static unsigned done = 0;
  auto kernel = k2_conv2d_bf16_tc_kernel<BN, GATHER>;
  cudaError_t err = allow_smem(kernel, tc_smem_bytes(BN, kTcMaxStages),
                               device, &done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTcThreads, tc_smem_bytes(BN, a.stages), stream>>>(
      tm_x, tm_w, x, y, ws, a);
  err = cudaGetLastError();
  if (err == cudaSuccess && a.split > 1) err = launch_sum(ws, y, a, 4, stream);
  return (int)err;
}

template <int BN, int VEC>
int launch_f32(const float* x, const float* w, float* y, float* ws,
               const ConvShape& a, dim3 grid, cudaStream_t stream) {
  k2_conv2d_f32_kernel<BN, VEC><<<grid, kF32Threads, 0, stream>>>(x, w, y,
                                                                  ws, a);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && a.split > 1)
    err = launch_sum(ws, y, a, VEC, stream);
  return (int)err;
}

}  // namespace

extern "C" {

// bf16 on the tensor cores.  Plan: bn (64 or 128), gather (0: TMA for x,
// only 1x1 with no padding; 1: cp.async gathers), stages of the ring
// (1..5), split, grid (gx, gy).
int conv2d_bf16_tc(const void* x, const void* w, void* y, void* ws, int B,
                   int H, int W, int Cin, int Cout, int KH, int KW, int pad_t,
                   int pad_l, int Ho, int Wo, int bn, int gather, int stages,
                   int split, int gx, int gy, int device, void* stream) {
  const ConvShape a = make_shape(B, H, W, Cin, Cout, KH, KW, pad_t, pad_l, Ho,
                                 Wo, kTcBK, split, stages);
  const bool direct = KH == 1 && KW == 1 && pad_t == 0 && pad_l == 0 &&
                      Ho == H && Wo == W;
  if ((bn != 64 && bn != 128) || stages < 1 || stages > kTcMaxStages ||
      Cin % 8 || Cout % 8 || !aligned16(x) ||
      !aligned16(w) || !plan_fits(a, kTcBM, bn, gx, gy, ws) ||
      (!gather && !direct))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm_x = {}, tm_w = {};
  const cuuint64_t w_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin,
                                (cuuint64_t)(KH * KW)};
  const cuuint64_t w_strides[2] = {(cuuint64_t)Cout * 2,
                                   (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t w_box[3] = {64, kTcBK, 1};
  if (!encode_bf16(&tm_w, w, 3, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  if (!gather) {
    const cuuint64_t x_dims[2] = {(cuuint64_t)Cin, (cuuint64_t)a.M};
    const cuuint64_t x_strides[1] = {(cuuint64_t)Cin * 2};
    const cuuint32_t x_box[2] = {kTcBK, kTcBM};
    if (!encode_bf16(&tm_x, x, 2, x_dims, x_strides, x_box))
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)split);
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  bf16* yb = (bf16*)y;
  float* wsf = (float*)ws;
  if (bn == 64)
    return gather ? launch_tc<64, true>(tm_x, tm_w, xb, yb, wsf, a, grid,
                                        device, s)
                  : launch_tc<64, false>(tm_x, tm_w, xb, yb, wsf, a, grid,
                                         device, s);
  return gather ? launch_tc<128, true>(tm_x, tm_w, xb, yb, wsf, a, grid,
                                       device, s)
                : launch_tc<128, false>(tm_x, tm_w, xb, yb, wsf, a, grid,
                                        device, s);
}

// bf16 on the CUDA cores, any shape.  Plan: grid (gx, gy), no split.
int conv2d_bf16_simt(const void* x, const void* w, void* y, int B, int H,
                     int W, int Cin, int Cout, int KH, int KW, int pad_t,
                     int pad_l, int Ho, int Wo, int gx, int gy, int device,
                     void* stream) {
  const ConvShape a = make_shape(B, H, W, Cin, Cout, KH, KW, pad_t, pad_l, Ho,
                                 Wo, kBK, 1);
  if (!plan_fits(a, kBM, kBN, gx, gy, nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  k2_conv2d_simt_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)y, a);
  return (int)cudaGetLastError();
}

// float32 on the CUDA cores, any shape.  Plan: bn (64 or 128), vec (4:
// 16-byte copies, needs Cin % 4 == 0, Cout % 4 == 0 and aligned x, w; 1:
// 4-byte copies), split, grid (gx, gy).
int conv2d_f32(const void* x, const void* w, void* y, void* ws, int B, int H,
               int W, int Cin, int Cout, int KH, int KW, int pad_t,
               int pad_l, int Ho, int Wo, int bn, int vec, int split, int gx,
               int gy, int device, void* stream) {
  const ConvShape a = make_shape(B, H, W, Cin, Cout, KH, KW, pad_t, pad_l, Ho,
                                 Wo, kF32BK, split);
  if ((bn != 64 && bn != 128) || (vec != 1 && vec != 4) ||
      (vec == 4 && (Cin % 4 || Cout % 4 || !aligned16(x) || !aligned16(w) ||
                    !aligned16(y))) ||
      !plan_fits(a, kF32BM, bn, gx, gy, ws))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)split);
  const cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *wf = (const float*)w;
  float *yf = (float*)y, *wsf = (float*)ws;
  if (bn == 64)
    return vec == 4 ? launch_f32<64, 4>(xf, wf, yf, wsf, a, grid, s)
                    : launch_f32<64, 1>(xf, wf, yf, wsf, a, grid, s);
  return vec == 4 ? launch_f32<128, 4>(xf, wf, yf, wsf, a, grid, s)
                  : launch_f32<128, 1>(xf, wf, yf, wsf, a, grid, s);
}

const char* conv2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
