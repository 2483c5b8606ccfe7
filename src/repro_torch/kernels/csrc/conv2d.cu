// Stride-1 2-D convolution for NVIDIA Hopper (sm_90a), NHWC x HWIO -> NHWC.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers).  Unlike dse_sweep.cu this source is built WITH FMA
// contraction: the kernel is held to its plain version by a tolerance, not
// bit for bit (the sum over kh*kw*Cin terms is taken in another order anyway).
// Every entry point takes raw device pointers and the caller's CUDA stream,
// launches on that stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// conv2d<T>   replaces the TPU kernel repro/kernels/conv2d.py::_conv_kernel
//
//   y[b, oh, ow, n] = sum_{i, j, c} x[b, oh + i - pad_t, ow + j - pad_l, c]
//                                  * w[i, j, c, n]
//   over the zero-padded input: a read outside [0, H) x [0, W) is 0, so the
//   top/left padding is (pad_t, pad_l) and the bottom/right padding is
//   whatever H_out / W_out imply.  VALID is pad 0; SAME is (kh//2, kw//2)
//   with H_out = H, W_out = W.  Inputs are read as T (float or bf16),
//   converted to float, accumulated in float and the output is rounded to T
//   once -- what _conv_kernel does with its float32 accumulator.
//     in : x [B, H, W, Cin], w [KH, KW, Cin, Cout] (T, contiguous)
//     out: y [B, H_out, W_out, Cout] (T)
//
//   The TPU kernel walks one (batch, row tile) per grid step and adds kh*kw
//   shifted-window MXU matmuls [tile_h*W_out, Cin] x [Cin, Cout]; its tile
//   must divide H_out.  Here the same sum is an implicit GEMM with
//     M = B*H_out*W_out (output pixels), N = Cout, K = KH*KW*Cin,
//   the K axis walked tap by tap (i, j) and, inside a tap, in chunks of BK
//   channels.  HWIO weights are already the [K, N] row-major matrix; the A
//   operand is never materialised (no im2col): each thread keeps the
//   (b, oh, ow) of the pixels it loads and gathers the shifted window from x
//   with a bounds check, which is the padding.  Every edge (M, N, Cin not
//   multiples of the tile) is masked, so there is no divisibility rule.
//
//   Bound on an H100: operations.  ResNet-50's stride-1 convs do 2*M*N*K
//   flops on about (M*Cin + K*N + M*N) elements, 10^2..10^3 flops per byte,
//   above the card's ridge point.  This first version runs on the CUDA cores
//   in float32 FMAs (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s
//   bf16 dense), so it cannot come near the bf16 bound; wgmma + TMA is later
//   work.  What the design does about the operations: a 128 x 64 output tile
//   per 256-thread block, each thread accumulating an 8 x 4 register tile
//   (32 FMAs per 12 shared-memory reads); the next K chunk is fetched from
//   device memory into registers while the current one is multiplied out of
//   shared memory; A is stored k-major with a 4-float pad so the compute loop
//   reads both operands as float4.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as Tensor.to()
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ y, int B, int H, int W, int Cin, int Cout,
              int KH, int KW, int pad_t, int pad_l, int Ho, int Wo) {
  __shared__ __align__(16) float As[kBK][kBM + kApad];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int M = B * Ho * Wo;  // the wrapper checks it fits an int
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
      a_ow[r] = m % Wo;
      const int t = m / Wo;
      a_oh[r] = t % Ho;
      a_b[r] = t / Ho;
    } else {
      a_b[r] = -1;
      a_oh[r] = 0;
      a_ow[r] = 0;
    }
  }
  const int b_n = tid % kBN;
  const int b_k = tid / kBN;

  const int n_chunks = (Cin + kBK - 1) / kBK;
  const int n_steps = KH * KW * n_chunks;

  float ra[kRA], rb[kRB];
  // fetch K step `s` (tap s / n_chunks, channel chunk s % n_chunks) into
  // registers; out-of-range elements (padding, ragged edges) are 0
  auto fetch = [&](int s) {
    const int tap = s / n_chunks;
    const int c0 = (s - tap * n_chunks) * kBK;
    const int i = tap / KW;
    const int j = tap - i * KW;
    const int c = c0 + a_k;
#pragma unroll
    for (int r = 0; r < kRA; ++r) {
      float v = 0.0f;
      const int ih = a_oh[r] + i - pad_t;
      const int iw = a_ow[r] + j - pad_l;
      if (a_b[r] >= 0 && c < Cin && (unsigned)ih < (unsigned)H &&
          (unsigned)iw < (unsigned)W) {
        v = to_float(x[(((int64_t)a_b[r] * H + ih) * W + iw) * Cin + c]);
      }
      ra[r] = v;
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const int cc = c0 + b_k + r * kBStep;
      rb[r] = (cc < Cin && n < Cout)
                  ? to_float(w[((int64_t)tap * Cin + cc) * Cout + n])
                  : 0.0f;
    }
  };

  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) acc[a][b] = 0.0f;

  fetch(0);
  for (int s = 0; s < n_steps; ++s) {
#pragma unroll
    for (int r = 0; r < kRA; ++r) As[a_k][a_m + r * kAStep] = ra[r];
#pragma unroll
    for (int r = 0; r < kRB; ++r) Bs[b_k + r * kBStep][b_n] = rb[r];
    __syncthreads();
    if (s + 1 < n_steps) fetch(s + 1);  // in flight during the products
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
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) acc[a][b] += av[a] * bv[b];
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int m = m0 + ty * kTM + a;
    if (m >= M) break;
#pragma unroll
    for (int b = 0; b < kTN; ++b) {
      const int n = n0 + tx * kTN + b;
      if (n < Cout) y[(int64_t)m * Cout + n] = from_float<T>(acc[a][b]);
    }
  }
}

template <typename T>
int launch_conv2d(const void* x, const void* w, void* y, int B, int H, int W,
                  int Cin, int Cout, int KH, int KW, int pad_t, int pad_l,
                  int Ho, int Wo, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t M = (int64_t)B * Ho * Wo;
  dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((Cout + kBN - 1) / kBN));
  conv2d_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (T*)y, B, H, W, Cin, Cout, KH, KW, pad_t,
      pad_l, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv2d_f32(const void* x, const void* w, void* y, int B, int H, int W,
               int Cin, int Cout, int KH, int KW, int pad_t, int pad_l,
               int Ho, int Wo, int device, void* stream) {
  return launch_conv2d<float>(x, w, y, B, H, W, Cin, Cout, KH, KW, pad_t,
                              pad_l, Ho, Wo, device, stream);
}

int conv2d_bf16(const void* x, const void* w, void* y, int B, int H, int W,
                int Cin, int Cout, int KH, int KW, int pad_t, int pad_l,
                int Ho, int Wo, int device, void* stream) {
  return launch_conv2d<__nv_bfloat16>(x, w, y, B, H, W, Cin, Cout, KH, KW,
                                      pad_t, pad_l, Ho, Wo, device, stream);
}

const char* conv2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
