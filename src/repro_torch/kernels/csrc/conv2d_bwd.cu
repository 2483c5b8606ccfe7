// The weight gradient of the stride-1 convolution (K2's backward) for NVIDIA
// Hopper (sm_90a), NHWC x NHWC -> HWIO.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -Xptxas -v
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers), with FMA contraction: the kernels are held to their plain
// version by a tolerance.  Every entry point takes raw device pointers and
// the caller's CUDA stream, launches on that stream, does not synchronise,
// allocates nothing (the workspace comes from the caller), and returns a CUDA
// error code: cudaErrorInvalidValue for a launch plan it refuses, else
// cudaGetLastError().
//
// ---------------------------------------------------------------------------
// K2 backward -- replaces no TPU kernel.  The reference trains through
// lax.conv_general_dilated and jax.vjp (repro/models/resnet.py conv2d); its
// Pallas kernel repro/kernels/conv2d.py::_conv_kernel has no backward.  For
// y = conv(x, w) at stride 1 with pads ((pt, pb), (pl, pr)):
//
//   dx = conv(dy, w_rot), pads ((kh-1-pt, kh-1-pb), (kw-1-pl, kw-1-pr)),
//        w_rot[i, j, co, ci] = w[kh-1-i, kw-1-j, ci, co]
//        -- K2's own forward kernels (conv2d.cu), launched by the wrapper;
//   dw[i, j, ci, co] = sum over pixels p = (b, oh, ow) of
//        xpad[b, oh + i, ow + j, ci] * dy[b, oh, ow, co]
//        -- this file.
//
//   One GEMM per tap (i, j): M = Cin, N = Cout, K = P = B*H_out*W_out.  P is
//   large (100,352 at B=32, 56x56) and the output small (at most 3*3*512*512
//   at ResNet-50's shapes), so the blocks split the pixel walk: block
//   (m tile, n tile, tap * split + z) walks pixel steps [z*steps/split,
//   (z+1)*steps/split) of its tap.  With split > 1 each block writes its
//   float32 partial tile to ws[z, tap, Cin, Cout] and k2_wgrad_sum_kernel
//   adds the slices in slice order and rounds to T once; with split == 1 the
//   block rounds its tile straight into dw.  No atomics: two runs give the
//   same bits.  The split is the plan's (repro_torch/kernels/conv2d.py,
//   plan_wgrad()); these entry points check it and choose nothing.
//
//   Bound on an H100: operations at every ResNet-50 shape (2*P*kh*kw*Cin*Cout
//   flops on P*(Cin + Cout) + kh*kw*Cin*Cout elements).
//
//   Variants (every kernel's name starts with k2_wgrad_, the profiler's
//   symbol for K2's weight gradient):
//
//   k2_wgrad_bf16_tc_kernel   bf16, Cin % 8 == 0, Cout % 8 == 0, 16-byte
//     aligned x and dy: every ResNet-50 shape.  A 128 (Cin) x 128 (Cout)
//     tile per 256-thread block, 8 warps of 64 x 32; the pixel walk in steps
//     of 32 through a ring of 3 shared-memory stages filled by 16-byte
//     cp.async (zero-filled for a pixel in the padding or past P, a channel
//     past Cin or Cout).  Both operands are pixel-major in memory and stay so
//     in shared memory (rows of 128 channels, padded to 136 so that
//     ldmatrix's eight rows fall in distinct banks); ldmatrix.trans turns
//     them into the m16n8k16 fragments (A = x^T, row-major; B = dy, column-
//     major), and mma.sync.m16n8k16 bf16 x bf16 -> f32 multiplies them.
//
//   k2_wgrad_simt_kernel<T>   float32 (the reference convolves float32
//     exactly: IEEE float32 on the CUDA cores, 67 TFLOP/s; TF32 would break
//     the tolerance), and bf16 shapes the tensor-core kernel does not take.
//     A 128 x 128 tile per 256-thread block, 8 x 8 outputs a thread, steps
//     of 8 pixels loaded as T into registers and stored to shared memory as
//     float32, double-buffered: one barrier a step.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

using bf16 = __nv_bfloat16;

struct WgradShape {
  int B, H, W, Cin, Cout, KH, KW, pad_t, pad_l, Ho, Wo;
  int P;      // B * Ho * Wo (the wrapper checks it fits an int)
  int steps;  // ceil(P / BK): the pixel steps of one tap
  int split;  // pixel slices of one tap
};

WgradShape make_shape(int B, int H, int W, int Cin, int Cout, int KH, int KW,
                      int pad_t, int pad_l, int Ho, int Wo, int bk,
                      int split) {
  WgradShape a{B, H, W, Cin, Cout, KH, KW, pad_t, pad_l, Ho, Wo};
  a.P = B * Ho * Wo;
  a.steps = (a.P + bk - 1) / bk;
  a.split = split;
  return a;
}

// the steps of pixel slice z: the plan's WgradPlan.slice_bounds
__device__ __forceinline__ void slice_bounds(const WgradShape& a, int z,
                                             int& s0, int& s1) {
  s0 = (int)((int64_t)z * a.steps / a.split);
  s1 = (int)((int64_t)(z + 1) * a.steps / a.split);
}

// the input element of pixel p under tap (i, j), channel c: its offset in x,
// or -1 for a pixel past P or in the padding
__device__ __forceinline__ int64_t x_offset(const WgradShape& a, int p, int i,
                                            int j, int c) {
  if (p >= a.P) return -1;
  const int ow = p % a.Wo;
  const int t = p / a.Wo;
  const int oh = t % a.Ho;
  const int b = t / a.Ho;
  const int ih = oh + i - a.pad_t;
  const int iw = ow + j - a.pad_l;
  if ((unsigned)ih >= (unsigned)a.H || (unsigned)iw >= (unsigned)a.W)
    return -1;
  return (((int64_t)b * a.H + ih) * a.W + iw) * a.Cin + c;
}

// --- k2_wgrad_bf16_tc_kernel -------------------------------------------------

constexpr int kTcBM = 128;     // input channels a block
constexpr int kTcBN = 128;     // output channels a block
constexpr int kTcBK = 32;      // pixels a step
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;
constexpr int kTcLd = 128 + 8;  // a shared row: 128 channels + 16 bytes
constexpr int kTcStageElems = 2 * kTcBK * kTcLd;  // A then B
constexpr int kTcSmemBytes = kTcStages * kTcStageElems * 2;  // 52,224

// four 8x8 b16 matrices, each transposed: lanes 8i..8i+7 give the row
// addresses of matrix i, and each lane receives (rows 2(lane%4), +1,
// column lane/4) of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kTcThreads, 2)
k2_wgrad_bf16_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                        bf16* __restrict__ dw, float* __restrict__ ws,
                        WgradShape a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // rows (input channels) wm*64 .. +63
  const int wn = warp & 3;   // columns (output channels) wn*32 .. +31
  const int m0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * kTcBN;
  const int tap = blockIdx.z / a.split;
  const int z = blockIdx.z - tap * a.split;
  const int ti = tap / a.KW;
  const int tj = tap - ti * a.KW;
  int s0, s1;
  slice_bounds(a, z, s0, s1);
  const int n_steps = s1 - s0;

  // this thread's copies: 16 bytes (8 channels) of rows tid/16 and
  // tid/16 + 16 of a step, for A (x) and for B (dy)
  const int c8 = (tid & 15) * 8;
  const bool a_chan = m0 + c8 < a.Cin;  // Cin % 8 == 0: all 8 or none
  const bool b_chan = n0 + c8 < a.Cout;

  auto load = [&](int stage, int s) {
    bf16* As = smem + stage * kTcStageElems;
    bf16* Bs = As + kTcBK * kTcLd;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = (tid >> 4) + 16 * e;
      const int p = s * kTcBK + r;
      const int64_t xo = a_chan ? x_offset(a, p, ti, tj, m0 + c8) : -1;
      cp_async16(smem_u32(As + r * kTcLd + c8), xo >= 0 ? x + xo : x, xo >= 0);
      const bool bok = b_chan && p < a.P;
      cp_async16(smem_u32(Bs + r * kTcLd + c8),
                 bok ? dy + (int64_t)p * a.Cout + n0 + c8 : dy, bok);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
  for (int k = 0; k < kTcStages - 1; ++k) {
    if (k < n_steps) load(k, s0 + k);
    else cp_async_commit();  // an empty group keeps the count
  }

  const int mi = lane >> 3;  // ldmatrix: the matrix this lane addresses
  const int mr = lane & 7;   // and its row
  for (int it = 0; it < n_steps; ++it) {
    // step it has landed for this thread; the barrier makes it everyone's
    // and retires every read of the stage the next load overwrites
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    const int next = it + kTcStages - 1;
    if (next < n_steps) load(next % kTcStages, s0 + next);
    else cp_async_commit();
    const bf16* As = smem + (it % kTcStages) * kTcStageElems;
    const bf16* Bs = As + kTcBK * kTcLd;
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      // A = x^T [m, k] from As[k][m]: matrices (m 0-7, k 0-7), (m 8-15,
      // k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15) -- a0a1 .. a6a7
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(af[mt], As + (ks + (mi >> 1) * 8 + mr) * kTcLd +
                                      wm * 64 + mt * 16 + (mi & 1) * 8);
      // B = dy [k, n] from Bs[k][n]: matrices (k 0-7, n 0-7), (k 8-15,
      // n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) -- b0b1, b2b3 of two
      // n8 tiles
      uint32_t bfr[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bfr[np], Bs + (ks + (mi & 1) * 8 + mr) * kTcLd +
                                       wn * 32 + np * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                   bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // the accumulator fragment: (row lane/4 (+8), columns 2(lane%4), +1)
  const int g = lane >> 2;
  const int q = lane & 3;
  const int64_t plane = (int64_t)a.Cin * a.Cout;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (m >= a.Cin) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * q;
        if (n >= a.Cout) continue;  // Cout % 8 == 0: n + 1 < Cout too
        const float v0 = acc[mt][nt][2 * h];
        const float v1 = acc[mt][nt][2 * h + 1];
        const int64_t o = tap * plane + (int64_t)m * a.Cout + n;
        if (a.split > 1) {
          *reinterpret_cast<float2*>(
              ws + (int64_t)z * a.KH * a.KW * plane + o) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dw + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// --- k2_wgrad_simt_kernel<T> -------------------------------------------------

constexpr int kSimtBM = 128;
constexpr int kSimtBN = 128;
constexpr int kSimtBK = 8;  // pixels a step
constexpr int kSimtThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* y, float v) { *y = v; }
__device__ __forceinline__ void store1(bf16* y, float v) {
  *y = __float2bfloat16(v);  // round to nearest even, as Tensor.to()
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
k2_wgrad_simt_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     T* __restrict__ dw, float* __restrict__ ws,
                     WgradShape a) {
  __shared__ __align__(16) float As[2][kSimtBK][kSimtBM];
  __shared__ __align__(16) float Bs[2][kSimtBK][kSimtBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kSimtBM;
  const int n0 = blockIdx.y * kSimtBN;
  const int tap = blockIdx.z / a.split;
  const int z = blockIdx.z - tap * a.split;
  const int ti = tap / a.KW;
  const int tj = tap - ti * a.KW;
  int s0, s1;
  slice_bounds(a, z, s0, s1);

  // this thread loads 4 consecutive channels of row (pixel) tid / 32 of a
  // step, for A and for B
  const int lr = tid >> 5;
  const int lc = (tid & 31) * 4;
  float ra[4], rb[4];
  auto fetch = [&](int s) {
    const int p = s * kSimtBK + lr;
    const int64_t xo = x_offset(a, p, ti, tj, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + lc + e;
      ra[e] = (xo >= 0 && m < a.Cin) ? to_f32(x[xo + m]) : 0.0f;
      const int n = n0 + lc + e;
      rb[e] = (p < a.P && n < a.Cout) ? to_f32(dy[(int64_t)p * a.Cout + n])
                                      : 0.0f;
    }
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][lr][lc]) =
        make_float4(ra[0], ra[1], ra[2], ra[3]);
    *reinterpret_cast<float4*>(&Bs[buf][lr][lc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  // thread (tx, ty): rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns
  // 4 tx + {0..3} and 64 + 4 tx + {0..3}
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  if (s0 < s1) {
    fetch(s0);
    stash(0);
  }
  __syncthreads();
  int buf = 0;
  for (int s = s0; s < s1; ++s, buf ^= 1) {
    const bool more = s + 1 < s1;
    if (more) fetch(s + 1);  // in flight during the products
#pragma unroll
    for (int k = 0; k < kSimtBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] += av[p] * bv[q];
    }
    // buffer buf ^ 1 was last read in the previous step, before the
    // barrier that ended it
    if (more) stash(buf ^ 1);
    __syncthreads();
  }

  const int64_t plane = (int64_t)a.Cin * a.Cout;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int m = m0 + (p < 4 ? 4 * ty + p : 64 + 4 * ty + p - 4);
    if (m >= a.Cin) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int n = n0 + (q < 4 ? 4 * tx + q : 64 + 4 * tx + q - 4);
      if (n >= a.Cout) continue;
      const int64_t o = tap * plane + (int64_t)m * a.Cout + n;
      if (a.split > 1)
        ws[(int64_t)z * a.KH * a.KW * plane + o] = acc[p][q];
      else
        store1(dw + o, acc[p][q]);
    }
  }
}

// --- k2_wgrad_sum_kernel -----------------------------------------------------

// dw[e] = ((ws[0, e] + ws[1, e]) + ws[2, e]) + ... over the `split` slices,
// in slice order, rounded to T once
template <typename T>
__global__ void __launch_bounds__(256)
k2_wgrad_sum_kernel(const float* __restrict__ ws, T* __restrict__ dw,
                    int64_t n, int split) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = ws[e];
  for (int z = 1; z < split; ++z) s += ws[z * n + e];
  store1(dw + e, s);
}

// --- host side ---------------------------------------------------------------

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool plan_fits(const WgradShape& a, int bm, int bn, int gx, int gy,
               const void* ws) {
  return a.split >= 1 && a.split <= a.steps && (a.split == 1 || ws) &&
         gx == ceil_div(a.Cin, bm) && gy == ceil_div(a.Cout, bn) &&
         (int64_t)a.KH * a.KW * a.split <= 65535;
}

template <typename T>
cudaError_t launch_sum(const float* ws, T* dw, const WgradShape& a,
                       cudaStream_t stream) {
  const int64_t n = (int64_t)a.KH * a.KW * a.Cin * a.Cout;
  k2_wgrad_sum_kernel<T><<<(unsigned)ceil_div(n, 256), 256, 0, stream>>>(
      ws, dw, n, a.split);
  return cudaGetLastError();
}

template <typename T>
int launch_simt(const void* x, const void* dy, void* dw, void* ws,
                const WgradShape& a, int gx, int gy, int device,
                void* stream) {
  if (!plan_fits(a, kSimtBM, kSimtBN, gx, gy, ws))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)(a.KH * a.KW * a.split));
  k2_wgrad_simt_kernel<T><<<grid, kSimtThreads, 0, s>>>(
      (const T*)x, (const T*)dy, (T*)dw, (float*)ws, a);
  err = cudaGetLastError();
  if (err == cudaSuccess && a.split > 1)
    err = launch_sum((const float*)ws, (T*)dw, a, s);
  return (int)err;
}

}  // namespace

extern "C" {

// bf16 on the tensor cores.  Plan: split, grid (gx, gy) over Cin and Cout
// in tiles of 128; the grid's z is KH * KW * split.
int conv2d_wgrad_bf16_tc(const void* x, const void* dy, void* dw, void* ws,
                         int B, int H, int W, int Cin, int Cout, int KH,
                         int KW, int pad_t, int pad_l, int Ho, int Wo,
                         int split, int gx, int gy, int device,
                         void* stream) {
  const WgradShape a = make_shape(B, H, W, Cin, Cout, KH, KW, pad_t, pad_l,
                                  Ho, Wo, kTcBK, split);
  if (Cin % 8 || Cout % 8 || !aligned16(x) || !aligned16(dy) ||
      !aligned16(dw) || !plan_fits(a, kTcBM, kTcBN, gx, gy, ws))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static unsigned done = 0;
  err = allow_smem(k2_wgrad_bf16_tc_kernel, kTcSmemBytes, device, &done);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)(KH * KW * split));
  k2_wgrad_bf16_tc_kernel<<<grid, kTcThreads, kTcSmemBytes, s>>>(
      (const bf16*)x, (const bf16*)dy, (bf16*)dw, (float*)ws, a);
  err = cudaGetLastError();
  if (err == cudaSuccess && split > 1)
    err = launch_sum((const float*)ws, (bf16*)dw, a, s);
  return (int)err;
}

// bf16 on the CUDA cores, any shape.  Plan: split, grid (gx, gy) over Cin
// and Cout in tiles of 128.
int conv2d_wgrad_bf16_simt(const void* x, const void* dy, void* dw, void* ws,
                           int B, int H, int W, int Cin, int Cout, int KH,
                           int KW, int pad_t, int pad_l, int Ho, int Wo,
                           int split, int gx, int gy, int device,
                           void* stream) {
  const WgradShape a = make_shape(B, H, W, Cin, Cout, KH, KW, pad_t, pad_l,
                                  Ho, Wo, kSimtBK, split);
  return launch_simt<bf16>(x, dy, dw, ws, a, gx, gy, device, stream);
}

// float32 on the CUDA cores, any shape.  Plan: as the bf16 CUDA-core one.
int conv2d_wgrad_f32(const void* x, const void* dy, void* dw, void* ws, int B,
                     int H, int W, int Cin, int Cout, int KH, int KW,
                     int pad_t, int pad_l, int Ho, int Wo, int split, int gx,
                     int gy, int device, void* stream) {
  const WgradShape a = make_shape(B, H, W, Cin, Cout, KH, KW, pad_t, pad_l,
                                  Ho, Wo, kSimtBK, split);
  return launch_simt<float>(x, dy, dw, ws, a, gx, gy, device, stream);
}

const char* conv2d_wgrad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
