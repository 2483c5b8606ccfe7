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
//   Bound on an H100 (bytes over 3.35 TB/s, operations over 989 TFLOP/s
//   bf16): the 1x1 kernels at 56x56 and 28x28 are byte-bound (32-170 flops
//   a byte: ResNet-50's P*(Cin + Cout) inputs against Cin*Cout outputs);
//   the 3x3 kernels and everything at 14x14 and 7x7 are bound by
//   operations (up to ~1000 flops a byte).
//
//   Variants (every kernel's name starts with k2_wgrad_, the profiler's
//   symbol for K2's weight gradient):
//
//   k2_wgrad_bf16_wgmma_kernel<BM, BN, TAPS>   bf16, Cin % 8 == 0, Cout % 8
//     == 0, 16-byte aligned x, dy and dw: every ResNet-50 shape.
//     - wgmma.mma_async m64nBNk16, both operands from shared memory and
//       both transposed (imm-trans-a = imm-trans-b = 1): A = window^T is
//       M-major and B = dy is N-major, because in memory both are
//       pixel-major rows of channels.  A box of 64 channels is one 128-byte
//       swizzled row a pixel, as TMA writes it.  float32 accumulators.
//     - TMA fills the ring: 4-D tensor maps over x [B, H, W, Cin] and dy
//       [B, H_out, W_out, Cout] (channels innermost), one box (64 channels,
//       bw, bh, bb images) a step, the box chosen by the plan so that whole
//       steps tile the image (ResNet-50: [56, 2, 1], [28, 4, 1], [14, 2, 4],
//       [7, 1, 16] -- 112 pixels, none zero-filled).  Tap (i, j) reads x's
//       box at the offset (j - pad_l, i - pad_t); TMA's out-of-bounds zero
//       fill is the convolution's padding, so the kernel does no per-pixel
//       index arithmetic.  A 1x1 kernel with no padding walks x and dy as
//       [B*H*W] pixels (boxes of up to 128).
//     - Warp-specialised: warpgroup 0's first thread issues every load into
//       a ring of up to 8 stages, each with a full and an empty mbarrier;
//       warpgroups 1 and 2 issue the products, keeping one step's wgmma in
//       flight while the next is issued.  No __syncthreads in the walk.
//     - Tiles fitted by the plan: BM = 64 where Cin = 64 (no product on a
//       zero-filled channel at any ResNet-50 shape), the consumers then
//       taking alternate steps of the same 64 x BN tile and adding their
//       float32 tiles in a fixed order at the end; BM = 128 splits Cin
//       between them.  TAPS = 3 holds a row of a 3x3 kernel in one block,
//       so that each dy box serves three taps.
//     - Pixel slices as above; the tile's epilogue writes the float32
//       partial (or, unsplit, the bf16 result) from the accumulators.
//     - Launched, like the slice sum, as a programmatic dependent of the
//       kernel before it on the stream (griddepcontrol.wait before any
//       global access), so that its launch and barrier set-up overlap that
//       kernel's tail: a call is a few microseconds of fixed cost against
//       4-40 of work at ResNet-50's shapes.
//     What still bounds it (measured, PERF.md): at 56x56 the bytes, at
//     50-70 % of the card's rate; elsewhere the shared memory each step
//     passes through (TMA writes plus both operands read by every wgmma:
//     128 B a clock an SM), the waves of 3x3 tiles at 7x7, and each call's
//     fixed cost.
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

// --- k2_wgrad_bf16_wgmma_kernel ----------------------------------------------

// D[64 x 64] += A[64 x 16] (M-major, descriptor da, imm-trans-a = 1) *
// B[16 x 64] (N-major, descriptor db, imm-trans-b = 1), bf16 -> f32
__device__ __forceinline__ void wgmma_tt_m64n64k16(float (&d)[32],
                                               uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
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

// D[64 x 128] += A[64 x 16] (M-major, descriptor da, imm-trans-a = 1) *
// B[16 x 128] (N-major, descriptor db, imm-trans-b = 1), bf16 -> f32
__device__ __forceinline__ void wgmma_tt_m64n128k16(float (&d)[64],
                                               uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_tt(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tt<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  wgmma_tt_m64n64k16(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tt<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  wgmma_tt_m64n128k16(d, da, db);
}

// named barriers of the two consumer warpgroups (0 is __syncthreads')
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// programmatic dependent launch: wait until the grids this one depends on
// have completed and their writes are visible; let the next grid launch
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kWgMaxStages = 8;
constexpr int kWgMaxRows = 128;  // pixels a step (box rows)
constexpr int kWgMaxSmem = 232448;

// What the wgmma kernel walks: the box (bw, bh, bb) over the logical
// [W, H, images] of dy, (nw, nh) boxes along W and H, `rows` = bw*bh*bb
// pixels a step; the steps of one tap are nw * nh * ceil(images / bb).
struct WgmmaShape {
  int Cin, Cout, KH, KW, pad_t, pad_l;
  int bw, bh, bb, nw, nh, rows;
  int steps, split, stages;
};

// the kernel's dynamic shared memory: the ring (or, where larger, the
// consumers' float32 exchange), the full and empty barriers, 1 KiB to align
// the base to the 128-byte swizzle's 1024-byte period
__host__ __device__ constexpr int wg_stage_bytes(int bm, int bn, int taps,
                                                 int rows) {
  return (taps * (bm / 64) + bn / 64) * rows * 128;
}
__host__ __device__ constexpr int wg_ring_bytes(int bm, int bn, int taps,
                                                int rows, int stages) {
  return stages * wg_stage_bytes(bm, bn, taps, rows) >
                 (bm == 64 ? taps * 64 * bn * 4 : 0)
             ? stages * wg_stage_bytes(bm, bn, taps, rows)
             : taps * 64 * bn * 4;
}
__host__ __device__ constexpr int wg_smem_bytes(int bm, int bn, int taps,
                                                int rows, int stages) {
  return wg_ring_bytes(bm, bn, taps, rows, stages) + 2 * stages * 8 + 1024;
}

// dw[tap] (+)= window_tap(x)^T dy over one pixel slice, for TAPS taps
// (group g: taps g*TAPS .. g*TAPS + TAPS - 1) of a BM (Cin) x BN (Cout)
// tile.  Warpgroup 0's first thread issues every TMA load: per step one
// box of dy for each 64 output channels and, per tap, one box of x for each
// 64 input channels, at the tap's offset (j - pad_l, i - pad_t); the
// padding is TMA's zero fill.  BM = 128: consumer warpgroup c multiplies
// input channels [64 c, 64 c + 64) on every step; BM = 64: it multiplies
// all 64 on the steps of its parity, and the two float32 tiles are added
// (warpgroup 1's + warpgroup 2's) through shared memory at the end.
template <int BM, int BN, int TAPS>
__global__ void __launch_bounds__(kWgThreads, 1)
k2_wgrad_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_dy,
                           bf16* __restrict__ dw, float* __restrict__ ws,
                           WgmmaShape a) {
  constexpr int MB = BM / 64;  // x boxes a tap
  constexpr int NB = BN / 64;  // dy boxes
  constexpr bool kSplitM = BM == 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int box_bytes = a.rows * 128;
  const int stage_bytes = wg_stage_bytes(BM, BN, TAPS, a.rows);
  const int stages = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + wg_ring_bytes(BM, BN, TAPS, a.rows, stages));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_dy);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kSplitM ? 256 : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // launched as a programmatic dependent of the previous kernel on the
  // stream: everything above overlaps its tail; nothing global is read or
  // written before it has completed.  It lets its own dependents launch
  // only as it exits (an earlier trigger parks their blocks beside its own:
  // measured slower)
  grid_dependency_wait();
  __syncthreads();

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int group = blockIdx.z / a.split;
  const int z = blockIdx.z - group * a.split;
  const int s0 = (int)((int64_t)z * a.steps / a.split);
  const int n_steps = (int)((int64_t)(z + 1) * a.steps / a.split) - s0;
  const int wg = tid / 128;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == 0) {
      for (int it = 0; it < n_steps; ++it) {
        const int st = it % stages;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        // the step's box origin: the plan's WgradPlan.box_origin
        const int s = s0 + it;
        const int t = s / a.nw;
        const int w0 = (s - t * a.nw) * a.bw;
        const int h0 = (t % a.nh) * a.bh;
        const int b0 = (t / a.nh) * a.bb;
        uint8_t* base = smem + st * stage_bytes;
        mbar_arrive_expect_tx(&full[st], stage_bytes);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(base + nb * box_bytes, &tm_dy, &full[st], n0 + 64 * nb,
                      w0, h0, b0);
#pragma unroll
        for (int tp = 0; tp < TAPS; ++tp) {
          const int tap = group * TAPS + tp;
          const int i = tap / a.KW;
          const int j = tap - i * a.KW;
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            tma_load_4d(base + (NB + tp * MB + mb) * box_bytes, &tm_x,
                        &full[st], m0 + 64 * mb, w0 + j - a.pad_l,
                        h0 + i - a.pad_t, b0);
        }
      }
    }
  } else {
    // ---- consumers ----
    const int cw = wg - 1;
    float acc[TAPS][BN / 2];
#pragma unroll
    for (int tp = 0; tp < TAPS; ++tp)
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) acc[tp][q] = 0.0f;
    const int ksteps = a.rows / 16;
    int held = -1;  // the stage whose products may still be in flight
    for (int it = kSplitM ? 0 : cw; it < n_steps; it += kSplitM ? 1 : 2) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      const uint32_t base = smem_u32(smem + st * stage_bytes);
#pragma unroll
      for (int tp = 0; tp < TAPS; ++tp) fence_acc(acc[tp]);
      wgmma_fence();
#pragma unroll
      for (int tp = 0; tp < TAPS; ++tp) {
        const uint32_t xa =
            base + (NB + tp * MB + (kSplitM ? cw : 0)) * box_bytes;
        // both operands are pixel-major rows of 64 channels (128 bytes,
        // swizzled): MN-major, 8-pixel groups 1024 bytes apart (SBO), B's
        // 64-channel boxes box_bytes apart (LBO); 16 pixels = 2048 bytes
        for (int kk = 0; kk < ksteps; ++kk)
          wgmma_tt<BN>(acc[tp], smem_desc(xa + kk * 2048, box_bytes, 1024),
                       smem_desc(base + kk * 2048, box_bytes, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int tp = 0; tp < TAPS; ++tp) fence_acc(acc[tp]);
      if (held >= 0) mbar_arrive(&empty[held]);
      held = st;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int tp = 0; tp < TAPS; ++tp) fence_acc(acc[tp]);
    if (held >= 0) mbar_arrive(&empty[held]);

    const int t = tid & 127;
    bool store = true;
    if (!kSplitM) {
      // warpgroup 2 hands its tile to warpgroup 1 once both are done with
      // the ring; warpgroup 1 adds it to its own and stores
      float* xch = reinterpret_cast<float*>(smem);
      consumers_sync(1);
      if (cw == 1) {
#pragma unroll
        for (int tp = 0; tp < TAPS; ++tp)
#pragma unroll
          for (int q = 0; q < BN / 2; ++q)
            xch[(tp * (BN / 2) + q) * 128 + t] = acc[tp][q];
      }
      consumers_sync(2);
      store = cw == 0;
      if (store) {
#pragma unroll
        for (int tp = 0; tp < TAPS; ++tp)
#pragma unroll
          for (int q = 0; q < BN / 2; ++q)
            acc[tp][q] += xch[(tp * (BN / 2) + q) * 128 + t];
      }
    }

    if (store) {
      // accumulator fragment: thread t of the warpgroup holds rows
      // 16 (t / 32) + (t % 32) / 4 and +8, columns 8 q + 2 (t % 4) + {0, 1}
      // in acc[4 q + {0, 1}] and acc[4 q + {2, 3}]
      const int r0 =
          m0 + (kSplitM ? 64 * cw : 0) + (t >> 5) * 16 + ((t & 31) >> 2);
      const int64_t plane = (int64_t)a.Cin * a.Cout;
#pragma unroll
      for (int tp = 0; tp < TAPS; ++tp) {
        const int64_t tap_off = (int64_t)(group * TAPS + tp) * plane;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int n = n0 + q * 8 + (t & 3) * 2;
          if (n >= a.Cout) continue;  // Cout % 8 == 0: n + 1 < Cout too
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = r0 + 8 * h;
            if (m >= a.Cin) continue;
            const float v0 = acc[tp][4 * q + 2 * h];
            const float v1 = acc[tp][4 * q + 2 * h + 1];
            const int64_t o = tap_off + (int64_t)m * a.Cout + n;
            if (a.split > 1) {
              *reinterpret_cast<float2*>(
                  ws + (int64_t)z * a.KH * a.KW * plane + o) =
                  make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(dw + o) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
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

__device__ __forceinline__ void store4(bf16* y, float4 v) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(y);
  p[0] = __floats2bfloat162_rn(v.x, v.y);
  p[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void store4(float* y, float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}

// dw[e] = ((ws[0, e] + ws[1, e]) + ws[2, e]) + ... over the `split` slices,
// in slice order, rounded to T once; VEC consecutive elements a thread
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
k2_wgrad_sum_kernel(const float* __restrict__ ws, T* __restrict__ dw,
                    int64_t n, int split) {
  grid_dependency_wait();  // the partials of the kernel before it
  grid_launch_dependents();  // a short grid: the next may launch under it
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
    store4(dw + e, s);
  } else {
    float s = ws[e];
    for (int z = 1; z < split; ++z) s += ws[z * n + e];
    store1(dw + e, s);
  }
}

// --- host side ---------------------------------------------------------------

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool plan_fits(const WgradShape& a, int bm, int bn, int gx, int gy,
               const void* ws) {
  return a.split >= 1 && a.split <= a.steps && (a.split == 1 || ws) &&
         gx == ceil_div(a.Cin, bm) && gy == ceil_div(a.Cout, bn) &&
         (int64_t)a.KH * a.KW * a.split <= 65535;
}

// the slice sum over n = KH*KW*Cin*Cout elements, 4 a thread where n % 4 == 0;
// launched as a programmatic dependent of the kernel that wrote ws
template <typename T>
cudaError_t launch_sum(const float* ws, T* dw, int64_t n, int split,
                       cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  const int vec = n % 4 == 0 ? 4 : 1;
  cfg.gridDim = dim3((unsigned)ceil_div(n / vec, 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      vec == 4 ? cudaLaunchKernelEx(&cfg, k2_wgrad_sum_kernel<T, 4>, ws, dw, n,
                                    split)
               : cudaLaunchKernelEx(&cfg, k2_wgrad_sum_kernel<T, 1>, ws, dw, n,
                                    split);
  return err == cudaSuccess ? cudaGetLastError() : err;
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
    err = launch_sum((const float*)ws, (T*)dw,
                     (int64_t)a.KH * a.KW * a.Cin * a.Cout, a.split, s);
  return (int)err;
}

template <int BM, int BN, int TAPS>
int launch_wgmma(const CUtensorMap& tm_x, const CUtensorMap& tm_dy, bf16* dw,
                 float* ws, const WgmmaShape& a, dim3 grid, int device,
                 cudaStream_t stream) {
  static unsigned done = 0;
  auto kernel = k2_wgrad_bf16_wgmma_kernel<BM, BN, TAPS>;
  cudaError_t err = allow_smem(kernel, kWgMaxSmem, device, &done);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = wg_smem_bytes(BM, BN, TAPS, a.rows, a.stages);
  cfg.stream = stream;
  // a programmatic dependent of the kernel before it on the stream
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_dy, dw, ws, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && a.split > 1)
    err = launch_sum(ws, dw, (int64_t)a.KH * a.KW * a.Cin * a.Cout, a.split,
                     stream);
  return (int)err;
}

// a 4-D tensor map over a [images, H, W, C] bf16 tensor, channels innermost,
// boxes of 64 channels x (bw, bh, bb)
bool encode_nhwc(CUtensorMap* map, const void* base, int C, int64_t W,
                 int64_t H, int64_t N, int bw, int bh, int bb) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)(C * W * 2),
                                 (cuuint64_t)(C * W * H * 2)};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh,
                             (cuuint32_t)bb};
  return encode_bf16(map, base, 4, dims, strides, box);
}

}  // namespace

extern "C" {

// bf16 on the tensor cores.  Plan: the tile bm (64 or 128) x bn (64 or
// 128) over (Cin, Cout) with `taps` taps a block ((bm, bn, taps) one of
// the kernel's instances), the box (bw, bh, bb) of a step, flat (1: a 1x1
// kernel with no padding, whose x and dy are walked as [B*H*W] pixels in
// boxes of bw), the ring's stages, split, grid (gx, gy); the grid's z is
// KH * KW / taps * split.
int conv2d_wgrad_bf16_tc(const void* x, const void* dy, void* dw, void* ws,
                         int B, int H, int W, int Cin, int Cout, int KH,
                         int KW, int pad_t, int pad_l, int Ho, int Wo,
                         int bm, int bn, int taps, int bw, int bh, int bb,
                         int flat, int stages, int split, int gx, int gy,
                         int device, void* stream) {
  const int rows = bw * bh * bb;
  const bool direct = KH == 1 && KW == 1 && pad_t == 0 && pad_l == 0 &&
                      Ho == H && Wo == W;
  // the logical [images, H, W] that the boxes walk, of dy and of x
  const int64_t P = (int64_t)B * Ho * Wo;
  const int64_t lw = flat ? P : Wo, lh = flat ? 1 : Ho, ln = flat ? 1 : B;
  WgmmaShape a{Cin, Cout, KH, KW, pad_t, pad_l, bw, bh, bb,
               (int)ceil_div(lw, bw), (int)ceil_div(lh, bh), rows};
  const int64_t steps = (int64_t)a.nw * a.nh * ceil_div(ln, bb);
  a.steps = (int)steps;
  a.split = split;
  a.stages = stages;
  const bool instance = (bm == 64 && (bn == 64 || bn == 128) &&
                         (taps == 1 || (taps == 3 && bn == 64))) ||
                        (bm == 128 && (bn == 64 || bn == 128) && taps == 1);
  if (!instance || KH * KW % taps || Cin % 8 || Cout % 8 || !aligned16(x) ||
      !aligned16(dy) || !aligned16(dw) || (flat && !direct) || bw < 1 ||
      bh < 1 || bb < 1 || bw > 256 || bh > 256 || bb > 256 || rows % 16 ||
      rows > kWgMaxRows || stages < (bm == 64 ? 3 : 2) ||
      stages > kWgMaxStages ||
      wg_smem_bytes(bm, bn, taps, rows, stages) > kWgMaxSmem || split < 1 ||
      split > steps || steps >= (1ll << 31) || (split > 1 && !ws) ||
      gx != ceil_div(Cin, bm) || gy != ceil_div(Cout, bn) ||
      (int64_t)KH * KW / taps * split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm_x = {}, tm_dy = {};
  const bool ok =
      flat ? encode_nhwc(&tm_x, x, Cin, P, 1, 1, bw, bh, bb) &&
                 encode_nhwc(&tm_dy, dy, Cout, P, 1, 1, bw, bh, bb)
           : encode_nhwc(&tm_x, x, Cin, W, H, B, bw, bh, bb) &&
                 encode_nhwc(&tm_dy, dy, Cout, Wo, Ho, B, bw, bh, bb);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy,
                  (unsigned)(KH * KW / taps * split));
  const cudaStream_t s = (cudaStream_t)stream;
  bf16* d = (bf16*)dw;
  float* wsf = (float*)ws;
  if (bm == 128)
    return bn == 64 ? launch_wgmma<128, 64, 1>(tm_x, tm_dy, d, wsf, a, grid,
                                               device, s)
                    : launch_wgmma<128, 128, 1>(tm_x, tm_dy, d, wsf, a, grid,
                                                device, s);
  if (bn == 128)
    return launch_wgmma<64, 128, 1>(tm_x, tm_dy, d, wsf, a, grid, device, s);
  return taps == 3 ? launch_wgmma<64, 64, 3>(tm_x, tm_dy, d, wsf, a, grid,
                                             device, s)
                   : launch_wgmma<64, 64, 1>(tm_x, tm_dy, d, wsf, a, grid,
                                             device, s);
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
