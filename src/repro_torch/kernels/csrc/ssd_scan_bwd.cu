// Mamba2 SSD chunk scan, backward (the scan's VJP), for NVIDIA Hopper
// (sm_90a).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers), with FMA contraction and without --use_fast_math.
// Every entry point takes raw device pointers, element strides,
// caller-allocated scratch and the caller's CUDA stream, launches on that
// stream, does not synchronise, allocates nothing, and returns the first
// non-zero cudaGetLastError() of its launches.
//
// ---------------------------------------------------------------------------
// ssd_scan_bwd   replaces no TPU kernel: the reference trains through
//   jax.vjp of the XLA chunked form repro/models/ssd.py::ssd_chunked and
//   has no backward kernel.  It is the VJP of this port's forward K4
//   (ssd_scan.cu), ngroups == 1, written from the chunked algebra.
//
//   Per (batch b, head h, chunk c) of Q steps, with cum = cumsum(dt A),
//   e_i = exp(cum_i), L_ij = exp(cum_i - cum_j) (i >= j), de_j =
//   exp(cum_last - cum_j), xdt = x dt, S_in the state entering the chunk
//   (the forward's scratch) and dS_out the gradient of the state leaving it:
//     G      = (dY (.) e)^T C                          [hp, ds]
//     dS_in  = G + e^{cum_last} dS_out  (reverse pass over the chunks,
//                                        started at d final_state)
//     d(xdt) = (C B^T (.) L)^T dY + de (.) (B dS_out^T)
//     M      = dY xdt^T under the causal mask;  dCB = sum_h M (.) L
//     dcum_i = rowsum(P)_i - colsum(P)_i          P = M (.) L (.) C B^T
//              + e_i sum_s C_is (dY S_in)_is               (y_off)
//              - de_i sum_p xdt_ip (B dS_out^T)_ip         (decay_end)
//     dcum_last += sum_j de_j sum_p xdt_jp (B dS_out^T)_jp
//                  + e^{cum_last} <S_in, dS_out>           (chunk decay)
//     ddA    = the reverse cumsum of dcum within the chunk (float64)
//     dx = d(xdt) dt;  ddt = sum_p d(xdt) x + ddA A;  dA = sum ddA dt
//     dC = dCB B + sum_h e (.) (dY S_in);  dB = dCB^T C + sum_h de (.)
//          (xdt dS_out)
//   y_off's term is the row sum of C (.) (e dY S_in), a product dC needs
//   anyway: no C S_in^T product is formed.
//
//   in : dy [b, S, nh, hp] (float32, dense), d final state [b, nh, hp, ds]
//        (float32, dense; null for zero), the forward's x, dt, A, B, C
//        (strides as ssd_scan.cu) and its scratch: states (the entering
//        state of every chunk) [b, nh, nc, hp, ds] and cum [b, nh, nc, Q]
//   out: dx [b, S, nh, hp], dB, dC [b, S, 1, ds] (Tin, dense); ddt [b, S,
//        nh], dA [nh] (float32, dense)
//   scratch (float32), each variant the ones it names (kernels/ssd_scan.py
//        plan_bwd): cb, dcb [b, nc, Q, Q]; dstate [b, nh, nc, hp, ds];
//        rowpart, colpart [b, nh, nc, T, Q] (T = Q / 64 row tiles);
//        dcum_loc, ddt_x [b, nh, nc, Q]; rsum [b, nh, nc, T]; dA_part [nh,
//        b, nc]; yoff [b, nh, nc, ceil(ds / 64), Q]; tc: bcpart [G, 2, b, S,
//        ds] (G head groups)
//
//   Deterministic: dB and dC are shared by every head and dA by every
//   (b, S), and no output or partial takes a float atomic.  Every sum over
//   heads walks the heads in order inside one block (a head group's
//   partial is added in group order by a later kernel); every other
//   cross-block sum goes through a per-tile partial in scratch that a later
//   kernel adds in a fixed order; every in-block reduction is a fixed tree
//   (warp shuffles, then shared memory in index order).  Two runs are
//   bitwise equal.
//
//   Two variants, picked by shape in Python (kernels/ssd_scan.py::plan_bwd);
//   seven launches each, counted as one call.
//
//   tc (hp == 64, ds % 64 == 0, ds <= 256, Q % 64 == 0, Q <= 256: every
//   mamba2-130m and zamba2-1.2b shape), every product on the tensor cores:
//   1. ssd_bwd_dcb_tc_kernel, grid (T (T + 1) / 2 lower-triangle tiles,
//      b * nc): the C B^T tile (into cb), then for every head in order M's
//      tile, dCB += M (.) L in registers, P's row and column sums (into
//      rowpart, colpart); dcb written once.
//   2. ssd_bwd_state_grad_tc_kernel, grid (nc, b * nh, ds / 64): G, K the
//      chunk, e^cum applied to dY's rows as they are read.
//   3. ssd_bwd_state_pass_kernel (shared with general): the reverse pass.
//   4. ssd_bwd_dxbc_tc_kernel, grid (T, (1 + ds / 64) G, b * nc), two kinds
//      of block over one 64-row tile of a chunk, each walking a group of
//      heads in order: the d(xdt) block makes d(xdt) = de (B dS_out^T) +
//      (C B^T (.) L)^T dY in one accumulator (dx, and the row sums of ddt
//      and decay_end into ddt_x, dcum_loc, rsum); a dB / dC block, one per
//      64 columns of ds, makes dY S_in and x dS_out per head and adds them,
//      scaled by e and de dt, into its dC and dB tiles, with y_off's
//      partial row sums into yoff; the first group adds dCB B and dCB^T C.
//      It writes the group's float32 dC, dB partials into bcpart.
//   5. ssd_bwd_dcum_kernel (shared): dcum assembled from the partials in
//      tile order, its reverse cumsum by one thread in float64, ddt, and
//      the chunk's dA partial.
//   6. ssd_bwd_bc_sum_kernel: dC, dB = the G group partials in order.
//   7. ssd_bwd_da_kernel (shared): dA[h], the partials in (b, chunk) order.
//   G, the head groups of launch 4, is 1 unless its blocks would leave the
//   card under two an SM (b = 1): the plan then splits the heads into G
//   groups of consecutive heads.
//
//   Each tc product is a 64 x 64 output tile of 128 threads (each warp
//   32 x 32 as 2 x 4 mma.sync m16n8k8 TF32 tiles).  K is staged raw by
//   cp.async through a ring of three slices of 32 in shared memory, two
//   slices ahead of the one multiplied, one __syncthreads a slice; each
//   operand keeps its source layout (k rows, or m rows with k contiguous),
//   padded so that a warp's fragment reads fall in distinct banks.  What
//   cannot be taken out of a product is applied as the fragments are read,
//   with no branch: L under the causal mask as two factors from per-head
//   tables (one on C B^T's columns, one on dY's rows), e^cum on dY for G;
//   dt, e and de are row or column scales of the output, applied in the
//   epilogues.  Accuracy: a product with two float32 operands runs as
//   3xTF32 (each operand cut into hi + lo TF32 parts by bit masks, lo hi +
//   hi lo + hi hi, the small terms first, pass by pass); one bf16 operand,
//   exact in TF32, drops its lo term (2xTF32); C B^T of bf16 inputs runs
//   on the bf16 tensor cores (mma.sync m16n8k16, exact products, float32
//   accumulation) from C and B rows copied by cp.async; float32 inputs:
//   every product 3xTF32.  Each head's product sums in a fresh accumulator
//   and is added in float32.
//
//   dy is read by three launches, each one pass over it: dcb (M; the
//   64-row tiles of a chunk are read by the row's lower-triangle tiles at
//   once, from L2), state_grad (G, which the reverse pass needs before
//   anything that reads dS_out) and dxbc (the d(xdt) block reads the rows
//   below its tile, the dB / dC blocks of the same tile, its neighbours in
//   the grid walking the same heads, read the tile's rows again from L2).
//   M cannot join dxbc's pass: dCB sums over heads for every tile pair, and
//   a dxbc block holds one row tile.
//
//   general (every other shape: the test and ragged shapes): the first
//   version's CUDA-core kernels, 64 x 64 tiles of 256 threads masked at the
//   edges, each thread a 4 x 4 register tile in float32: dcb, state_grad,
//   state_pass, dx (d(xdt), dx, the sums of ddt and decay_end), dbc (dC,
//   dB, the heads in order, and y_off's partial row sums), dcum, da.
//
//   What bounds it on an H100: operations.  At mamba2-130m's b = 8, S =
//   4096, nh = 24, hp = 64, ds = 128, Q = 256 the products over the lower
//   triangles are ~80 GFLOP on ~0.9 GB (chip_smoke.py ssd_bwd_bound):
//   1.20 ms at the float32 CUDA-core rate, 0.375 ms at the tensor cores'
//   (bf16 C B^T at 989 TFLOP/s, 2xTF32 at 495 / 2, 3xTF32 at 495 / 3).
//   The 3xTF32 products run at ~40 % of the card's mma.sync TF32 rate
//   (tools/mma_sync_tf32_peak.cu): the warp issues the fragment reads, the
//   splits and three mma.sync for every product (PERF.md).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::mma_tf32;

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // rows / columns of an output tile
constexpr int kThreads = 256;   // threads of a general block and the passes
constexpr int kK = 16;          // K slice staged through shared memory
constexpr int kMaxQ = 8192;     // the dcum kernel holds a chunk's dcum
constexpr int kScratch = 11;    // scratch tensors, in the order below

enum Variant { kGeneral = 0, kTc = 1 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Params {
  const float* dy;          // [b, S, nh, hp] dense
  const float* dfinal;      // [b, nh, hp, ds] dense, or null
  const void* x;            // Tin, strides xs_*
  const float* dt;          // strides dts_*
  const float* A;           // [nh]
  const void* B;            // Tin [b, S, 1, ds], strides bs_*
  const void* C;            // Tin, strides cs_*
  const float* states;      // [b, nh, nc, hp, ds]: S_in of every chunk
  const float* cum;         // [b, nh, nc, Q]
  void* dx;                 // Tin [b, S, nh, hp] dense
  float* ddt;               // [b, S, nh] dense
  float* dA;                // [nh]
  void* dB;                 // Tin [b, S, 1, ds] dense
  void* dC;
  // scratch
  float* cb;                // [b, nc, Q, Q]
  float* dcb;               // [b, nc, Q, Q]
  float* dstate;            // [b, nh, nc, hp, ds]: G, then dS_out
  float* rowpart;           // [b, nh, nc, T, Q]
  float* colpart;           // [b, nh, nc, T, Q]
  float* dcum_loc;          // [b, nh, nc, Q]
  float* ddt_x;             // [b, nh, nc, Q]
  float* rsum;              // [b, nh, nc, T]
  float* dA_part;           // [nh, b, nc]
  float* yoff;              // general: [b, nh, nc, ty, Q]; tc: null
  float* bcpart;            // tc: [groups, 2, b, S, ds]; general: null
  int batch, nh, hp, ds, Q, nc, T;
  int ty;                   // y_off's partial row sums per row (yoff)
  int groups;               // tc: head groups of the dxbc launch
  long long xs_b, xs_s, xs_h, dts_b, dts_s, dts_h, bs_b, bs_s, cs_b, cs_s;
};

// Sum of v over the block's threads in a fixed tree.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// (row tile, column tile) of lower-triangle tile t, row-major order
__device__ __forceinline__ void tile_pair(int t, int& ti, int& tj) {
  ti = 0;
  while (t > ti) { t -= ti + 1; ++ti; }
  tj = t;
}

// ===========================================================================
// general variant: CUDA cores, masked edges
// ===========================================================================

struct __align__(16) Stage {
  float a[kK][kTile + 4];   // A slice, k-major; rows 16-byte aligned
  float b[kK][kTile + 4];
};

// acc[i][j] += sum_{k in [k_begin, k_end)} la(r, k) lb(k, c) for the rows
// r = 4 ty + i and columns c = 4 tx + j of a 64 x 64 tile (ty = tid / 16,
// tx = tid % 16).  la / lb return the element (0 where it does not exist);
// AK / BK say whether k is the operand's contiguous index (then 16
// neighbouring threads load 16 neighbouring k of one row), else r / c is
// (64 neighbouring threads load one k).  The next slice's elements are
// loaded into registers while the current slice is multiplied.  The slice
// loop is the same for all threads (a block-uniform k range).
template <bool AK, bool BK, class LA, class LB>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4], int k_begin,
                                        int k_end, LA la, LB lb,
                                        Stage& sm) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;   // 0 .. 1023
      const int akk = AK ? (idx & (kK - 1)) : (idx >> 6);
      const int ar = AK ? (idx >> 4) : (idx & (kTile - 1));
      const int bkk = BK ? (idx & (kK - 1)) : (idx >> 6);
      const int bc = BK ? (idx >> 4) : (idx & (kTile - 1));
      ra[e] = k0 + akk < k_end ? la(ar, k0 + akk) : 0.f;
      rb[e] = k0 + bkk < k_end ? lb(k0 + bkk, bc) : 0.f;
    }
  };
  if (k_begin < k_end) fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      sm.a[AK ? (idx & (kK - 1)) : (idx >> 6)]
          [AK ? (idx >> 4) : (idx & (kTile - 1))] = ra[e];
      sm.b[BK ? (idx & (kK - 1)) : (idx >> 6)]
          [BK ? (idx >> 4) : (idx & (kTile - 1))] = rb[e];
    }
    __syncthreads();
    if (k0 + kK < k_end) fetch(k0 + kK);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sm.a[kk][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[kk][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 threads of a row group (lanes of one half-warp): every
// lane gets the total, always added in the same tree.
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Column sums of a tile: part[j] of every thread (its 4 rows summed) into
// out[c] for the 64 columns, the 16 row groups added in order.
__device__ __forceinline__ void col_reduce(const float (&part)[4],
                                           float (*red)[kTile],
                                           float* out) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][4 * tx + j] = part[j];
  __syncthreads();
  if (tid < kTile) {
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += red[g][tid];
    out[tid] = s;
  }
  __syncthreads();
}

// 1. C B^T tile, then per head M, dCB, and P's row / column sums.
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcb_kernel(Params p) {
  __shared__ Stage sm;
  __shared__ float red[16][kTile];
  __shared__ float csum[kTile];
  __shared__ float cum_i[kTile], cum_j[kTile];
  // this thread's own C B^T elements and dCB sums, held in shared memory
  // (out of registers) across the head loop
  __shared__ __align__(16) float cb_s[kTile][kTile + 4];
  __shared__ __align__(16) float dcb_s[kTile][kTile + 4];
  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int bi = blockIdx.y / p.nc, c = blockIdx.y % p.nc;
  const int Q = p.Q, i0 = ti * kTile, j0 = tj * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long s0 = (long long)c * Q;
  const Tin* Bp = static_cast<const Tin*>(p.B) + bi * p.bs_b;
  const Tin* Cp = static_cast<const Tin*>(p.C) + bi * p.cs_b;
  const Tin* xp = static_cast<const Tin*>(p.x) + bi * p.xs_b;
  const float* dtp = p.dt + bi * p.dts_b;

  float cbv[4][4];
  zero(cbv);
  tile_mm<true, true>(cbv, 0, p.ds,
          [&](int r, int k) {
            const int i = i0 + r;
            return i < Q ? ld(Cp + (s0 + i) * p.cs_s + k) : 0.f;
          },
          [&](int k, int col) {
            const int j = j0 + col;
            return j < Q ? ld(Bp + (s0 + j) * p.bs_s + k) : 0.f;
          },
          sm);
  float* cbt = p.cb + ((long long)(bi * p.nc + c) * Q) * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + 4 * ty + a, j = j0 + 4 * tx + q;
      if (i < Q && j < Q) cbt[(long long)i * Q + j] = cbv[a][q];
    }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(&cb_s[4 * ty + a][4 * tx]) =
        make_float4(cbv[a][0], cbv[a][1], cbv[a][2], cbv[a][3]);
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(&dcb_s[4 * ty + a][4 * tx]) =
        make_float4(0.f, 0.f, 0.f, 0.f);

  for (int h = 0; h < p.nh; ++h) {
    const long long bh = (long long)bi * p.nh + h;
    const float* cum = p.cum + (bh * p.nc + c) * Q;
    if (tid < kTile) {
      cum_i[tid] = i0 + tid < Q ? cum[i0 + tid] : 0.f;
      cum_j[tid] = j0 + tid < Q ? cum[j0 + tid] : 0.f;
    }
    const float* dy = p.dy + ((long long)bi * Q * p.nc) * p.nh * p.hp;
    float m[4][4];
    zero(m);
    tile_mm<true, true>(m, 0, p.hp,
            [&](int r, int k) {
              const int i = i0 + r;
              return i < Q ? dy[((s0 + i) * p.nh + h) * p.hp + k] : 0.f;
            },
            [&](int k, int col) {
              const int j = j0 + col;
              if (j >= Q) return 0.f;
              const long long s = s0 + j;
              return ld(xp + s * p.xs_s + h * p.xs_h + k) *
                     dtp[s * p.dts_s + h * p.dts_h];
            },
            sm);
    float rows[4], cols[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rows[a] = 0.f;
      const float4 c4 =
          *reinterpret_cast<const float4*>(&cb_s[4 * ty + a][4 * tx]);
      const float cbr[4] = {c4.x, c4.y, c4.z, c4.w};
      float4* d4 = reinterpret_cast<float4*>(&dcb_s[4 * ty + a][4 * tx]);
      float dsum[4] = {d4->x, d4->y, d4->z, d4->w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * ty + a, col = 4 * tx + q;
        const int i = i0 + r, j = j0 + col;
        const bool ok = i < Q && j < Q && i >= j;
        const float Lij = ok ? expf(cum_i[r] - cum_j[col]) : 0.f;
        const float ml = m[a][q] * Lij;
        dsum[q] += ml;
        const float pv = ml * cbr[q];
        rows[a] += pv;
        cols[q] += pv;
      }
      *d4 = make_float4(dsum[0], dsum[1], dsum[2], dsum[3]);
    }
    float* rp = p.rowpart + ((bh * p.nc + c) * p.T + tj) * Q;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float v = row_reduce(rows[a]);
      const int i = i0 + 4 * ty + a;
      if (tx == 0 && i < Q) rp[i] = v;
    }
    col_reduce(cols, red, csum);
    float* cp = p.colpart + ((bh * p.nc + c) * p.T + ti) * Q;
    if (tid < kTile && j0 + tid < Q) cp[j0 + tid] = csum[tid];
  }
  float* dcbt = p.dcb + ((long long)(bi * p.nc + c) * Q) * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + 4 * ty + a, j = j0 + 4 * tx + q;
      if (i < Q && j < Q)
        dcbt[(long long)i * Q + j] = dcb_s[4 * ty + a][4 * tx + q];
    }
}

// 2. G = dY^T (C (.) e^cum): one 64 x 64 tile of [hp, ds].
template <typename Tin>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_grad_kernel(Params p) {
  __shared__ Stage sm;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / p.nh, h = bh % p.nh, Q = p.Q;
  const int n_s = (p.ds + kTile - 1) / kTile;
  const int p0 = (blockIdx.z / n_s) * kTile, d0 = (blockIdx.z % n_s) * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long s0 = (long long)c * Q;
  const float* cum = p.cum + ((long long)bh * p.nc + c) * Q;
  const float* dy = p.dy + (long long)bi * Q * p.nc * p.nh * p.hp;
  const Tin* Cp = static_cast<const Tin*>(p.C) + bi * p.cs_b;
  float g[4][4];
  zero(g);
  tile_mm<false, false>(g, 0, Q,
          [&](int r, int k) {
            const int pp = p0 + r;
            return pp < p.hp ? dy[((s0 + k) * p.nh + h) * p.hp + pp] : 0.f;
          },
          [&](int k, int col) {
            const int s = d0 + col;
            return s < p.ds ? ld(Cp + (s0 + k) * p.cs_s + s) * expf(cum[k])
                            : 0.f;
          },
          sm);
  float* out = p.dstate + (((long long)bh * p.nc + c) * p.hp) * p.ds;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = p0 + 4 * ty + a, s = d0 + 4 * tx + q;
      if (pp < p.hp && s < p.ds) out[(long long)pp * p.ds + s] = g[a][q];
    }
}

// 3. The reverse pass: dstate[c] <- dS_out of chunk c (both variants).
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_pass_kernel(Params p) {
  const long long n = (long long)p.hp * p.ds;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long bh = blockIdx.y;
  float carry = p.dfinal ? p.dfinal[bh * n + e] : 0.f;
  float* base = p.dstate + bh * p.nc * n + e;
  const float* last = p.cum + bh * p.nc * p.Q + p.Q - 1;
  // four chunks' loads issued before their dependent updates
  constexpr int kAhead = 4;
  for (int c1 = p.nc; c1 > 0; c1 -= kAhead) {
    const int m = c1 < kAhead ? c1 : kAhead;
    float g[kAhead], dec[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < m) {
        g[u] = base[(long long)(c1 - 1 - u) * n];
        dec[u] = expf(last[(long long)(c1 - 1 - u) * p.Q]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < m) {
        base[(long long)(c1 - 1 - u) * n] = carry;
        carry = fmaf(dec[u], carry, g[u]);
      }
    }
  }
}

// 4. 64 rows of d(xdt): dx, and the row sums of ddt and decay_end.
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_kernel(Params p) {
  __shared__ Stage sm;
  __shared__ float cum_s[kTile];
  __shared__ float rsum_s[kTile];
  const int r_tile = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int bi = bh / p.nh, h = bh % p.nh, Q = p.Q;
  const int j0 = r_tile * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long s0 = (long long)c * Q;
  const long long chunk = (long long)bh * p.nc + c;
  const float* cum = p.cum + chunk * Q;
  const float cum_last = cum[Q - 1];
  const float* cbt = p.cb + ((long long)(bi * p.nc + c) * Q) * Q;
  const float* dy = p.dy + (long long)bi * Q * p.nc * p.nh * p.hp;
  const float* dS = p.dstate + chunk * p.hp * p.ds;
  const Tin* xp = static_cast<const Tin*>(p.x) + bi * p.xs_b;
  const Tin* Bp = static_cast<const Tin*>(p.B) + bi * p.bs_b;
  const float* dtp = p.dt + bi * p.dts_b;
  Tin* dxp = static_cast<Tin*>(p.dx) +
             (long long)bi * Q * p.nc * p.nh * p.hp;
  if (tid < kTile) cum_s[tid] = j0 + tid < Q ? cum[j0 + tid] : 0.f;
  __syncthreads();

  float sx[4] = {0.f, 0.f, 0.f, 0.f}, sr[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < p.hp; p0 += kTile) {
    float ta[4][4], tb[4][4];
    // (C B^T (.) L)^T dY over the rows i >= j of the chunk
    zero(ta);
    tile_mm<false, false>(ta, j0, Q,
            [&](int r, int k) {
              const int j = j0 + r;
              if (j >= Q || k < j) return 0.f;
              return cbt[(long long)k * Q + j] * expf(cum[k] - cum_s[r]);
            },
            [&](int k, int col) {
              const int pp = p0 + col;
              return pp < p.hp ? dy[((s0 + k) * p.nh + h) * p.hp + pp] : 0.f;
            },
            sm);
    // B dS_out^T
    zero(tb);
    tile_mm<true, true>(tb, 0, p.ds,
            [&](int r, int k) {
              const int j = j0 + r;
              return j < Q ? ld(Bp + (s0 + j) * p.bs_s + k) : 0.f;
            },
            [&](int k, int col) {
              const int pp = p0 + col;
              return pp < p.hp ? dS[(long long)pp * p.ds + k] : 0.f;
            },
            sm);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * ty + a, j = j0 + r;
      if (j >= Q) continue;
      const long long s = s0 + j;
      const float dtv = dtp[s * p.dts_s + h * p.dts_h];
      const float de = expf(cum_last - cum_s[r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pp = p0 + 4 * tx + q;
        if (pp >= p.hp) continue;
        const float xv = ld(xp + s * p.xs_s + h * p.xs_h + pp);
        const float dxdt = fmaf(de, tb[a][q], ta[a][q]);
        st(dxp + (s * p.nh + h) * p.hp + pp, dxdt * dtv);
        sx[a] = fmaf(dxdt, xv, sx[a]);
        sr[a] = fmaf(xv * dtv, tb[a][q], sr[a]);
      }
    }
  }
  float rpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float x_sum = row_reduce(sx[a]);
    const float r_sum = row_reduce(sr[a]);
    const int r = 4 * ty + a, j = j0 + r;
    if (j < Q) {
      const float rj = expf(cum_last - cum_s[r]) * r_sum;
      if (tx == 0) {
        p.ddt_x[chunk * Q + j] = x_sum;
        p.dcum_loc[chunk * Q + j] = -rj;   // y_off's term: yoff (dbc)
        rpart[a] = rj;
      }
    }
  }
  // the tile's sum of r_j, rows in index order
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) rsum_s[4 * ty + a] = rpart[a];
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < kTile; ++r) s += rsum_s[r];
    p.rsum[chunk * p.T + r_tile] = s;
  }
}

// 5. dC and dB, one 64 x 64 tile each, the heads in order; per head the
// y_off row sums of the tile's columns, e_i sum_s C_is (dY S_in)_is before
// its e_i, into yoff.
template <typename Tin>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dbc_kernel(Params p) {
  __shared__ Stage sm;
  __shared__ float cum_s[kTile];
  const int r_tile = blockIdx.x, d0 = blockIdx.y * kTile;
  const int bi = blockIdx.z / p.nc, c = blockIdx.z % p.nc, Q = p.Q;
  const int i0 = r_tile * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long s0 = (long long)c * Q;
  const float* dcbt = p.dcb + ((long long)(bi * p.nc + c) * Q) * Q;
  const Tin* Bp = static_cast<const Tin*>(p.B) + bi * p.bs_b;
  const Tin* Cp = static_cast<const Tin*>(p.C) + bi * p.cs_b;
  const Tin* xp = static_cast<const Tin*>(p.x) + bi * p.xs_b;
  const float* dtp = p.dt + bi * p.dts_b;
  const float* dy = p.dy + (long long)bi * Q * p.nc * p.nh * p.hp;
  const int k_end = min(Q, i0 + kTile);
  float dC[4][4], dB[4][4];
  zero(dC);
  zero(dB);
  // dC += dCB B over j <= i;  dB += dCB^T C over i >= j
  tile_mm<true, false>(dC, 0, k_end,
          [&](int r, int k) {
            const int i = i0 + r;
            return (i < Q && k <= i) ? dcbt[(long long)i * Q + k] : 0.f;
          },
          [&](int k, int col) {
            const int s = d0 + col;
            return s < p.ds ? ld(Bp + (s0 + k) * p.bs_s + s) : 0.f;
          },
          sm);
  tile_mm<false, false>(dB, i0, Q,
          [&](int r, int k) {
            const int j = i0 + r;
            return (j < Q && k >= j) ? dcbt[(long long)k * Q + j] : 0.f;
          },
          [&](int k, int col) {
            const int s = d0 + col;
            return s < p.ds ? ld(Cp + (s0 + k) * p.cs_s + s) : 0.f;
          },
          sm);
  for (int h = 0; h < p.nh; ++h) {
    const long long chunk = ((long long)bi * p.nh + h) * p.nc + c;
    const float* cum = p.cum + chunk * Q;
    const float* Sin = p.states + chunk * p.hp * p.ds;
    const float* dS = p.dstate + chunk * p.hp * p.ds;
    __syncthreads();      // the last head's epilogue has read cum_s
    if (tid < kTile) cum_s[tid] = i0 + tid < Q ? cum[i0 + tid] : 0.f;
    const float cum_last = cum[Q - 1];
    float t[4][4];
    zero(t);
    tile_mm<true, false>(t, 0, p.hp,
            [&](int r, int k) {
              const int i = i0 + r;
              return i < Q ? dy[((s0 + i) * p.nh + h) * p.hp + k] : 0.f;
            },
            [&](int k, int col) {
              const int s = d0 + col;
              return s < p.ds ? Sin[(long long)k * p.ds + s] : 0.f;
            },
            sm);
    float* yo = p.yoff + (chunk * p.ty + blockIdx.y) * Q;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float ein = expf(cum_s[4 * ty + a]);
      const int i = i0 + 4 * ty + a;
      float ys = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sc = d0 + 4 * tx + q;
        dC[a][q] = fmaf(ein, t[a][q], dC[a][q]);
        if (i < Q && sc < p.ds)
          ys = fmaf(ld(Cp + (s0 + i) * p.cs_s + sc), t[a][q], ys);
      }
      ys = row_reduce(ys);
      if (tx == 0 && i < Q) yo[i] = ys;
    }
    zero(t);
    tile_mm<true, false>(t, 0, p.hp,
            [&](int r, int k) {
              const int j = i0 + r;
              if (j >= Q) return 0.f;
              const long long s = s0 + j;
              return ld(xp + s * p.xs_s + h * p.xs_h + k) *
                     dtp[s * p.dts_s + h * p.dts_h];
            },
            [&](int k, int col) {
              const int s = d0 + col;
              return s < p.ds ? dS[(long long)k * p.ds + s] : 0.f;
            },
            sm);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float de = expf(cum_last - cum_s[4 * ty + a]);
#pragma unroll
      for (int q = 0; q < 4; ++q) dB[a][q] = fmaf(de, t[a][q], dB[a][q]);
    }
  }
  Tin* dCp = static_cast<Tin*>(p.dC);
  Tin* dBp = static_cast<Tin*>(p.dB);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + 4 * ty + a, s = d0 + 4 * tx + q;
      if (i < Q && s < p.ds) {
        const long long at = ((long long)bi * Q * p.nc + s0 + i) * p.ds + s;
        st(dCp + at, dC[a][q]);
        st(dBp + at, dB[a][q]);
      }
    }
}

// 6. dcum from the partials, its reverse cumsum, ddt and dA's partial
// (both variants; blockDim kThreads).
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dcum_kernel(Params p) {
  extern __shared__ float dc[];            // [Q]
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / p.nh, h = bh % p.nh, Q = p.Q, T = p.T;
  const int tid = threadIdx.x;
  const long long chunk = (long long)bh * p.nc + c;
  const long long n = (long long)p.hp * p.ds;
  const float* cum = p.cum + chunk * Q;
  const float* Sin = p.states + chunk * n;
  const float* dS = p.dstate + chunk * n;
  float dot = 0.f;
  for (long long e = tid; e < n; e += kThreads) dot = fmaf(Sin[e], dS[e], dot);
  dot = block_sum(dot, red);
  const float* rp = p.rowpart + chunk * T * Q;
  const float* cp = p.colpart + chunk * T * Q;
  for (int i = tid; i < Q; i += kThreads) {
    const int ti = i / kTile;
    // y_off: its partial row sums in column-tile order, then e_i
    float y = 0.f;
    for (int t = 0; t < p.ty; ++t) y += p.yoff[(chunk * p.ty + t) * Q + i];
    float d = fmaf(expf(cum[i]), y, p.dcum_loc[chunk * Q + i]);
    for (int t = 0; t <= ti; ++t) d += rp[(long long)t * Q + i];
    for (int t = ti; t < T; ++t) d -= cp[(long long)t * Q + i];
    if (i == Q - 1) {
      float rs = 0.f;
      for (int t = 0; t < T; ++t) rs += p.rsum[chunk * T + t];
      d += rs + expf(cum[Q - 1]) * dot;
    }
    dc[i] = d;
  }
  __syncthreads();
  if (tid == 0) {
    double acc = 0.0;
    for (int i = Q - 1; i >= 0; --i) {
      acc += (double)dc[i];
      dc[i] = (float)acc;
    }
  }
  __syncthreads();
  const float a = p.A[h];
  const long long s0 = (long long)c * Q;
  float part = 0.f;
  for (int i = tid; i < Q; i += kThreads) {
    const long long s = s0 + i;
    const float dtv = p.dt[bi * p.dts_b + s * p.dts_s + h * p.dts_h];
    p.ddt[(bi * (long long)Q * p.nc + s) * p.nh + h] =
        fmaf(dc[i], a, p.ddt_x[chunk * Q + i]);
    part = fmaf(dc[i], dtv, part);
  }
  part = block_sum(part, red);
  if (tid == 0) p.dA_part[((long long)h * p.batch + bi) * p.nc + c] = part;
}

// 7. dA[h] = the (b, chunk) partials in order (both variants).
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_da_kernel(Params p) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= p.nh) return;
  const float* part = p.dA_part + (long long)h * p.batch * p.nc;
  float s = 0.f;
  for (int k = 0; k < p.batch * p.nc; ++k) s += part[k];
  p.dA[h] = s;
}

// ===========================================================================
// tc variant: every product on the tensor cores
// ===========================================================================

constexpr int kNT = 128;                 // threads of a tc block: 4 warps
constexpr int kBK = 32;                  // K slice of a tc product
constexpr int kLs = 16;                  // rows of an L-table slice
constexpr int kMaxQTc = 256;             // the variant's largest chunk
constexpr int kMaxDsTc = 256;            // and state size
constexpr int kTcBlocksPerSm = 2;        // blocks an SM, at least

bool tc_fits(int hp, int ds, int Q) {
  return hp == kTile && ds % kTile == 0 && ds <= kMaxDsTc &&
         Q % kTile == 0 && Q <= kMaxQTc;
}

// Two neighbouring elements as floats, and stores of two.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

struct Ident {
  __device__ __forceinline__ float operator()(int, int, float v) const {
    return v;
  }
};

// The ring of staged slices shared by a block's products: kStages slices of
// the A and B operands, each the largest an operand takes (64 rows of 32 +
// 4 floats).  Deeper rings and shorter slices measured no faster
// (PERF.md).
constexpr int kStages = 3;
constexpr int kOpFloats = kTile * (kBK + 4);
struct Ring {
  float op[kStages][2][kOpFloats];
};
constexpr int kRingBytes = (int)sizeof(Ring);

// dynamic shared memory: the ring; dcb's bf16 C and B rows share its
// space
int dcb_tc_smem(bool bf16_in, int ds) {
  return bf16_in ? max(kRingBytes, 2 * kTile * (ds + 8) * 2) : kRingBytes;
}
constexpr int kDcbSmemMax = 2 * kTile * (kMaxDsTc + 8) * 2;

// One operand of a tc product, a slice of 32 k by the tile's 64 m (or n),
// copied raw into the ring by cp.async, 16 bytes a copy.  kKRows: the
// source's rows are k and its 64 neighbouring elements the tile's m (rows
// of kTile + 8 in the ring); else its rows are m and its neighbouring
// elements k (rows of 32 + 4 floats, 32 + 8 bf16).  Either way the
// fragment reads of a warp (lanes g = lane / 4 and t = lane % 4 at k = t,
// m = g) fall in distinct banks, or two lanes read one word.  get()
// converts an element to float and transforms it as the fragments read
// it: f(k, m, v), k counted from k_first (L and the mask, e^cum).
template <typename T, bool kKRows, class F = Ident>
struct Op {
  typedef T Elem;
  const T* base;   // the tile's source row 0 (k = 0 or m = 0)
  long long ld;    // source row stride, elements
  int k_first;
  F f;
  static constexpr int kPer = 16 / (int)sizeof(T);
  static constexpr int kLdS =
      kKRows ? kTile + 8 : kBK + (sizeof(T) == 4 ? 4 : 8);
  __device__ __forceinline__ void load(int kt, T* s) const {
    if constexpr (kKRows) {
      constexpr int cpr = kTile / kPer;
#pragma unroll
      for (int c = threadIdx.x; c < kBK * cpr; c += kNT) {
        const int r = c / cpr, x = (c % cpr) * kPer;
        hopper::cp_async16(hopper::smem_u32(s + r * kLdS + x),
                           base + (long long)(kt * kBK + r) * ld + x, true);
      }
    } else {
      constexpr int cpr = kBK / kPer;
#pragma unroll
      for (int c = threadIdx.x; c < kTile * cpr; c += kNT) {
        const int r = c / cpr, x = (c % cpr) * kPer;
        hopper::cp_async16(hopper::smem_u32(s + r * kLdS + x),
                           base + (long long)r * ld + kt * kBK + x, true);
      }
    }
  }
  __device__ __forceinline__ float get(const T* s, int kt, int k,
                                       int mn) const {
    const float v = to_f(kKRows ? s[k * kLdS + mn] : s[mn * kLdS + k]);
    return f(k_first + kt * kBK + k, mn, v);
  }
};

// Where this thread's accumulators lie: acc[mt][nt][2 h + c] is row
// row(mt, h), column col(nt) + c of the block's 64 x 64 output.
struct FragPos {
  int wm, wn, g, t;
  __device__ __forceinline__ FragPos() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    wm = 32 * (warp & 1);
    wn = 32 * (warp >> 1);
  }
  __device__ __forceinline__ int row(int mt, int h) const {
    return wm + 16 * mt + g + 8 * h;
  }
  __device__ __forceinline__ int col(int nt) const {
    return wn + 8 * nt + 2 * t;
  }
};

typedef float TileAcc[2][4][4];

// A float32 x as hi + lo, both TF32: hi keeps x's sign, exponent and top
// 10 mantissa bits, lo = x - hi (exact in float32) cut the same way; two
// bit masks and a subtraction, all at the full issue rate.  lo hi + hi lo
// + hi hi then misses x y by under 3 2^-20 |x y| (lo lo, and what the cuts
// drop).  An operand that holds bf16 values is exact in TF32 and is passed
// as it is.
template <bool kSplit>
__device__ __forceinline__ void split_cut(float x, uint32_t& hi,
                                          uint32_t& lo) {
  if constexpr (kSplit) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// acc += A B over nk slices of 16 of the operands oa, ob: slice kt + 2 is
// copied into the ring while slice kt is multiplied, one __syncthreads a
// slice.  Each product is float32 on the tensor cores as 3xTF32: lo(A)
// hi(B) + hi(A) lo(B) + hi(A) hi(B), the small terms first; kSplitA /
// kSplitB false for an operand that is exact in TF32 (bf16 data) drops its
// lo term.  Ends with the ring drained and a __syncthreads, so products
// may follow each other at once.
template <bool kSplitA, bool kSplitB, class OA, class OB>
__device__ __forceinline__ void mma_tile(const OA& oa, const OB& ob, int nk,
                                         Ring& ring, TileAcc& acc) {
  typedef typename OA::Elem TA;
  typedef typename OB::Elem TB;
  const FragPos fp;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) {
      oa.load(st, reinterpret_cast<TA*>(ring.op[st][0]));
      ob.load(st, reinterpret_cast<TB*>(ring.op[st][1]));
    }
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();   // slice kt landed; slice kt - 1's readers are done
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      oa.load(nxt, reinterpret_cast<TA*>(ring.op[nxt % kStages][0]));
      ob.load(nxt, reinterpret_cast<TB*>(ring.op[nxt % kStages][1]));
    }
    hopper::cp_async_commit();
    const TA* sa = reinterpret_cast<const TA*>(ring.op[kt % kStages][0]);
    const TB* sb = reinterpret_cast<const TB*>(ring.op[kt % kStages][1]);
#pragma unroll
    for (int kb = 0; kb < kBK; kb += 8) {
      const int k0 = kb + fp.t, k1 = kb + fp.t + 4;
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = fp.wm + 16 * mt + fp.g;
        split_cut<kSplitA>(oa.get(sa, kt, k0, m), ah[mt][0], al[mt][0]);
        split_cut<kSplitA>(oa.get(sa, kt, k0, m + 8), ah[mt][1], al[mt][1]);
        split_cut<kSplitA>(oa.get(sa, kt, k1, m), ah[mt][2], al[mt][2]);
        split_cut<kSplitA>(oa.get(sa, kt, k1, m + 8), ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = fp.wn + 8 * nt + fp.g;
        split_cut<kSplitB>(ob.get(sb, kt, k0, n), bh[nt][0], bl[nt][0]);
        split_cut<kSplitB>(ob.get(sb, kt, k1, n), bh[nt][1], bl[nt][1]);
      }
      // pass by pass, so that the eight tiles' products are in flight
      // between two that share an accumulator
      if constexpr (kSplitA) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
      }
      if constexpr (kSplitB) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C B^T of bf16 inputs: the products C[i, s] B[j, s] are exact in float32
// and the bf16 tensor cores sum them in float32.  The tile's 64 C rows and
// 64 B rows are copied into shared memory with cp.async, rows ld = ds + 8
// bf16 apart (ds / 2 + 4 words: a warp's fragment words fall in 32 banks);
// each warp its 32 x 32 of the output as 2 x 4 m16n8k16 tiles, in the
// accumulator layout of FragPos.
__device__ __forceinline__ void cb_tile_bf16(const bf16* Cr, long long cs,
                                             const bf16* Br, long long bs,
                                             int ds, bf16* smem,
                                             TileAcc& acc) {
  const int ld = ds + 8, chunks = ds / 8;
  bf16* Cs = smem;
  bf16* Bs = smem + kTile * ld;
  for (int i = threadIdx.x; i < kTile * chunks; i += kNT) {
    const int r = i / chunks, k8 = (i % chunks) * 8;
    hopper::cp_async16(hopper::smem_u32(Cs + r * ld + k8), Cr + r * cs + k8,
                       true);
    hopper::cp_async16(hopper::smem_u32(Bs + r * ld + k8), Br + r * bs + k8,
                       true);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  const FragPos fp;
  for (int k0 = 0; k0 < ds; k0 += 16) {
    const int ka = k0 + 2 * fp.t;
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = fp.wm + 16 * mt + fp.g;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(&Cs[r * ld + ka]);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(&Cs[(r + 8) * ld + ka]);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(&Cs[r * ld + ka + 8]);
      a[mt][3] =
          *reinterpret_cast<const uint32_t*>(&Cs[(r + 8) * ld + ka + 8]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = fp.wn + 8 * nt + fp.g;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[r * ld + ka]);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[r * ld + ka + 8]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                 b[nt][0], b[nt][1]);
  }
  __syncthreads();   // the rows' space is the ring's next
}

// Writes a block's 64 x 64 accumulators to rows of `out` ld floats apart.
__device__ __forceinline__ void store_tile(float* out, long long ld,
                                           const TileAcc& acc) {
  const FragPos fp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        st2(out + fp.row(mt, h) * ld + fp.col(nt), acc[mt][nt][2 * h],
            acc[mt][nt][2 * h + 1]);
}

// Row totals over a 64 x 64 tile: v[mt][h] is this thread's sum over its
// 8 columns of row fp.row(mt, h); dst[r] gets row r's total, the four
// lanes of a quad added by shuffles, then the two warps of the row band in
// order.  Every thread takes part; ends synchronised.
__device__ __forceinline__ void tile_row_sums(const float (&v)[2][2],
                                              float (*red)[kTile],
                                              float* dst) {
  const FragPos fp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = v[mt][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (fp.t == 0) red[fp.wn >> 5][fp.row(mt, h)] = s;
    }
  __syncthreads();
  if (threadIdx.x < kTile) dst[threadIdx.x] = red[0][threadIdx.x] +
                                              red[1][threadIdx.x];
  __syncthreads();
}

// Row and column totals of a 64 x 64 tile in one exchange: rows[mt][h] is
// this thread's sum over its 8 columns of row fp.row(mt, h), cols[nt][c]
// over its 4 rows of column fp.col(nt) + c; row r's total goes to rdst[r],
// column c's to cdst[c].  Lanes are added by shuffles, then the two warps
// of a band in order.  Every thread takes part; ends synchronised.
__device__ __forceinline__ void tile_sums(const float (&rows)[2][2],
                                          const float (&cols)[4][2],
                                          float (*red)[kTile], float* rdst,
                                          float* cdst) {
  const FragPos fp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = rows[mt][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (fp.t == 0) red[fp.wn >> 5][fp.row(mt, h)] = s;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = cols[nt][c];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (fp.g == 0) red[2 + (fp.wm >> 5)][fp.col(nt) + c] = s;
    }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < kTile)
    rdst[tid] = red[0][tid] + red[1][tid];
  else
    cdst[tid - kTile] = red[2][tid - kTile] + red[3][tid - kTile];
  __syncthreads();
}

// 1. C B^T tile, then per head M, dCB, and P's row / column sums.
template <typename Tin>
__global__ void __launch_bounds__(kNT, kTcBlocksPerSm)
ssd_bwd_dcb_tc_kernel(Params p) {
  // the ring; before it, the bf16 C and B rows of the C B^T tile
  extern __shared__ __align__(16) unsigned char dcb_dyn[];
  Ring& ring = *reinterpret_cast<Ring*>(dcb_dyn);
  __shared__ float cum_i[kTile], cum_j[kTile], dt_j[kTile];
  __shared__ float red[4][kTile];
  constexpr bool kF32 = sizeof(Tin) == 4;
  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int bi = blockIdx.y / p.nc, c = blockIdx.y % p.nc, Q = p.Q;
  const int i0 = ti * kTile, j0 = tj * kTile, tid = threadIdx.x;
  const long long s0 = (long long)c * Q, bc = (long long)bi * p.nc + c;
  const long long dys = (long long)p.nh * p.hp;
  const Tin* Bp = static_cast<const Tin*>(p.B) + bi * p.bs_b + s0 * p.bs_s;
  const Tin* Cp = static_cast<const Tin*>(p.C) + bi * p.cs_b + s0 * p.cs_s;
  const Tin* xp = static_cast<const Tin*>(p.x) + bi * p.xs_b + s0 * p.xs_s;
  const float* dtp = p.dt + bi * p.dts_b + s0 * p.dts_s;
  const float* dy = p.dy + ((long long)bi * p.nc * Q + s0) * dys;
  const int nkm = p.hp / kBK;
  const FragPos fp;
  TileAcc cbv = {};
  if constexpr (kF32) {
    const Op<float, false> a{Cp + (long long)i0 * p.cs_s, p.cs_s, 0, {}};
    const Op<float, false> b{Bp + (long long)j0 * p.bs_s, p.bs_s, 0, {}};
    mma_tile<true, true>(a, b, p.ds / kBK, ring, cbv);
  } else {
    cb_tile_bf16(Cp + (long long)i0 * p.cs_s, p.cs_s,
                 Bp + (long long)j0 * p.bs_s, p.bs_s, p.ds,
                 reinterpret_cast<bf16*>(dcb_dyn), cbv);
  }
  store_tile(p.cb + (bc * Q + i0) * Q + j0, Q, cbv);
  TileAcc dcb = {};
  for (int h = 0; h < p.nh; ++h) {
    const long long chunk = ((long long)bi * p.nh + h) * p.nc + c;
    const float* cum = p.cum + chunk * Q;
    // the last head's epilogue ended on a __syncthreads
    if (tid < kTile) {
      cum_i[tid] = cum[i0 + tid];
      cum_j[tid] = cum[j0 + tid];
      dt_j[tid] = dtp[(long long)(j0 + tid) * p.dts_s + h * p.dts_h];
    }
    TileAcc m = {};
    {
      const Op<float, false> a{dy + (long long)i0 * dys + h * p.hp, dys, 0,
                               {}};
      const Op<Tin, false> b{xp + (long long)j0 * p.xs_s + h * p.xs_h,
                             p.xs_s, 0, {}};
      mma_tile<true, kF32>(a, b, nkm, ring, m);
    }
    // M = dY x^T, then dt_j and L: dCB += M L, P = M L C B^T.  Below the
    // diagonal (ti > tj: j < i0 <= i) L_ij = exp(cum_i - cum_i0) exp(cum_i0
    // - cum_j), both factors at most 1; the diagonal tile takes the exp of
    // each element under the causal mask.
    float lr[2][2], lc[4][2];
    const bool diag = ti == tj;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        lr[mt][hh] = diag ? 1.f : expf(cum_i[fp.row(mt, hh)] - cum_i[0]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = fp.col(nt) + cc;
        lc[nt][cc] = dt_j[col] * (diag ? 1.f : expf(cum_i[0] - cum_j[col]));
      }
    float rows[2][2] = {}, cols[4][2] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = fp.row(mt, hh);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = fp.col(nt) + cc, e = 2 * hh + cc;
            float L = lr[mt][hh] * lc[nt][cc];
            if (diag) {
              // exp may overflow above the diagonal: the select drops it
              const float d = L * expf(cum_i[r] - cum_j[col]);
              L = r >= col ? d : 0.f;
            }
            const float ml = m[mt][nt][e] * L;
            dcb[mt][nt][e] += ml;
            const float pv = ml * cbv[mt][nt][e];
            rows[mt][hh] += pv;
            cols[nt][cc] += pv;
          }
      }
    tile_sums(rows, cols, red, p.rowpart + (chunk * p.T + tj) * Q + i0,
              p.colpart + (chunk * p.T + ti) * Q + j0);
  }
  store_tile(p.dcb + (bc * Q + i0) * Q + j0, Q, dcb);
}

// v * e[k]: dY's rows scaled by e^cum as G stages them
struct ScaleK {
  const float* e;
  __device__ __forceinline__ float operator()(int k, int, float v) const {
    return v * e[k];
  }
};

// 2. G = (dY (.) e)^T C: one 64 x 64 tile of [hp, ds], K the chunk.
template <typename Tin>
__global__ void __launch_bounds__(kNT)
ssd_bwd_state_grad_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char g_dyn[];
  Ring& ring = *reinterpret_cast<Ring*>(g_dyn);
  __shared__ float e_s[kMaxQTc];
  constexpr bool kF32 = sizeof(Tin) == 4;
  const int c = blockIdx.x, bh = blockIdx.y, d0 = blockIdx.z * kTile;
  const int bi = bh / p.nh, h = bh % p.nh, Q = p.Q;
  const long long s0 = (long long)c * Q, chunk = (long long)bh * p.nc + c;
  const long long dys = (long long)p.nh * p.hp;
  const float* cum = p.cum + chunk * Q;
  for (int q = threadIdx.x; q < Q; q += kNT) e_s[q] = expf(cum[q]);
  __syncthreads();
  Op<float, true, ScaleK> a{
      p.dy + ((long long)bi * p.nc * Q + s0) * dys + h * p.hp, dys, 0,
      ScaleK{e_s}};
  Op<Tin, true> b{static_cast<const Tin*>(p.C) + bi * p.cs_b + s0 * p.cs_s +
                      d0,
                  p.cs_s, 0, {}};
  TileAcc g = {};
  mma_tile<true, kF32>(a, b, Q / kBK, ring, g);
  store_tile(p.dstate + chunk * p.hp * p.ds + d0, p.ds, g);
}

// L_ij = exp(cum_i - cum_j) of d(xdt)'s product, split between its two
// operands from per-head tables: L_ij = w_i g_s[col] with w_i = exp(cum_i
// - cum_k0), g_s[col] = exp(cum_k0 - cum_j), j = t0 + col and k0 the first
// row of i's 16-row slice s.  w_i scales dY's row i (LRow), g_s C B^T's
// column j in slice s (LCol), which also applies the causal mask.  Below
// the tile's diagonal block (j < k0 <= i) both factors are at most 1:
// neither overflows, and a product underflows only where L does.  In the
// diagonal block g_s exceeds 1 for j > k0; the tables serve it while each
// of its slices decays by under 60 (cum_k0 - cum_{k0 + 15}): every factor
// a valid entry takes is then finite.  A head whose diagonal block decays
// faster takes LDirect instead, exp(cum_i - cum_j) per element as the
// plain version does.  The transforms have no branch: a branch between
// the fragment reads had serialised their shared-memory latencies.
struct LCol {
  const float* g;      // [(Q - t0) / 16][64]
  int t0;
  __device__ __forceinline__ float operator()(int i, int col,
                                              float v) const {
    const float r = v * g[(i - t0) / kLs * kTile + col];
    return i >= t0 + col ? r : 0.f;   // g may be inf above the diagonal
  }
};
struct LRow {
  const float* w;      // [Q - t0]
  int t0;
  __device__ __forceinline__ float operator()(int i, int, float v) const {
    return v * w[i - t0];
  }
};
struct LDirect {
  const float* cum;    // the chunk's cum
  int t0;
  __device__ __forceinline__ float operator()(int i, int col,
                                              float v) const {
    const float r = v * expf(cum[i] - cum[t0 + col]);
    return i >= t0 + col ? r : 0.f;   // exp may overflow above it
  }
};

// acc[.][.][e] += s[row of e] a[.][.][e]
__device__ __forceinline__ void acc_rows(TileAcc& acc, const TileAcc& a,
                                         const float (&s)[2][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][nt][e] = fmaf(s[mt][e >> 1], a[mt][nt][e], acc[mt][nt][e]);
}

// 4. One launch, two kinds of block, each over one 64-row tile of a chunk
// and a group of heads in order: the d(xdt) block makes each head's d(xdt)
// (dx, and the row sums of ddt and decay_end); a dB / dC block, one per 64
// columns of ds, makes the tile's dC and dB columns and, per head, y_off's
// partial row sums.  The blocks of one chunk are neighbours in the grid
// and walk the heads together, so a head's dY rows come from L2 to the
// blocks after the first.

// d(xdt) of rows t0.. of a chunk, heads h0 .. h1 - 1.
template <typename Tin>
__device__ __forceinline__ void dxbc_dx(const Params& p, Ring& ring, int t,
                                        int bi, int c, int h0, int h1) {
  __shared__ float cum_s[kMaxQTc];
  __shared__ float w_s[kMaxQTc], g_s[kMaxQTc / kLs * kTile];
  __shared__ int direct_s;
  __shared__ float red[2][kTile];
  __shared__ float rj_s[kTile];
  constexpr bool kF32 = sizeof(Tin) == 4;
  const int Q = p.Q, ds = p.ds, tid = threadIdx.x;
  const int t0 = t * kTile, nkx = (Q - t0) / kBK;
  const long long s0 = (long long)c * Q, bc = (long long)bi * p.nc + c;
  const long long dys = (long long)p.nh * p.hp;
  const Tin* Bt = static_cast<const Tin*>(p.B) + bi * p.bs_b +
                  (s0 + t0) * p.bs_s;
  const Tin* xt = static_cast<const Tin*>(p.x) + bi * p.xs_b +
                  (s0 + t0) * p.xs_s;
  const float* dtt = p.dt + bi * p.dts_b + (s0 + t0) * p.dts_s;
  const float* dyt = p.dy + ((long long)bi * p.nc * Q + s0 + t0) * dys;
  const float* cbt = p.cb + (bc * Q + t0) * Q + t0;
  const FragPos fp;
  for (int h = h0; h < h1; ++h) {
    const long long chunk = ((long long)bi * p.nh + h) * p.nc + c;
    const float* cum = p.cum + chunk * Q;
    __syncthreads();   // the last head's readers of cum_s and the tables
    for (int q = tid; q < Q; q += kNT) cum_s[q] = cum[q];
    __syncthreads();
    for (int e = tid; e < (Q - t0) / kLs * kTile; e += kNT) {
      const int sl = e / kTile, col = e % kTile;
      g_s[e] = expf(cum_s[t0 + sl * kLs] - cum_s[t0 + col]);
    }
    for (int r = tid; r < Q - t0; r += kNT)
      w_s[r] = expf(cum_s[t0 + r] - cum_s[t0 + r / kLs * kLs]);
    if (tid == 0) {
      int d = 0;
      for (int sl = 0; sl < kTile / kLs; ++sl)
        d |= cum_s[t0 + sl * kLs] - cum_s[t0 + sl * kLs + kLs - 1] > 60.f;
      direct_s = d;
    }
    __syncthreads();
    const float cum_last = cum_s[Q - 1];
    float de_r[2][2], dt_r[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = fp.row(mt, hh);
        de_r[mt][hh] = expf(cum_last - cum_s[t0 + r]);
        dt_r[mt][hh] = dtt[(long long)r * p.dts_s + h * p.dts_h];
      }
    const float* dyh = dyt + h * p.hp;
    const Tin* xh = xt + h * p.xs_h;
    // d(xdt) = de (B dS_out^T) + (C B^T (.) L)^T dY over i >= t0, in one
    // accumulator: the first product scaled by de, then the second
    TileAcc X = {};
    {
      const Op<Tin, false> A{Bt, p.bs_s, 0, {}};
      const Op<float, false> B{p.dstate + chunk * p.hp * ds, ds, 0, {}};
      mma_tile<kF32, true>(A, B, ds / kBK, ring, X);
    }
    // decay_end's row sums, r_j = dt_j sum_p x_jp (de B dS_out^T)_jp
    float rsum[2][2] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = fp.row(mt, hh);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 xv = ld2(xh + (long long)r * p.xs_s + fp.col(nt));
          float* v = &X[mt][nt][2 * hh];
          v[0] *= de_r[mt][hh];
          v[1] *= de_r[mt][hh];
          rsum[mt][hh] = fmaf(xv.y, v[1], fmaf(xv.x, v[0], rsum[mt][hh]));
        }
        rsum[mt][hh] *= dt_r[mt][hh];
      }
    if (!direct_s) {
      const Op<float, true, LCol> A{cbt, Q, t0, LCol{g_s, t0}};
      const Op<float, true, LRow> B{dyh, dys, t0, LRow{w_s, t0}};
      mma_tile<true, true>(A, B, nkx, ring, X);
    } else {
      const Op<float, true, LDirect> A{cbt, Q, t0, LDirect{cum_s, t0}};
      const Op<float, true> B{dyh, dys, 0, {}};
      mma_tile<true, true>(A, B, nkx, ring, X);
    }
    Tin* dxt = static_cast<Tin*>(p.dx) +
               ((long long)bi * p.nc * Q + s0 + t0) * dys + h * p.hp;
    float xsum[2][2] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = fp.row(mt, hh);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = fp.col(nt);
          const float2 xv = ld2(xh + (long long)r * p.xs_s + col);
          const float v0 = X[mt][nt][2 * hh], v1 = X[mt][nt][2 * hh + 1];
          st2(dxt + (long long)r * dys + col, v0 * dt_r[mt][hh],
              v1 * dt_r[mt][hh]);
          xsum[mt][hh] = fmaf(v1, xv.y, fmaf(v0, xv.x, xsum[mt][hh]));
        }
      }
    tile_row_sums(xsum, red, p.ddt_x + chunk * Q + t0);
    tile_row_sums(rsum, red, rj_s);
    if (tid < kTile) p.dcum_loc[chunk * Q + t0 + tid] = -rj_s[tid];
    if (tid < 32) {   // the tile's sum of r_j, a fixed tree
      float v = rj_s[tid] + rj_s[tid + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tid == 0) p.rsum[chunk * p.T + t] = v;
    }
  }
}

// dC, dB of rows t0.. and columns d0.. of a chunk, heads h0 .. h1 - 1,
// into the group's partials; dCB's terms by the first group.
template <typename Tin>
__device__ __forceinline__ void dxbc_bc(const Params& p, Ring& ring, int t,
                                        int sd, int grp, int bi, int c,
                                        int h0, int h1) {
  __shared__ float cum_t[kTile];
  __shared__ float cum_last;
  __shared__ float red[2][kTile];
  constexpr bool kF32 = sizeof(Tin) == 4;
  const int Q = p.Q, ds = p.ds, tid = threadIdx.x;
  const int t0 = t * kTile, d0 = sd * kTile, nkh = p.hp / kBK;
  const long long s0 = (long long)c * Q, bc = (long long)bi * p.nc + c;
  const long long dys = (long long)p.nh * p.hp;
  const Tin* Bc = static_cast<const Tin*>(p.B) + bi * p.bs_b + s0 * p.bs_s;
  const Tin* Ct = static_cast<const Tin*>(p.C) + bi * p.cs_b +
                  (s0 + t0) * p.cs_s;
  const Tin* xt = static_cast<const Tin*>(p.x) + bi * p.xs_b +
                  (s0 + t0) * p.xs_s;
  const float* dtt = p.dt + bi * p.dts_b + (s0 + t0) * p.dts_s;
  const float* dyt = p.dy + ((long long)bi * p.nc * Q + s0 + t0) * dys;
  const float* dcbt = p.dcb + bc * Q * Q;
  const FragPos fp;
  // dC = dCB B over j < t0 + 64 and dB = dCB^T C over i >= t0, by the
  // first group; the others start from 0
  TileAcc dC = {}, dB = {};
  if (grp == 0) {
    const Op<float, false> A{dcbt + (long long)t0 * Q, Q, 0, {}};
    const Op<Tin, true> B{Bc + d0, p.bs_s, 0, {}};
    mma_tile<true, kF32>(A, B, (t0 + kTile) / kBK, ring, dC);
    const Op<float, true> A2{dcbt + (long long)t0 * Q + t0, Q, 0, {}};
    const Op<Tin, true> B2{Ct + d0, p.cs_s, 0, {}};
    mma_tile<true, kF32>(A2, B2, (Q - t0) / kBK, ring, dB);
  }
  for (int h = h0; h < h1; ++h) {
    const long long chunk = ((long long)bi * p.nh + h) * p.nc + c;
    const float* cum = p.cum + chunk * Q;
    __syncthreads();   // the last head's readers of cum_t are done
    if (tid < kTile) cum_t[tid] = cum[t0 + tid];
    if (tid == kTile) cum_last = cum[Q - 1];
    __syncthreads();
    float e_r[2][2], dedt[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = fp.row(mt, hh);
        e_r[mt][hh] = expf(cum_t[r]);
        dedt[mt][hh] = expf(cum_last - cum_t[r]) *
                       dtt[(long long)r * p.dts_s + h * p.dts_h];
      }
    const float* dS = p.dstate + chunk * p.hp * ds;
    // dC += e (dY S_in), y_off's row sums of C (.) (dY S_in); dB += de dt
    // (x dS_out)
    TileAcc T = {};
    {
      const Op<float, false> A{dyt + h * p.hp, dys, 0, {}};
      const Op<float, true> B{p.states + chunk * p.hp * ds + d0, ds, 0, {}};
      mma_tile<true, true>(A, B, nkh, ring, T);
    }
    float ysum[2][2] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = fp.row(mt, hh);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 cv = ld2(Ct + (long long)r * p.cs_s + d0 + fp.col(nt));
          ysum[mt][hh] = fmaf(cv.y, T[mt][nt][2 * hh + 1],
                              fmaf(cv.x, T[mt][nt][2 * hh], ysum[mt][hh]));
        }
      }
    acc_rows(dC, T, e_r);
    tile_row_sums(ysum, red, p.yoff + (chunk * p.ty + sd) * Q + t0);
    TileAcc U = {};
    {
      const Op<Tin, false> A{xt + h * p.xs_h, p.xs_s, 0, {}};
      const Op<float, true> B{dS + d0, ds, 0, {}};
      mma_tile<kF32, true>(A, B, nkh, ring, U);
    }
    acc_rows(dB, U, dedt);
  }
  const long long n_out = (long long)p.batch * p.nc * Q * ds;
  float* outC = p.bcpart + (long long)grp * 2 * n_out +
                ((long long)bi * p.nc * Q + s0 + t0) * ds + d0;
  store_tile(outC, ds, dC);
  store_tile(outC + n_out, ds, dB);
}

// grid (T, (1 + ds / 64) G, b nc): blockIdx.y = kind + (1 + ds / 64) group,
// kind 0 the d(xdt) block, kind 1 + sd the dB / dC block of columns 64 sd..
template <typename Tin>
__global__ void __launch_bounds__(kNT, kTcBlocksPerSm)
ssd_bwd_dxbc_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char dxbc_dyn[];
  Ring& ring = *reinterpret_cast<Ring*>(dxbc_dyn);
  const int kinds = 1 + p.ds / kTile;
  const int kind = blockIdx.y % kinds, grp = blockIdx.y / kinds;
  const int bi = blockIdx.z / p.nc, c = blockIdx.z % p.nc;
  const int hpg = (p.nh + p.groups - 1) / p.groups;
  const int h0 = grp * hpg, h1 = min(p.nh, h0 + hpg);
  if (kind == 0)
    dxbc_dx<Tin>(p, ring, blockIdx.x, bi, c, h0, h1);
  else
    dxbc_bc<Tin>(p, ring, blockIdx.x, kind - 1, grp, bi, c, h0, h1);
}

// 6. dC, dB = the head groups' partials, added in group order.
template <typename Tout>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_sum_kernel(Params p) {
  const long long n = (long long)p.batch * p.nc * p.Q * p.ds;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= 2 * n) return;
  const int which = e >= n;          // 0: dC, 1: dB
  const long long at = e - which * n;
  float4 s = *reinterpret_cast<const float4*>(p.bcpart + which * n + at);
  for (int g = 1; g < p.groups; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(
        p.bcpart + (2LL * g + which) * n + at);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  Tout* out = static_cast<Tout*>(which ? p.dB : p.dC) + at;
  st2(out, s.x, s.y);
  st2(out + 2, s.z, s.w);
}

// ===========================================================================
// launches
// ===========================================================================

struct Launch {
  dim3 grid;
  int threads;
  int smem;     // dynamic shared memory, bytes
};

constexpr int kLaunches = 7;

// The launches of one call of `variant`, in issue order: general dcb,
// state_grad, state_pass, dx, dbc, dcum, da; tc dcb, state_grad,
// state_pass, dxbc, dcum, bc_sum, da.
void launches(int variant, bool in_bf16, int batch, int S, int nh, int hp,
              int ds, int Q, int groups, Launch (&l)[kLaunches]) {
  const int nc = S / Q, bh = batch * nh;
  const int T = (Q + kTile - 1) / kTile;
  const int tp = (hp + kTile - 1) / kTile, td = (ds + kTile - 1) / kTile;
  const long long n = (long long)hp * ds;
  const Launch pass = {dim3((unsigned)((n + kThreads - 1) / kThreads), bh),
                       kThreads, 0};
  const Launch dcum = {dim3(nc, bh), kThreads, Q * (int)sizeof(float)};
  const Launch da = {dim3((nh + kThreads - 1) / kThreads), kThreads, 0};
  if (variant == kTc) {
    const long long n_out = 2LL * batch * S * ds;
    l[0] = {dim3(T * (T + 1) / 2, batch * nc), kNT,
            dcb_tc_smem(in_bf16, ds)};
    l[1] = {dim3(nc, bh, td), kNT, kRingBytes};
    l[2] = pass;
    l[3] = {dim3(T, (1 + td) * groups, batch * nc), kNT, kRingBytes};
    l[4] = dcum;
    l[5] = {dim3((unsigned)((n_out + 4 * kThreads - 1) / (4 * kThreads))),
            kThreads, 0};
    l[6] = da;
  } else {
    l[0] = {dim3(T * (T + 1) / 2, batch * nc), kThreads, 0};
    l[1] = {dim3(nc, bh, tp * td), kThreads, 0};
    l[2] = pass;
    l[3] = {dim3(T, nc, bh), kThreads, 0};
    l[4] = {dim3(T, td, batch * nc), kThreads, 0};
    l[5] = dcum;
    l[6] = da;
  }
}

template <typename Tin>
int launch(const Params& p, int variant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.Q > kMaxQ) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr bool kBf16 = sizeof(Tin) == 2;
  Launch l[kLaunches];
  launches(variant, kBf16, p.batch, p.nc * p.Q, p.nh, p.hp, p.ds, p.Q,
           p.groups, l);
  int code;
  if (variant == kTc) {
    // the loaders read 16 (float) or 8 (bf16) bytes at a time
    const long long v = 16 / (long long)sizeof(Tin);
    if (!tc_fits(p.hp, p.ds, p.Q) || p.groups < 1 || !p.yoff ||
        !p.bcpart || !hopper::aligned16(p.x) || !hopper::aligned16(p.B) ||
        !hopper::aligned16(p.C) || p.xs_b % v || p.xs_s % v || p.xs_h % v ||
        p.bs_b % v || p.bs_s % v || p.cs_b % v || p.cs_s % v)
      return (int)cudaErrorInvalidValue;
    static unsigned dcb_done = 0, g_done = 0, dxbc_done = 0;
    if ((code = (int)hopper::allow_smem(ssd_bwd_dcb_tc_kernel<Tin>,
                                        max(kRingBytes, kDcbSmemMax), device,
                                        &dcb_done)) ||
        (code = (int)hopper::allow_smem(ssd_bwd_state_grad_tc_kernel<Tin>,
                                        kRingBytes, device, &g_done)) ||
        (code = (int)hopper::allow_smem(ssd_bwd_dxbc_tc_kernel<Tin>,
                                        kRingBytes, device, &dxbc_done)))
      return code;
    ssd_bwd_dcb_tc_kernel<Tin><<<l[0].grid, l[0].threads, l[0].smem, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
    ssd_bwd_state_grad_tc_kernel<Tin>
        <<<l[1].grid, l[1].threads, l[1].smem, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
    ssd_bwd_state_pass_kernel<<<l[2].grid, l[2].threads, l[2].smem, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
    ssd_bwd_dxbc_tc_kernel<Tin>
        <<<l[3].grid, l[3].threads, l[3].smem, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
    ssd_bwd_dcum_kernel<<<l[4].grid, l[4].threads, l[4].smem, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
    ssd_bwd_bc_sum_kernel<Tin><<<l[5].grid, l[5].threads, l[5].smem, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
    ssd_bwd_da_kernel<<<l[6].grid, l[6].threads, l[6].smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (variant != kGeneral || !p.yoff) return (int)cudaErrorInvalidValue;
  ssd_bwd_dcb_kernel<Tin><<<l[0].grid, l[0].threads, l[0].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_state_grad_kernel<Tin>
      <<<l[1].grid, l[1].threads, l[1].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_state_pass_kernel<<<l[2].grid, l[2].threads, l[2].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_dx_kernel<Tin><<<l[3].grid, l[3].threads, l[3].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_dbc_kernel<Tin><<<l[4].grid, l[4].threads, l[4].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_dcum_kernel<<<l[5].grid, l[5].threads, l[5].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_da_kernel<<<l[6].grid, l[6].threads, l[6].smem, s>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* dy, const void* dfinal, const void* x,
                   const void* dt, const void* A, const void* B,
                   const void* C, const void* states, const void* cum,
                   void* dx, void* ddt, void* dA, void* dB, void* dC,
                   void* const* scratch, int batch, int S, int nh, int hp,
                   int ds, int Q, int variant, int groups,
                   const long long* st) {
  Params p;
  p.dy = static_cast<const float*>(dy);
  p.dfinal = static_cast<const float*>(dfinal);
  p.x = x; p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = B; p.C = C;
  p.states = static_cast<const float*>(states);
  p.cum = static_cast<const float*>(cum);
  p.dx = dx; p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = dB; p.dC = dC;
  float* const* sc = reinterpret_cast<float* const*>(scratch);
  p.cb = sc[0]; p.dcb = sc[1]; p.dstate = sc[2]; p.rowpart = sc[3];
  p.colpart = sc[4]; p.dcum_loc = sc[5]; p.ddt_x = sc[6]; p.rsum = sc[7];
  p.dA_part = sc[8]; p.yoff = sc[9]; p.bcpart = sc[10];
  p.batch = batch; p.nh = nh; p.hp = hp; p.ds = ds; p.Q = Q; p.nc = S / Q;
  p.T = (Q + kTile - 1) / kTile;
  p.ty = (ds + kTile - 1) / kTile;
  p.groups = groups;
  p.xs_b = st[0]; p.xs_s = st[1]; p.xs_h = st[2];
  p.dts_b = st[3]; p.dts_s = st[4]; p.dts_h = st[5];
  p.bs_b = st[6]; p.bs_s = st[7];
  p.cs_b = st[8]; p.cs_s = st[9];
  return p;
}

}  // namespace

extern "C" {

// strides: 10 element strides in order: x (batch, seq, head), dt (batch,
// seq, head), B (batch, seq), C (batch, seq); dy, d final state and every
// output dense.  scratch: kScratch pointers in the order of Params (cb,
// dcb, dstate, rowpart, colpart, dcum_loc, ddt_x, rsum, dA_part, yoff,
// bcpart), null where the variant names none.  variant: 0 general, 1 tc;
// groups: the tc variant's head groups (1 for general).  dfinal may be
// null (a zero gradient of the final state).
int ssd_scan_bwd_f32(const void* dy, const void* dfinal, const void* x,
                     const void* dt, const void* A, const void* B,
                     const void* C, const void* states, const void* cum,
                     void* dx, void* ddt, void* dA, void* dB, void* dC,
                     void* const* scratch, int batch, int S, int nh, int hp,
                     int ds, int Q, int variant, int groups,
                     const long long* strides, int device, void* stream) {
  const Params p = make_params(dy, dfinal, x, dt, A, B, C, states, cum, dx,
                               ddt, dA, dB, dC, scratch, batch, S, nh, hp,
                               ds, Q, variant, groups, strides);
  return launch<float>(p, variant, device, stream);
}

int ssd_scan_bwd_bf16(const void* dy, const void* dfinal, const void* x,
                      const void* dt, const void* A, const void* B,
                      const void* C, const void* states, const void* cum,
                      void* dx, void* ddt, void* dA, void* dB, void* dC,
                      void* const* scratch, int batch, int S, int nh, int hp,
                      int ds, int Q, int variant, int groups,
                      const long long* strides, int device, void* stream) {
  const Params p = make_params(dy, dfinal, x, dt, A, B, C, states, cum, dx,
                               ddt, dA, dB, dC, scratch, batch, S, nh, hp,
                               ds, Q, variant, groups, strides);
  return launch<bf16>(p, variant, device, stream);
}

// The launches of one call of `variant` with `groups` head groups and bf16
// (in_bf16 = 1) or float32 inputs, 5 ints each into out (grid x, y, z,
// threads, dynamic shared memory in bytes), in issue order; then the tile,
// the threads per general block, the largest chunk and the number of
// scratch pointers.
void ssd_scan_bwd_launch_shape(int batch, int S, int nh, int hp, int ds,
                               int Q, int variant, int groups, int in_bf16,
                               int* out) {
  Launch l[kLaunches];
  launches(variant, in_bf16 != 0, batch, S, nh, hp, ds, Q, groups, l);
  for (int i = 0; i < kLaunches; ++i) {
    out[5 * i] = (int)l[i].grid.x;
    out[5 * i + 1] = (int)l[i].grid.y;
    out[5 * i + 2] = (int)l[i].grid.z;
    out[5 * i + 3] = l[i].threads;
    out[5 * i + 4] = l[i].smem;
  }
  out[5 * kLaunches] = kTile;
  out[5 * kLaunches + 1] = kThreads;
  out[5 * kLaunches + 2] = kMaxQ;
  out[5 * kLaunches + 3] = kScratch;
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
