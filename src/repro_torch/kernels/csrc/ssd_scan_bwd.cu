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
//   L_ij = exp(cum_i - cum_j) (i >= j), de_j = exp(cum_last - cum_j),
//   xdt = x dt, S_in the state entering the chunk (the forward's scratch)
//   and dS_out the gradient of the state leaving it:
//     G      = dY^T (C (.) e^cum)                     [hp, ds]
//     dS_in  = G + e^{cum_last} dS_out  (reverse pass over the chunks,
//                                        started at d final_state)
//     d(xdt) = (C B^T (.) L)^T dY + de (.) (B dS_out^T)
//     M      = dY xdt^T under the causal mask;  dCB = sum_h M (.) L
//     dcum_i = rowsum(P)_i - colsum(P)_i          P = M (.) L (.) C B^T
//              + e^{cum_i} sum_s C_is (dY S_in)_is        (y_off)
//              - de_i sum_p xdt_ip (B dS_out^T)_ip         (decay_end)
//     dcum_last += sum_j de_j sum_p xdt_jp (B dS_out^T)_jp
//                  + e^{cum_last} <S_in, dS_out>           (chunk decay)
//     ddA    = the reverse cumsum of dcum within the chunk (float64)
//     dx = d(xdt) dt;  ddt = sum_p d(xdt) x + ddA A;  dA = sum ddA dt
//     dC = dCB B + sum_h e^cum (dY S_in);  dB = dCB^T C + sum_h de (xdt dS_out)
//
//   in : dy [b, S, nh, hp] (float32, dense), d final state [b, nh, hp, ds]
//        (float32, dense; null for zero), the forward's x, dt, A, B, C
//        (strides as ssd_scan.cu) and its scratch: states (the entering
//        state of every chunk) [b, nh, nc, hp, ds] and cum [b, nh, nc, Q]
//   out: dx [b, S, nh, hp], dB, dC [b, S, 1, ds] (Tin, dense); ddt [b, S,
//        nh], dA [nh] (float32, dense)
//   scratch (float32): cb, dcb [b, nc, Q, Q]; dstate [b, nh, nc, hp, ds];
//        rowpart, colpart [b, nh, nc, T, Q] (T = ceil(Q / 64)); dcum_loc,
//        ddt_x [b, nh, nc, Q]; rsum [b, nh, nc, T]; dA_part [nh, b, nc]
//
//   Deterministic: dB and dC are shared by every head and dA by every
//   (b, S), and no output takes a float atomic.  The kernels that sum over
//   heads (dcb, dbc) are one block per (b, chunk, tile) walking the heads
//   in order; every other cross-block sum goes through a per-tile partial
//   in scratch that a later kernel adds in a fixed order; every in-block
//   reduction is a fixed tree (warp shuffles, then shared memory in index
//   order).  Two runs are bitwise equal.
//
//   Seven launches, in this order on the stream:
//   1. ssd_bwd_dcb_kernel, grid (T (T + 1) / 2 lower-triangle tiles,
//      b * nc): the C B^T tile once (into cb), then for every head in
//      order M's tile, dCB += M (.) L, and P's row and column sums over
//      the tile (into rowpart, colpart); dcb written once.
//   2. ssd_bwd_state_grad_kernel, grid (nc, b * nh, hp / 64 x ds / 64
//      tiles): G into dstate.
//   3. ssd_bwd_state_pass_kernel, grid (ceil(hp ds / 256), b * nh): one
//      thread a state element walks the chunks last to first, replacing
//      each G by the dS_out of its chunk.
//   4. ssd_bwd_dx_kernel, grid (T, nc, b * nh): 64 rows of d(xdt) over
//      the head dimension in 64-wide tiles: dx, and per row the sums of
//      ddt and dcum that stay in the row (into ddt_x, dcum_loc, rsum).
//   5. ssd_bwd_dcum_kernel, grid (nc, b * nh): dcum assembled from the
//      partials in tile order, its reverse cumsum by one thread in
//      float64, ddt, and the chunk's dA partial.
//   6. ssd_bwd_dbc_kernel, grid (T, ceil(ds / 64), b * nc): 64 x 64 tiles
//      of dC and dB, the heads walked in order.
//   7. ssd_bwd_da_kernel: dA[h], the partials added in (b, chunk) order.
//
//   Every product is a 64 x 64 output tile of 256 threads, each a 4 x 4
//   register tile (4 neighbouring rows by 4 neighbouring columns, read as
//   16-byte vectors from shared memory), K staged through shared memory in
//   slices of 16 by loader functions that apply dt, the decays, L and the
//   causal mask as they load, neighbouring threads on the operand's
//   contiguous index, the next slice's loads in flight in registers while
//   the current one is multiplied; all on the CUDA cores in float32.  Every
//   kernel is bounded to 128 registers, two blocks an SM: the dCB kernel
//   then spills ~120 bytes and still ran 1.8x faster than at one block an
//   SM without (PERF.md).  This is the simple first version: the tensor
//   cores are not used.
//
//   What bounds it on an H100: operations.  At mamba2-130m's b = 8, S =
//   4096, nh = 24, hp = 64, ds = 128, Q = 256 the backward needs ~2.1x the
//   forward's products (the masked products twice, M and d(xdt); four
//   Q hp ds products a head; C B^T and dCB's two products per (b, chunk)),
//   ~90 GFLOP on ~0.9 GB, ~100 flops a byte, above the float32 CUDA-core
//   ridge (67 TFLOP/s / 3.35 TB/s = 20).  The kernels run them on the CUDA
//   cores at float32 accuracy (held to 1e-4 of scale); 3xTF32 on the
//   tensor cores, as the forward does, is the next step (PERF.md).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // rows / columns of an output tile
constexpr int kThreads = 256;   // threads of every block
constexpr int kK = 16;          // K slice staged through shared memory
constexpr int kMaxQ = 8192;     // the dcum kernel holds a chunk's dcum
constexpr int kScratch = 9;     // scratch tensors, in the order below

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
  int batch, nh, hp, ds, Q, nc, T;
  long long xs_b, xs_s, xs_h, dts_b, dts_s, dts_h, bs_b, bs_s, cs_b, cs_s;
};

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

__device__ __forceinline__ void tile_pair(int t, int& ti, int& tj) {
  ti = 0;
  while (t > ti) { t -= ti + 1; ++ti; }
  tj = t;
}

// 1. C B^T tile, then per head M, dCB, and P's row / column sums.
template <typename Tin>
__global__ void __launch_bounds__(kThreads, 2)
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

// 3. The reverse pass: dstate[c] <- dS_out of chunk c.
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

// 4. 64 rows of d(xdt): dx, and the row sums of ddt and dcum.
template <typename Tin>
__global__ void __launch_bounds__(kThreads, 2)
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
  const float* Sin = p.states + chunk * p.hp * p.ds;
  const Tin* xp = static_cast<const Tin*>(p.x) + bi * p.xs_b;
  const Tin* Bp = static_cast<const Tin*>(p.B) + bi * p.bs_b;
  const Tin* Cp = static_cast<const Tin*>(p.C) + bi * p.cs_b;
  const float* dtp = p.dt + bi * p.dts_b;
  Tin* dxp = static_cast<Tin*>(p.dx) +
             (long long)bi * Q * p.nc * p.nh * p.hp;
  if (tid < kTile) cum_s[tid] = j0 + tid < Q ? cum[j0 + tid] : 0.f;
  __syncthreads();

  float sx[4] = {0.f, 0.f, 0.f, 0.f}, sr[4] = {0.f, 0.f, 0.f, 0.f},
        sy[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < p.hp; p0 += kTile) {
    // C S_in^T first, consumed into the y_off row sums before the other
    // two products (fewer accumulators live at once)
    float ta[4][4], tb[4][4];
    zero(ta);
    tile_mm<true, true>(ta, 0, p.ds,
            [&](int r, int k) {
              const int j = j0 + r;
              return j < Q ? ld(Cp + (s0 + j) * p.cs_s + k) : 0.f;
            },
            [&](int k, int col) {
              const int pp = p0 + col;
              return pp < p.hp ? Sin[(long long)pp * p.ds + k] : 0.f;
            },
            sm);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + 4 * ty + a;
      if (j >= Q) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pp = p0 + 4 * tx + q;
        if (pp < p.hp)
          sy[a] = fmaf(dy[((s0 + j) * p.nh + h) * p.hp + pp], ta[a][q],
                       sy[a]);
      }
    }
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
    const float y_sum = row_reduce(sy[a]);
    const int r = 4 * ty + a, j = j0 + r;
    if (j < Q) {
      const float de = expf(cum_last - cum_s[r]);
      const float rj = de * r_sum;
      if (tx == 0) {
        p.ddt_x[chunk * Q + j] = x_sum;
        p.dcum_loc[chunk * Q + j] = expf(cum_s[r]) * y_sum - rj;
      }
      if (tx == 0) rpart[a] = rj;
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

// 5. dcum from the partials, its reverse cumsum, ddt and dA's partial.
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
    float d = p.dcum_loc[chunk * Q + i];
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

// 6. dC and dB, one 64 x 64 tile each, the heads in order.
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
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float ein = expf(cum_s[4 * ty + a]);
#pragma unroll
      for (int q = 0; q < 4; ++q) dC[a][q] = fmaf(ein, t[a][q], dC[a][q]);
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

// 7. dA[h] = the (b, chunk) partials in order.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_da_kernel(Params p) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= p.nh) return;
  const float* part = p.dA_part + (long long)h * p.batch * p.nc;
  float s = 0.f;
  for (int k = 0; k < p.batch * p.nc; ++k) s += part[k];
  p.dA[h] = s;
}

struct Launch {
  dim3 grid;
  int threads;
  int smem;     // dynamic shared memory, bytes
};

constexpr int kLaunches = 7;

// The launches of one call, in issue order: dcb, state_grad, state_pass,
// dx, dcum, dbc, da.
void launches(int batch, int S, int nh, int hp, int ds, int Q,
              Launch (&l)[kLaunches]) {
  const int nc = S / Q, bh = batch * nh;
  const int T = (Q + kTile - 1) / kTile;
  const int tp = (hp + kTile - 1) / kTile, td = (ds + kTile - 1) / kTile;
  const long long n = (long long)hp * ds;
  l[0] = {dim3(T * (T + 1) / 2, batch * nc), kThreads, 0};
  l[1] = {dim3(nc, bh, tp * td), kThreads, 0};
  l[2] = {dim3((unsigned)((n + kThreads - 1) / kThreads), bh), kThreads, 0};
  l[3] = {dim3(T, nc, bh), kThreads, 0};
  l[4] = {dim3(nc, bh), kThreads, Q * (int)sizeof(float)};
  l[5] = {dim3(T, td, batch * nc), kThreads, 0};
  l[6] = {dim3((nh + kThreads - 1) / kThreads), kThreads, 0};
}

template <typename Tin>
int launch(const Params& p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.Q > kMaxQ) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Launch l[kLaunches];
  launches(p.batch, p.nc * p.Q, p.nh, p.hp, p.ds, p.Q, l);
  int code;
  ssd_bwd_dcb_kernel<Tin><<<l[0].grid, l[0].threads, l[0].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_state_grad_kernel<Tin>
      <<<l[1].grid, l[1].threads, l[1].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_state_pass_kernel<<<l[2].grid, l[2].threads, l[2].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_dx_kernel<Tin><<<l[3].grid, l[3].threads, l[3].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_dcum_kernel<<<l[4].grid, l[4].threads, l[4].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_dbc_kernel<Tin><<<l[5].grid, l[5].threads, l[5].smem, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;
  ssd_bwd_da_kernel<<<l[6].grid, l[6].threads, l[6].smem, s>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* dy, const void* dfinal, const void* x,
                   const void* dt, const void* A, const void* B,
                   const void* C, const void* states, const void* cum,
                   void* dx, void* ddt, void* dA, void* dB, void* dC,
                   void* const* scratch, int batch, int S, int nh, int hp,
                   int ds, int Q, const long long* st) {
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
  p.dA_part = sc[8];
  p.batch = batch; p.nh = nh; p.hp = hp; p.ds = ds; p.Q = Q; p.nc = S / Q;
  p.T = (Q + kTile - 1) / kTile;
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
// dcb, dstate, rowpart, colpart, dcum_loc, ddt_x, rsum, dA_part).
// dfinal may be null (a zero gradient of the final state).
int ssd_scan_bwd_f32(const void* dy, const void* dfinal, const void* x,
                     const void* dt, const void* A, const void* B,
                     const void* C, const void* states, const void* cum,
                     void* dx, void* ddt, void* dA, void* dB, void* dC,
                     void* const* scratch, int batch, int S, int nh, int hp,
                     int ds, int Q, const long long* strides, int device,
                     void* stream) {
  const Params p = make_params(dy, dfinal, x, dt, A, B, C, states, cum, dx,
                               ddt, dA, dB, dC, scratch, batch, S, nh, hp,
                               ds, Q, strides);
  return launch<float>(p, device, stream);
}

int ssd_scan_bwd_bf16(const void* dy, const void* dfinal, const void* x,
                      const void* dt, const void* A, const void* B,
                      const void* C, const void* states, const void* cum,
                      void* dx, void* ddt, void* dA, void* dB, void* dC,
                      void* const* scratch, int batch, int S, int nh, int hp,
                      int ds, int Q, const long long* strides, int device,
                      void* stream) {
  const Params p = make_params(dy, dfinal, x, dt, A, B, C, states, cum, dx,
                               ddt, dA, dB, dC, scratch, batch, S, nh, hp,
                               ds, Q, strides);
  return launch<bf16>(p, device, stream);
}

// The launches of one call, 5 ints each into out (grid x, y, z, threads,
// dynamic shared memory in bytes), in issue order; then the tile, the
// threads per block, the largest chunk and the number of scratch tensors.
void ssd_scan_bwd_launch_shape(int batch, int S, int nh, int hp, int ds,
                               int Q, int* out) {
  Launch l[kLaunches];
  launches(batch, S, nh, hp, ds, Q, l);
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
