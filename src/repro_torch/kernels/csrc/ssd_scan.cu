// Mamba2 SSD chunk scan for NVIDIA Hopper (sm_90a).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers), WITH FMA contraction and without --use_fast_math: the
// kernel is held to its plain version by a tolerance, and expf keeps its
// accurate form.  Every entry point takes raw device pointers, element
// strides, caller-allocated scratch and the caller's CUDA stream, launches
// on that stream, does not synchronise, allocates nothing, and returns the
// first non-zero cudaGetLastError() of its launches.
//
// ---------------------------------------------------------------------------
// ssd_scan   replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
//
//   ngroups == 1.  Per (batch b, head h), the sequence is cut into chunks of
//   Q steps; within a chunk, all in float32:
//     cum   = cumsum(dt * A)                                      [Q]
//     L     = exp(cum_i - cum_j) for i >= j, else 0               [Q, Q]
//     y     = (C B^T (.) L) @ (x dt) + (C exp(cum)) @ state^T     [Q, hp]
//     state = state exp(cum[-1]) + ((x dt) exp(cum[-1] - cum))^T @ B
//                                                                 [hp, ds]
//     in : x [b, S, nh, hp] (Tin), dt [b, S, nh] (float32), A [nh]
//          (float32), B, C [b, S, 1, ds] (Tin); any strides with the last
//          dimension dense (B and C may be column slices of one tensor)
//     out: y [b, S, nh, hp] (Tout, dense), final state [b, nh, hp, ds]
//          (float32, dense)
//     scratch: states [b, nh, nc, hp, ds] and cum [b, nh, nc, Q] (float32);
//          the shared-C B^T variant also cb [b, nc, Q, Q] (float32)
//
//   The TPU kernel runs a (b, nh, chunk) grid with the chunk axis sequential
//   on one core, carrying the [hp, ds] state in VMEM across grid steps and
//   holding the whole [Q, Q] decay matrix L and C B^T per step.  On Hopper
//   that design would give b * nh blocks (24 of 132 SMs at B = 1) and, at
//   the model's chunk Q = 256, two float32 [256, 256] matrices of 256 KB
//   each, above a block's 227 KB of shared memory.  So the one scan is
//   several kernels here, the decomposition of the reference's ssd_chunked.
//
//   What bounds it on an H100: operations.  The scan needs, per (b, chunk),
//   C B^T over the lower triangle, ds Q (Q + 1) flops (shared by all heads
//   when ngroups == 1), and per (b, h, chunk) the masked product over the
//   lower triangle, hp Q (Q + 1), plus 4 Q hp ds for y_off and the state
//   contribution: at mamba2-130m's B = 1, S = 4096, nh = 24, hp = 64,
//   ds = 128, Q = 256 that is 5.0 GFLOP on ~41 MB, ~120 flops per byte,
//   above the float32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20).  Three
//   of the four products have float32 operands (C B^T (.) L, x dt, the
//   state) and are held to 1e-5 of scale: one rounding of such an operand
//   to TF32 or bf16 breaks that.  So they run on the tensor cores as
//   3xTF32: each float32 operand is split into hi + lo, both TF32, and the
//   product is lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B) with float32
//   accumulation (what it drops, lo(A) lo(B), is ~2^-22 of a product);
//   where one operand holds bf16 values, exact in TF32, two terms.  C B^T
//   of bf16 inputs is exact product by product in float32 and runs on the
//   bf16 tensor cores.  The same tiles with the float32 products on the
//   CUDA cores (8 x 4 register tiles from 16-byte shared loads) took
//   1.3-1.4x the time at the model shapes (PERF.md).
//
//   Two variants, picked by shape in Python (kernels/ssd_scan.py::plan):
//
//   shared_cb (hp == 64, ds % 64 == 0, ds <= 256, Q % 64 == 0, Q <= 256:
//   every mamba2-130m shape), four launches:
//   0. ssd_cb_bf16_kernel / ssd_cb_f32_kernel, grid (lower-triangle tiles,
//      b * nc): C B^T once per (b, chunk) for all heads, only the 64 x 64
//      tiles on or below the diagonal, into the cb scratch (4 MB at B = 1,
//      S = 4096: L2 holds it).  bf16: mma.sync m16n8k16 with float32
//      accumulation, each warp 16 rows x 64 columns.  float32: the 3xTF32
//      tile below.
//   1. ssd_state_tile_kernel, grid (nc, b * nh, ds / 64): cum by a float64
//      warp scan, written to scratch; the chunk's contribution
//      ((x dt) exp(cum[-1] - cum))^T @ B for one 64-column slice of ds.
//   2. ssd_state_pass_kernel<4>: the general variant's pass (below), four
//      state elements a thread in one 16-byte access.
//   3. ssd_output_tile_kernel, grid (nc, b * nh, Q / 64), the heaviest row
//      tiles issued first: y of 64 rows x hp as one product over
//      K = ds + (the row tile's end): C against the entering state, its
//      rows then scaled by exp(cum_i), then (C B^T (.) L) against (x dt),
//      C B^T read from the cb scratch; L is exp'd per element while the
//      slice is staged, the diagonal tile masked by a select.
//   The tensor-core products (kernels 1, 3, and 0 in float32) share one
//   block tile: 128 threads, a 64 x 64 output (each warp 32 x 32 as 2 x 4
//   mma.sync m16n8k8 tf32 tiles), K in slices of 16 staged through two
//   shared buffers (the next slice's loads in flight in registers while the
//   current one is multiplied; the staging applies dt, the decay and L).
//   The loaders read 16 bytes (8 for bf16 quarters) at a time: the wrapper
//   hands this variant operands whose base and strides lie on 16 bytes.
//   What holds the output kernel back now is the staging itself (its
//   transposed loads touch 32 rows a warp instruction, one barrier a slice),
//   not the tensor cores: see PERF.md.

//   general (every other shape; the test and reduced-model shapes), three
//   launches, each thread a 4 x 4 register tile from scalar shared loads:
//   1. ssd_chunk_state_kernel, grid (nc, b * nh): cum (float64 warp scan)
//      and the chunk's contribution to states, 64 x 64 output tiles.
//   2. ssd_state_pass_kernel<1>, grid (ceil(hp ds / 256), b * nh): one
//      thread per state element walks the chunks in order (the loads of
//      four chunks issued ahead), replaces each chunk's
//      contribution by the state ENTERING that chunk, and carries
//      state = state * exp(cum[-1]) + contribution, the TPU kernel's
//      association; the last value is the final state.
//   3. ssd_output_kernel, grid (ceil(Q / 64), nc, b * nh): one block per
//      64-row tile of one chunk; C B^T rebuilt per head and key tile.
//
//   cum is accumulated in float64 and rounded to float32 once per element,
//   as the plain version does: every partial sum of float values of one
//   chunk whose exponents span less than 53 - log2(Q) bits is exact in
//   float64, so the warp scan gives the serial loop's floats.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// the 3xTF32 helpers the K3 backward shares (hopper.cuh)
using hopper::mma_tf32;
using hopper::split_tf32;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // general variant: 16 x 16
constexpr int kTile = 64;      // rows, keys and columns of one output tile
constexpr int kMaxSmem = 232448;

enum Variant { kGeneral = 0, kSharedCb = 1 };

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* final_state;
  float* states;
  float* cum;
  float* cb;
  int nh, hp, ds, Q, nc;
  long long xs_b, xs_s, xs_h;     // x strides (batch, seq, head)
  long long dts_b, dts_s, dts_h;  // dt strides
  long long bs_b, bs_s;           // B strides (batch, seq)
  long long cs_b, cs_s;           // C strides
};

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(bf16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// ---- cum of one chunk: float64 warp scan ----------------------------------

// v[0..Q) holds dt * A of the chunk's steps; on return (after the caller's
// __syncthreads) it holds their cumsum, accumulated in float64 and rounded
// to float once per element.  Warp 0 works; each lane sums a run of
// consecutive steps, the lanes' totals are scanned by shuffles, and each
// lane then walks its run again from its exclusive prefix.
__device__ __forceinline__ void chunk_cumsum(float* v, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int q0 = min(lane * per, Q), q1 = min(q0 + per, Q);
  double own = 0.0;
  for (int q = q0; q < q1; ++q) own += (double)v[q];
  double incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.0;
  for (int q = q0; q < q1; ++q) {
    run += (double)v[q];
    v[q] = (float)run;
  }
}

// ===========================================================================
// general variant
// ===========================================================================

// ---- 1. per-chunk cum and the chunk's own state contribution ------------

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(Params p) {
  extern __shared__ __align__(16) float sm1[];
  const int Q = p.Q, hp = p.hp, ds = p.ds;
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.nh, h = bh % p.nh;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float* dts = sm1;              // [Q] dt
  float* cum = dts + Q;          // [Q]
  float* dec = cum + Q;          // [Q] exp(cum[-1] - cum)
  float* Ws = dec + Q;           // [64][64] (x dt) dec, rows = steps
  float* Bs = Ws + kTile * kTile;  // [64][64] B, rows = steps
  const long long t0 = (long long)c * Q;
  const Tin* x = static_cast<const Tin*>(p.x);
  const Tin* Bp = static_cast<const Tin*>(p.B);
  const float a = p.A[h];

  for (int q = tid; q < Q; q += kThreads) {
    const float d = p.dt[b * p.dts_b + (t0 + q) * p.dts_s + h * p.dts_h];
    dts[q] = d;
    cum[q] = d * a;
  }
  __syncthreads();
  chunk_cumsum(cum, Q);
  __syncthreads();
  float* cum_g = p.cum + ((long long)bh * p.nc + c) * Q;
  const float cend = cum[Q - 1];
  for (int q = tid; q < Q; q += kThreads) {
    cum_g[q] = cum[q];
    dec[q] = expf(cend - cum[q]);
  }

  float* out = p.states + (((long long)bh * p.nc + c) * hp) * ds;
  for (int p0 = 0; p0 < hp; p0 += kTile) {
    for (int s0 = 0; s0 < ds; s0 += kTile) {
      float acc[4][4] = {};
      for (int q0 = 0; q0 < Q; q0 += kTile) {
        __syncthreads();
        for (int i = tid; i < kTile * kTile; i += kThreads) {
          const int qq = i / kTile, cc = i % kTile;
          const int q = q0 + qq;
          const long long t = t0 + q;
          float w = 0.f, bv = 0.f;
          if (q < Q && p0 + cc < hp)
            w = (load(x, b * p.xs_b + t * p.xs_s + h * p.xs_h + p0 + cc) *
                 dts[q]) * dec[q];
          if (q < Q && s0 + cc < ds)
            bv = load(Bp, b * p.bs_b + t * p.bs_s + s0 + cc);
          Ws[i] = w;
          Bs[i] = bv;
        }
        __syncthreads();
        const int qn = min(kTile, Q - q0);
        for (int qq = 0; qq < qn; ++qq) {
          float wv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[r] = Ws[qq * kTile + ty + 16 * r];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = Bs[qq * kTile + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] += wv[r] * bv[k];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pp = p0 + ty + 16 * r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ss = s0 + tx + 16 * k;
          if (pp < hp && ss < ds) out[(long long)pp * ds + ss] = acc[r][k];
        }
      }
    }
  }
}

// ---- 2. the sequential pass over chunks (both variants) ------------------

// V consecutive state elements per thread (4: one 16-byte access, when
// hp ds is a multiple of 4; else 1); the loads of four chunks are issued
// before the carried update walks them.
template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(Params p) {
  const int bh = blockIdx.y;
  const long long n = (long long)p.hp * p.ds;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= n) return;
  float* __restrict__ st = p.states + (long long)bh * p.nc * n + e;
  const float* __restrict__ cum = p.cum + (long long)bh * p.nc * p.Q;
  float run[V] = {};
  for (int c0 = 0; c0 < p.nc; c0 += 4) {
    float v[4][V], g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < p.nc) {
        load_v(v[u], st + (c0 + u) * n);
        g[u] = expf(cum[(long long)(c0 + u) * p.Q + p.Q - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < p.nc) {
        store_v(st + (c0 + u) * n, run);   // the state entering the chunk
#pragma unroll
        for (int i = 0; i < V; ++i) run[i] = run[i] * g[u] + v[u][i];
      }
    }
  }
  store_v(p.final_state + bh * n + e, run);
}

// ---- 3. the outputs, per 64-row tile of a chunk --------------------------

int output_smem_floats(int ds, int Q) {
  const int ld = ds | 1;
  return 2 * kTile * ld + kTile * kTile + kTile * (kTile + 1) + Q;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(Params p) {
  extern __shared__ __align__(16) float sm3[];
  const int Q = p.Q, hp = p.hp, ds = p.ds;
  const int ld = ds | 1;
  const int nrt = (Q + kTile - 1) / kTile;
  const int rt = nrt - 1 - blockIdx.x;        // heaviest row tiles first
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / p.nh, h = bh % p.nh;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = rt * kTile;
  const int rows = min(kTile, Q - r0);
  const long long t0 = (long long)c * Q;
  float* Cs = sm3;                      // [64][ld] C rows of the tile
  float* Bs = Cs + kTile * ld;          // [64][ld] state rows, then B rows
  float* Xs = Bs + kTile * ld;          // [64][64] (x dt) rows of a key tile
  float* Ps = Xs + kTile * kTile;       // [64][65] (C B^T) (.) L tile
  float* cum = Ps + kTile * (kTile + 1);  // [r0 + rows]
  const Tin* x = static_cast<const Tin*>(p.x);
  const Tin* Bp = static_cast<const Tin*>(p.B);
  const Tin* Cp = static_cast<const Tin*>(p.C);
  Tout* y = static_cast<Tout*>(p.y);

  const float* cum_g = p.cum + ((long long)bh * p.nc + c) * Q;
  for (int i = tid; i < r0 + rows; i += kThreads) cum[i] = cum_g[i];
  for (int i = tid; i < kTile * ds; i += kThreads) {
    const int r = i / ds, s = i % ds;
    Cs[r * ld + s] =
        r < rows ? load(Cp, b * p.cs_b + (t0 + r0 + r) * p.cs_s + s) : 0.f;
  }
  const float* st = p.states + (((long long)bh * p.nc + c) * hp) * ds;

  for (int p0 = 0; p0 < hp; p0 += kTile) {
    const int pn = min(kTile, hp - p0);
    __syncthreads();   // Bs / Xs / Ps free from the previous column tile
    for (int i = tid; i < kTile * ds; i += kThreads) {
      const int r = i / ds, s = i % ds;
      Bs[r * ld + s] = r < pn ? st[(long long)(p0 + r) * ds + s] : 0.f;
    }
    __syncthreads();

    // y_off = exp(cum_i) * sum_s C[i, s] state[p, s]
    float acc[4][4] = {};
    for (int s = 0; s < ds; ++s) {
      float cv[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ld + s];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = Bs[(tx + 16 * k) * ld + s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] += cv[r] * sv[k];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float e = i < rows ? expf(cum[r0 + i]) : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] *= e;
    }

    for (int kt = 0; kt <= rt; ++kt) {
      const int k0 = kt * kTile;
      const int kn = min(kTile, Q - k0);
      __syncthreads();   // done with Bs (state or last B tile), Xs, Ps
      for (int i = tid; i < kTile * ds; i += kThreads) {
        const int j = i / ds, s = i % ds;
        Bs[j * ld + s] =
            j < kn ? load(Bp, b * p.bs_b + (t0 + k0 + j) * p.bs_s + s) : 0.f;
      }
      for (int i = tid; i < kTile * kTile; i += kThreads) {
        const int j = i / kTile, pp = i % kTile;
        float v = 0.f;
        if (j < kn && pp < pn) {
          const long long t = t0 + k0 + j;
          v = load(x, b * p.xs_b + t * p.xs_s + h * p.xs_h + p0 + pp) *
              p.dt[b * p.dts_b + t * p.dts_s + h * p.dts_h];
        }
        Xs[i] = v;
      }
      __syncthreads();

      float cb[4][4] = {};
      for (int s = 0; s < ds; ++s) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ld + s];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = Bs[(tx + 16 * k) * ld + s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) cb[r][k] += cv[r] * bv[k];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = ty + 16 * r;
        const int i = r0 + ii;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int jj = tx + 16 * k;
          const int j = k0 + jj;
          // exp only on or below the diagonal: above it cum_i - cum_j > 0
          Ps[ii * (kTile + 1) + jj] =
              (ii < rows && jj < kn && j <= i)
                  ? cb[r][k] * expf(cum[i] - cum[j])
                  : 0.f;
        }
      }
      __syncthreads();

      for (int j = 0; j < kn; ++j) {
        float pv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty + 16 * r) * (kTile + 1) + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = Xs[j * kTile + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] += pv[r] * xv[k];
      }
    }

    const long long ys_s = (long long)p.nh * hp;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pp = tx + 16 * k;
        if (i < rows && pp < pn)
          store(y, (long long)b * p.nc * Q * ys_s + (t0 + r0 + i) * ys_s +
                       (long long)h * hp + p0 + pp,
                acc[r][k]);
      }
    }
  }
}

// ===========================================================================
// shared_cb variant
// ===========================================================================

constexpr int kNT = 128;                 // threads of a tile block
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kMaxQ = 256;               // the variant's largest chunk

// Four consecutive elements, loaded in one 16-byte (float) or 8-byte (bf16)
// access; get(i) converts element i to float.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <> struct Vec4<bf16> {
  uint2 v;
  __device__ __forceinline__ void load(const bf16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t w = i < 2 ? v.x : v.y;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// One block tile's shared slices, double-buffered: A k-major a[k][m], B
// b[k][n], rows padded to kLd = 72 floats so that the fragment loads of a
// warp (lanes g = lane / 4 and t = lane % 4 at [k + t][m + g]) fall in 32
// banks.  Warp w computes rows 32 (w % 2) .. + 31 and columns 32 (w / 2) ..
// + 31 of the 64 x 64 output as 2 x 4 m16n8k8 tiles.
constexpr int kLd = kBM + 8;
struct TileSmem {
  float a[2][kBK][kLd];
  float b[2][kBK][kLd];
};

// Two ways a thread stages its 8 elements of a 16 x 64 slice:
//   row pattern (kk = tid / 8, q = tid % 8): slice row kk, columns 4 q ..
//     4 q + 3 and 32 + 4 q .. 32 + 4 q + 3, from a source row k0 + kk whose
//     64 columns are the slice's columns;
//   transposed pattern (m = tid % 64, hh = tid / 64): slice column m, rows
//     8 hh .. 8 hh + 7, from source row m at columns k0 + 8 hh .. + 7.
__device__ __forceinline__ void put_row(float (*s)[kLd], const float v[8]) {
  const int kk = threadIdx.x >> 3, q = threadIdx.x & 7;
  *reinterpret_cast<float4*>(&s[kk][4 * q]) =
      make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(&s[kk][32 + 4 * q]) =
      make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void put_transposed(float (*s)[kLd],
                                               const float v[8]) {
  const int m = threadIdx.x & 63, hh = threadIdx.x >> 6;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[8 * hh + j][m] = v[j];
}

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

// acc += A B over nk slices of 16, F staging them: F::fetch(kt) issues the
// global loads of slice kt into registers, F::put(a, b) turns them into the
// slice in shared memory.  The loads of slice kt + 1 are in flight while
// slice kt is multiplied.  Each product is float32 on the tensor cores as
// 3xTF32: lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B), the small terms first;
// kSplitA / kSplitB false for an operand that is exact in TF32 (bf16 data)
// drops its lo term.  Ends on a __syncthreads, so a second call may follow
// at once.
template <bool kSplitA, bool kSplitB, typename F>
__device__ __forceinline__ void tile_mainloop(F& f, int nk, TileSmem& sm,
                                              TileAcc& acc) {
  const FragPos fp;
  f.fetch(0);
  f.put(sm.a[0], sm.b[0]);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) f.fetch(kt + 1);
#pragma unroll
    for (int kb = 0; kb < kBK; kb += 8) {
      const float* a0 = &sm.a[cur][kb + fp.t][0];
      const float* a1 = &sm.a[cur][kb + fp.t + 4][0];
      const float* b0 = &sm.b[cur][kb + fp.t][0];
      const float* b1 = &sm.b[cur][kb + fp.t + 4][0];
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = fp.wm + 16 * mt + fp.g;
        split_tf32<kSplitA>(a0[m], ah[mt][0], al[mt][0]);
        split_tf32<kSplitA>(a0[m + 8], ah[mt][1], al[mt][1]);
        split_tf32<kSplitA>(a1[m], ah[mt][2], al[mt][2]);
        split_tf32<kSplitA>(a1[m + 8], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = fp.wn + 8 * nt + fp.g;
        split_tf32<kSplitB>(b0[n], bh[nt][0], bl[nt][0]);
        split_tf32<kSplitB>(b1[n], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (kSplitA)
            mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
          if constexpr (kSplitB)
            mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
          mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
        }
    }
    if (kt + 1 < nk) f.put(sm.a[cur ^ 1], sm.b[cur ^ 1]);
    __syncthreads();
  }
}

// ---- 0. C B^T once per (b, chunk), lower-triangle 64 x 64 tiles ----------

// (row tile, column tile) of lower-triangle tile `idx`, row-major order
__device__ __forceinline__ void tri_tile(int idx, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= idx) ++ti;
  tj = idx - ti * (ti + 1) / 2;
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

// bf16 inputs: the products C[i, s] B[j, s] are exact in float32; the
// tensor cores sum them with float32 accumulation.  C and B rows of the
// tile in shared memory, ld = ds + 8 bf16 (ds / 2 + 4 words: the 32 lanes'
// fragment words fall in 32 banks).  Warp w: rows 16 w .. 16 w + 15, all
// 64 columns as 8 n-tiles of m16n8k16.
int cb_bf16_smem_bytes(int ds) { return 2 * kBM * (ds + 8) * 2; }

__global__ void __launch_bounds__(kNT)
ssd_cb_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smcb[];
  const int Q = p.Q, ds = p.ds, ld = ds + 8;
  int ti, tj;
  tri_tile(blockIdx.x, ti, tj);
  const int bc = blockIdx.y, b = bc / p.nc, c = bc % p.nc;
  const long long t0 = (long long)c * Q;
  const bf16* Cp = static_cast<const bf16*>(p.C);
  const bf16* Bp = static_cast<const bf16*>(p.B);
  bf16* Cs = reinterpret_cast<bf16*>(smcb);
  bf16* Bs = Cs + kBM * ld;
  const int chunks = ds / 8;
  for (int i = threadIdx.x; i < kBM * chunks; i += kNT) {
    const int r = i / chunks, k8 = (i % chunks) * 8;
    *reinterpret_cast<uint4*>(&Cs[r * ld + k8]) =
        *reinterpret_cast<const uint4*>(
            Cp + b * p.cs_b + (t0 + ti * kBM + r) * p.cs_s + k8);
    *reinterpret_cast<uint4*>(&Bs[r * ld + k8]) =
        *reinterpret_cast<const uint4*>(
            Bp + b * p.bs_b + (t0 + tj * kBN + r) * p.bs_s + k8);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 16 * warp + g;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < ds; k0 += 16) {
    const int ka = k0 + 2 * t;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(&Cs[ra * ld + ka]);
    const uint32_t a1 =
        *reinterpret_cast<const uint32_t*>(&Cs[(ra + 8) * ld + ka]);
    const uint32_t a2 =
        *reinterpret_cast<const uint32_t*>(&Cs[ra * ld + ka + 8]);
    const uint32_t a3 =
        *reinterpret_cast<const uint32_t*>(&Cs[(ra + 8) * ld + ka + 8]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int rb = 8 * n + g;
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(&Bs[rb * ld + ka]);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(&Bs[rb * ld + ka + 8]);
      mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
    }
  }
  float* out = p.cb + ((long long)bc * Q + ti * kBM + ra) * Q + tj * kBN;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * Q + 8 * n + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// Writes a block's 64 x 64 float32 accumulators to rows of `out` ld floats
// apart, float2 by float2.
__device__ __forceinline__ void store_tile(float* out, long long ld,
                                           const TileAcc& acc) {
  const FragPos fp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(out + fp.row(mt, h) * ld + fp.col(nt)) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// float32 inputs: the tile above, 3xTF32, A = C rows, B = B rows, both
// staged transposed (k = s).
struct CbF32Fetch {
  const float* crow;   // C row ti * 64 + m of the chunk
  const float* brow;   // B row tj * 64 + m
  float4 c0, c1, b0, b1;
  __device__ __forceinline__ void fetch(int kt) {
    const int k = kt * kBK + 8 * (threadIdx.x >> 6);
    c0 = *reinterpret_cast<const float4*>(crow + k);
    c1 = *reinterpret_cast<const float4*>(crow + k + 4);
    b0 = *reinterpret_cast<const float4*>(brow + k);
    b1 = *reinterpret_cast<const float4*>(brow + k + 4);
  }
  __device__ __forceinline__ void put(float (*a)[kLd], float (*b)[kLd]) {
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    put_transposed(a, cv);
    put_transposed(b, bv);
  }
};

__global__ void __launch_bounds__(kNT)
ssd_cb_f32_kernel(Params p) {
  __shared__ __align__(16) TileSmem sm;
  const int Q = p.Q;
  int ti, tj;
  tri_tile(blockIdx.x, ti, tj);
  const int bc = blockIdx.y, b = bc / p.nc, c = bc % p.nc;
  const long long t0 = (long long)c * Q;
  const int m = threadIdx.x & 63;
  CbF32Fetch f;
  f.crow = static_cast<const float*>(p.C) + b * p.cs_b +
           (t0 + ti * kBM + m) * p.cs_s;
  f.brow = static_cast<const float*>(p.B) + b * p.bs_b +
           (t0 + tj * kBN + m) * p.bs_s;
  TileAcc acc = {};
  tile_mainloop<true, true>(f, p.ds / kBK, sm, acc);
  store_tile(p.cb + ((long long)bc * Q + ti * kBM) * Q + tj * kBN, Q, acc);
}

// ---- 1. cum and the chunk's contribution, per 64-column slice of ds ------

// A = (x dt) dec [q][p] (row pattern), B = B [q][s0 + n] (row pattern)
template <typename Tin>
struct StateFetch {
  const Tin* x;        // x at (b, chunk start, h)
  const Tin* bm;       // B at (b, chunk start) + s0
  long long xs, bs;    // x and B step strides
  const float* dts;    // shared [Q]
  const float* dec;    // shared [Q]
  Vec4<Tin> x0, x1, b0, b1;
  int q;
  __device__ __forceinline__ void fetch(int kt) {
    const int kk = threadIdx.x >> 3, c4 = 4 * (threadIdx.x & 7);
    q = kt * kBK + kk;
    x0.load(x + q * xs + c4);
    x1.load(x + q * xs + 32 + c4);
    b0.load(bm + q * bs + c4);
    b1.load(bm + q * bs + 32 + c4);
  }
  __device__ __forceinline__ void put(float (*a)[kLd], float (*b)[kLd]) {
    const float d = dts[q], e = dec[q];
    float w[8], v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (x0.get(i) * d) * e;
      w[4 + i] = (x1.get(i) * d) * e;
      v[i] = b0.get(i);
      v[4 + i] = b1.get(i);
    }
    put_row(a, w);
    put_row(b, v);
  }
};

template <typename Tin>
__global__ void __launch_bounds__(kNT)
ssd_state_tile_kernel(Params p) {
  __shared__ __align__(16) TileSmem sm;
  __shared__ float dts[kMaxQ], cum[kMaxQ], dec[kMaxQ];
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const int Q = p.Q;
  const int c = blockIdx.x, bh = blockIdx.y, s0 = blockIdx.z * kBN;
  const int b = bh / p.nh, h = bh % p.nh;
  const long long t0 = (long long)c * Q;
  const float a = p.A[h];
  for (int q = threadIdx.x; q < Q; q += kNT) {
    const float d = p.dt[b * p.dts_b + (t0 + q) * p.dts_s + h * p.dts_h];
    dts[q] = d;
    cum[q] = d * a;
  }
  __syncthreads();
  chunk_cumsum(cum, Q);
  __syncthreads();
  const float cend = cum[Q - 1];
  float* cum_g = p.cum + ((long long)bh * p.nc + c) * Q;
  for (int q = threadIdx.x; q < Q; q += kNT) {
    if (blockIdx.z == 0) cum_g[q] = cum[q];
    dec[q] = expf(cend - cum[q]);
  }
  __syncthreads();

  StateFetch<Tin> f;
  f.x = static_cast<const Tin*>(p.x) + b * p.xs_b + t0 * p.xs_s +
        h * p.xs_h;
  f.bm = static_cast<const Tin*>(p.B) + b * p.bs_b + t0 * p.bs_s + s0;
  f.xs = p.xs_s;
  f.bs = p.bs_s;
  f.dts = dts;
  f.dec = dec;
  TileAcc acc = {};
  tile_mainloop<true, !kBf16>(f, Q / kBK, sm, acc);
  store_tile(p.states + ((long long)bh * p.nc + c) * p.hp * p.ds + s0, p.ds,
             acc);
}

// ---- 3. y per 64-row tile: one product over K = ds + the row tile's end --

// y_off before its row scale: A = C[i][s] (transposed), B = state[p][s]
// (transposed)
template <typename Tin>
struct YoffFetch {
  const Tin* crow;     // C row r0 + m
  const float* srow;   // entering state, row p = m
  Vec4<Tin> c0, c1;
  float4 s0, s1;
  __device__ __forceinline__ void fetch(int kt) {
    const int k = kt * kBK + 8 * (threadIdx.x >> 6);
    c0.load(crow + k);
    c1.load(crow + k + 4);
    s0 = *reinterpret_cast<const float4*>(srow + k);
    s1 = *reinterpret_cast<const float4*>(srow + k + 4);
  }
  __device__ __forceinline__ void put(float (*a)[kLd], float (*b)[kLd]) {
    float cv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cv[i] = c0.get(i);
      cv[4 + i] = c1.get(i);
    }
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    put_transposed(a, cv);
    put_transposed(b, sv);
  }
};

// y_diag: A = C B^T[i][j] L[i][j] (transposed; 0 where j > i, by select),
// B = x[j][p] dt[j] (row pattern)
template <typename Tin>
struct DiagFetch {
  const float* cbrow;  // C B^T row i = r0 + m of the chunk
  const Tin* x;        // x at (b, chunk start, h)
  const float* dt;     // dt at (b, chunk start, h)
  long long xs, dts;
  const float* cum;    // shared cum of the chunk
  float cum_i;
  int i;
  float4 cb0, cb1;
  Vec4<Tin> x0, x1;
  float d;
  int j0, j;
  __device__ __forceinline__ void fetch(int kt) {
    j0 = kt * kBK + 8 * (threadIdx.x >> 6);
    cb0 = *reinterpret_cast<const float4*>(cbrow + j0);
    cb1 = *reinterpret_cast<const float4*>(cbrow + j0 + 4);
    j = kt * kBK + (threadIdx.x >> 3);
    const int c4 = 4 * (threadIdx.x & 7);
    x0.load(x + j * xs + c4);
    x1.load(x + j * xs + 32 + c4);
    d = dt[j * dts];
  }
  __device__ __forceinline__ void put(float (*a)[kLd], float (*b)[kLd]) {
    const float cb[8] = {cb0.x, cb0.y, cb0.z, cb0.w,
                         cb1.x, cb1.y, cb1.z, cb1.w};
    float pv[8], xv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // above the diagonal cum_i - cum_j > 0 may overflow exp: the select
      // drops it
      const float v = cb[k] * expf(cum_i - cum[j0 + k]);
      pv[k] = j0 + k <= i ? v : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xv[k] = x0.get(k) * d;
      xv[4 + k] = x1.get(k) * d;
    }
    put_transposed(a, pv);
    put_row(b, xv);
  }
};

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kNT)
ssd_output_tile_kernel(Params p) {
  __shared__ __align__(16) TileSmem sm;
  __shared__ float cum[kMaxQ];
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const int Q = p.Q, ds = p.ds;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int rt = gridDim.z - 1 - blockIdx.z;   // heaviest row tiles first
  const int b = bh / p.nh, h = bh % p.nh;
  const int r0 = rt * kBM, kend = r0 + kBM;
  const long long t0 = (long long)c * Q;
  const float* cum_g = p.cum + ((long long)bh * p.nc + c) * Q;
  for (int i = threadIdx.x; i < kend; i += kNT) cum[i] = cum_g[i];
  __syncthreads();
  const int m = threadIdx.x & 63;
  const FragPos fp;
  TileAcc acc = {};
  {
    YoffFetch<Tin> f;
    f.crow = static_cast<const Tin*>(p.C) + b * p.cs_b +
             (t0 + r0 + m) * p.cs_s;
    f.srow = p.states + (((long long)bh * p.nc + c) * p.hp + m) * ds;
    tile_mainloop<!kBf16, true>(f, ds / kBK, sm, acc);
  }
  // y_off = exp(cum_i) (C state^T)_i
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float e = expf(cum[r0 + fp.row(mt, hh)]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][2 * hh] *= e;
        acc[mt][nt][2 * hh + 1] *= e;
      }
    }
  {
    DiagFetch<Tin> f;
    f.cbrow = p.cb + ((long long)(b * p.nc + c) * Q + r0 + m) * Q;
    f.x = static_cast<const Tin*>(p.x) + b * p.xs_b + t0 * p.xs_s +
          h * p.xs_h;
    f.dt = p.dt + b * p.dts_b + t0 * p.dts_s + h * p.dts_h;
    f.xs = p.xs_s;
    f.dts = p.dts_s;
    f.cum = cum;
    f.i = r0 + m;
    f.cum_i = cum[r0 + m];
    tile_mainloop<true, true>(f, kend / kBK, sm, acc);
  }
  const long long ys = (long long)p.nh * p.hp;
  Tout* y = static_cast<Tout*>(p.y) + ((long long)b * p.nc * Q + t0 + r0) * ys +
            (long long)h * p.hp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        Tout* at = y + fp.row(mt, hh) * ys + fp.col(nt);
        const float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if constexpr (sizeof(Tout) == 4) {
          *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
}

// ===========================================================================
// launches
// ===========================================================================

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return 0;
}

// One call's launches, in order: C B^T (shared_cb only; else a zero grid),
// the chunk states, the pass, the outputs; grid, threads and dynamic
// shared memory (bytes) of each.
struct Launch {
  dim3 grid;
  int threads, smem;
};
struct Launches {
  Launch cb, chunk_state, state_pass, output;
};

// state elements per thread of the pass: 4 under shared_cb (hp = 64)
int pass_width(int variant) { return variant == kSharedCb ? 4 : 1; }

Launches launches(int variant, bool in_bf16, int batch, int S, int nh,
                  int hp, int ds, int Q) {
  const int bh = batch * nh, nc = S / Q;
  const long long n = (long long)hp * ds;
  const int v = pass_width(variant);
  Launches l;
  l.state_pass = {dim3((unsigned)((n + v * kThreads - 1) / (v * kThreads)),
                       bh),
                  kThreads, 0};
  if (variant == kSharedCb) {
    const int nq = Q / kBM;
    l.cb = {dim3(nq * (nq + 1) / 2, batch * nc), kNT,
            in_bf16 ? cb_bf16_smem_bytes(ds) : 0};
    l.chunk_state = {dim3(nc, bh, ds / kBN), kNT, 0};
    l.output = {dim3(nc, bh, nq), kNT, 0};
  } else {
    l.cb = {dim3(0, 0, 0), 0, 0};
    l.chunk_state = {dim3(nc, bh), kThreads,
                     (3 * Q + 2 * kTile * kTile) * (int)sizeof(float)};
    l.output = {dim3((Q + kTile - 1) / kTile, nc, bh), kThreads,
                output_smem_floats(ds, Q) * (int)sizeof(float)};
  }
  return l;
}

// Whether the shared_cb variant takes these sizes (the plan's rule).
bool shared_cb_fits(int hp, int ds, int Q) {
  return hp == kBN && ds % kBN == 0 && ds <= 256 && Q % kBM == 0 &&
         Q <= kMaxQ;
}

template <typename Tin, typename Tout>
int launch(const Params& p, int variant, int batch, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const Launches l = launches(variant, kBf16, batch, p.nc * p.Q, p.nh, p.hp,
                              p.ds, p.Q);
  int code;
  if (variant == kSharedCb) {
    if (!shared_cb_fits(p.hp, p.ds, p.Q)) return (int)cudaErrorInvalidValue;
    if constexpr (kBf16) {
      if ((code = set_smem(ssd_cb_bf16_kernel, l.cb.smem))) return code;
      ssd_cb_bf16_kernel<<<l.cb.grid, l.cb.threads, l.cb.smem, s>>>(p);
    } else {
      ssd_cb_f32_kernel<<<l.cb.grid, l.cb.threads, 0, s>>>(p);
    }
    if ((code = (int)cudaGetLastError())) return code;
    ssd_state_tile_kernel<Tin>
        <<<l.chunk_state.grid, l.chunk_state.threads, 0, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
  } else {
    if (variant != kGeneral) return (int)cudaErrorInvalidValue;
    code = set_smem(ssd_chunk_state_kernel<Tin>, l.chunk_state.smem);
    if (code) return code;
    ssd_chunk_state_kernel<Tin><<<l.chunk_state.grid, l.chunk_state.threads,
                                  l.chunk_state.smem, s>>>(p);
    if ((code = (int)cudaGetLastError())) return code;
  }

  if (variant == kSharedCb)
    ssd_state_pass_kernel<4>
        <<<l.state_pass.grid, l.state_pass.threads, 0, s>>>(p);
  else
    ssd_state_pass_kernel<1>
        <<<l.state_pass.grid, l.state_pass.threads, 0, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;

  if (variant == kSharedCb) {
    ssd_output_tile_kernel<Tin, Tout>
        <<<l.output.grid, l.output.threads, 0, s>>>(p);
  } else {
    code = set_smem(ssd_output_kernel<Tin, Tout>, l.output.smem);
    if (code) return code;
    ssd_output_kernel<Tin, Tout>
        <<<l.output.grid, l.output.threads, l.output.smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

Params make_params(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* final_state,
                   void* states, void* cum, void* cb, int S, int nh, int hp,
                   int ds, int Q, const long long* st) {
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = B; p.C = C; p.y = y;
  p.final_state = static_cast<float*>(final_state);
  p.states = static_cast<float*>(states);
  p.cum = static_cast<float*>(cum);
  p.cb = static_cast<float*>(cb);
  p.nh = nh; p.hp = hp; p.ds = ds; p.Q = Q; p.nc = S / Q;
  p.xs_b = st[0]; p.xs_s = st[1]; p.xs_h = st[2];
  p.dts_b = st[3]; p.dts_s = st[4]; p.dts_h = st[5];
  p.bs_b = st[6]; p.bs_s = st[7];
  p.cs_b = st[8]; p.cs_s = st[9];
  return p;
}

}  // namespace

extern "C" {

// strides: 10 element strides in order: x (batch, seq, head), dt (batch,
// seq, head), B (batch, seq), C (batch, seq).  variant: 0 general, 1
// shared_cb (cb may be null for general).  out_bf16: 0 writes y in
// float32, 1 in bfloat16.
int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, void* final_state, void* states,
                 void* cum, void* cb, int batch, int S, int nh, int hp,
                 int ds, int Q, int variant, const long long* strides,
                 int out_bf16, int device, void* stream) {
  const Params p = make_params(x, dt, A, B, C, y, final_state, states, cum,
                               cb, S, nh, hp, ds, Q, strides);
  return out_bf16 ? launch<float, bf16>(p, variant, batch, device, stream)
                  : launch<float, float>(p, variant, batch, device, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, void* y, void* final_state, void* states,
                  void* cum, void* cb, int batch, int S, int nh, int hp,
                  int ds, int Q, int variant, const long long* strides,
                  int out_bf16, int device, void* stream) {
  const Params p = make_params(x, dt, A, B, C, y, final_state, states, cum,
                               cb, S, nh, hp, ds, Q, strides);
  return out_bf16 ? launch<bf16, bf16>(p, variant, batch, device, stream)
                  : launch<bf16, float>(p, variant, batch, device, stream);
}

// The launches of one call of `variant` with bf16 (in_bf16 = 1) or float32
// inputs, 21 ints into out: for C B^T (zeros under the general variant),
// the chunk states, the pass and the outputs in turn, the grid (x, y, z),
// the threads per block and the dynamic shared memory (bytes); then the
// most shared memory a block may take.
void ssd_scan_launch_shape(int batch, int S, int nh, int hp, int ds, int Q,
                           int variant, int in_bf16, int* out) {
  const Launches l = launches(variant, in_bf16 != 0, batch, S, nh, hp, ds, Q);
  const Launch* g[4] = {&l.cb, &l.chunk_state, &l.state_pass, &l.output};
  for (int i = 0; i < 4; ++i) {
    out[5 * i] = (int)g[i]->grid.x;
    out[5 * i + 1] = (int)g[i]->grid.y;
    out[5 * i + 2] = (int)g[i]->grid.z;
    out[5 * i + 3] = g[i]->threads;
    out[5 * i + 4] = g[i]->smem;
  }
  out[20] = kMaxSmem;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
