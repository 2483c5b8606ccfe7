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
//     scratch: states [b, nh, nc, hp, ds] and cum [b, nh, nc, Q] (float32)
//
//   The TPU kernel runs a (b, nh, chunk) grid with the chunk axis sequential
//   on one core, carrying the [hp, ds] state in VMEM across grid steps and
//   holding the whole [Q, Q] decay matrix L and C B^T per step.  On Hopper
//   that design would give b * nh blocks (24 of 132 SMs at B = 1) and, at
//   the model's chunk Q = 256, two float32 [256, 256] matrices of 256 KB
//   each, above a block's 227 KB of shared memory.  So the one scan is three
//   kernels here, the decomposition of the reference's ssd_chunked:
//
//   1. ssd_chunk_state_kernel, grid (nc, b * nh): cum of the chunk
//      (accumulated in double, rounded to float once per element: the
//      plain version does the same, so both take the decay exponents from
//      the same float values) written to scratch, and the chunk's own
//      contribution ((x dt) exp(cum[-1] - cum))^T @ B written to states,
//      as 64 x 64 output tiles over 64-step slices of the chunk.
//   2. ssd_state_pass_kernel, grid (ceil(hp ds / 256), b * nh): one thread
//      per state element walks the chunks in order, replaces each chunk's
//      contribution by the state ENTERING that chunk, and carries
//      state = state * exp(cum[-1]) + contribution, the TPU kernel's
//      association; the last value is the final state.
//   3. ssd_output_kernel, grid (ceil(Q / 64), nc, b * nh): one block per
//      64-row tile of one chunk.  y_off = exp(cum_i) (C_i . state_p), then
//      for each 64-key tile j <= the row tile: the C B^T tile from shared
//      C and B rows, times L recomputed from cum, exp only where i >= j
//      (i < j gives 0 without evaluating exp, which could overflow), then
//      added into y by a product with the (x dt) tile.  L and C B^T never
//      exist whole: one 64 x 64 tile of their product lives in shared
//      memory at a time.  Row tiles are issued heaviest first (the last
//      row tile of a chunk sees every key tile).
//
//   Shared memory of kernel 3: C rows and B rows (or state rows) [64][ld]
//   each, ld = ds rounded up to odd so that 16 rows fall in 16 banks; the
//   (x dt) tile [64][64]; the masked C B^T tile [64][65]; cum [<= Q].  At
//   ds = 128, Q = 256: 100 KB, two blocks per SM; above 48 KB it needs the
//   dynamic-shared-memory opt-in, set before every launch.
//
//   Each block has 256 threads as a 16 x 16 grid; every product is a 64 x 64
//   output tile with a 4 x 4 register tile per thread (rows ty + 16 a,
//   columns tx + 16 b), from shared memory, on the CUDA cores in float32 for
//   both input types.  hp > 64 and ds > 64 loop over 64-wide column tiles.
//
//   Bound on an H100: operations.  The scan needs, per (b, chunk), C B^T
//   over the lower triangle, ds Q (Q + 1) flops (shared by all heads when
//   ngroups == 1), and per (b, h, chunk) the masked product over the lower
//   triangle, hp Q (Q + 1), plus 4 Q hp ds for y_off and the state
//   contribution: at mamba2-130m's B = 1, S = 4096, nh = 24, hp = 64,
//   ds = 128, Q = 256 that is 5.0 GFLOP on ~41 MB, ~120 flops per byte,
//   above the float32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20).  The
//   TPU kernel does 12.9 GFLOP (C B^T per head, full Q x Q products); this
//   version skips the tiles above the diagonal but recomputes C B^T per
//   head (~9.3 GFLOP).  What it leaves for later: C B^T once per (b, chunk)
//   for all heads, bf16 mma / wgmma for C B^T, fusing the three kernels.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // rows, keys and columns of one output tile
constexpr int kMaxSmem = 232448;

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
  if (tid == 0) {
    double run = 0.0;
    for (int q = 0; q < Q; ++q) {
      run += (double)cum[q];
      cum[q] = (float)run;
    }
  }
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

// ---- 2. the sequential pass over chunks ----------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(Params p) {
  const int bh = blockIdx.y;
  const long long n = (long long)p.hp * p.ds;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float* st = p.states + (long long)bh * p.nc * n + e;
  const float* cum = p.cum + (long long)bh * p.nc * p.Q;
  float run = 0.f;
  for (int c = 0; c < p.nc; ++c) {
    const float contrib = st[c * n];
    st[c * n] = run;                 // the state entering chunk c
    run = run * expf(cum[(long long)c * p.Q + p.Q - 1]) + contrib;
  }
  p.final_state[bh * n + e] = run;
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

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return 0;
}

// The grids and dynamic shared memory (bytes) of one call's three launches.
struct Launches {
  dim3 chunk_state, state_pass, output;
  int smem_chunk_state, smem_output;
};

Launches launches(int batch, int S, int nh, int hp, int ds, int Q) {
  const int bh = batch * nh, nc = S / Q;
  const long long n = (long long)hp * ds;
  Launches l;
  l.chunk_state = dim3(nc, bh);
  l.smem_chunk_state = (3 * Q + 2 * kTile * kTile) * (int)sizeof(float);
  l.state_pass = dim3((unsigned)((n + kThreads - 1) / kThreads), bh);
  l.output = dim3((Q + kTile - 1) / kTile, nc, bh);
  l.smem_output = output_smem_floats(ds, Q) * (int)sizeof(float);
  return l;
}

template <typename Tin, typename Tout>
int launch(const Params& p, int batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Launches l = launches(batch, p.nc * p.Q, p.nh, p.hp, p.ds, p.Q);

  int code = set_smem(ssd_chunk_state_kernel<Tin>, l.smem_chunk_state);
  if (code) return code;
  ssd_chunk_state_kernel<Tin>
      <<<l.chunk_state, kThreads, l.smem_chunk_state, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;

  ssd_state_pass_kernel<<<l.state_pass, kThreads, 0, s>>>(p);
  if ((code = (int)cudaGetLastError())) return code;

  code = set_smem(ssd_output_kernel<Tin, Tout>, l.smem_output);
  if (code) return code;
  ssd_output_kernel<Tin, Tout><<<l.output, kThreads, l.smem_output, s>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* final_state,
                   void* states, void* cum, int S, int nh, int hp, int ds,
                   int Q, const long long* st) {
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = B; p.C = C; p.y = y;
  p.final_state = static_cast<float*>(final_state);
  p.states = static_cast<float*>(states);
  p.cum = static_cast<float*>(cum);
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
// seq, head), B (batch, seq), C (batch, seq).  out_bf16: 0 writes y in
// float32, 1 in bfloat16.
int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, void* final_state, void* states,
                 void* cum, int batch, int S, int nh, int hp, int ds, int Q,
                 const long long* strides, int out_bf16, int device,
                 void* stream) {
  const Params p = make_params(x, dt, A, B, C, y, final_state, states, cum,
                               S, nh, hp, ds, Q, strides);
  return out_bf16 ? launch<float, bf16>(p, batch, device, stream)
                  : launch<float, float>(p, batch, device, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, void* y, void* final_state, void* states,
                  void* cum, int batch, int S, int nh, int hp, int ds, int Q,
                  const long long* strides, int out_bf16, int device,
                  void* stream) {
  const Params p = make_params(x, dt, A, B, C, y, final_state, states, cum,
                               S, nh, hp, ds, Q, strides);
  return out_bf16 ? launch<bf16, bf16>(p, batch, device, stream)
                  : launch<bf16, float>(p, batch, device, stream);
}

// The launches of one call, 14 ints into out: the grids (x, y, z) of the
// chunk states, the pass and the outputs; the dynamic shared memory (bytes)
// of the chunk states and of the outputs; the threads per block; the most
// shared memory a block may take.
void ssd_scan_launch_shape(int batch, int S, int nh, int hp, int ds, int Q,
                           int* out) {
  const Launches l = launches(batch, S, nh, hp, ds, Q);
  const dim3 g[3] = {l.chunk_state, l.state_pass, l.output};
  for (int i = 0; i < 3; ++i) {
    out[3 * i] = (int)g[i].x;
    out[3 * i + 1] = (int)g[i].y;
    out[3 * i + 2] = (int)g[i].z;
  }
  out[9] = l.smem_chunk_state;
  out[10] = l.smem_output;
  out[11] = kThreads;
  out[12] = kMaxSmem;
  out[13] = kTile;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
