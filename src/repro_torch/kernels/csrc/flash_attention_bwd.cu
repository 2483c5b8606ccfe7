// Flash-attention backward for NVIDIA Hopper (sm_90a), BSHD layout.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -Xptxas -v
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers), with FMA contraction and without --use_fast_math (the
// kernels are held to their plain version by a tolerance; expf and exp2f
// keep their accurate forms).  Every entry point takes raw device pointers,
// element strides, the launch plan and the caller's CUDA stream, launches
// on that stream, does not synchronise, allocates nothing, and returns a
// CUDA error code: cudaErrorInvalidValue for a plan or shape it refuses,
// else cudaGetLastError().
//
// ---------------------------------------------------------------------------
// K3 backward   the gradient of the TPU kernel
//   repro/kernels/flash_attention.py::_flash_kernel (the reference defines
//   none: it trains through its XLA attention, repro/models/layers.py
//   flash_attention, and jax.vjp differentiates that)
//
//   Given q [B, S, H, D], k, v [B, S, KV, D], the forward's o [B, S, H, D]
//   and row log-sum-exp lse [B, H, S] (flash_attention.cu's *_lse entry
//   points), and do = dL/do [B, S, H, D], with G = H / KV:
//     D_i   = sum_d do[i, d] o[i, d]                       (float32)
//     P_ij  = exp(scale q_i . k_j - lse_i), 0 for j > i when causal
//     dV_j  = sum_{h in group} sum_i P_ij do_i
//     dP_ij = do_i . v_j
//     dS_ij = P_ij (dP_ij - D_i) scale
//     dQ_i  = sum_j dS_ij k_j
//     dK_j  = sum_{h in group} sum_i dS_ij q_i
//   out: dq [B, S, H, D], dk, dv [B, S, KV, D] in the input type.
//
//   Bound on an H100: operations.  Per (b, h) the backward does five
//   products over the causally visible pairs -- S again, dP, dV, dQ, dK --
//   2 * pairs * 5 * D flops, 2.5 times the forward's: at stablelm-1.6b's
//   B=1, S=4096, H=32, D=64 that is 171.8 GFLOP on ~50 MB, far above the
//   card's ridge point.
//
//   Design (a first, simple version; making it fast is later work): two
//   launches a call, no float atomics, so two runs are bitwise equal.
//   1. dQ: one block per (b * H + h, 64-row q block), the heaviest causal
//      q blocks first.  It first computes D of its rows from o and do and
//      writes it to a float32 [B, H, S] scratch, then walks the visible kv
//      tiles: S = Q K^T and dP = dO V^T for its rows, P from lse, dS, and
//      dQ += dS K, kept in registers until the end.
//   2. dK / dV: one block per (b * KV + kvh, 64-key block).  It walks the
//      G query heads of its group and, for each, the q tiles that see its
//      keys (all of them when not causal): S^T = K Q^T and dP^T = V dO^T
//      for its keys, P^T from lse, dS^T from D (written by launch 1), dV
//      += P^T dO, dK += dS^T Q, all in registers, so the group's heads are
//      summed without atomics.
//
//   flash_bwd_dq_bf16_kernel<D, BK>, flash_bwd_dkdv_bf16_kernel<D, BQ>
//     bf16, D in {64, 128}: mma.sync.aligned.m16n8k16 from ldmatrix
//     fragments, four warps a block, each owning 16 rows (dQ) or 16 keys
//     (dK / dV); the tile it walks double-buffered by 16-byte cp.async in
//     row-padded shared memory.  A C fragment pair of an m16n8 product is
//     the A fragment of the next product (P and dS are rounded to bf16 in
//     registers and never touch shared memory); the same row-major tile of
//     Q, K or dO gives B fragments both ways (ldmatrix, ldmatrix.trans).
//     The dK / dV kernel steps 32 query rows at D = 128 (BQ), so that its
//     four accumulators stay in registers.
//   flash_bwd_dq_f32_kernel<D>, flash_bwd_dkdv_f32_kernel<D>   float32 on
//     the CUDA cores (the reference's float32 attention is IEEE float32):
//     256 threads a 32-row block; thread (r, c) = (t / 8, t % 8) computes
//     the scores of row r and columns c + 8 j and owns accumulator columns
//     c + 8 j; P and dS go through shared memory once a tile.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// strides: (batch, seq, head) element strides of each tensor, in this order
enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, S]
  float* dd;         // [B, H, S]: D, written by the dQ kernel
  void* dq;
  void* dk;
  void* dv;
  int S, H, KV;
  int64_t st[3 * kTensors];
  float scale;
  int causal;
};

// the (b, head) base of tensor T and its row stride
template <typename E, int T>
__device__ __forceinline__ E* base(const Params& p, const void* ptr, int b,
                                   int head) {
  return const_cast<E*>(static_cast<const E*>(ptr)) + b * p.st[3 * T] +
         head * p.st[3 * T + 2];
}
template <int T>
__device__ __forceinline__ int64_t row_stride(const Params& p) {
  return p.st[3 * T + 1];
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&t);
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and each lane receives (row lane/4, columns 2(lane%4), +1) of each: the
// mma.sync fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed
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

// the A fragment of k-step j from the C fragments of n-tiles 2j and 2j + 1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// --- bf16, mma.sync ------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // rows (dQ) or keys (dK / dV) a block
constexpr int kPad = 8;             // bf16 elements of row padding (16 bytes)

// rows [r0, r0 + ROWS) of a [S, D] bf16 view with row stride `st` into a
// [ROWS][D + kPad] shared tile by 16-byte cp.async; rows past S zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t st, int r0, int S) {
  constexpr int LD = D + kPad;
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r0 + r < S;
    cp_async16(smem_u32(dst + r * LD + c * 8),
               ok ? src + (int64_t)(r0 + r) * st + c * 8 : src, ok);
  }
}

// acc[16 x N] (=|+)= A[16 rows of the warp] . B[N rows]^T over D: A and B
// both row-major [rows][D + kPad] tiles in shared memory (A's rows at
// a_rows, the warp's 16)
template <int D, int N>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[N / 8][4],
                                              const bf16* a_rows,
                                              const bf16* b) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (np * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 +
                          (mi & 1) * 8);
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// acc[16 x D] += X[16 x N] (C fragments, rounded to bf16) . T[N x D] (a
// row-major [N][D + kPad] tile in shared memory)
template <int D, int N>
__device__ __forceinline__ void frag_times_tile(float (&acc)[D / 8][4],
                                                const float (&x)[N / 8][4],
                                                const bf16* t) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    uint32_t a[4];
    c_to_a(a, x[2 * j], x[2 * j + 1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, t + (j * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 +
                                (mi >> 1) * 8);
      mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

// rows rlo, rlo + 8 of a 16-row accumulator into a bf16 [S, D] view
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t st,
                                           const float (&acc)[D / 8][4],
                                           int rlo, int S) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rlo + 8 * i;
    if (row >= S) continue;
    bf16* out = dst + (int64_t)row * st;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + t4 * 2) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D, int BK>
constexpr int dq_smem_bytes() {
  return (2 * kRows + 4 * BK) * (D + kPad) * 2;
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma / ldmatrix tile shapes");
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* dOs = Qs + kRows * LD;                    // [kRows][LD]
  bf16* Ks = dOs + kRows * LD;                    // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                    // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int qb = p.causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;  // heaviest first
  const int q0 = qb * kRows;
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
  const bf16* qp = base<const bf16, kQ>(p, p.q, b, h);
  const bf16* kp = base<const bf16, kK>(p, p.k, b, kvh);
  const bf16* vp = base<const bf16, kV>(p, p.v, b, kvh);
  const bf16* op = base<const bf16, kO>(p, p.o, b, h);
  const bf16* dop = base<const bf16, kDO>(p, p.dout, b, h);
  bf16* dqp = base<bf16, kDQ>(p, p.dq, b, h);

  load_tile<D, kRows>(Qs, qp, row_stride<kQ>(p), q0, p.S);
  load_tile<D, kRows>(dOs, dop, row_stride<kDO>(p), q0, p.S);
  load_tile<D, BK>(Ks, kp, row_stride<kK>(p), 0, p.S);
  load_tile<D, BK>(Vs, vp, row_stride<kV>(p), 0, p.S);
  cp_async_commit();

  // D of this warp's 16 rows from o and do: lane l sums columns l, l + 32,
  // ... of a row, a butterfly finishes it; lane r < 16 keeps row r's
  float d_mine = 0.0f;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.0f;
    if (row < p.S) {
      const bf16* orow = op + (int64_t)row * row_stride<kO>(p);
      const bf16* drow = dop + (int64_t)row * row_stride<kDO>(p);
      for (int c = lane; c < D; c += 32)
        acc += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == r) d_mine = acc;
  }
  const int64_t lrow = (int64_t)bh * p.S;
  if (lane < 16 && q0 + warp * 16 + lane < p.S)
    p.dd[lrow + q0 + warp * 16 + lane] = d_mine;
  const int rlo = q0 + warp * 16 + g, rhi = rlo + 8;  // this thread's rows
  const float d_lo = __shfl_sync(0xffffffffu, d_mine, g);
  const float d_hi = __shfl_sync(0xffffffffu, d_mine, g + 8);
  const float l2_lo = rlo < p.S ? p.lse[lrow + rlo] * kLog2e : 0.0f;
  const float l2_hi = rhi < p.S ? p.lse[lrow + rhi] * kLog2e : 0.0f;
  const float sl2 = p.scale * kLog2e;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  const int kv_end = p.causal ? min(q0 + kRows, p.S) : p.S;
  const int n_kv = (kv_end + BK - 1) / BK;

  for (int kb = 0; kb < n_kv; ++kb) {
    // the next tile is in flight while this one is multiplied out
    if (kb + 1 < n_kv) {
      load_tile<D, BK>(Ks + ((kb + 1) & 1) * BK * LD, kp, row_stride<kK>(p),
                       (kb + 1) * BK, p.S);
      load_tile<D, BK>(Vs + ((kb + 1) & 1) * BK * LD, vp, row_stride<kV>(p),
                       (kb + 1) * BK, p.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + (kb & 1) * BK * LD;
    const bf16* Vb = Vs + (kb & 1) * BK * LD;
    const int k0 = kb * BK;

    float s[BK / 8][4], dp[BK / 8][4];
    rows_dot_rows<D, BK>(s, Qs + warp * 16 * LD, Kb);
    rows_dot_rows<D, BK>(dp, dOs + warp * 16 * LD, Vb);

    // P from lse (0 past the diagonal and past S), dS = P (dP - D) scale,
    // kept in s
    const bool masked = (k0 + BK > p.S) || (p.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >> 1;
        float pe = exp2f(fmaf(s[n][e], sl2, -(hi ? l2_hi : l2_lo)));
        if (masked) {
          const int row = hi ? rhi : rlo;
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          if (key >= p.S || (p.causal && key > row)) pe = 0.0f;
        }
        s[n][e] = pe * (dp[n][e] - (hi ? d_hi : d_lo)) * p.scale;
      }
    frag_times_tile<D, BK>(dq, s, Kb);   // dQ += dS K
    __syncthreads();  // every warp is done with this buffer before refill
  }
  store_rows<D>(dqp, row_stride<kDQ>(p), dq, rlo, p.S);
}

template <int D, int BQ>
constexpr int dkdv_smem_bytes() {
  return (2 * kRows + 4 * BQ) * (D + kPad) * 2 + 4 * BQ * 4;
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0 && BQ % 16 == 0, "mma / ldmatrix tile shapes");
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* Vs = Ks + kRows * LD;                     // [kRows][LD]
  bf16* Qs = Vs + kRows * LD;                     // [2][BQ][LD]
  bf16* dOs = Qs + 2 * BQ * LD;                   // [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]: lse
  float* Ds = Ls + 2 * BQ;                                  // [2][BQ]: D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // the heaviest causal blocks first
  const int b = bkv / p.KV, kvh = bkv % p.KV, G = p.H / p.KV;
  const bf16* kp = base<const bf16, kK>(p, p.k, b, kvh);
  const bf16* vp = base<const bf16, kV>(p, p.v, b, kvh);

  // steps: the group's heads, each over the q tiles that see these keys
  const int qt0 = p.causal ? k0 / BQ : 0;
  const int n_qt = (p.S + BQ - 1) / BQ - qt0;
  const int steps = G * n_qt;
  auto load_step = [&](int i, int buf) {
    const int h = kvh * G + i / n_qt, q0 = (qt0 + i % n_qt) * BQ;
    load_tile<D, BQ>(Qs + buf * BQ * LD, base<const bf16, kQ>(p, p.q, b, h),
                     row_stride<kQ>(p), q0, p.S);
    load_tile<D, BQ>(dOs + buf * BQ * LD,
                     base<const bf16, kDO>(p, p.dout, b, h),
                     row_stride<kDO>(p), q0, p.S);
    if (tid < BQ) {
      const int64_t at = (int64_t)(b * p.H + h) * p.S + q0 + tid;
      const bool ok = q0 + tid < p.S;
      Ls[buf * BQ + tid] = ok ? p.lse[at] * kLog2e : 0.0f;
      Ds[buf * BQ + tid] = ok ? p.dd[at] : 0.0f;
    }
  };

  load_tile<D, kRows>(Ks, kp, row_stride<kK>(p), k0, p.S);
  load_tile<D, kRows>(Vs, vp, row_stride<kV>(p), k0, p.S);
  load_step(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const int klo = k0 + warp * 16 + g;  // this thread's keys: klo, klo + 8
  const float sl2 = p.scale * kLog2e;

  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) {
      load_step(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qs + buf * BQ * LD;
    const bf16* dOb = dOs + buf * BQ * LD;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Ds + buf * BQ;
    const int q0 = (qt0 + i % n_qt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float st[BQ / 8][4], dpt[BQ / 8][4];
    rows_dot_rows<D, BQ>(st, Ks + warp * 16 * LD, Qb);
    rows_dot_rows<D, BQ>(dpt, Vs + warp * 16 * LD, dOb);

    // P^T (0 for a query before the key or past S) in st, dS^T in dpt
    const bool masked = (q0 + BQ > p.S) || (p.causal && k0 + kRows - 1 > q0);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + t4 * 2 + (e & 1);
        float pe = exp2f(fmaf(st[n][e], sl2, -Lb[qi]));
        if (masked) {
          const int key = klo + (e >> 1) * 8;
          if (q0 + qi >= p.S || (p.causal && key > q0 + qi)) pe = 0.0f;
        }
        dpt[n][e] = pe * (dpt[n][e] - Db[qi]) * p.scale;
        st[n][e] = pe;
      }
    frag_times_tile<D, BQ>(dv, st, dOb);   // dV += P^T dO
    frag_times_tile<D, BQ>(dk, dpt, Qb);   // dK += dS^T Q
    __syncthreads();  // every warp is done with this buffer before refill
  }
  store_rows<D>(base<bf16, kDK>(p, p.dk, b, kvh), row_stride<kDK>(p), dk,
                klo, p.S);
  store_rows<D>(base<bf16, kDV>(p, p.dv, b, kvh), row_stride<kDV>(p), dv,
                klo, p.S);
}

// --- float32, CUDA cores --------------------------------------------------------

constexpr int kF = 32;           // rows (dQ) or keys (dK / dV) a block; the
                                 // tile it walks
constexpr int kFThreads = 256;   // thread t: row t / 8, columns t % 8 + 8 j

template <int D>
constexpr int f32_smem_bytes() {
  return (4 * kF * (D + 1) + 2 * kF * (kF + 1) + 2 * kF) * 4;
}

// rows [r0, r0 + kF) of a [S, D] float32 view into a [kF][D + 1] tile
// (the odd row length keeps a warp's column reads on distinct banks); rows
// past S are zeros
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         int64_t st, int r0, int S) {
  for (int i = threadIdx.x; i < kF * D; i += kFThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[(int64_t)(r0 + r) * st + c] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int LD = D + 1, LP = kF + 1;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;               // [kF][LD]
  float* dOs = Qs + kF * LD;     // [kF][LD]
  float* Ks = dOs + kF * LD;     // [kF][LD]
  float* Vs = Ks + kF * LD;      // [kF][LD]
  float* dSs = Vs + kF * LD;     // [kF][LP]

  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;
  const int bh = blockIdx.x;
  const int qb = p.causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
  const int q0 = qb * kF, row = q0 + r;
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
  const float* kp = base<const float, kK>(p, p.k, b, kvh);
  const float* vp = base<const float, kV>(p, p.v, b, kvh);
  const float* op = base<const float, kO>(p, p.o, b, h);
  load_f32<D>(Qs, base<const float, kQ>(p, p.q, b, h), row_stride<kQ>(p), q0,
              p.S);
  load_f32<D>(dOs, base<const float, kDO>(p, p.dout, b, h),
              row_stride<kDO>(p), q0, p.S);
  __syncthreads();

  // D of row r: columns c + 8 j here, the 8 threads of the row after
  float dsum = 0.0f;
  if (row < p.S) {
    const float* orow = op + (int64_t)row * row_stride<kO>(p);
    for (int d = c; d < D; d += 8) dsum = fmaf(dOs[r * LD + d], orow[d], dsum);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
  const int64_t lrow = (int64_t)bh * p.S;
  if (c == 0 && row < p.S) p.dd[lrow + row] = dsum;
  const float lse = row < p.S ? p.lse[lrow + row] : 0.0f;

  float dq[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j] = 0.0f;
  const int kv_end = p.causal ? min(q0 + kF, p.S) : p.S;
  for (int k0 = 0; k0 < kv_end; k0 += kF) {
    load_f32<D>(Ks, kp, row_stride<kK>(p), k0, p.S);
    load_f32<D>(Vs, vp, row_stride<kV>(p), k0, p.S);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF / 8; ++j) {
      const int kl = c + 8 * j, key = k0 + kl;
      const float s = dot_rows<D>(Qs + r * LD, Ks + kl * LD);
      const float dp = dot_rows<D>(dOs + r * LD, Vs + kl * LD);
      float pe = expf(s * p.scale - lse);
      if (key >= p.S || (p.causal && key > row)) pe = 0.0f;
      dSs[r * LP + kl] = pe * (dp - dsum) * p.scale;
    }
    __syncthreads();
    for (int kl = 0; kl < kF; ++kl) {
      const float ds = dSs[r * LP + kl];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        dq[j] = fmaf(ds, Ks[kl * LD + c + 8 * j], dq[j]);
    }
    __syncthreads();  // K, V and dS are refilled next
  }
  if (row < p.S) {
    float* out = base<float, kDQ>(p, p.dq, b, h) +
                 (int64_t)row * row_stride<kDQ>(p);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) out[c + 8 * j] = dq[j];
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_dkdv_f32_kernel(const Params p) {
  constexpr int LD = D + 1, LP = kF + 1;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;               // [kF][LD]
  float* Vs = Ks + kF * LD;      // [kF][LD]
  float* Qs = Vs + kF * LD;      // [kF][LD]
  float* dOs = Qs + kF * LD;     // [kF][LD]
  float* Ps = dOs + kF * LD;     // [kF][LP]: P^T, key-major
  float* dSs = Ps + kF * LP;     // [kF][LP]: dS^T
  float* Ls = dSs + kF * LP;     // [kF]
  float* Ds = Ls + kF;           // [kF]

  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kF, key = k0 + r;
  const int b = bkv / p.KV, kvh = bkv % p.KV, G = p.H / p.KV;
  load_f32<D>(Ks, base<const float, kK>(p, p.k, b, kvh), row_stride<kK>(p),
              k0, p.S);
  load_f32<D>(Vs, base<const float, kV>(p, p.v, b, kvh), row_stride<kV>(p),
              k0, p.S);

  float dk[D / 8], dv[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk[j] = dv[j] = 0.0f;
  const int qs0 = p.causal ? k0 : 0;  // the first query that sees a key here
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const int64_t lrow = (int64_t)(b * p.H + h) * p.S;
    for (int q0 = qs0; q0 < p.S; q0 += kF) {
      load_f32<D>(Qs, base<const float, kQ>(p, p.q, b, h), row_stride<kQ>(p),
                  q0, p.S);
      load_f32<D>(dOs, base<const float, kDO>(p, p.dout, b, h),
                  row_stride<kDO>(p), q0, p.S);
      if (tid < kF) {
        const bool ok = q0 + tid < p.S;
        Ls[tid] = ok ? p.lse[lrow + q0 + tid] : 0.0f;
        Ds[tid] = ok ? p.dd[lrow + q0 + tid] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kF / 8; ++j) {
        const int ql = c + 8 * j, query = q0 + ql;
        const float s = dot_rows<D>(Ks + r * LD, Qs + ql * LD);
        const float dp = dot_rows<D>(Vs + r * LD, dOs + ql * LD);
        float pe = expf(s * p.scale - Ls[ql]);
        if (query >= p.S || (p.causal && key > query)) pe = 0.0f;
        Ps[r * LP + ql] = pe;
        dSs[r * LP + ql] = pe * (dp - Ds[ql]) * p.scale;
      }
      __syncthreads();
      for (int ql = 0; ql < kF; ++ql) {
        const float pv = Ps[r * LP + ql], ds = dSs[r * LP + ql];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          dv[j] = fmaf(pv, dOs[ql * LD + c + 8 * j], dv[j]);
          dk[j] = fmaf(ds, Qs[ql * LD + c + 8 * j], dk[j]);
        }
      }
      __syncthreads();  // Q, dO, P and dS are refilled next
    }
  }
  if (key < p.S) {
    float* ko = base<float, kDK>(p, p.dk, b, kvh) +
                (int64_t)key * row_stride<kDK>(p);
    float* vo = base<float, kDV>(p, p.dv, b, kvh) +
                (int64_t)key * row_stride<kDV>(p);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      ko[c + 8 * j] = dk[j];
      vo[c + 8 * j] = dv[j];
    }
  }
}

// --- launch ------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int threads, const Params& p,
                   int gx, int gy, unsigned* smem_done, int device,
                   void* stream) {
  cudaError_t err = allow_smem(kernel, smem, device, smem_done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), threads, smem,
           (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

template <int D, int BQ>
int launch_bf16(const Params& p, int B, int device, void* stream) {
  static unsigned dq_done = 0, dkdv_done = 0;
  cudaError_t err = launch(flash_bwd_dq_bf16_kernel<D, 64>,
                           dq_smem_bytes<D, 64>(), kThreads, p, B * p.H,
                           (p.S + kRows - 1) / kRows, &dq_done, device,
                           stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(flash_bwd_dkdv_bf16_kernel<D, BQ>,
                     dkdv_smem_bytes<D, BQ>(), kThreads, p, B * p.KV,
                     (p.S + kRows - 1) / kRows, &dkdv_done, device, stream);
}

template <int D>
int launch_f32(const Params& p, int B, int device, void* stream) {
  static unsigned dq_done = 0, dkdv_done = 0;
  cudaError_t err = launch(flash_bwd_dq_f32_kernel<D>,
                           f32_smem_bytes<D>(), kFThreads, p, B * p.H,
                           (p.S + kF - 1) / kF, &dq_done, device, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(flash_bwd_dkdv_f32_kernel<D>, f32_smem_bytes<D>(),
                     kFThreads, p, B * p.KV, (p.S + kF - 1) / kF,
                     &dkdv_done, device, stream);
}

bool aligned_rows(const void* const* ptrs, const long long* st, int elem) {
  for (int i = 0; i < kTensors; ++i)
    if (!aligned16(ptrs[i])) return false;
  for (int i = 0; i < 3 * kTensors; ++i)
    if ((st[i] * elem) % 16) return false;
  return true;
}

// the checks both variants share; fills p
bool make_params(Params* p, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse, void* dd,
                 void* dq, void* dk, void* dv, int B, int S, int H, int KV,
                 int hd, const long long* strides, float scale, int causal,
                 int elem) {
  const void* ptrs[kTensors] = {q, k, v, o, dout, dq, dk, dv};
  if (B < 1 || S < 1 || KV < 1 || H % KV || (hd != 64 && hd != 128) ||
      (int64_t)B * H >= (1ll << 31) || lse == nullptr || dd == nullptr ||
      !aligned_rows(ptrs, strides, elem))
    return false;
  p->q = q; p->k = k; p->v = v; p->o = o; p->dout = dout;
  p->lse = static_cast<const float*>(lse);
  p->dd = static_cast<float*>(dd);
  p->dq = dq; p->dk = dk; p->dv = dv;
  p->S = S; p->H = H; p->KV = KV;
  for (int i = 0; i < 3 * kTensors; ++i) p->st[i] = strides[i];
  p->scale = scale;
  p->causal = causal;
  return true;
}

}  // namespace

extern "C" {

// Both entry points: q, k, v, o, do, lse, the D scratch (float32 [B, H, S]),
// dq, dk, dv device pointers; B, S, H, KV, hd (== hv, 64 or 128); strides:
// 24 element strides, (batch, seq, head) of q, k, v, o, do, dq, dk, dv in
// order; the softmax scale; causal; the plan: the dQ kernel's rows a block
// (q_rows) and kv step, the dK / dV kernel's keys a block (kv_rows) and q
// step; the device and the stream.  Every row 16-byte aligned.  Launches
// the dQ kernel (which writes D), then the dK / dV kernel.

// bf16 on mma.sync.  Plan: q_rows = kv_rows = kv_step = 64; q_step 64 at
// hd 64, 32 at hd 128.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dd, void* dq, void* dk, void* dv, int B,
                             int S, int H, int KV, int hd,
                             const long long* strides, float scale,
                             int causal, int q_rows, int kv_rows, int q_step,
                             int kv_step, int device, void* stream) {
  Params p;
  if (!make_params(&p, q, k, v, o, dout, lse, dd, dq, dk, dv, B, S, H, KV,
                   hd, strides, scale, causal, 2) ||
      q_rows != kRows || kv_rows != kRows || kv_step != 64 ||
      q_step != (hd == 64 ? 64 : 32))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return hd == 64 ? launch_bf16<64, 64>(p, B, device, stream)
                  : launch_bf16<128, 32>(p, B, device, stream);
}

// float32 on the CUDA cores.  Plan: every block and step 32 rows.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dd, void* dq, void* dk, void* dv, int B,
                            int S, int H, int KV, int hd,
                            const long long* strides, float scale, int causal,
                            int q_rows, int kv_rows, int q_step, int kv_step,
                            int device, void* stream) {
  Params p;
  if (!make_params(&p, q, k, v, o, dout, lse, dd, dq, dk, dv, B, S, H, KV,
                   hd, strides, scale, causal, 4) ||
      q_rows != kF || kv_rows != kF || q_step != kF || kv_step != kF)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return hd == 64 ? launch_f32<64>(p, B, device, stream)
                  : launch_f32<128>(p, B, device, stream);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
